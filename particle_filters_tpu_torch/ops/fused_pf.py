"""Fused SIR filter on kernel B1 (PyTorch port of
``particle_filters_tpu/ops/fused_pf.py``).

Each step is one launch over the particle arrays:

    normals → x' = g(x) + Lq·ε → Δlogw = obs_ll(x', z) → weight moments
    → the packed row [log_z, ess, mean (nx), Σw·x⊗x (nx²)],
      the no-resample carry (log_z, 0) and the trigger ess < thresh·N

on a CUDA tensor by the Triton kernel B1 (``_fused_pf_triton.py``, whose
note says what bounds it, why it is Triton and how its last program
finishes the moments), on a CPU tensor by its plain version
:func:`fused_step_reference` (block partials folded by
:func:`_combine_partials`). Weight normalization is lazy, as in the JAX
package: the carry is ``(particles, logw, off_u)`` with
``off_u = (pending log-Z, uniform flag)``, and the next step folds both into
its load. What a caller keeps across launches (the kernel's ticket counter,
its partials rows, the carry and the trigger) is a :class:`StepWork`.

Layout: particles are (N,) for nx = 1 and (nx, N) for nx > 1, log-weights
(N,). The JAX package's (8, N/8) layout and 128-lane observation padding
were TPU layout choices and are not carried over.

Resampling goes through kernels S and B2 (via ``systematic_resample_values``
of ``resampling/hard.py``); S takes the step's log-weights with the row's
log Z, so the resample normalizes nothing on its own. Whether a step
resamples is decided on the host from the kernel's trigger: one 4-byte
device→host read per step, where the JAX package branches on the device
with ``lax.cond``.

With a process group (the counterpart of the JAX package's ``axis_name``)
each rank runs B1 over its n = N/S particles as rank r of the whole cloud:
the kernel draws the normals of the particles' global indices and weights
with log N_global, and its row is the rank's. The ranks ``all_gather``
their partials rows (the kernel's programs', the plain version's blocks)
and every rank combines them in rank order by :func:`_combine_partials`
(:func:`fold_ranks`): the global row, the carry (log Z, 0) and the trigger
ESS < thresh·N, read on the host from bits that are the same on every
rank. The rows alone would fold too (log Z = logsumexp_s log_z_s, …), but
that log Z rounds otherwise than one device's, and the lazy carry feeds
the difference into the log-weights, where it moves a resample's f32 run
end by one about every other resample step at N = 4096. Combining the
partials instead, the plain version's blocks being the one-device blocks
when a rank's count is a multiple of the block, keeps the sharded plain
run bit-equal to the one-device run; on the card the programs' partials
split the cloud otherwise than one launch's, and the sums round
otherwise. Under a group the kernel still finishes its rank's row, carry
and trigger, which the fold then overwrites: one kernel serves both uses,
where a switch for the finish would compile a second kernel for every
model, and the finish is one program's pass over the programs' partials
rows (about 1.3 µs of a 2²⁰ step on the H100, PERF.md §7). The resample is
the global systematic one (``parallel/distributed_resample.py``), all-gather
or neighbour mode. The initial cloud is drawn at the global shape from the
replicated generator, each rank keeping its columns, so the sharded filter
starts from the one-device filter's cloud.

Models are pointwise: an object with ``nx``, ``params`` (the model's
scalars), torch ``g(x)`` and ``obs_loglik(x, z)`` on (nx, B) tiles for the
plain version, and ``@triton.jit`` ``g_tl`` / ``obs_loglik_tl`` for the
kernel, which reads the same scalars from a tensor. Two ship here:
:class:`SVModel` and :class:`LinearObsFirstModel`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from particle_filters_tpu_torch.core import comm
from particle_filters_tpu_torch.core.structs import as_f32
from particle_filters_tpu_torch.resampling.hard import systematic_resample_values
from particle_filters_tpu_torch.utils.timing import span

_MAX_NX = 10


# --- pointwise models ------------------------------------------------------
class SVModel:
    """1-D stochastic volatility: x' = α x + noise, z ~ N(0, β² eˣ)
    (log-likelihood without the −½ log 2π constant, as the benchmark's)."""

    nx = 1

    def __init__(self, alpha: float, beta: float = 1.0) -> None:
        self.params = (float(alpha), float(beta))

    def g(self, x):
        return self.params[0] * x

    def obs_loglik(self, x, z):
        # −½(z²/β²·e⁻ˣ + log(β² eˣ)), spelled as the kernel spells it.
        beta = self.params[1]
        return -0.5 * (z[0] * z[0] / beta**2 * torch.exp(-x[0]) + x[0] + 2 * math.log(beta))

    @property
    def g_tl(self):
        from particle_filters_tpu_torch.ops._fused_pf_triton import sv_g

        return sv_g

    @property
    def obs_loglik_tl(self):
        from particle_filters_tpu_torch.ops._fused_pf_triton import sv_obs_loglik

        return sv_obs_loglik


class LinearObsFirstModel:
    """Linear-Gaussian: x' = A x + noise, z = x[0] + N(0, r)."""

    def __init__(self, A, r: float) -> None:
        A = np.asarray(A, np.float32)
        self.nx = A.shape[0]
        self.params = tuple(float(a) for a in A.reshape(-1)) + (float(r),)

    def g(self, x):
        nx = self.nx
        A = self.params[: nx * nx]
        return torch.stack(
            [sum(A[i * nx + j] * x[j] for j in range(nx)) for i in range(nx)]
        )

    def obs_loglik(self, x, z):
        d = z[0] - x[0]
        return -0.5 * d * d / self.params[-1]

    @property
    def g_tl(self):
        from particle_filters_tpu_torch.ops._fused_pf_triton import linear_g

        return linear_g

    @property
    def obs_loglik_tl(self):
        from particle_filters_tpu_torch.ops._fused_pf_triton import (
            linear_obs_first_loglik,
        )

        return linear_obs_first_loglik


# --- kernel B1, its plain version, and the combine -------------------------
# Programs of B1 per SM: its persistent grid (chip_smoke.py's sweep, PERF.md).
PROGRAMS_PER_SM = 2


def block_size(nx: int) -> int:
    """Particles per partials row of the plain version: 1024 at nx = 1,
    fewer as the tile grows."""
    nxp = 1 << (nx - 1).bit_length()
    return max(128, 1024 // nxp)


def partials_width(nx: int) -> int:
    return 3 + nx + nx * nx


def row_width(nx: int) -> int:
    """Width of the packed row ``[log_z, ess, mean (nx), Σw·x⊗x (nx²)]``."""
    return 2 + nx + nx * nx


def noise_factor(Q) -> np.ndarray:
    """f32 ``Lq = cholesky(Q + 1e-10·I)``, taken in numpy as the JAX fused
    filter takes it."""
    Q = np.asarray(Q, np.float32)
    return np.linalg.cholesky(Q + 1e-10 * np.eye(Q.shape[0])).astype(np.float32)


def _combine_partials(partials: torch.Tensor, nx: int):
    """Exact global moments from per-block (max, Σe, Σe², Σe·x, Σe·x⊗x).

    Returns ``(log_z, ess, mean, exx)`` with ``exx`` the normalized second
    moment Σw·x⊗x, flat (nx²,); the covariance is ``exx − mean⊗mean``.
    """
    m_b = partials[:, 0]
    s_b = partials[:, 1]
    e2_b = partials[:, 2]
    ex_b = partials[:, 3 : 3 + nx]
    exx_b = partials[:, 3 + nx : 3 + nx + nx * nx]

    m_g = torch.max(m_b)
    scale = torch.exp(m_b - m_g)  # (n_blocks,)
    Z = torch.sum(s_b * scale)
    log_z = m_g + torch.log(torch.clamp(Z, min=1e-30))
    sum_w2 = torch.sum(e2_b * scale * scale)  # Σ exp(2(lw − m_g))
    ess = (Z * Z) / torch.clamp(sum_w2, min=1e-30)
    mean = (scale[:, None] * ex_b).sum(0) / Z
    exx = (scale[:, None] * exx_b).sum(0) / Z
    return log_z, ess, mean, exx


def _block_partials(x_new, lw_new):
    """One partials row ``[m, Σe, Σe², Σe·x, Σe·x⊗x]`` per block of
    ``block_size(nx)`` particles, e = exp(lw − m)."""
    nx, n = x_new.shape
    block = block_size(nx)
    nb = -(-n // block)
    pad = nb * block - n
    lw_b = torch.nn.functional.pad(lw_new, (0, pad), value=float("-inf")).view(nb, block)
    x_b = torch.nn.functional.pad(x_new, (0, pad)).view(nx, nb, block)
    m = lw_b.max(dim=1).values
    m = torch.where(m > float("-inf"), m, torch.zeros_like(m))
    e = torch.exp(lw_b - m[:, None])  # (nb, block); padding gives 0
    ex = (x_b * e).sum(-1).T  # (nb, nx)
    exx = (x_b[:, None] * x_b[None, :] * e).sum(-1)  # (nx, nx, nb)
    return torch.cat(
        [
            m[:, None],
            e.sum(-1, keepdim=True),
            (e * e).sum(-1, keepdim=True),
            ex,
            exx.permute(2, 0, 1).reshape(nb, nx * nx),
        ],
        dim=1,
    )


def _packed(partials: torch.Tensor, nx: int) -> torch.Tensor:
    """The packed row ``[log_z, ess, mean, Σw·x⊗x]`` of partials rows."""
    log_z, ess, mean, exx = _combine_partials(partials, nx)
    return torch.cat([log_z[None], ess[None], mean, exx])


def fold_ranks(partials: torch.Tensor, nx: int, group) -> torch.Tensor:
    """The whole cloud's packed row from this rank's partials rows: every
    rank's gathered in rank order and combined (the same bits on every
    rank). The ranks' counts of rows must agree (equal counts per rank)."""
    return _packed(comm.all_gather_cat(partials, group), nx)


def fused_step_reference(x, lw, off_u, z, eps, Lq, model, n_global=None):
    """Plain version of B1 with injected normals ``eps`` (nx, N).

    Returns ``(x', lw', row)``: x' (nx, N), lw' (N,) and the packed row
    ``[log_z, ess, mean (nx), Σw·x⊗x (nx²)]`` that the kernel writes, from
    block partials folded by :func:`_combine_partials`. ``n_global`` (the
    whole cloud's count on a rank of a sharded filter) sets the uniform
    log-weight −log N.
    """
    x_new, lw_new, partials = _reference_partials(x, lw, off_u, z, eps, Lq, model, n_global)
    return x_new, lw_new, _packed(partials, x.shape[0])


def _reference_partials(x, lw, off_u, z, eps, Lq, model, n_global=None):
    """:func:`fused_step_reference` with the block partials for its row."""
    nx, n = x.shape
    n_global = n if n_global is None else n_global
    noise = sum(Lq[:, j : j + 1] * eps[j] for j in range(nx))
    x_new = model.g(x) + noise
    lw_in = torch.where(off_u[1] > 0.5, -math.log(n_global), lw - off_u[0])
    lw_new = lw_in + model.obs_loglik(x_new, z)
    return x_new, lw_new, _block_partials(x_new, lw_new)


class StepWork:
    """What one caller of B1 keeps across launches: the int32 ticket
    counter (0 between launches: the kernel's last program resets it), one
    partials row per program, the carry ``(log_z, 0)`` in two slots that
    launches alternate (a launch may read the previous carry as its
    ``off_u``) and the int32 trigger ``ess < thresh·N``; after a step
    :meth:`last_partials` are the partials rows its row came from (the
    kernel's programs', or the plain version's blocks). One launch at a
    time per object; each ``FusedSIRFilter`` owns one."""

    def __init__(self, nx: int, device, programs: Optional[int] = None) -> None:
        device = torch.device(device)
        if programs is None:
            programs = 1
            if device.type == "cuda":
                sms = torch.cuda.get_device_properties(device).multi_processor_count
                programs = PROGRAMS_PER_SM * sms
        self.programs = int(programs)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        self.trigger = torch.zeros(1, dtype=torch.int32, device=device)
        self.partials = torch.zeros((self.programs, partials_width(nx)), device=device)
        self._carry = torch.zeros((2, 2), device=device)
        self._slot = 0
        self._last = self.partials[:0]

    def last_partials(self) -> torch.Tensor:
        """The partials rows of the last step (read before the next one)."""
        return self._last

    @property
    def carry(self) -> torch.Tensor:
        """The no-resample carry ``(log_z, 0)`` of the last launch."""
        return self._carry[self._slot]

    def _next_carry(self) -> torch.Tensor:
        self._slot ^= 1
        return self._carry[self._slot]


def _check_step_args(x, lw, off_u, z, Lq, params, eps, work=None, ranks=1, **outs):
    nx, n = x.shape
    tensors = {"x": x, "lw": lw, "off_u": off_u, "z": z, "Lq": Lq, "params": params}
    if eps is not None:
        tensors["eps"] = eps
    tensors.update({k: v for k, v in outs.items() if v is not None})
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}.")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}.")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous.")
    if lw.shape != (n,) or off_u.shape != (2,) or Lq.shape != (nx, nx):
        raise ValueError(
            f"shapes: lw {tuple(lw.shape)} (want ({n},)), off_u "
            f"{tuple(off_u.shape)} (want (2,)), Lq {tuple(Lq.shape)} "
            f"(want ({nx}, {nx}))."
        )
    want = {"eps": x.shape, "x_out": x.shape, "lw_out": lw.shape,
            "row_out": (row_width(nx),)}
    for name, shape in want.items():
        t = tensors.get(name)
        if t is not None and t.shape != shape:
            raise ValueError(f"{name} must be {tuple(shape)}; got {tuple(t.shape)}.")
    if work is not None and work.counter.device != x.device:
        raise ValueError(f"work is on {work.counter.device}, x on {x.device}.")
    # Offsets are int32: x's (row·N + particle) and Philox's (row·(N + a
    # tile) over the whole cloud).
    if nx > _MAX_NX or nx * ranks * (n + 2048) >= 2**31:
        raise ValueError("need nx <= 10 and nx·S·(N + 2048) < 2**31.")


def fused_step(x, lw, off_u, z, Lq, params, model, *, seed: int,
               eps: Optional[torch.Tensor] = None, resample_thresh: float = 0.5,
               work: Optional[StepWork] = None, x_out=None, lw_out=None, row_out=None,
               shard=(0, 1)):
    """One fused propagate-and-weight step: ``(x', lw', row)`` with the
    packed row ``[log_z, ess, mean (nx), Σw·x⊗x (nx²)]``.

    ``x`` (nx, N), ``lw`` (N,), ``off_u`` (2,), ``z`` (nz,), ``Lq`` (nx, nx)
    and ``params`` (the model's scalars) are f32 tensors on one device. On a
    CUDA tensor kernel B1 draws the normals with Philox keyed on ``seed``
    (``eps``, when given, replaces them: a test hook); on a CPU tensor the
    plain version takes ``eps`` or draws it from a generator seeded with
    ``seed``. The carry ``(log_z, 0)`` and the trigger
    ``ess < resample_thresh·N`` land in ``work`` (a fresh :class:`StepWork`
    when none is given); ``x_out``, ``lw_out`` and ``row_out`` receive the
    outputs when given. ``shard = (r, S)`` runs the step as rank r of S
    ranks of a cloud of S·N particles (the caller folds the ranks' partials):
    the normals are those of the particles' global indices (the plain
    version draws the global (nx, S·N) normals and keeps its columns), and
    N in −log N and in the trigger is S·N. ``fused_step.launches`` counts
    kernel launches.
    """
    _check_step_args(x, lw, off_u, z, Lq, params, eps, work, shard[1],
                     x_out=x_out, lw_out=lw_out, row_out=row_out)
    return _fused_step(x, lw, off_u, z, Lq, params, model, seed, eps, resample_thresh,
                       work, x_out, lw_out, row_out, shard)


def _fused_step(x, lw, off_u, z, Lq, params, model, seed, eps, resample_thresh,
                work, x_out, lw_out, row_out, shard=(0, 1)):
    """:func:`fused_step` on arguments that have been checked."""
    nx, n = x.shape
    rank, ranks = shard
    work = StepWork(nx, x.device) if work is None else work
    row_out = torch.empty(row_width(nx), device=x.device) if row_out is None else row_out
    carry = work._next_carry()
    if x.device.type == "cpu":
        if eps is None:
            gen = torch.Generator().manual_seed(int(seed))
            eps = torch.randn((nx, ranks * n), generator=gen, dtype=x.dtype)
            eps = eps[:, rank * n:(rank + 1) * n]
        x_new, lw_new, work._last = _reference_partials(x, lw, off_u, z, eps, Lq, model,
                                                        ranks * n)
        row = _packed(work._last, nx)
        row_out.copy_(row)
        carry.copy_(torch.stack([row[0], torch.zeros_like(row[0])]))
        work.trigger.copy_(row[1] < resample_thresh * ranks * n)
        if x_out is not None:
            x_new = x_out.copy_(x_new)
        if lw_out is not None:
            lw_new = lw_out.copy_(lw_new)
        return x_new, lw_new, row_out
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}.")
    from particle_filters_tpu_torch.ops import _fused_pf_triton

    x_out = torch.empty_like(x) if x_out is None else x_out
    lw_out = torch.empty_like(lw) if lw_out is None else lw_out
    programs = _fused_pf_triton.launch(
        x, lw, off_u, z, Lq, params, eps, model, int(seed),
        float(resample_thresh * ranks * n), x_out, lw_out, row_out, carry, work.trigger,
        work.counter, work.partials, work.programs, shard,
    )
    work._last = work.partials[:programs]
    fused_step.launches += 1
    return x_out, lw_out, row_out


fused_step.launches = 0


# --- the filter --------------------------------------------------------------
class FusedSIRFilter:
    """SIR particle filter on the fused step (pointwise models, nx ≤ 10,
    additive Gaussian process noise x' = g(x) + Lq ε).

    ``initialize(generator, mean, cov)`` then ``run(generator, state, zs)``
    returns ``(state, history)`` with the history schema of
    ``ParticleFilter.run``. The generator lives on ``device`` (the card
    unless ``device="cpu"``): it draws the initial cloud, the per-step
    kernel seeds and the resampling uniforms.

    With ``group`` the filter is one rank of a sharded one (the module's
    note): ``Np`` is the global count and must divide over the ranks, the
    state holds this rank's n = Np/S particles, the generator is the
    replicated one (seeded alike on every rank), and ``distributed_resample``
    (``"all_gather"`` | ``"neighbor"``, with ``neighbor_radius``) picks the
    cross-rank resample, as in ``ParticleFilter``.
    """

    def __init__(self, model, Q, *, Np: int, resample_thresh: float = 0.5, group=None,
                 distributed_resample: str = "all_gather", neighbor_radius: int = 2,
                 device="cuda") -> None:
        self.model = model
        self.Q = np.asarray(Q, np.float32)
        self.nx = self.Q.shape[0]
        if self.nx > _MAX_NX:
            raise ValueError("FusedSIRFilter supports nx <= 10.")
        if model.nx != self.nx:
            raise ValueError(f"model.nx = {model.nx} but Q is {self.Q.shape}.")
        self.device = torch.device(device)
        self.Lq = torch.as_tensor(noise_factor(self.Q), device=self.device)
        self.params = torch.tensor(model.params, dtype=torch.float32, device=self.device)
        if distributed_resample not in ("all_gather", "neighbor"):
            raise ValueError("distributed_resample must be 'all_gather' or 'neighbor'.")
        self.group = group
        self.distributed_resample = distributed_resample
        self.neighbor_radius = int(neighbor_radius)
        self.rank, self.ranks = (0, 1) if group is None else (comm.rank(group), comm.size(group))
        self.Np = int(Np)
        if self.Np % self.ranks:
            raise ValueError(f"Np={Np} must divide over {self.ranks} ranks.")
        self.n = self.Np // self.ranks
        self.resample_thresh = float(resample_thresh)
        self._off_resampled = torch.tensor([0.0, 1.0], device=self.device)
        self._work = StepWork(self.nx, self.device)

    def _shape(self):
        return (self.n,) if self.nx == 1 else (self.nx, self.n)

    def initialize(self, generator, mean, cov):
        """Particles ~ N(mean, cov), normalized uniform weights, off_u = 0:
        the cloud of all Np particles, of which a rank keeps its columns."""
        mean = as_f32(mean, self.device).reshape(-1)
        cov = torch.atleast_2d(as_f32(cov, self.device))
        L = torch.linalg.cholesky(cov + 1e-10 * torch.eye(self.nx, device=self.device))
        eps = torch.randn((self.nx, self.Np), generator=generator, device=self.device)
        cloud = mean[:, None] + L @ eps
        particles = cloud[:, self.rank * self.n:(self.rank + 1) * self.n]
        particles = particles.reshape(self._shape()).contiguous()
        logw = torch.full((self.n,), -math.log(self.Np), device=self.device)
        return particles, logw, torch.zeros(2, device=self.device)

    def effective_logw(self, state):
        """The state's true normalized log-weights (the run loop never
        materializes them; the kernel folds the pending scalars in)."""
        _, logw, off_u = state
        return torch.where(off_u[1] > 0.5, -math.log(self.Np), logw - off_u[0])

    def _draw_seeds(self, generator, T: int):
        """T kernel seeds from ``generator``: one host read per call."""
        return torch.randint(
            0, 2**31 - 1, (T,), generator=generator, device=generator.device
        ).tolist()

    def _resample(self, generator, particles, logw, log_z):
        """The resampled particles and whether a neighbour pool sufficed.
        ``logw`` is the kernel's output, whose logsumexp over the whole
        cloud is ``log_z`` (a device scalar, never read on the host): kernel
        S takes both and forms the weights itself, on one device and, over
        the gathered cloud, in all-gather mode (which so stays bit-equal to
        one device)."""
        p = particles.view(self.n, 1) if self.nx == 1 else particles.T
        ok = True
        if self.group is None:
            p_new = systematic_resample_values(generator, p, logw=logw, log_z=log_z)
        elif self.distributed_resample == "neighbor":
            from particle_filters_tpu_torch.parallel.distributed_resample import (
                neighbor_exchange_systematic_resample,
            )

            p_new, ok = neighbor_exchange_systematic_resample(
                generator, p, logw - log_z, group=self.group, radius=self.neighbor_radius)
        else:
            from particle_filters_tpu_torch.parallel.distributed_resample import (
                all_gather_systematic_resample,
            )

            p_new, _ = all_gather_systematic_resample(generator, p, logw, group=self.group,
                                                      log_z=log_z)
        return (p_new.view(self.n) if self.nx == 1 else p_new.T.contiguous()), ok

    def _check(self, state, z):
        particles, logw, off_u = state
        _check_step_args(particles.view(self.nx, self.n), logw, off_u, z, self.Lq,
                         self.params, None, ranks=self.ranks)

    def _step_core(self, seed, generator, carry, z, row_out, x_out=None, lw_out=None):
        """One fused step + conditional resample on checked arguments:
        ``(carry, trigger, exchange_ok)``. The step's row ``[log_z, ess,
        mean (nx), Σw·x⊗x (nx²)]`` (the whole cloud's, folded over the ranks
        with a group) lands in ``row_out``; x' and lw' in ``x_out`` and
        ``lw_out`` when given (neither may be an input of the step)."""
        particles, logw, off_u = carry
        with span("pf.sir.b1"):
            x_new, logw, _ = _fused_step(
                particles.view(self.nx, self.n), logw, off_u, z, self.Lq, self.params,
                self.model, seed, None, self.resample_thresh, self._work, x_out, lw_out,
                row_out, (self.rank, self.ranks),
            )
        particles = x_new.view(self._shape())
        if self.ranks > 1:
            row_out.copy_(fold_ranks(self._work.last_partials(), self.nx, self.group))
            self._work.carry.copy_(torch.stack([row_out[0], torch.zeros_like(row_out[0])]))
            self._work.trigger.copy_(row_out[1] < self.resample_thresh * self.Np)
        # The one host read of the step (4 bytes): the resample branch runs on the host.
        with span("pf.sir.trigger_read"):
            trigger = bool(self._work.trigger.item())
        ok = True
        if trigger:
            with span("pf.sir.resample"):
                particles, ok = self._resample(generator, particles, logw, row_out[0])
            off_u = self._off_resampled
        else:
            off_u = self._work.carry
        return (particles, logw, off_u), trigger, ok

    def _hist_dict(self, rows, triggers, oks=None):
        nx = self.nx
        mean = rows[..., 2 : 2 + nx]
        exx = rows[..., 2 + nx : 2 + nx + nx * nx].reshape(rows.shape[:-1] + (nx, nx))
        resampled = torch.tensor(triggers, dtype=torch.bool, device=rows.device)
        return {
            "mean": mean,
            "cov": exx - mean[..., :, None] * mean[..., None, :],
            "ess": rows[..., 1],
            "resampled": resampled,
            "log_evidence": rows[..., 0],
            "exchange_ok": (torch.ones_like(resampled) if oks is None else
                            torch.tensor(oks, dtype=torch.bool, device=rows.device)),
        }

    def _obs(self, z):
        return as_f32(z, self.device).contiguous()

    def step(self, generator, state, z):
        """One filter step: ``(new_state, info)`` with one history row."""
        (seed,) = self._draw_seeds(generator, 1)
        z = self._obs(z).reshape(-1)
        self._check(state, z)
        row = torch.empty(row_width(self.nx), device=self.device)
        (particles, logw, off_u), trig, ok = self._step_core(seed, generator, state, z, row)
        return (particles, logw, off_u.clone()), self._hist_dict(row, trig, ok)

    def run(self, generator, state, zs):
        """Filter a (T, nz) sequence; the history mirrors ``ParticleFilter.run``.

        The outputs are allocated once: two particle and two log-weight
        buffers that the steps alternate, and the (T, 2 + nx + nx²) rows the
        kernel writes. ``state`` is read, never written."""
        with span("pf.sir.run"):
            zs = self._obs(zs)
            T = zs.shape[0]
            self._check(state, zs[0])
            seeds = self._draw_seeds(generator, T)
            xs = torch.empty((2, self.nx, self.n), device=self.device)
            lws = torch.empty((2, self.n), device=self.device)
            rows = torch.empty((T, row_width(self.nx)), device=self.device)
            triggers, oks = [], []
            for t, seed in enumerate(seeds):
                state, trig, ok = self._step_core(seed, generator, state, zs[t], rows[t],
                                                  xs[t % 2], lws[t % 2])
                triggers.append(trig)
                oks.append(ok)
            particles, logw, off_u = state
            return (particles, logw, off_u.clone()), self._hist_dict(rows, triggers, oks)
