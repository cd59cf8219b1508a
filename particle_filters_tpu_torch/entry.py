"""The entry points of ``__graft_entry__.py`` on the port.

    python -m particle_filters_tpu_torch.entry [--device cpu]

- :func:`entry`: ``(step_fn, example_args)`` for one step of the main
  path, ``FusedSIRFilter.step`` at N = 2²⁰ on the stochastic-volatility
  model (α 0.95, σ 0.2, β 1, resampling at ESS < N/2): kernel B1, and B2
  when the step resamples. The JAX ``entry()`` falls back to the general
  filter off the TPU; this one does not. On the CPU (``device="cpu"``) the
  same filter runs B1's plain version; without a card the default raises.
- :func:`entry_generic`: one step of the general ``ParticleFilter`` at
  N = 65536 on the same model, a function of its own, never a fallback.
- :func:`dryrun_multichip`: the JAX dry run's four phases on an
  ``(n_batch, n / n_batch)`` mesh of ``n`` ranks started by
  ``parallel.launch.run_ranks`` (NCCL, one rank a card, on ``"cuda"``;
  gloo on ``"cpu"``): (a) one sharded differentiable-PF SGD step, (b) the
  general SIR filter in neighbour mode resampling every step, (c) the
  sharded fused filter (B1 and B2) resampling every step in all-gather
  mode, (d) the sharded EDH flow with 3 λ-steps. Sizes are the JAX dry
  run's: B = 2·n_batch sequences, N = 16·n_particles, T = 4.

The module's main runs ``entry()``'s step, then the dry run over the
visible cards (``--device cpu``: over 8 gloo ranks, as the JAX script runs
it over 8 devices).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.distributed as dist

from particle_filters_tpu_torch.core.linalg import mvn_logpdf_chol
from particle_filters_tpu_torch.models import (
    EDHConfig,
    EDHFlowPF,
    ExtendedKalmanFilter,
    GaussianTracker,
    ParticleFilter,
)
from particle_filters_tpu_torch.ops import resample as b2
from particle_filters_tpu_torch.ops.fused_pf import FusedSIRFilter, SVModel, fused_step
from particle_filters_tpu_torch.parallel import (
    make_mesh,
    make_sharded_dpf_train_step,
    make_sharded_flow_run,
    make_sharded_fused_init,
    make_sharded_fused_pf,
    make_sharded_fused_run,
    make_sharded_pf_run,
)
from particle_filters_tpu_torch.parallel.launch import run_ranks
from particle_filters_tpu_torch.utils.timing import resolve_device

ALPHA, SIGMA, BETA = 0.95, 0.2, 1.0
N_ENTRY, N_GENERIC = 1 << 20, 65536
Z0 = 0.3
GENERIC_VAR0 = 0.41  # __graft_entry__.entry_generic's prior variance
# The dry run's DPF model and its starting parameters (``__graft_entry__.py:186``).
DRY_ALPHA0, DRY_SIGMA0, DRY_T = 0.9, 0.25, 4
DRY_SEED = 0  # the seed of the dry run's data and generators
DRY_TIMEOUT_S = 600.0


def _example_args(device, state0):
    return (torch.Generator(device=device).manual_seed(1), state0,
            torch.tensor([Z0], device=device))


def entry(device="cuda"):
    """``(step_fn, example_args)``: one ``FusedSIRFilter.step`` at N = 2²⁰
    on the SV model from the stationary prior N(0, σ²/(1 − α²)) drawn from
    seed 0; ``example_args`` = (a generator seeded 1, the state, z = [0.3])."""
    device = resolve_device(device)
    pf = FusedSIRFilter(SVModel(ALPHA, BETA), [[SIGMA**2]], Np=N_ENTRY, resample_thresh=0.5,
                        device=device)
    state0 = pf.initialize(torch.Generator(device=device).manual_seed(0), [0.0],
                           [[SIGMA**2 / (1 - ALPHA**2)]])
    return pf.step, _example_args(device, state0)


def sv_pf(n: int, device, **kw) -> ParticleFilter:
    """The general SIR filter on the SV model (α 0.95, σ 0.2, β 1):
    ``__graft_entry__._make_sv_pf``."""
    def obs_loglik(x, z):
        var = BETA**2 * torch.exp(x[0])
        return -0.5 * (z[0] ** 2 / var + torch.log(var))

    return ParticleFilter(lambda x, u: ALPHA * x, None, Q=[[SIGMA**2]], R=None, Np=n,
                          obs_loglik=obs_loglik, device=device, **kw)


def entry_generic(device="cuda"):
    """``(step_fn, example_args)``: one general ``ParticleFilter`` step
    (predict, weight, resample, moments) at N = 65536 on the SV model from
    N(0, 0.41) drawn from seed 0; ``example_args`` as :func:`entry`'s."""
    device = resolve_device(device)
    pf = sv_pf(N_GENERIC, device)
    state0 = pf.initialize(torch.Generator(device=device).manual_seed(0), [0.0],
                           [[GENERIC_VAR0]])
    return pf.step, _example_args(device, state0)


# --- the dry run -------------------------------------------------------------------
def dpf_parts():
    """The dry run's SV model for the DPF step: (transition_fn,
    obs_loglik_fn, init_fn, loss_fn)."""
    def transition_fn(params, eps, particles):
        return params["alpha"] * particles + torch.exp(params["log_sigma"]) * eps

    def obs_loglik_fn(params, particles, y):
        var = BETA**2 * torch.exp(particles[:, 0])
        return -0.5 * (y[0] ** 2 / var + torch.log(var))

    def init_fn(params, eps):
        return torch.exp(params["log_sigma"]) * eps

    def loss_fn(means, truth):
        return torch.mean((means - truth) ** 2)

    return transition_fn, obs_loglik_fn, init_fn, loss_fn


def _edh(n_particles: int, group, device) -> EDHFlowPF:
    """EDH on the dry run's 2-D linear system with an EKF tracker."""
    A = torch.tensor([[0.9, 0.1], [0.0, 0.8]], device=device)
    C = torch.eye(2, device=device)
    Q, R = 0.04 * torch.eye(2, device=device), 0.25 * torch.eye(2, device=device)
    LQ = torch.linalg.cholesky(Q + 1e-10 * torch.eye(2, device=device))
    LR = torch.linalg.cholesky(R)
    h = lambda x: C @ x  # noqa: E731
    tracker = GaussianTracker(ExtendedKalmanFilter(lambda x, u: A @ x, h, Q, R, device=device))
    return EDHFlowPF(tracker, lambda x, u, v: A @ x + v, h, lambda x: C,
                     lambda xn, xo: mvn_logpdf_chol(xn, A @ xo, LQ),
                     lambda z, x: mvn_logpdf_chol(z, h(x), LR), R,
                     EDHConfig(n_particles=n_particles, n_lambda_steps=3), device=device,
                     group=group)


def dryrun_rank(n_batch: int, seed: int, layout=None, device_type: str = "cpu"):
    """One rank of the dry run, on this world's ``(n_batch, S / n_batch)``
    mesh at the sizes of a ``layout`` = (batch, particles) mesh (this
    world's when None): the DPF step's ``loss`` and new ``alpha``, the
    histories ``pf``, ``fused`` and ``edh`` of phases (b)-(d), and
    ``launches``, B1's and B2's counts over phase (c)'s run (set to 0 just
    before it, read just after; kernels run only on a card)."""
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    mesh = make_mesh(n_batch, device_type=device_type)
    world = dist.get_world_size()
    layout = (n_batch, world // n_batch) if layout is None else layout
    B, N, T = 2 * layout[0], 16 * layout[1], DRY_T
    n_all = layout[0] * layout[1]
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, T, 1)).astype(np.float32)
    ys = (BETA * np.exp(0.5 * xs) * rng.standard_normal((B, T, 1))).astype(np.float32)
    xs, ys = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)

    def gen(k):
        return torch.Generator(device=device).manual_seed(seed + k)

    tr, ll, init, loss_fn = dpf_parts()
    step = make_sharded_dpf_train_step(mesh, n_particles=N, dim=1, transition_fn=tr,
                                       obs_loglik_fn=ll, init_fn=init, loss_fn=loss_fn)
    params = {"alpha": torch.tensor(DRY_ALPHA0, device=device),
              "log_sigma": torch.tensor(math.log(DRY_SIGMA0), device=device)}
    loss, new = step(params, gen(0), ys, xs)

    g = dist.group.WORLD
    pf = sv_pf(16 * n_all, device, group=g, distributed_resample="neighbor",
               neighbor_radius=2, resample_thresh=2.0)
    g7 = gen(7)
    _, hist = make_sharded_pf_run(pf)(g7, pf.initialize(g7, [0.0], [[0.41]]), ys[0])

    fpf = make_sharded_fused_pf(SVModel(0.9, BETA), [[0.04]], Np=64 * n_all, mesh=g,
                                resample_thresh=2.0, device=device)
    g11 = gen(11)
    st = make_sharded_fused_init(fpf)(g11, [0.0], [[0.25]])
    fused_step.launches = 0
    b2.resample_by_starts.launches = 0
    _, fh = make_sharded_fused_run(fpf)(g11, st, ys[0])
    launches = {"B1": fused_step.launches, "B2": b2.resample_by_starts.launches}

    edh = _edh(16 * n_all, g, device)
    g21 = gen(21)
    st = edh.init_from_gaussian(g21, torch.zeros(2), torch.eye(2))
    ts = edh.tracker.init(torch.zeros(2), torch.eye(2))
    zs = torch.from_numpy(rng.standard_normal((T, 2)).astype(np.float32)).to(device)
    _, _, eh = make_sharded_flow_run(edh)(g21, st, ts, zs)
    return {"loss": loss, "alpha": new["alpha"], "pf": hist, "fused": fh, "edh": eh,
            "launches": launches}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def check_dry_run(r) -> None:
    """The JAX dry run's assertions on one rank's result (numpy)."""
    _check(np.isfinite(r["loss"]), f"training step loss {r['loss']} is not finite")
    _check(np.isfinite(r["alpha"]) and float(r["alpha"]) != DRY_ALPHA0,
           f"alpha {r['alpha']} did not move from {DRY_ALPHA0}")
    _check(np.all(np.isfinite(r["pf"]["mean"])), "the neighbour-mode SIR run is not finite")
    _check(bool(np.all(r["pf"]["exchange_ok"])),
           "the neighbour-exchange pool was insufficient at radius 2")
    _check(bool(np.all(r["pf"]["resampled"])), "the forced neighbour resample did not run")
    _check(np.all(np.isfinite(r["fused"]["mean"])), "the sharded fused run is not finite")
    _check(bool(np.all(r["fused"]["resampled"])),
           "the forced cross-rank resample did not trigger")
    _check(np.all(np.isfinite(r["edh"]["mean"])), "the sharded EDH run is not finite")


def dryrun_multichip(n: int, device="cuda") -> dict:
    """The four phases on ``n`` ranks (module docstring); every rank's
    result is checked as the JAX dry run asserts, the JAX line is printed,
    and rank 0's result is returned (numpy; ``launches`` is its phase (c)
    count). On ``"cuda"`` it needs ``n`` visible cards."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}) needs {n} cards, "
                           f"{torch.cuda.device_count()} are visible.")
    n_batch = 2 if n % 2 == 0 and n >= 2 else 1
    n_part = n // n_batch
    ranks = run_ranks(dryrun_rank, n, backend="nccl" if device.type == "cuda" else "gloo",
                      timeout_s=DRY_TIMEOUT_S, args=(n_batch, DRY_SEED, None, device.type))
    for r in ranks:
        check_dry_run(r)
    r = ranks[0]
    print(f"dryrun_multichip({n}): mesh={dict(batch=n_batch, particles=n_part)}, "
          f"loss={float(r['loss']):.4f}, alpha {DRY_ALPHA0} -> {float(r['alpha']):.4f}, "
          f"neighbor-exchange resample ok over {r['pf']['mean'].shape[0]} steps, "
          f"sharded fused path ok over {r['fused']['mean'].shape[0]} steps, "
          f"sharded EDH flow ok over {r['edh']['mean'].shape[0]} steps")
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    step_fn, example_args = entry(device)
    _, info = step_fn(*example_args)
    print(f"entry() ok: mean {tuple(info['mean'].shape)}, ess {float(info['ess']):.1f}, "
          f"resampled {bool(info['resampled'])}")
    dryrun_multichip(torch.cuda.device_count() if device.type == "cuda" else 8, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
