"""Entropy-regularized optimal-transport (Sinkhorn) differentiable
resampling (PyTorch port of ``particle_filters_tpu/resampling/ot.py``).

Squared-Euclidean cost, damped dual c-transform updates
f ← (1−δ)f + δ·τ_ε(b, g, C), the transport plan P = a bᵀ ⊙ exp((f⊕g−C)/ε),
the barycentric projection x'ⱼ = (Pᵀx)ⱼ / bⱼ, uniform output weights, and the
OT-distance / sparsity / dual diagnostics. Each half-update is one
logsumexp over the whole cost matrix; the ``n_iters`` iterations are
unrolled (a Python loop), so autograd differentiates through them.

Two paths, chosen by what the call shows:

- a float32 cloud (N, d ≤ 4) on the card, unbatched (not under
  ``torch.func`` transforms), with ε and the damping Python numbers, takes
  the tile kernels of ``ops/sinkhorn_tile.py``: the cost is formed in
  registers, the dual loop is one library call (2·``n_iters`` launches) and
  the projection one launch, and no N × N tensor exists (but for the
  diagnostics). Where autograd must differentiate the cloud or the weights,
  the same launches also keep f and g after every iteration and each
  half-update's normalizer (N-long vectors, ``_TileSinkhorn``), and the
  backward is the tile VJP: the gradient of the unrolled loop, through all
  ``n_iters`` iterations and the projection, in one more library call
  (4·``n_iters`` + 2 launches), again with nothing N × N; it is once
  differentiable (a second derivative through it raises);
- every other call (CPU tensors, float64, the vmapped (ε × damping) sweep of
  ``examples/ex08_dpf_ot_tuning.py``, ``torch.func`` transforms) takes the
  unrolled torch ops below, which autograd differentiates as they run.

Program spans (``utils/timing.py::span``, built only while a profiler
records): ``pf.ot.sinkhorn`` around the dual loop, ``pf.ot.project`` around
the plan and the barycentric projection, on both paths; ``pf.ot.vjp``
around each tile resample's backward (on the card it runs on autograd's
device thread, not the caller's). Counters, across calls:
``sinkhorn_ot_resample.half_updates`` (2·``n_iters`` a call, either path)
and ``sinkhorn_ot_resample.vjp_half_updates`` (2·``n_iters`` a tile
backward).

On the torch path the cost comes from an x·yᵀ product, and (f⊕g−C)/ε at
ε = 0.01 multiplies any error in C by 100: on the card it must be formed
with TF32 off, which the caller sets
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import math

import torch
from torch._C._functorch import is_functorch_wrapped_tensor

from particle_filters_tpu_torch.core.weights import uniform_logw
from particle_filters_tpu_torch.ops.sinkhorn_tile import (
    MAX_D,
    sinkhorn_tile,
    sinkhorn_tile_vjp,
    tile_projection,
)
from particle_filters_tpu_torch.resampling.soft import log_normalize_lastaxis
from particle_filters_tpu_torch.utils.timing import span


def pairwise_squared_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C[i, j] = ‖x_i − y_j‖² by the (x² − 2xy + y²) expansion, one matmul,
    clamped at 0."""
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)  # (N, 1)
    y_sq = torch.sum(y * y, dim=-1, keepdim=True)  # (M, 1)
    xy = x @ y.T
    return torch.clamp(x_sq - 2.0 * xy + y_sq.T, min=0.0)


def sinkhorn_ot_resample(
    particles: torch.Tensor,
    weights: torch.Tensor,
    *,
    epsilon: float = 0.1,
    n_iters: int = 50,
    min_val: float = 1e-12,
    tol: float = 1e-6,
    damping: float = 0.5,
    return_diagnostics: bool = False,
):
    """Sinkhorn-OT resample of an (N, d) cloud with linear weights (N,).

    Returns ``(new_particles, new_weights)`` with uniform ``new_weights``,
    optionally plus a diagnostics dict. All ``n_iters`` damped iterations
    run (no data-dependent early exit); convergence is reported by the last
    dual change, ``converged`` = that change below ``tol``.
    ``sinkhorn_ot_resample.half_updates`` counts the half-updates run (two
    an iteration), across calls.
    """
    w = torch.clamp(weights, min=min_val)
    a = w / (torch.sum(w) + min_val)  # source mass
    log_a = torch.log(a)
    resample = _tile_resample if _on_tiles(particles, weights, epsilon, damping) else \
        _torch_resample
    return resample(particles.contiguous(), log_a, epsilon=epsilon, n_iters=n_iters, tol=tol,
                    damping=damping, return_diagnostics=return_diagnostics)


sinkhorn_ot_resample.half_updates = 0
sinkhorn_ot_resample.vjp_half_updates = 0


def _torch_resample(particles, log_a, *, epsilon, n_iters, tol, damping, return_diagnostics):
    """:func:`sinkhorn_ot_resample` in unrolled torch ops from the log source
    masses, which autograd differentiates as they run."""
    n = particles.shape[0]
    dtype = particles.dtype
    log_b = torch.full((n,), -math.log(n), dtype=dtype, device=particles.device)

    C = pairwise_squared_distances(particles, particles)

    def tau_f(g):
        # τ_i = −ε logsumexp_j (log b_j + (g_j − C_ij)/ε)
        return -epsilon * torch.logsumexp(log_b[None, :] + (g[None, :] - C) / epsilon, dim=1)

    def tau_g(f):
        return -epsilon * torch.logsumexp(log_a[:, None] + (f[:, None] - C) / epsilon, dim=0)

    f = torch.zeros((n,), dtype=dtype, device=particles.device)
    g = torch.zeros_like(f)
    deltas = []
    with span("pf.ot.sinkhorn"):
        for _ in range(n_iters):
            f_new = (1.0 - damping) * f + damping * tau_f(g)
            g_new = (1.0 - damping) * g + damping * tau_g(f_new)
            sinkhorn_ot_resample.half_updates += 2
            if return_diagnostics:
                deltas.append(torch.maximum(torch.amax(torch.abs(f_new - f)),
                                            torch.amax(torch.abs(g_new - g))))
            f, g = f_new, g_new

    with span("pf.ot.project"):  # transport plan and barycentric projection
        log_P = log_a[:, None] + log_b[None, :] + (f[:, None] + g[None, :] - C) / epsilon
        P = torch.exp(log_P)
        new_particles = (P.T @ particles) * n  # ÷ b_j with b_j = 1/N
        new_weights = torch.exp(log_b)

    if not return_diagnostics:
        return new_particles, new_weights

    return new_particles, new_weights, _diagnostics(torch.stack(deltas), P, C, f, g, epsilon,
                                                    tol)


def _diagnostics(history, P, C, f, g, epsilon, tol) -> dict:
    return {
        "final_delta": history[-1],
        "converged": history[-1] < tol,
        "convergence_history": history,
        "ot_distance": torch.sum(P * C),
        "transport_plan_sparsity": torch.mean((P > 1e-6).to(P.dtype)),
        "dual_variables": {
            "f_mean": torch.mean(f),
            "f_std": torch.std(f, unbiased=False),
            "g_mean": torch.mean(g),
            "g_std": torch.std(g, unbiased=False),
        },
        "epsilon": epsilon,
    }


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _on_tiles(particles, weights, epsilon, damping) -> bool:
    """Whether a call takes the tile kernels (the module docstring's
    conditions), with or without a gradient."""
    return (_on_card(particles) and particles.ndim == 2
            and particles.dtype == weights.dtype == torch.float32
            and 1 <= particles.shape[1] <= MAX_D
            and isinstance(epsilon, (int, float)) and isinstance(damping, (int, float))
            and not is_functorch_wrapped_tensor(particles)
            and not is_functorch_wrapped_tensor(weights))


def _tile_loop(particles, log_a, log_b, *, epsilon, n_iters, damping, deltas, saved=None):
    """The dual loop and the projection on the tile kernels, under their
    spans: ``(new_particles, new_weights, f, g, history)``."""
    with span("pf.ot.sinkhorn"):
        f, g, history = sinkhorn_tile(particles, log_a, log_b, epsilon=epsilon,
                                      n_iters=n_iters, damping=damping, deltas=deltas,
                                      saved=saved)
        sinkhorn_ot_resample.half_updates += 2 * n_iters
    with span("pf.ot.project"):
        new_particles = tile_projection(particles, log_a, f, g, epsilon=epsilon)
        new_weights = torch.exp(log_b)
    return new_particles, new_weights, f, g, history


class _TileSinkhorn(torch.autograd.Function):
    """The tile path where autograd differentiates the cloud or log a: the
    forward's launches keep f and g after every iteration and each
    half-update's k·τ ((n_iters + 1) × 2 and n_iters × 2 N-long vectors),
    and the backward is :func:`sinkhorn_tile_vjp` under ``pf.ot.vjp``: the
    gradient for the cloud and log a of the unrolled loop and projection.
    With ``deltas`` (the diagnostics) f, g and the history are outputs
    without a gradient, else None. The backward's kernels build no graph, so
    a backward asked to build one (``create_graph``, a second derivative)
    raises rather than leave the resampler's share out; the torch ops' path,
    off the card, gives one. (``once_differentiable`` would not do: under
    ``torch.autograd.grad`` its error node lies off the path to the inputs,
    never runs, and the share drops out silently.)"""

    @staticmethod
    def forward(ctx, particles, log_a, log_b, epsilon, n_iters, damping, deltas):
        n = particles.shape[0]
        saved = (log_a.new_empty((n_iters + 1, 2, n)), log_a.new_empty((n_iters, 2, n)))
        new_particles, _, f, g, history = _tile_loop(particles, log_a, log_b, epsilon=epsilon,
                                                     n_iters=n_iters, damping=damping,
                                                     deltas=deltas, saved=saved)
        ctx.save_for_backward(particles, log_a, log_b, *saved, new_particles)
        ctx.opts = (epsilon, damping)
        if not deltas:
            return new_particles, None, None, None
        f, g = f.clone(), g.clone()
        ctx.mark_non_differentiable(f, g, history)
        return new_particles, f, g, history

    @staticmethod
    def backward(ctx, grad_particles, *_):
        if torch.is_grad_enabled():  # autograd's create_graph
            raise RuntimeError("the Sinkhorn tile backward is once differentiable: no second "
                               "derivative through it (the torch ops' path, on the CPU or in "
                               "float64, gives one).")
        particles, log_a, log_b, pots, lse, new_particles = ctx.saved_tensors
        epsilon, damping = ctx.opts
        with span("pf.ot.vjp"):
            grad_x, grad_log_a = sinkhorn_tile_vjp(
                particles, log_a, log_b, (pots, lse), new_particles,
                grad_particles.contiguous(), epsilon=epsilon, damping=damping)
            sinkhorn_ot_resample.vjp_half_updates += 2 * lse.shape[0]
        return grad_x, grad_log_a, None, None, None, None, None


def _tile_resample(particles, log_a, *, epsilon, n_iters, tol, damping, return_diagnostics):
    """:func:`sinkhorn_ot_resample` on the tile kernels: the dual loop in one
    library call, then the projection (through :class:`_TileSinkhorn` where
    a gradient is needed); with ``return_diagnostics`` the plan and the cost
    are formed from the potentials for the diagnostics alone."""
    log_b = torch.full_like(log_a, -math.log(particles.shape[0]))
    kw = dict(epsilon=epsilon, n_iters=n_iters, damping=damping, deltas=return_diagnostics)
    if torch.is_grad_enabled() and (particles.requires_grad or log_a.requires_grad):
        new_particles, f, g, history = _TileSinkhorn.apply(particles, log_a, log_b, *kw.values())
        new_weights = torch.exp(log_b)
    else:
        new_particles, new_weights, f, g, history = _tile_loop(particles, log_a, log_b, **kw)
    if not return_diagnostics:
        return new_particles, new_weights
    C = pairwise_squared_distances(particles, particles)
    P = torch.exp(log_a[:, None] + log_b[None, :] + (f[:, None] + g[None, :] - C) / epsilon)
    return new_particles, new_weights, _diagnostics(history, P, C, f, g, epsilon, tol)


def ot_resample(
    generator,
    particles: torch.Tensor,
    log_weights: torch.Tensor,
    *,
    epsilon: float = 0.1,
    n_iters: int = 50,
    damping: float = 0.5,
    return_aux: bool = False,
):
    """The shared resampler interface: ``(generator, particles, logw) →
    (new_particles, uniform logw[, aux])``. The generator is unused (OT
    resampling is deterministic given the cloud) and kept for uniformity."""
    del generator
    logw_n, _ = log_normalize_lastaxis(log_weights)
    out = sinkhorn_ot_resample(
        particles, torch.exp(logw_n), epsilon=epsilon, n_iters=n_iters,
        damping=damping, return_diagnostics=return_aux,
    )
    new_logw = uniform_logw(particles.shape[-2], log_weights.dtype, log_weights.device)
    if return_aux:
        return out[0], new_logw, out[2]
    return out[0], new_logw
