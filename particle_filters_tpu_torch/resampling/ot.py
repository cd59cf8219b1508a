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
  ``torch.func`` transforms), with ε and the damping Python numbers and no
  input that autograd must differentiate, takes the tile kernels of
  ``ops/sinkhorn_tile.py``: the cost is formed in registers, the dual loop
  is one library call (2·``n_iters`` launches) and the projection one
  launch, and no N × N tensor exists (but for the diagnostics);
- every other call (CPU tensors, the gradient, the vmapped (ε × damping)
  sweep of ``examples/ex08_dpf_ot_tuning.py``) takes the unrolled torch ops
  below.

Program spans (``utils/timing.py::span``, built only while a profiler
records): ``pf.ot.sinkhorn`` around the dual loop, ``pf.ot.project`` around
the plan and the barycentric projection, on both paths.

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
from particle_filters_tpu_torch.ops.sinkhorn_tile import MAX_D, sinkhorn_tile, tile_projection
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
    n = particles.shape[0]
    dtype = particles.dtype

    w = torch.clamp(weights, min=min_val)
    a = w / (torch.sum(w) + min_val)  # source mass
    log_a = torch.log(a)
    if _on_tiles(particles, weights, epsilon, damping):
        return _tile_resample(particles.contiguous(), log_a, epsilon=epsilon, n_iters=n_iters,
                              tol=tol, damping=damping, return_diagnostics=return_diagnostics)
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


sinkhorn_ot_resample.half_updates = 0


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
    conditions)."""
    return (_on_card(particles) and particles.ndim == 2
            and particles.dtype == weights.dtype == torch.float32
            and 1 <= particles.shape[1] <= MAX_D
            and isinstance(epsilon, (int, float)) and isinstance(damping, (int, float))
            and not is_functorch_wrapped_tensor(particles)
            and not is_functorch_wrapped_tensor(weights)
            and not (torch.is_grad_enabled()
                     and (particles.requires_grad or weights.requires_grad)))


def _tile_resample(particles, log_a, *, epsilon, n_iters, tol, damping, return_diagnostics):
    """:func:`sinkhorn_ot_resample` on the tile kernels: the dual loop in one
    library call, then the projection; with ``return_diagnostics`` the plan
    and the cost are formed from the potentials for the diagnostics alone."""
    log_b = torch.full_like(log_a, -math.log(particles.shape[0]))
    with span("pf.ot.sinkhorn"):
        f, g, history = sinkhorn_tile(particles, log_a, log_b, epsilon=epsilon,
                                      n_iters=n_iters, damping=damping,
                                      deltas=return_diagnostics)
        sinkhorn_ot_resample.half_updates += 2 * n_iters
    with span("pf.ot.project"):
        new_particles = tile_projection(particles, log_a, f, g, epsilon=epsilon)
        new_weights = torch.exp(log_b)
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
