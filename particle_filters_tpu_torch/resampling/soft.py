"""Soft (Gumbel-mixture) differentiable resampling (PyTorch port of
``particle_filters_tpu/resampling/soft.py``).

Mixture proposal q = (1−α)w + α/N, a Gumbel-Softmax over ancestors for every
new particle, the barycentric projection x'ᵢ = Σⱼ aᵢⱼ xⱼ, uniform output
weights, and the assignment-entropy diagnostics. Differentiable by autograd
(the Gumbel noise is reparameterized). Operates on the last two axes, so a
leading batch is one call.

The noise is kept apart from the assignment: :func:`gumbel_softmax` and
:func:`soft_resample` take the Gumbel draws as a tensor (``gumbel=``) and
draw them from ``generator`` only when it is None.
"""

from __future__ import annotations

import math

import torch


def log_normalize_lastaxis(logw: torch.Tensor):
    """Stable log-normalize along the last axis: ``(logw_norm, log_z)``
    (the batched variant of ``core.weights.log_normalize``)."""
    m = torch.amax(logw, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    log_z = m + torch.log(torch.sum(torch.exp(logw - m), dim=-1, keepdim=True))
    return logw - log_z, log_z[..., 0]


def sample_gumbel(generator, shape, dtype=torch.float32, eps: float = 1e-20,
                  device=None) -> torch.Tensor:
    """i.i.d. Gumbel(0, 1). The uniforms lie on [eps, 1 − eps), as the JAX
    package draws them: ``torch.rand`` can return 0, where −log(−log u)
    would be −inf, so u is mapped and clamped to that interval."""
    device = generator.device if device is None else device
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    u = torch.clamp(u * ((1.0 - eps) - eps) + eps, min=eps)
    return -torch.log(-torch.log(u))


def gumbel_softmax(generator, log_probs: torch.Tensor, temperature: float,
                   gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Gumbel-Softmax relaxation along the last axis; ``gumbel`` (the shape
    of ``log_probs``) is drawn from ``generator`` when None."""
    if gumbel is None:
        gumbel = sample_gumbel(generator, log_probs.shape, log_probs.dtype,
                               device=log_probs.device)
    return torch.softmax((log_probs + gumbel) / temperature, dim=-1)


def assignment_entropy(assignment: torch.Tensor) -> torch.Tensor:
    """−Σⱼ aᵢⱼ log aᵢⱼ for every new particle i."""
    return -torch.sum(assignment * torch.log(assignment + 1e-10), dim=-1)


def soft_resample(
    generator,
    particles: torch.Tensor,
    log_weights: torch.Tensor,
    *,
    alpha: float = 0.5,
    temperature: float = 0.5,
    return_aux: bool = False,
    gumbel: torch.Tensor | None = None,
):
    """Soft resampling: ``(generator, particles (..., N, d), logw (..., N))
    → (new_particles, uniform logw[, aux])``.

    ``alpha`` mixes toward uniform (α=0: pure weights; α=1: pure uniform);
    ``temperature`` sets the Gumbel-Softmax hardness; ``gumbel`` (..., N, N)
    are the draws, one per (new, ancestor) pair, taken from ``generator``
    when None.
    """
    n = particles.shape[-2]
    logw_n, _ = log_normalize_lastaxis(log_weights)
    w = torch.exp(logw_n)
    probs = (1.0 - alpha) * w + alpha / n
    log_probs = torch.log(probs + 1e-20)
    # Every new particle shares the base distribution; the Gumbel noise is
    # independent per (new, ancestor) pair.
    tiled = log_probs.unsqueeze(-2).expand(log_probs.shape[:-1] + (n, n))
    assignment = gumbel_softmax(generator, tiled, temperature, gumbel)
    new_particles = assignment @ particles
    new_logw = torch.full_like(log_weights, -math.log(n))
    if not return_aux:
        return new_particles, new_logw
    ent = assignment_entropy(assignment)
    aux = {
        "assignment": assignment,
        "assignment_entropy_mean": torch.mean(ent),
        "assignment_entropy_std": torch.std(ent, unbiased=False),
        "max_weight_before": torch.amax(w, dim=-1),
    }
    return new_particles, new_logw, aux
