"""Log-domain particle-weight arithmetic (PyTorch port of
``particle_filters_tpu/core/weights.py``).

Same definitions as the JAX module: max-subtracted log-normalization with
the all −inf guard, ESS = 1/Σw², weighted population moments. The mesh
``axis_name`` argument is not ported yet; the multi-device layer brings a
process-group argument instead.
"""

from __future__ import annotations

import math

import torch


def log_normalize(logw: torch.Tensor):
    """Normalize log-weights stably: returns ``(logw_norm, log_z)``.

    ``logw_norm`` satisfies ``logsumexp(logw_norm) == 0``; ``log_z`` is the
    log-normalizer ``logsumexp(logw)`` (the incremental evidence term).
    """
    m = torch.max(logw)
    # Guard fully-degenerate input (all -inf): clamp the max and floor the
    # sum so log_z stays finite and logw_norm stays -inf (not NaN).
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.sum(torch.exp(logw - m))
    log_z = m + torch.log(torch.clamp(s, min=1e-30))
    return logw - log_z, log_z


def ess_from_logw(logw: torch.Tensor) -> torch.Tensor:
    """Effective sample size 1/Σwᵢ² from (possibly unnormalized) log-weights."""
    logw_n, _ = log_normalize(logw)
    w = torch.exp(logw_n)
    return 1.0 / torch.clamp(torch.sum(w * w), min=1e-30)


def effective_sample_size(w: torch.Tensor) -> torch.Tensor:
    """ESS = (Σw)²/Σw² for linear-domain weights (need not be normalized)."""
    s1 = torch.sum(w)
    s2 = torch.sum(w * w)
    return (s1 * s1) / torch.clamp(s2, min=1e-30)


def weight_entropy(logw: torch.Tensor) -> torch.Tensor:
    """Shannon entropy −Σ wᵢ log wᵢ of normalized weights (in nats)."""
    logw_n, _ = log_normalize(logw)
    w = torch.exp(logw_n)
    return -torch.sum(torch.where(w > 0, w * logw_n, torch.zeros_like(w)))


def weighted_mean_cov(particles: torch.Tensor, logw: torch.Tensor):
    """Weighted mean and population covariance of an (N, d) particle cloud.

    The contractions are matmuls; on a CUDA tensor they run in full f32 only
    with TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``), which
    the caller sets — the package sets no global flags.
    """
    logw_n, _ = log_normalize(logw)
    w = torch.exp(logw_n)  # (N,)
    mean = w @ particles  # (d,)
    centered = particles - mean
    cov = (centered * w[:, None]).T @ centered
    return mean, cov


def weighted_mean(particles: torch.Tensor, logw: torch.Tensor) -> torch.Tensor:
    logw_n, _ = log_normalize(logw)
    return torch.exp(logw_n) @ particles


def uniform_logw(
    n: int, dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """Normalized uniform log-weights: full(−log N)."""
    return torch.full((n,), -math.log(n), dtype=dtype, device=device)
