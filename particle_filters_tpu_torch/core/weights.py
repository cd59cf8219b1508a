"""Log-domain particle-weight arithmetic (PyTorch port of
``particle_filters_tpu/core/weights.py``).

Same definitions as the JAX module: max-subtracted log-normalization with
the all −inf guard, ESS = 1/Σw², weighted population moments. The JAX
package's mesh ``axis_name`` is a ``torch.distributed`` process group here:
with ``group`` the max and the sums are taken over every rank's slice
(``core/comm.py``: the max by ``all_reduce(MAX)``, a sum by an
``all_gather`` added in rank order, the same bits on every rank), so each
rank holds its slice of globally normalized weights and the global moments.
"""

from __future__ import annotations

import math

import torch

from particle_filters_tpu_torch.core import comm


def log_normalize(logw: torch.Tensor, group=None):
    """Normalize log-weights stably: returns ``(logw_norm, log_z)``.

    ``logw_norm`` satisfies ``logsumexp(logw_norm) == 0``; ``log_z`` is the
    log-normalizer ``logsumexp(logw)`` (the incremental evidence term), over
    every rank's slice with ``group``.
    """
    m = comm.pmax(torch.max(logw), group)
    # Guard fully-degenerate input (all -inf): clamp the max and floor the
    # sum so log_z stays finite and logw_norm stays -inf (not NaN).
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = comm.psum(torch.sum(torch.exp(logw - m)), group)
    log_z = m + torch.log(torch.clamp(s, min=1e-30))
    return logw - log_z, log_z


def ess_from_logw(logw: torch.Tensor, group=None) -> torch.Tensor:
    """Effective sample size 1/Σwᵢ² from (possibly unnormalized) log-weights."""
    logw_n, _ = log_normalize(logw, group)
    w = torch.exp(logw_n)
    return 1.0 / torch.clamp(comm.psum(torch.sum(w * w), group), min=1e-30)


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


def weighted_mean_cov(particles: torch.Tensor, logw: torch.Tensor, group=None):
    """Weighted mean and population covariance of an (N, d) particle cloud.

    The contractions are matmuls; on a CUDA tensor they run in full f32 only
    with TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``), which
    the caller sets — the package sets no global flags.
    """
    logw_n, _ = log_normalize(logw, group)
    w = torch.exp(logw_n)  # (N,)
    mean = comm.psum(w @ particles, group)  # (d,)
    centered = particles - mean
    cov = comm.psum((centered * w[:, None]).T @ centered, group)
    return mean, cov


def weighted_mean(particles: torch.Tensor, logw: torch.Tensor, group=None) -> torch.Tensor:
    logw_n, _ = log_normalize(logw, group)
    return comm.psum(torch.exp(logw_n) @ particles, group)


def uniform_logw(
    n: int, dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """Normalized uniform log-weights: full(−log N)."""
    return torch.full((n,), -math.log(n), dtype=dtype, device=device)
