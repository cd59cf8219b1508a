"""Hard (index-producing) resampling: systematic, multinomial, stratified,
residual (PyTorch port of ``particle_filters_tpu/resampling/hard.py``).

One inverse-CDF convention, :func:`_child_run_ends`, defines systematic
ancestry for the index, count and value paths alike: the run ends and
starts of ``ops/systematic_starts.py``, from a cdf summed in f64, rounded
once to f32 and kept nondecreasing. A CPU tensor takes the blocked cumsum
of ``core/block_cumsum.py`` with a running maximum (``_cdf``); a CUDA
tensor kernel S, which sums in another fixed order. Both give the same
bits on every run, where ``torch.cumsum`` of a CUDA float tensor does not.
Their sums are not the JAX package's (``blocked_cumsum`` there adds in
another order, in f32), nor each other's, so run ends can differ by ±1 at
rare ceil boundaries; on a shared cdf and u they are integer-equal. Below
2²⁴ the card's systematic paths take float32 weights, as every filter of
the port holds them; weights of another dtype on the card raise
``TypeError`` (a CPU tensor of any float dtype takes the plain chain).

Past max(N, M) = 2²⁴ the run ends come from the exact quantized-integer
convention of ``resampling/exact.py``, bit-identical to the JAX package's.

All functions take normalized linear weights ``w`` or log-weights ``logw``
and draw their uniforms from the caller's ``torch.Generator``, which must
live on the weights' device. :func:`systematic_resample_values_batched`
resamples many independent clouds (trials) in one launch of kernel B2.

A caller that holds the log-normalizer of its log-weights already (the
fused SIR filter: kernel B1's log Z) passes it as ``log_z`` beside ``logw``
to the values resample: below 2²⁴ kernel S then reads the log-weights
themselves (its log-domain input), and the normalization's own reduction
and elementwise passes are not run. Without ``log_z`` the log-weights are
normalized first, as before.
"""

from __future__ import annotations

from typing import Optional

import torch

from particle_filters_tpu_torch.core.block_cumsum import blocked_cumsum
from particle_filters_tpu_torch.core.weights import log_normalize
from particle_filters_tpu_torch.ops.resample import resample_by_starts
from particle_filters_tpu_torch.ops.systematic_starts import (
    cdf as _cdf,
    starts_from_run_ends,
    systematic_run_ends,
    systematic_starts,
)
from particle_filters_tpu_torch.resampling.exact import (
    EXACT_THRESHOLD,
    exact_child_run_ends_u,
)


def _weights_from(
    w: Optional[torch.Tensor], logw: Optional[torch.Tensor]
) -> torch.Tensor:
    """Normalized linear weights along the last axis (one cloud per row)."""
    if (w is None) == (logw is None):
        raise ValueError("Pass exactly one of w= or logw=.")
    if logw is not None:
        norm = log_normalize if logw.ndim == 1 else torch.func.vmap(log_normalize)
        return torch.exp(norm(logw)[0])
    return w / torch.sum(w, dim=-1, keepdim=True)


def _uniform(generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def _inverse_cdf(cdf: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """idx[i] = smallest j with positions[i] < cdf[j]."""
    n = cdf.shape[0]
    cdf = cdf / cdf[-1]  # force the final entry to 1
    idx = torch.searchsorted(cdf, positions, right=True)
    return idx.clamp_(0, n - 1).to(torch.int32)


def _child_run_ends_u(
    weights: torch.Tensor, m: int, u: torch.Tensor, *, exact: Optional[bool] = None,
    log_z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """t_j = #{i : (u + i)/M < cdf_j} = ⌈M·cdf_j − u⌉ for a given u, along
    the last axis of ``weights`` (one u per row): kernel S on a CUDA
    tensor, its plain version on a CPU one. With ``log_z`` (one a row) the
    rows are log-weights and ``log_z`` their log-normalizers (kernel S's
    log-domain input). Past max(N, M) = 2²⁴ the exact integer path computes
    them from normalized linear weights; ``exact=True/False`` forces either
    path (testing)."""
    n = weights.shape[-1]
    if exact is None:
        exact = max(n, m) > EXACT_THRESHOLD
    if exact:
        if log_z is not None:
            weights = _weights_from(None, weights)
        return exact_child_run_ends_u(weights, m, u)
    u = torch.as_tensor(u, dtype=weights.dtype)
    if u.device != weights.device:
        u = u.to(weights.device)
    u = u.expand(weights.shape[:-1]).reshape(-1).contiguous()
    if log_z is not None:
        log_z = log_z.reshape(-1).contiguous()
    return systematic_run_ends(weights.reshape(-1, n).contiguous(), m, u,
                               log_z=log_z).view(weights.shape)


def _child_run_ends(
    generator, weights: torch.Tensor, m: int, *, exact: Optional[bool] = None
) -> torch.Tensor:
    """The END (exclusive) of each ancestor's child run under systematic
    resampling with M positions (u + i)/M, u ~ U[0, 1) from ``generator``."""
    u = _uniform(generator, weights.shape[:-1], weights)
    return _child_run_ends_u(weights, m, u, exact=exact)


def _systematic_starts(generator, weights: torch.Tensor, m: int) -> torch.Tensor:
    """start_j = t_{j−1} (t_{−1} = 0): int32 (N,), values in [0, M]."""
    t = _child_run_ends(generator, weights, m)
    return torch.cat([t.new_zeros(1), t[:-1]])


def systematic_resample(
    generator,
    w: Optional[torch.Tensor] = None,
    *,
    logw: Optional[torch.Tensor] = None,
    num_samples: Optional[int] = None,
) -> torch.Tensor:
    """Systematic resampling: positions (u + i)/M with one shared u.
    Returns int32 ancestor indices ``idx[i] = max{j : start_j ≤ i}``."""
    weights = _weights_from(w, logw)
    m = num_samples or weights.shape[0]
    starts = _systematic_starts(generator, weights, m)
    marks = torch.zeros(m + 1, dtype=torch.int32, device=weights.device)
    marks.index_add_(0, starts, torch.ones_like(starts))  # slot m drops
    return torch.cumsum(marks[:m], dim=0, dtype=torch.int32) - 1


def systematic_counts(
    generator,
    w: Optional[torch.Tensor] = None,
    *,
    logw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-ancestor child counts under the same convention (and, for the
    same generator state, the same u) as ``systematic_resample``."""
    weights = _weights_from(w, logw)
    t = _child_run_ends(generator, weights, weights.shape[0])
    return torch.diff(t, prepend=t.new_zeros(1))


def systematic_resample_values(
    generator,
    particles: torch.Tensor,
    *,
    w: Optional[torch.Tensor] = None,
    logw: Optional[torch.Tensor] = None,
    log_z: Optional[torch.Tensor] = None,
    return_starts: bool = False,
):
    """Systematic resampling returning the resampled (N, d) particle VALUES:
    the one-cloud case of :func:`systematic_resample_values_batched`
    (``log_z`` a 0-d or (1,) tensor).

    The starts come from kernel S (``ops/systematic_starts.py``) and the
    values from kernel B2 (``ops/resample.py``) on a CUDA tensor, from their
    plain versions on a CPU tensor. The values are copies, so they equal ``particles[idx]``.
    With ``return_starts`` also returns the (N,) int32 child-run starts the
    values were copied by.
    """
    out, starts = systematic_resample_values_batched(
        generator, particles[None],
        w=None if w is None else w[None], logw=None if logw is None else logw[None],
        log_z=None if log_z is None else log_z.reshape(1), return_starts=True)
    return (out[0], starts) if return_starts else out[0]


def systematic_resample_values_batched(
    generator,
    particles: torch.Tensor,
    *,
    w: Optional[torch.Tensor] = None,
    logw: Optional[torch.Tensor] = None,
    log_z: Optional[torch.Tensor] = None,
    return_starts: bool = False,
):
    """Systematic resampling of B independent clouds (B, N, d) with weights
    (B, N), one u per cloud from ``generator``, in ONE launch of kernel B2
    (:func:`batched_starts`). ``log_z`` (B,), given with ``logw``, holds the
    clouds' log-normalizers (logsumexp over each row): the starts are then
    taken from the log-weights (:func:`batched_starts`'s log-domain input).
    With ``return_starts`` also returns those (B·N,) starts."""
    if log_z is None:
        weights = _weights_from(w, logw)
    elif logw is None or w is not None:
        raise ValueError("log_z= goes with logw= alone.")
    else:
        weights = logw
    b, n, d = particles.shape
    starts = batched_starts(weights, _uniform(generator, (b,), weights), log_z=log_z)
    out = resample_by_starts(particles.reshape(b * n, d).contiguous(), starts)
    out = out.view(b, n, d)
    return (out, starts) if return_starts else out


def batched_starts(weights: torch.Tensor, u: torch.Tensor,
                   log_z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The child-run starts of B clouds (B, N) for the u's (B,), as one
    sorted int32 array (B·N,): cloud b's starts offset by b·N. Every cloud's
    first start is 0, so ``idx[i] = max{j : start_j ≤ i}`` never crosses a
    cloud. Below N = 2²⁴ one call of kernel S on a CUDA tensor. With
    ``log_z`` (B,) the rows are log-weights and ``log_z`` their
    log-normalizers: kernel S (or its plain version) reads them in its log
    domain; past 2²⁴ they are normalized as without it, since the exact path
    takes normalized linear weights."""
    n = weights.shape[-1]
    if n > EXACT_THRESHOLD:
        if log_z is not None:
            weights = _weights_from(None, weights)
        return starts_from_run_ends(exact_child_run_ends_u(weights, n, u))
    return systematic_starts(weights.contiguous(), u.contiguous(),
                             log_z=None if log_z is None else log_z.contiguous())


def stratified_resample(
    generator,
    w: Optional[torch.Tensor] = None,
    *,
    logw: Optional[torch.Tensor] = None,
    num_samples: Optional[int] = None,
) -> torch.Tensor:
    """Stratified resampling: positions (uᵢ + i)/M with independent uᵢ."""
    weights = _weights_from(w, logw)
    m = num_samples or weights.shape[0]
    u = _uniform(generator, (m,), weights)
    positions = (u + torch.arange(m, dtype=weights.dtype, device=weights.device)) / m
    return _inverse_cdf(_cdf(weights), positions)


def multinomial_resample(
    generator,
    w: Optional[torch.Tensor] = None,
    *,
    logw: Optional[torch.Tensor] = None,
    num_samples: Optional[int] = None,
) -> torch.Tensor:
    """Multinomial resampling: M sorted iid uniforms, inverse-CDF mapped,
    then randomly permuted so marginals match ``rng.choice(p=w)``."""
    weights = _weights_from(w, logw)
    m = num_samples or weights.shape[0]
    u, _ = torch.sort(_uniform(generator, (m,), weights))
    idx_sorted = _inverse_cdf(_cdf(weights), u)
    perm = torch.randperm(m, generator=generator, device=weights.device)
    return idx_sorted[perm]


def residual_resample(
    generator,
    w: Optional[torch.Tensor] = None,
    *,
    logw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Residual resampling: ⌊N wᵢ⌋ deterministic copies + multinomial on the
    fractional residuals, slot i taking the deterministic ancestor while
    i < Σ⌊N wᵢ⌋."""
    weights = _weights_from(w, logw)
    n = weights.shape[0]
    counts = torch.floor(n * weights)
    n_det = torch.sum(counts)
    cum_counts = torch.cumsum(counts, dim=0)

    slots = torch.arange(n, dtype=weights.dtype, device=weights.device)
    det_idx = torch.searchsorted(cum_counts, slots, right=True).clamp_(0, n - 1)

    resid = torch.clamp(n * weights - counts, min=0.0)
    resid_cdf = blocked_cumsum(resid / torch.clamp(torch.sum(resid), min=1e-38))
    u = _uniform(generator, (n,), weights)
    multi_idx = torch.searchsorted(resid_cdf, u, right=True).clamp_(0, n - 1)

    return torch.where(slots < n_det, det_idx, multi_idx).to(torch.int32)


_METHODS = {
    "systematic": systematic_resample,
    "multinomial": multinomial_resample,
    "stratified": stratified_resample,
    "residual": residual_resample,
}


def resample_indices(
    method: str,
    generator,
    w: Optional[torch.Tensor] = None,
    *,
    logw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatch by method name ('systematic' | 'multinomial' | 'stratified' |
    'residual')."""
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(
            f"Unknown resample method {method!r}; expected one of {sorted(_METHODS)}."
        ) from None
    return fn(generator, w, logw=logw)
