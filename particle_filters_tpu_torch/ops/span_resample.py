"""Probe X2: span-staged systematic resample values for d = 1.

Replaces ``benchmarks/exp_resample_dma.py::_dma_kernel``, the TPU probe of a
blocked resample that stages, for each super-group of SG = 64 sub-groups,
one contiguous span of fine-chunk rows in fast memory instead of gathering
Q rows per sub-group. Since the sub-groups' first chunks ``a0`` are
nondecreasing, a super-group's rows form the span
``[a0[first], a0[last] + Q)``, whose length ``spanD`` depends on the weights:
a local weight desert makes ``a0`` jump. The probe's budget is ROWS = 128
rows. Its window is Q = 3 chunks a sub-group, right only where each
sub-group's ancestors lie in those chunks (the TPU path's first tier,
lognormal weights down to ESS ≈ N/3). :func:`span_resample_values` raises
``ValueError`` where either fails, with no fallback to kernel B2.

It computes what the TPU kernel computes, telescoped sums of particle
differences over a Q = 3-row window plus the chunk base (``csrc/
span_resample.cu``, whose note says what bounds it), so its values equal
kernel B2's (``ops/resample.py``) on the same starts to f32 rounding of
partial sums of up to 384 terms, not bit for bit. The kernel checks each
super-group's span from ``a0`` alone and stages only each sub-group's own
Q rows, ahead by ``cp.async``, one warp a sub-group; since a window is
sorted, one merge of its starts with the 128 positions gives the counts and
a scan of its differences the sums (``csrc/sorted_window.cuh``), and a
window that is not sorted is walked entry by entry.
"""

from __future__ import annotations

import ctypes

import torch

from particle_filters_tpu_torch.ops._nvcc import Kernel
from particle_filters_tpu_torch.ops.resample_blocked import SUB, fine_chunks

SG = 64  # sub-groups per super-group (block)
Q = 3  # fine-chunk rows per sub-group
ROWS = 128  # rows a super-group may stage
_KERNEL = Kernel("X2 span kernel", "pf_span_resample", ("span_resample.cu",),
                 "pf_span_resample", (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5)


def span_rows(a0: torch.Tensor) -> torch.Tensor:
    """``spanD = max_super(a0[last] + Q − a0[first])``, as a 0-d tensor."""
    a0s = a0.view(-1, SG)
    return torch.max(a0s[:, -1] + Q - a0s[:, 0])


def span_checks(starts: torch.Tensor, a0: torch.Tensor) -> torch.Tensor:
    """``[spanD, sub-groups whose last ancestor lies past their Q-chunk
    window]`` as an int32 (2,) tensor, computed on the device: the inputs
    are X2's path where ``spanD ≤ ROWS`` and no sub-group is uncovered."""
    n = starts.shape[0]
    sub = torch.arange(a0.shape[0], device=a0.device)
    after = (a0.long() + Q) * SUB  # the first particle past the window
    covered = (after >= n) | (starts[after.clamp(max=n - 1)] > sub * SUB + SUB - 1)
    return torch.stack([span_rows(a0), (~covered).sum().to(torch.int32)])


def span_compare_sum_reference(starts_f, diffs, chunk_base, a0):
    """Plain version of X2: each sub-group's Q rows gathered, compared with
    its 128 positions, summed row by row, plus the chunk base."""
    n_subs = a0.shape[0]
    rows = a0.long()[:, None] + torch.arange(Q, device=a0.device)  # (n_subs, Q)
    s = starts_f[rows]  # (n_subs, Q, 128)
    d = diffs[rows]
    pos = torch.arange(n_subs * SUB, device=a0.device, dtype=torch.float32).view(n_subs, SUB)
    C = s[:, None, :, :] <= pos[:, :, None, None]  # (n_subs, 128, Q, 128)
    acc = torch.where(C, d[:, None], 0.0).sum(-1).sum(-1)  # row sums, then rows
    return (acc + chunk_base.view(-1)[a0.long()][:, None]).view(-1, 1)


def _check_chunks(starts_f, diffs, chunk_base, a0) -> None:
    n_rows = starts_f.shape[0]
    if (starts_f.shape != (n_rows, SUB) or diffs.shape != (n_rows, SUB)
            or chunk_base.shape != (n_rows, 1)):
        raise ValueError(
            f"need starts_f and diffs (rows, 128) and chunk_base (rows, 1) (d = 1); got "
            f"{tuple(starts_f.shape)}, {tuple(diffs.shape)}, {tuple(chunk_base.shape)}."
        )
    if a0.ndim != 1 or a0.shape[0] % SG or n_rows < a0.shape[0] + ROWS:
        raise ValueError(
            f"need a0 (n_subs,) with n_subs a multiple of {SG} and rows >= n_subs + "
            f"{ROWS}; got a0 {tuple(a0.shape)}, {n_rows} rows."
        )
    if a0.shape[0] * SUB > 1 << 24:
        raise ValueError("N must not exceed 2**24: positions compare in f32.")
    if a0.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in (starts_f, diffs, chunk_base)):
        raise TypeError("need float32 chunk arrays and int32 a0.")
    if any(t.device != a0.device for t in (starts_f, diffs, chunk_base)):
        raise ValueError("all inputs must be on one device.")
    if not all(t.is_contiguous() for t in (starts_f, diffs, chunk_base, a0)):
        raise ValueError("all inputs must be contiguous.")


def span_compare_sum(starts_f, diffs, chunk_base, a0) -> torch.Tensor:
    """X2 on the fine-chunk arrays of :func:`resample_blocked.fine_chunks`
    (``extra`` ≥ ROWS rows) and ``a0``: the (n_subs·128, 1) values.

    A CUDA tensor goes through the kernel, which writes NaN for a
    super-group whose span exceeds ROWS; a CPU tensor through its plain
    version. ``span_compare_sum.launches`` counts kernel launches.
    """
    _check_chunks(starts_f, diffs, chunk_base, a0)
    if a0.device.type == "cpu":
        return span_compare_sum_reference(starts_f, diffs, chunk_base, a0)
    if a0.device.type != "cuda":
        raise ValueError(f"unsupported device {a0.device}.")
    n_subs = a0.shape[0]
    out = torch.empty((n_subs * SUB, 1), dtype=torch.float32, device=a0.device)
    _KERNEL(a0.device, starts_f.data_ptr(), diffs.data_ptr(), chunk_base.data_ptr(),
            a0.data_ptr(), out.data_ptr(), starts_f.shape[0], n_subs // SG, SG, Q, ROWS)
    span_compare_sum.launches += 1
    return out


span_compare_sum.launches = 0


def span_resample_unchecked(starts, particles, a0) -> torch.Tensor:
    """:func:`span_resample_values` without its checks (no host read, so a
    CUDA graph can capture it): the caller checks :func:`span_checks`."""
    n = particles.shape[0]
    starts_f, diffs, chunk_base = fine_chunks(starts, particles, n // SUB, ROWS)
    return span_compare_sum(starts_f, diffs, chunk_base, a0)


def span_resample_values(starts, particles, a0) -> torch.Tensor:
    """Systematic-resampled values of (N, 1) f32 ``particles`` from the
    sorted int32 child-run ``starts`` and the sub-groups' first chunks
    ``a0`` (``benchmarks.exp_resample_dma.rank_a0``); N a multiple of
    SG·128 = 8192, at most 2**24. Raises ``ValueError`` when ``spanD >
    ROWS`` or a sub-group's ancestors leave its Q-chunk window (one
    device→host read)."""
    n = particles.shape[0]
    if particles.ndim != 2 or particles.shape[1] != 1 or starts.shape != (n,):
        raise ValueError(
            f"need particles (N, 1) and starts (N,); got {tuple(particles.shape)}, "
            f"{tuple(starts.shape)}."
        )
    if n % (SG * SUB) or a0.shape != (n // SUB,):
        raise ValueError(
            f"need N a multiple of {SG * SUB} and a0 (N/128,); got N = {n}, a0 "
            f"{tuple(a0.shape)}."
        )
    span, uncovered = span_checks(starts, a0).tolist()
    if span > ROWS:
        raise ValueError(
            f"spanD = {span} rows exceeds the budget of {ROWS}: the weights leave "
            "a desert that one super-group's span cannot cover."
        )
    if uncovered:
        raise ValueError(
            f"{uncovered} sub-groups have ancestors past their Q = {Q} chunk window: "
            "the weights are too degenerate for this probe."
        )
    return span_resample_unchecked(starts, particles, a0)
