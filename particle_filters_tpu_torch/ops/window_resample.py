"""Probe X1: the windowed compare-and-sum of the blocked resample.

Replaces ``benchmarks/exp_kernel_var.py::kern_v0``, the TPU probe that split
the cost of the blocked resample kernel (``ops/resample_pallas.py``) into
its compare, select, reduce and transpose. For super-group ``s``, sub-group
``i`` and output ``k`` at the global position ``pos = (s·SG + i)·128 + k``::

    out = Σ_w [s_win[s, i, w] ≤ pos] · d_win[s, i, 0, w]

over the sub-group's window of W = Q·128 fine-chunk starts and particle
differences (``benchmarks/exp_kernel_var.py::make_inputs`` builds them).
``sum_only`` counts the selected entries instead; ``transpose=False``
writes (S, 128, SG) in place of (S, SG, 128).

``csrc/window_resample.cu`` runs one warp per sub-group with the window in
shared memory, staged ahead by ``cp.async``; its note says what bounds it.
Since the windows are sorted, the kernel finds the counts of a sub-group's
128 positions at once, by marking where the runs of starts end and taking a
running max of the marks, and their sums in a scan of the differences
(``csrc/sorted_window.cuh``); a window that is not sorted is walked entry by
entry. The sums telescope in another order than the plain version's
reduction, so the two agree to f32 rounding of partial sums of up to W
terms, not bit for bit; the counts are exact.
"""

from __future__ import annotations

import ctypes

import torch

from particle_filters_tpu_torch.ops._nvcc import Kernel
from particle_filters_tpu_torch.ops.resample_blocked import SUB

_KERNEL = Kernel("X1 window kernel", "pf_window_resample", ("window_resample.cu",),
                 "pf_window_compare_sum", (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5)
_MAX_POS = 1 << 24  # positions compare in f32, exact below 2**24
_MAX_W = 6144  # a warp's two buffers of 2·W floats stay within 96 KB of shared memory


def window_compare_sum_reference(s_win, d_win, *, sum_only=False, transpose=True):
    """Plain version of X1: a dense (S, SG, 128, W) select-and-sum."""
    n_super, sg, _ = s_win.shape
    pos = torch.arange(n_super * sg * SUB, device=s_win.device, dtype=torch.float32)
    C = s_win[..., None, :] <= pos.view(n_super, sg, SUB, 1)
    vals = torch.ones_like(s_win) if sum_only else d_win[:, :, 0]
    out = torch.where(C, vals[:, :, None, :], 0.0).sum(-1)
    return out if transpose else out.transpose(1, 2).contiguous()


def _check(s_win: torch.Tensor, d_win: torch.Tensor) -> None:
    if s_win.ndim != 3 or d_win.shape != (*s_win.shape[:2], 1, s_win.shape[2]):
        raise ValueError(
            f"need s_win (S, SG, W) and d_win (S, SG, 1, W); got "
            f"{tuple(s_win.shape)}, {tuple(d_win.shape)}."
        )
    n_super, sg, w = s_win.shape
    if w % SUB or not 0 < w <= _MAX_W:
        raise ValueError(f"W must be a multiple of {SUB} up to {_MAX_W}; got {w}.")
    if n_super * sg * SUB > _MAX_POS:
        raise ValueError("S·SG·128 must not exceed 2**24: positions compare in f32.")
    if s_win.dtype != torch.float32 or d_win.dtype != torch.float32:
        raise TypeError(f"need float32 windows; got {s_win.dtype}, {d_win.dtype}.")
    if s_win.device != d_win.device:
        raise ValueError("s_win and d_win must be on one device.")
    if not (s_win.is_contiguous() and d_win.is_contiguous()):
        raise ValueError("s_win and d_win must be contiguous.")


def window_compare_sum(s_win: torch.Tensor, d_win: torch.Tensor, *,
                       sum_only: bool = False, transpose: bool = True) -> torch.Tensor:
    """X1 on (S, SG, W) f32 starts ``s_win`` and (S, SG, 1, W) f32 diffs
    ``d_win``: (S, SG, 128) with ``transpose``, else (S, 128, SG).

    A CUDA tensor goes through the kernel; a CPU tensor through its plain
    version. ``window_compare_sum.launches`` counts kernel launches.
    """
    _check(s_win, d_win)
    if s_win.device.type == "cpu":
        return window_compare_sum_reference(
            s_win, d_win, sum_only=sum_only, transpose=transpose)
    if s_win.device.type != "cuda":
        raise ValueError(f"unsupported device {s_win.device}.")
    n_super, sg, w = s_win.shape
    shape = (n_super, sg, SUB) if transpose else (n_super, SUB, sg)
    out = torch.empty(shape, dtype=torch.float32, device=s_win.device)
    _KERNEL(s_win.device, s_win.data_ptr(), d_win.data_ptr(), out.data_ptr(), n_super * sg,
            sg, w, int(sum_only), int(transpose))
    window_compare_sum.launches += 1
    return out


window_compare_sum.launches = 0
