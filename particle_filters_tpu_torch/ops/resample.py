"""Kernel B2: systematic-resampled particle values from the child-run starts.

Replaces ``particle_filters_tpu/ops/resample_pallas.py::_resample_kernel``
(driven by ``systematic_resample_values_blocked``). On the TPU every
irregular memory op lowered to a serial loop, so that kernel avoided gathers:
it compared a window of starts against 128 output positions and summed
telescoping particle differences, in three span tiers with an XLA fallback,
exact only below N = 2²⁴ and with O(log N·eps) rounding.

The H100 gathers natively. ``csrc/systematic_resample.cu`` is a merge-path
load-balanced search (ModernGPU's ``load_balance_search``): the merge of the
N starts with the N output positions is cut into equal blocks along
merge-path diagonals, each block stages its window of starts in shared
memory and merges it serially, then copies the ancestors' values with
16-byte stores. Exact at any degeneracy, no tiers, no fallback, and equal to
``p[idx]`` bit for bit.

What bounds it on the card: bytes. At N = 2²⁰, d = 1 it must read the
starts and the particles and write the output, 12 MiB in all; the design
spends three rounds of loads on each block's split, where a binary search
per output spent twenty dependent ones.

The starts come from kernel S (``ops/systematic_starts.py``, through
``resampling.hard.batched_starts``), where the JAX package took them from
XLA.

The M→n form serves the sharded filters: M sorted starts (and M value
rows) and n outputs, from output ``offset`` on, ``out[i] = values[max{j :
starts[j] ≤ offset + i}]``. A rank writes only its own slice of a global
resample: all-gather mode merges the gathered cloud's N starts with the
rank's n outputs (offset rank·n); neighbor mode merges its (2r+1)·n pooled
starts. The kernel clamps each start to [0, n] after the offset as it reads
it, so the shift costs no pass over the starts.

A gate (an int32 trigger on the device, ``trigger=``) makes a launch a
no-op where the trigger reads 0: the fused SIR filter's captured run
launches B2 every step into one output buffer and lets its step's trigger
decide on the card. The plain version reads the trigger on the host. Without
a gate the kernel launches as it always has.
"""

from __future__ import annotations

import ctypes

import torch

from particle_filters_tpu_torch.ops._nvcc import Kernel, check_out_and_gate

_KERNEL = Kernel("B2 resample kernel", "pf_resample", ("systematic_resample.cu",),
                 "pf_resample_by_starts", (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4)


def resample_by_starts_reference(
    particles: torch.Tensor, starts: torch.Tensor, n_out=None, offset: int = 0
) -> torch.Tensor:
    """Plain version of B2: ``out[i] = particles[max{j : starts[j] ≤ offset
    + i}]`` for i < ``n_out`` (default: the rows of ``particles``)."""
    n_out = particles.shape[0] if n_out is None else n_out
    pos = torch.arange(offset, offset + n_out, device=starts.device, dtype=starts.dtype)
    idx = torch.searchsorted(starts, pos, right=True) - 1
    return particles[idx.clamp_(min=0)]


def _check(particles: torch.Tensor, starts: torch.Tensor, n_out: int, offset: int,
           out=None, trigger=None) -> None:
    if particles.ndim != 2:
        raise ValueError(f"particles must be (N, d); got {tuple(particles.shape)}.")
    if starts.ndim != 1 or starts.shape[0] != particles.shape[0]:
        raise ValueError(
            f"starts must be (N,) with N = {particles.shape[0]}; "
            f"got {tuple(starts.shape)}."
        )
    if particles.dtype != torch.float32 or starts.dtype != torch.int32:
        raise TypeError(
            f"need float32 particles and int32 starts; got {particles.dtype}, "
            f"{starts.dtype}."
        )
    if particles.device != starts.device:
        raise ValueError("particles and starts must be on one device.")
    if not (particles.is_contiguous() and starts.is_contiguous()):
        raise ValueError("particles and starts must be contiguous.")
    if particles.shape[0] > 2**30 or not 0 <= n_out <= 2**30:
        raise ValueError("need M and n_out in [0, 2**30].")
    if not 0 <= offset < 2**31 - n_out:
        raise ValueError(f"need 0 <= offset and offset + n_out < 2**31; got {offset}.")
    check_out_and_gate(out, (n_out, particles.shape[1]), torch.float32, particles.device,
                       trigger)


def resample_by_starts(particles: torch.Tensor, starts: torch.Tensor, n_out=None,
                       offset: int = 0, *, out=None, trigger=None) -> torch.Tensor:
    """Systematic-resampled values of (M, d) f32 ``particles`` given their
    sorted (M,) int32 child-run ``starts``: ``out[i] = particles[max{j :
    starts[j] ≤ offset + i}]`` for i < ``n_out`` (default M), which needs
    ``starts[0] ≤ offset`` (``starts[0] == 0`` for the whole cloud).

    A CUDA tensor goes through kernel B2; a CPU tensor through its plain
    version. The values land in ``out`` (n_out, d) when given. With
    ``trigger`` (an int32 (1,) on the particles' device, and ``out``) the
    call is gated: where the trigger reads 0 ``out`` is left as it was, and
    the starts are not read. ``resample_by_starts.launches`` counts kernel
    launches, gated ones too.
    """
    n_out = particles.shape[0] if n_out is None else int(n_out)
    offset = int(offset)
    _check(particles, starts, n_out, offset, out, trigger)
    if particles.device.type == "cpu":
        if trigger is not None and not bool(trigger[0]):
            return out
        values = resample_by_starts_reference(particles, starts, n_out, offset)
        return values if out is None else out.copy_(values)
    if particles.device.type != "cuda":
        raise ValueError(f"unsupported device {particles.device}.")
    if starts.data_ptr() % 16:  # the kernel stages the starts with 16-byte copies
        starts = starts.clone()
    m, d = particles.shape
    out = particles.new_empty((n_out, d)) if out is None else out
    _KERNEL(particles.device, particles.data_ptr(), starts.data_ptr(), out.data_ptr(),
            None if trigger is None else trigger.data_ptr(), m, n_out, d, offset)
    resample_by_starts.launches += 1
    return out


resample_by_starts.launches = 0
