"""Kernel S: the child-run ends and starts of systematic resampling, from
normalized weights, or from log-weights and their log-normalizer.

Replaces no TPU kernel. On the card it replaces the plain version below,
the chain of PyTorch ops that computed them (a blocked f64 cumsum by
products with a triangle of ones, a running maximum by ``cummax`` in rows
and ``cat``, the normalization and the run-end arithmetic, then the starts'
shift and offsets): ~35 launches moving ~2.5 GB at N = 2²⁴ where the work
needs one f32 weight read and one int32 written a row.

``csrc/systematic_starts.cu`` does the same work in the same precision:
prefix sums accumulated in f64 and rounded once to f32, a running maximum
over the whole row, ``ceil(M·(cdf / cdf[-1]) − u)`` rounded op by op as
PyTorch rounds it, clamped to [0, M]. Its sums associate in another fixed
order than the plain version's products, so on one input a cdf entry can
differ by one f32 ulp, and a run end by one, at rare positions; on the
card it gives the same bits on every call (no atomics, no look-back). A
row is cut into tiles of :data:`TILE` weights: a row of one tile takes one
pass; a longer one three (tile sums, one block a row scanning them into
offsets, then each tile again with its offset and floor), see :func:`plan`.

What bounds it on the card: bytes. It reads the weights twice (once a
pass over the tiles) and writes the output once.

Given log-weights and their log-normalizers ``log_z`` (one a row, on the
device), either form reads the log-weights and forms each weight
exp(logw − log_z) as it stages a tile, in both passes that read the row:
the log-domain input, chosen by the call's own arguments. The fused SIR filter
passes its step's log Z (kernel B1's row), so its resample runs no
normalization of its own. ``systematic_starts.log_rows`` counts the rows
that took it, the kernel's and the plain version's.

A gate (an int32 trigger on the device, ``trigger=`` with ``out=``) makes
every pass of a launch a no-op where the trigger reads 0, ``out`` left as
it was: the fused SIR filter's captured run launches S every step and lets
its step's trigger decide on the card. The plain version reads the trigger
on the host. Without a gate the kernel launches as it always has.

The plain version is the chain itself (:func:`cdf`, :func:`run_ends_reference`,
:func:`starts_reference`; in the log domain fed :func:`linear_weights`); CPU
tensors take it, bit for bit as before. A CUDA tensor takes the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from particle_filters_tpu_torch.core.block_cumsum import blocked_cumsum
from particle_filters_tpu_torch.ops._nvcc import Kernel, check_out_and_gate

_KERNEL = Kernel("systematic starts kernel", "pf_systematic_starts", ("systematic_starts.cu",),
                 "pf_systematic_starts", (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5)
TILE = 8192  # weights a tile: kTile in csrc/systematic_starts.cu
MAX_N = 1 << 24  # the f32 run ends' ceiling (resampling/exact.py takes larger)

# --- the plain version ------------------------------------------------------

_ROW = 256  # row width of the running maximum


def running_max(x: torch.Tensor) -> torch.Tensor:
    """``torch.cummax(x, -1).values`` over the last axis, in rows of 256:
    the card scans one long row serially, many short rows in parallel; the
    rows' running maxima carry between them."""
    n = x.shape[-1]
    if n <= _ROW:
        return torch.cummax(x, dim=-1).values
    rows = -(-n // _ROW)
    pad = x[..., -1:].expand(x.shape[:-1] + (rows * _ROW - n,))
    padded = torch.cat([x, pad], dim=-1).view(x.shape[:-1] + (rows, _ROW))
    within = torch.cummax(padded, dim=-1).values
    carry = running_max(within[..., -1])  # the maximum up to each row's end
    out = torch.cat(
        [within[..., :1, :], torch.maximum(within[..., 1:, :], carry[..., :-1, None])],
        dim=-2,
    )
    return out.flatten(-2)[..., :n]


def cdf(weights: torch.Tensor) -> torch.Tensor:
    """The nondecreasing cumulative sum of ``weights`` along the last axis.
    Each partial sum of the blocked scan rounds on its own, so one can land
    below its predecessor where a weight is under one ulp of it; the running
    maximum undoes that. Both are deterministic on the card."""
    return running_max(blocked_cumsum(weights))


def run_ends_reference(weights: torch.Tensor, m: int, u) -> torch.Tensor:
    """Plain version of the run-ends form: t_j = ⌈M·cdf_j − u⌉ along the
    last axis (one u per row), with cdf normalized by its last entry."""
    c = cdf(weights)
    c = c / c[..., -1:]
    u = torch.as_tensor(u, dtype=c.dtype, device=c.device)
    t = torch.ceil(m * c - u[..., None])
    return t.clamp_(0.0, m).to(torch.int32)


def starts_from_run_ends(t: torch.Tensor) -> torch.Tensor:
    """The (B·N,) starts of B clouds' (B, N) run ends: cloud b's run ends
    shifted by one after a first start 0, offset by b·N."""
    b, n = t.shape
    offsets = torch.arange(b, dtype=torch.int32, device=t.device)[:, None] * n
    return (torch.cat([t.new_zeros((b, 1)), t[:, :-1]], dim=1) + offsets).view(-1)


def starts_reference(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version of the starts form (M = N)."""
    return starts_from_run_ends(run_ends_reference(weights, weights.shape[-1], u))


def linear_weights(logw: torch.Tensor, log_z: torch.Tensor) -> torch.Tensor:
    """exp(logw − log_z) of B rows of log-weights (B, N) and their
    log-normalizers (B,). A log_z of −inf (every log-weight −inf) takes
    log(1e-30), the guarded log-normalizer of ``core/weights.py``'s
    ``log_normalize``, so the weights are 0 and not NaN; a log_z of +inf or
    NaN gives the weights that function gives."""
    floor = torch.full_like(log_z, math.log(1e-30))
    lz = torch.where(log_z == -math.inf, floor, log_z)
    return torch.exp(logw - lz[..., None])


# --- the kernel ---------------------------------------------------------------


@dataclass(frozen=True)
class Plan:
    """What the wrapper needs to know of the launches for ``rows`` rows of
    ``n`` weights: ``tiles`` a row, the ``passes`` (launches), and
    ``scratch``, the f64 words to allocate between them. The C entry owns
    the passes' grids and the scratch's layout, and refuses ``tiles`` that
    is not its own."""

    tiles: int
    passes: int
    scratch: int


def plan(rows: int, n: int) -> Plan:
    """One pass for a row of one tile; three for longer rows, with two
    words a tile and one a row of scratch."""
    tiles = -(-n // TILE)
    if tiles == 1:
        return Plan(1, 1, 0)
    return Plan(tiles, 3, 2 * rows * tiles + rows)


def _check(weights: torch.Tensor, u: torch.Tensor, m: int, log_z=None) -> None:
    if weights.ndim != 2:
        raise ValueError(f"weights must be (B, N); got {tuple(weights.shape)}.")
    rows, n = weights.shape
    if u.shape != (rows,):
        raise ValueError(f"u must be (B,) with B = {rows}; got {tuple(u.shape)}.")
    if weights.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"kernel S takes float32 weights and u, as every filter of the port "
                        f"holds them; got {weights.dtype}, {u.dtype}.")
    if weights.device.type != "cuda" or u.device != weights.device:
        raise ValueError(f"the kernel takes CUDA tensors on one device; got {weights.device}, "
                         f"{u.device}.")
    if not (weights.is_contiguous() and u.is_contiguous()):
        raise ValueError("weights and u must be contiguous.")
    if not (1 <= n <= MAX_N and 1 <= m <= MAX_N):
        raise ValueError(f"need N and M in [1, 2**24]; got N = {n}, M = {m}.")
    if rows * n >= 2**31:
        raise ValueError(f"need B·N < 2**31; got {rows} x {n}.")
    if log_z is not None and (log_z.shape != (rows,) or log_z.dtype != torch.float32
                              or log_z.device != weights.device or not log_z.is_contiguous()):
        raise ValueError(f"log_z must be a contiguous float32 (B,) with B = {rows} on "
                         f"{weights.device}; got {log_z.dtype} {tuple(log_z.shape)} on "
                         f"{log_z.device}.")


def _launch(weights: torch.Tensor, u: torch.Tensor, m: int, starts_form: bool,
            log_z=None, trigger=None, out=None) -> torch.Tensor:
    _check(weights, u, m, log_z)
    rows, n = weights.shape
    p = plan(rows, n)
    if out is None:
        out = weights.new_empty((rows * n,) if starts_form else (rows, n), dtype=torch.int32)
    scratch = weights.new_empty((p.scratch,), dtype=torch.float64)
    _KERNEL(weights.device, weights.data_ptr(), None if log_z is None else log_z.data_ptr(),
            u.data_ptr(), None if trigger is None else trigger.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), rows, n, p.tiles, m, int(starts_form))
    systematic_starts.launches += p.passes
    return out


def _run(weights: torch.Tensor, u: torch.Tensor, m: int, starts_form: bool,
         log_z: Optional[torch.Tensor], trigger=None, out=None) -> torch.Tensor:
    """Either form on a CPU tensor by the plain version, on a CUDA tensor by
    kernel S, into ``out`` when given (gated by ``trigger``); the log-domain
    rows counted, gated or not."""
    if out is not None or trigger is not None:
        rows, n = weights.shape
        check_out_and_gate(out, (rows * n,) if starts_form else (rows, n), torch.int32,
                           weights.device, trigger)
    if weights.device.type != "cpu":
        out = _launch(weights, u, m, starts_form, log_z, trigger, out)
    elif trigger is None or bool(trigger[0]):
        w = weights if log_z is None else linear_weights(weights, log_z)
        res = starts_reference(w, u) if starts_form else run_ends_reference(w, m, u)
        out = res if out is None else out.copy_(res)
    if log_z is not None:
        systematic_starts.log_rows += weights.shape[0]
    return out


def systematic_run_ends(weights: torch.Tensor, m: int, u: torch.Tensor,
                        log_z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (B, N) int32 run ends ⌈M·cdf_j − u_b⌉ of B rows of normalized
    weights (B, N) for the uniforms u (B,); with ``log_z`` (B,) the rows
    are log-weights whose log-normalizers it holds. A CPU tensor takes the
    plain version; a CUDA tensor kernel S (float32, contiguous, N and M at
    most 2²⁴)."""
    return _run(weights, u, int(m), False, log_z)


def systematic_starts(weights: torch.Tensor, u: torch.Tensor,
                      log_z: Optional[torch.Tensor] = None, *, trigger=None,
                      out=None) -> torch.Tensor:
    """The (B·N,) int32 child-run starts of B clouds (B, N) for the
    uniforms u (B,), M = N: cloud b's run ends shifted by one after a first
    start 0, offset by b·N, as kernel B2 reads them. With ``log_z`` (B,)
    the rows are log-weights whose log-normalizers it holds (the log-domain
    input). A CPU tensor takes the plain version; a CUDA tensor kernel S.
    The starts land in ``out`` (B·N,) when given; with ``trigger`` (an
    int32 (1,) on the weights' device, and ``out``) the call is gated: where
    the trigger reads 0, ``out`` is left as it was.
    ``systematic_starts.launches`` counts the kernel's launches (one a
    pass), both forms', gated ones too; ``systematic_starts.log_rows`` the
    rows launched in the log domain, both forms', on either device."""
    return _run(weights, u, weights.shape[-1], True, log_z, trigger, out)


systematic_starts.launches = 0
systematic_starts.log_rows = 0
