"""The Sinkhorn resampler's dual loop and projection as tile kernels that
form the cost in registers (``csrc/sinkhorn_tile.cu``).

Replaces no TPU kernel: the JAX package's Sinkhorn is plain ``jnp``. On the
card it replaces the dense path of ``resampling/ot.py``, which forms the
N × N cost and makes ~5 read-and-write passes over N × N f32 a half-update
(~3.2 GB at N = 8192), where the work needs the N-long cloud and
potentials. What bounds the kernels: the N² exponentials of a pass (the
SFU's 16 a clock an SM). The source's note says what the design does about
it.

The algebra both versions share, with k = log₂e / ε (rounded to f32) and
the arguments in base 2:

- half-update: out_i = (1 − δ)·p_i − δ·(max_i + log₂ Σ_j 2^(a_ij − max_i)) / k,
  a_ij = k·(h_j − C_ij), h = g + ε log b and p = f for τ_f, h = f_new + ε log a
  and p = g for τ_g (the cost is symmetric); the cost from x̃ = √k·x;
- projection: x'_j = 2^(k·g_j + max_j) · Σ_i 2^(a_ij − max_j) x̃_i / √k,
  a_ij = k·(h_i − C_ij), h = f + ε log a: the plan (Pᵀx)_j / b_j;
- every pass takes k·C as Σ_d (x̃_id − x̃_jd)², so the rounding of √k² against
  k scales the cost of the whole problem alike (ε off by ~1e-7 of itself);
- each row's max runs over column tiles of :data:`TILE`, its sum rescaled
  at each tile (the flash-attention recurrence).

:func:`sinkhorn_tile` runs the whole fixed-count dual loop in one call of
the library (2·``n_iters`` launches on the current stream, no sync);
:func:`tile_projection` the projection (one launch). Both take CUDA
tensors only and raise on anything else; ``resampling/ot.py`` decides
which path a call takes. :func:`sinkhorn_tile_reference` is the plain
version: the same algebra in PyTorch, on any device.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from particle_filters_tpu_torch.ops._nvcc import Kernel

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DUAL = Kernel("Sinkhorn tile kernel", "pf_sinkhorn_tile", ("sinkhorn_tile.cu",),
               "pf_sinkhorn_dual", (_P,) * 6 + (_I,) * 3 + (_F,) * 4)
_PROJECT = Kernel("Sinkhorn projection kernel", "pf_sinkhorn_tile", ("sinkhorn_tile.cu",),
                  "pf_sinkhorn_project", (_P,) * 5 + (_I,) * 2 + (_F,) * 3)
TILE = 32  # columns a running-max step: kChunk in csrc/sinkhorn_tile.cu
MAX_D = 4  # dimensions the kernels take: kMaxD
LOG2E = 1.4426950408889634
# What bounds a pass: N² exponentials on the SFU, 16 a clock on each of the
# H100's 132 SMs at 1.98 GHz (the clock behind its 67 TFLOP/s f32 peak).
SFU_EXP_PER_S = 132 * 16 * 1.98e9


def scales(epsilon: float) -> tuple[float, float, float]:
    """``(ε, k, √k)`` as float32 values, k = log₂e / ε: the numbers both
    versions compute with."""
    eps = float(np.float32(epsilon))
    k = float(np.float32(LOG2E / eps))
    return eps, k, float(np.float32(math.sqrt(k)))


def launches(n_iters: int) -> int:
    """The launches of one resample: 2 a dual iteration (τ_f, τ_g), one
    projection."""
    return 2 * n_iters + 1


# --- the plain version ----------------------------------------------------------


def _running_lse2(args_of, n: int, rows, values=None, tile: int = TILE):
    """Each row's (max, Σ 2^(a − max) · v) over n columns in tiles, for the
    rows of the tensor ``rows``: ``args_of(cols)`` gives a (rows,
    len(cols)) tile of base-2 arguments, and ``values`` (n, m), if given,
    weights the sum (else ones)."""
    top = rows.new_full((rows.shape[0],), -math.inf)
    width = 1 if values is None else values.shape[1]
    acc = rows.new_zeros((rows.shape[0], width))
    for c0 in range(0, n, tile):
        cols = slice(c0, min(c0 + tile, n))
        a = args_of(cols)
        new_top = torch.maximum(top, a.amax(dim=1))
        shift = torch.where(new_top == -math.inf, torch.zeros_like(new_top), new_top)
        e = torch.exp2(a - shift[:, None])
        part = e.sum(dim=1, keepdim=True) if values is None else e @ values[cols]
        acc = acc * torch.exp2(top - shift)[:, None] + part
        top = new_top
    return top, acc


def _args(xt, s, cols):
    """The base-2 arguments s_j − Σ_d (x̃_id − x̃_jd)² of every row against
    the columns ``cols``."""
    return s[None, cols] - torch.sum((xt[:, None, :] - xt[None, cols, :]) ** 2, dim=-1)


def _half_update(xt, pot, logm, prev, eps, k, damping, tile):
    s = k * (pot + eps * logm)
    top, acc = _running_lse2(lambda cols: _args(xt, s, cols), xt.shape[0], xt, tile=tile)
    tau = -(top + torch.log2(acc[:, 0])) / k
    return (1.0 - damping) * prev + damping * tau


def sinkhorn_tile_reference(particles, log_a, log_b, *, epsilon: float, n_iters: int,
                            damping: float, tile: int = TILE):
    """Plain version of :func:`sinkhorn_tile` and :func:`tile_projection`:
    ``(f, g, new_particles, deltas)`` from the cloud (N, d) and the log
    masses, the kernels' algebra in PyTorch at their column-tile width
    (module docstring); ``deltas`` (n_iters,) the largest change of f or g
    in each iteration."""
    eps, k, xs = scales(epsilon)
    xt = particles * xs
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_a)
    deltas = []
    for _ in range(n_iters):
        f_new = _half_update(xt, g, log_b, f, eps, k, damping, tile)
        g_new = _half_update(xt, f_new, log_a, g, eps, k, damping, tile)
        deltas.append(torch.maximum(torch.amax(torch.abs(f_new - f)),
                                    torch.amax(torch.abs(g_new - g))))
        f, g = f_new, g_new
    s = k * (f + eps * log_a)
    top, acc = _running_lse2(lambda cols: _args(xt, s, cols), xt.shape[0], xt, values=xt,
                             tile=tile)
    norm = torch.exp2(k * g.double() + top.double()).to(xt.dtype)  # one rounding: an FMA
    history = torch.stack(deltas) if deltas else log_a.new_zeros((0,))
    return f, g, norm[:, None] * acc / xs, history


# --- the kernels -------------------------------------------------------------------


def _check(particles: torch.Tensor, *vectors: torch.Tensor) -> None:
    if particles.ndim != 2:
        raise ValueError(f"particles must be (N, d); got {tuple(particles.shape)}.")
    n, d = particles.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the Sinkhorn tile kernels take d in [1, {MAX_D}]; got {d}.")
    if n < 1 or n * d >= 2**31:
        raise ValueError(f"need 1 <= N and N·d < 2**31; got {n} x {d}.")
    for t in (particles, *vectors):
        if t.dtype != torch.float32:
            raise TypeError(f"the Sinkhorn tile kernels take float32; got {t.dtype}.")
        if t.device.type != "cuda" or t.device != particles.device:
            raise ValueError(f"the kernels take CUDA tensors on one device; got {t.device}.")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors.")
    for v in vectors:
        if v.shape != (n,):
            raise ValueError(f"expected ({n},) vectors; got {tuple(v.shape)}.")


def sinkhorn_tile(particles, log_a, log_b, *, epsilon: float, n_iters: int, damping: float,
                  deltas: bool = False):
    """The damped dual loop on the card: ``(f, g, history)`` after
    ``n_iters`` iterations from f = g = 0, ``history`` (n_iters,) the
    largest change of f or g in each iteration if ``deltas``, else None.
    One library call, 2·``n_iters`` launches; ``sinkhorn_tile.launches``
    counts them, and :func:`tile_projection`'s."""
    _check(particles, log_a, log_b)
    n, d = particles.shape
    eps, k, xs = scales(epsilon)
    f = log_a.new_empty((n,))
    g = log_a.new_empty((n,))
    history = log_a.new_empty((n_iters,)) if deltas else None
    _DUAL(particles.device, particles.data_ptr(), log_a.data_ptr(), log_b.data_ptr(),
          f.data_ptr(), g.data_ptr(), None if history is None else history.data_ptr(), n, d,
          int(n_iters), eps, k, xs, float(damping))
    sinkhorn_tile.launches += 2 * int(n_iters)
    return f, g, history


sinkhorn_tile.launches = 0


def tile_projection(particles, log_a, f, g, *, epsilon: float):
    """The plan-and-projection pass on the card: x'_j = Σ_i P_ij x_i / b_j
    (N, d) from the potentials. One launch, counted on
    ``sinkhorn_tile.launches``."""
    _check(particles, log_a, f, g)
    n, d = particles.shape
    eps, k, xs = scales(epsilon)
    out = particles.new_empty((n, d))
    _PROJECT(particles.device, particles.data_ptr(), log_a.data_ptr(), f.data_ptr(),
             g.data_ptr(), out.data_ptr(), n, d, eps, k, xs)
    sinkhorn_tile.launches += 1
    return out
