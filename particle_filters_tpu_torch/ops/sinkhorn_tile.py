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
:func:`tile_projection` the projection (one launch). Where a gradient will
be taken the loop also keeps f and g after every iteration and each
half-update's row normalizer k·τ (``saved``: (4·n_iters + 2)·N floats), and
:func:`sinkhorn_tile_vjp` runs the vector-Jacobian product of the loop and
the projection, unrolled through every iteration, in one more call
(4·``n_iters`` + 2 launches: a row pass and a column pass a half-update and
for the projection, each recomputing the plan from the saved vectors; the
source's note has the algebra). All take CUDA tensors only and raise on
anything else; ``resampling/ot.py`` decides which path a call takes.
:func:`sinkhorn_tile_reference` and :func:`sinkhorn_tile_vjp_reference`
are the plain versions: the same algebra in PyTorch, on any device.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from particle_filters_tpu_torch.ops._nvcc import Kernel

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DUAL = Kernel("Sinkhorn tile kernel", "pf_sinkhorn_tile", ("sinkhorn_tile.cu",),
               "pf_sinkhorn_dual", (_P,) * 8 + (_I,) * 3 + (_F,) * 4)
_PROJECT = Kernel("Sinkhorn projection kernel", "pf_sinkhorn_tile", ("sinkhorn_tile.cu",),
                  "pf_sinkhorn_project", (_P,) * 5 + (_I,) * 2 + (_F,) * 3)
_VJP = Kernel("Sinkhorn VJP kernel", "pf_sinkhorn_tile", ("sinkhorn_tile.cu",),
              "pf_sinkhorn_vjp", (_P,) * 11 + (_I,) * 3 + (_F,) * 4)
TILE = 32  # columns a running-max step: kChunk in csrc/sinkhorn_tile.cu
MAX_D = 4  # dimensions the kernels take: kMaxD
LOG2E = 1.4426950408889634
# What bounds a pass: N² exponentials on the SFU, 16 a clock on each of the
# H100's 132 SMs at 1.98 GHz (the clock behind its 67 TFLOP/s f32 peak).
SFU_EXP_PER_S = 132 * 16 * 1.98e9


def scales(epsilon: float, exact: bool = False) -> tuple[float, float, float]:
    """``(ε, k, √k)`` as float32 values, k = log₂e / ε: the numbers both
    versions compute with; with ``exact`` unrounded (the plain versions in
    float64, which then compute the dense path's function)."""
    if exact:
        return float(epsilon), LOG2E / epsilon, math.sqrt(LOG2E / epsilon)
    eps = float(np.float32(epsilon))
    k = float(np.float32(LOG2E / eps))
    return eps, k, float(np.float32(math.sqrt(k)))


def launches(n_iters: int) -> int:
    """The launches of one resample: 2 a dual iteration (τ_f, τ_g), one
    projection."""
    return 2 * n_iters + 1


def vjp_launches(n_iters: int) -> int:
    """The launches of one resample's VJP: a row and a column pass for each
    half-update and for the projection."""
    return 4 * n_iters + 2


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
    """The damped half-update and its rows' k·τ."""
    s = k * (pot + eps * logm)
    top, acc = _running_lse2(lambda cols: _args(xt, s, cols), xt.shape[0], xt, tile=tile)
    t = -(top + torch.log2(acc[:, 0]))
    return (1.0 - damping) * prev + damping * (t / k), t


def sinkhorn_tile_reference(particles, log_a, log_b, *, epsilon: float, n_iters: int,
                            damping: float, tile: int = TILE, keep: bool = False):
    """Plain version of :func:`sinkhorn_tile` and :func:`tile_projection`:
    ``(f, g, new_particles, deltas)`` from the cloud (N, d) and the log
    masses, the kernels' algebra in PyTorch at their column-tile width
    (module docstring); ``deltas`` (n_iters,) the largest change of f or g
    in each iteration. With ``keep``, a fifth item: what the forward saves
    for the VJP, ``(potentials, lse)`` as :func:`sinkhorn_tile` fills them.
    In float64 the scales are unrounded (:func:`scales`)."""
    eps, k, xs = scales(epsilon, exact=particles.dtype == torch.float64)
    xt = particles * xs
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_a)
    deltas, pots, lses = [], [torch.stack([f, g])], []
    for _ in range(n_iters):
        f_new, t_f = _half_update(xt, g, log_b, f, eps, k, damping, tile)
        g_new, t_g = _half_update(xt, f_new, log_a, g, eps, k, damping, tile)
        deltas.append(torch.maximum(torch.amax(torch.abs(f_new - f)),
                                    torch.amax(torch.abs(g_new - g))))
        f, g = f_new, g_new
        pots.append(torch.stack([f, g]))
        lses.append(torch.stack([t_f, t_g]))
    s = k * (f + eps * log_a)
    top, acc = _running_lse2(lambda cols: _args(xt, s, cols), xt.shape[0], xt, values=xt,
                             tile=tile)
    norm = torch.exp2(k * g.double() + top.double()).to(xt.dtype)  # one rounding: an FMA
    history = torch.stack(deltas) if deltas else log_a.new_zeros((0,))
    out = (f, g, norm[:, None] * acc / xs, history)
    if not keep:
        return out
    lse = torch.stack(lses) if lses else log_a.new_zeros((0, 2, log_a.shape[0]))
    return out + ((torch.stack(pots), lse),)


def _cells(xt, own, other, cols):
    """A tile of the plan or of a half-update's softmax, 2^(own_i + other_j
    − Σ_d (x̃_id − x̃_jd)²), no max taken, and the differences x̃_i − x̃_j,
    for every point i against the partners ``cols``."""
    df = xt[:, None, :] - xt[None, cols, :]
    return torch.exp2(own[:, None] + other[None, cols] - torch.sum(df * df, dim=-1)), df


def _sum_cells(xt, own, other, term, tile):
    """Σ over the partners j, a tile at a time, of ``term(e, df, cols)``
    (N, m) for each point i."""
    total = None
    for c0 in range(0, xt.shape[0], tile):
        cols = slice(c0, min(c0 + tile, xt.shape[0]))
        part = term(*_cells(xt, own, other, cols), cols)
        total = part if total is None else total + part
    return total


def sinkhorn_tile_vjp_reference(particles, log_a, log_b, saved, new_particles, grad_out, *,
                                epsilon: float, damping: float, tile: int = TILE):
    """Plain version of :func:`sinkhorn_tile_vjp`: ``(grad_particles,
    grad_log_a)`` of ⟨grad_out, new_particles⟩ through the projection and
    every damped iteration, from ``saved`` = ``(potentials, lse)`` (as
    :func:`sinkhorn_tile_reference` keeps them), the kernels' passes in
    PyTorch over partner tiles of ``tile`` (the source's note has the
    algebra). In float64 the scales are unrounded (:func:`scales`)."""
    eps, k, xs = scales(epsilon, exact=particles.dtype == torch.float64)
    pots, lse = saved
    xt = particles * xs
    ln2 = math.log(2.0)
    half = 2.0 * xs / k  # dτ/dx per unit of π times the scaled difference

    # the projection: Π_ij = 2^(r_i + c_j − k C_ij), r = k (f + ε log a), c = k g
    f, g = pots[-1, 0], pots[-1, 1]
    r, c = k * (f + eps * log_a), k * g
    ybar = grad_out
    vz = _sum_cells(xt, r, c, lambda e, df, cols: torch.cat([
        e @ ybar[cols], torch.sum((e * (xt @ ybar[cols].T))[..., None] * df, dim=1)], 1), tile)
    v, a_sum = vz[:, :xt.shape[1]], vz[:, xt.shape[1]:]
    xv = torch.sum(particles * v, dim=1)
    cot_f, grad_log_a = ln2 * k * xv, ln2 * k * eps * xv
    grad_x = v - 2.0 * ln2 * a_sum
    b_sum = _sum_cells(xt, c, r, lambda e, df, cols: torch.sum(
        (e * (ybar @ xt[cols].T))[..., None] * df, dim=1), tile)
    grad_x = grad_x - 2.0 * ln2 * b_sum
    cot_g = ln2 * k * torch.sum(ybar * new_particles, dim=1)

    def half_vjp(t, h, logm, cot_out, cot_h, keep, cla):
        """One half-update's row and column passes: x-bar, and h-bar as
        ``keep``·h-bar − S (log m-bar −ε S into ``cla`` if given)."""
        nonlocal grad_x
        s = k * (h + eps * logm)
        u = damping * cot_out
        row = _sum_cells(xt, t, s, lambda e, df, cols: torch.sum(e[..., None] * df, dim=1),
                         tile)
        grad_x = grad_x + half * u[:, None] * row
        col = _sum_cells(xt, s, t, lambda e, df, cols: torch.cat([
            e @ u[cols, None], torch.sum((e * u[None, cols])[..., None] * df, dim=1)], 1), tile)
        grad_x = grad_x + half * col[:, 1:]
        return keep * cot_h - col[:, 0], None if cla is None else cla - eps * col[:, 0]

    n_iters = lse.shape[0]
    for it in range(n_iters - 1, -1, -1):
        keep = 1.0 if it == n_iters - 1 else 1.0 - damping
        cot_f, grad_log_a = half_vjp(lse[it, 1], pots[it + 1, 0], log_a, cot_g, cot_f, keep,
                                     grad_log_a)
        cot_g, _ = half_vjp(lse[it, 0], pots[it, 1], log_b, cot_f, cot_g, 1.0 - damping, None)
    return grad_x, grad_log_a


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


def _check_saved(particles, saved, n_iters: int) -> None:
    n = particles.shape[0]
    shapes = ((n_iters + 1, 2, n), (n_iters, 2, n))
    for t, shape in zip(saved, shapes):
        if t.shape != shape or t.dtype != torch.float32 or t.device != particles.device \
                or not t.is_contiguous():
            raise ValueError(f"saved must be contiguous float32 {shapes} on the cloud's "
                             f"device; got {tuple(t.shape)} {t.dtype} on {t.device}.")


def sinkhorn_tile(particles, log_a, log_b, *, epsilon: float, n_iters: int, damping: float,
                  deltas: bool = False, saved=None):
    """The damped dual loop on the card: ``(f, g, history)`` after
    ``n_iters`` iterations from f = g = 0, ``history`` (n_iters,) the
    largest change of f or g in each iteration if ``deltas``, else None.
    ``saved``, if given, is a pair of float32 tensors ((n_iters + 1, 2, N),
    (n_iters, 2, N)) that the same launches fill with f and g after every
    iteration (row 0 zeros) and each half-update's k·τ, what
    :func:`sinkhorn_tile_vjp` reads; f and g are then its last row.
    One library call, 2·``n_iters`` launches; ``sinkhorn_tile.launches``
    counts them, and :func:`tile_projection`'s and :func:`sinkhorn_tile_vjp`'s."""
    _check(particles, log_a, log_b)
    n, d = particles.shape
    eps, k, xs = scales(epsilon)
    if saved is None:
        f, g, pots, lse = log_a.new_empty((n,)), log_a.new_empty((n,)), None, None
    else:
        _check_saved(particles, saved, int(n_iters))
        pots, lse = saved
        f, g = pots[-1, 0], pots[-1, 1]
    history = log_a.new_empty((n_iters,)) if deltas else None
    def ptr(t):
        return None if t is None else t.data_ptr()

    _DUAL(particles.device, particles.data_ptr(), log_a.data_ptr(), log_b.data_ptr(),
          None if pots is not None else f.data_ptr(), None if pots is not None else g.data_ptr(),
          ptr(history), ptr(pots), ptr(lse), n, d, int(n_iters), eps, k, xs, float(damping))
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


def sinkhorn_tile_vjp(particles, log_a, log_b, saved, new_particles, grad_out, *,
                      epsilon: float, damping: float):
    """The VJP of the dual loop and the projection on the card:
    ``(grad_particles (N, d), grad_log_a (N,))`` of ⟨grad_out,
    new_particles⟩, unrolled through every iteration, from ``saved`` as
    :func:`sinkhorn_tile` filled it and the projection's output
    ``new_particles``. One library call, :func:`vjp_launches` launches,
    counted on ``sinkhorn_tile.launches``."""
    _check(particles, log_a, log_b)
    n, d = particles.shape
    n_iters = saved[1].shape[0]
    _check_saved(particles, saved, n_iters)
    for t in (new_particles, grad_out):
        if t.shape != (n, d) or t.dtype != torch.float32 or t.device != particles.device \
                or not t.is_contiguous():
            raise ValueError(f"expected contiguous float32 ({n}, {d}) on the cloud's device; "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}.")
    eps, k, xs = scales(epsilon)
    grad_x = particles.new_empty((n, d))
    grad_log_a, cot_f, cot_g = (log_a.new_empty((n,)) for _ in range(3))
    pots, lse = saved
    _VJP(particles.device, particles.data_ptr(), log_a.data_ptr(), log_b.data_ptr(),
         pots.data_ptr(), lse.data_ptr(), new_particles.data_ptr(), grad_out.data_ptr(),
         grad_x.data_ptr(), grad_log_a.data_ptr(), cot_f.data_ptr(), cot_g.data_ptr(), n, d,
         n_iters, eps, k, xs, float(damping))
    sinkhorn_tile.launches += vjp_launches(n_iters)
    return grad_x, grad_log_a
