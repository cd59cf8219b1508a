"""Kernel B1 in Triton: the fused SIR propagate-and-weight step.

Replaces ``particle_filters_tpu/ops/fused_pf.py::_fused_kernel``. This module
imports ``triton`` at the top, so only the CUDA launcher in ``fused_pf.py``
and the Triton members of the pointwise models import it.

Why Triton and not CUDA C++: the kernel is one elementwise pass with a
per-program reduction, and its model functions are the user's, as they are
in the JAX package, where ``g_vec``/``obs_ll_vec`` are traced into the
Pallas body. Here they are ``@triton.jit`` functions handed to the kernel as
``tl.constexpr`` arguments, so each model compiles its own kernel; a CUDA
C++ kernel would fix the model when it is compiled.

What bounds it on the H100: bytes. Per particle it reads x (4·nx B) and the
log-weight (4 B) and writes both back, 16 B at nx = 1, against a few dozen
flops (Philox, Box-Muller, one exp and the model); the per-program partials
row is a few bytes per 1024 particles. The design moves nothing else: the
normals are drawn in registers, the lazy-normalization scalars (pending
log-Z, uniform flag) are folded into the load, and the weight moments
leave as one row per program that ``_combine_partials`` folds in torch.

Model functions take ``(x, rows, p_ptr, NX)`` (``g``, returning the
propagated (NXP, BLOCK) tile) and ``(x, rows, z_ptr, p_ptr, NX)``
(``obs_loglik``, returning (BLOCK,)): ``x`` is the (NXP, BLOCK) particle tile,
NXP the power of two ≥ nx, ``rows`` the (NXP, 1) row index, ``p_ptr`` the
model's scalars and ``z_ptr`` the observation.
"""

from __future__ import annotations

import math

import torch
import triton
import triton.language as tl


@triton.jit
def _row(x, rows, i):
    """Row ``i`` of an (NXP, BLOCK) tile as a (BLOCK,) vector."""
    return tl.sum(tl.where(rows == i, x, 0.0), axis=0)


@triton.jit(do_not_specialize=["seed"])
def _fused_step_kernel(
    x_ptr, lw_ptr, z_ptr, off_ptr, lq_ptr, p_ptr, eps_ptr,
    x_out_ptr, lw_out_ptr, part_ptr,
    seed, n, log_n,
    NX: tl.constexpr, NXP: tl.constexpr, BLOCK: tl.constexpr,
    PART_W: tl.constexpr, G: tl.constexpr, OBS_LL: tl.constexpr,
    READ_EPS: tl.constexpr,
):
    pid = tl.program_id(0)
    cols = pid * BLOCK + tl.arange(0, BLOCK)  # global particle index
    rows = tl.arange(0, NXP)[:, None]
    cmask = cols < n
    mask2 = (rows < NX) & cmask[None, :]
    offs2 = rows * n + cols[None, :]  # (nx, N) row-major layout

    x = tl.load(x_ptr + offs2, mask=mask2, other=0.0)
    if READ_EPS:  # test hook: normals from a tensor
        eps = tl.load(eps_ptr + offs2, mask=mask2, other=0.0)
    else:  # Philox keyed on (step seed, global element index)
        eps = tl.randn(seed, offs2)

    # x' = g(x) + Lq·ε, Lq lower-triangular (nx ≤ 10), unrolled by column.
    noise = tl.zeros((NXP, BLOCK), dtype=tl.float32)
    for j in tl.static_range(NX):
        lq_col = tl.load(lq_ptr + rows * NX + j, mask=rows < NX, other=0.0)
        noise += lq_col * _row(eps, rows, j)[None, :]
    x_new = G(x, rows, p_ptr, NX) + noise
    tl.store(x_out_ptr + offs2, x_new, mask=mask2)

    # Lazy normalization: the carried log-weight minus the pending log-Z,
    # or the implicit uniform −log N right after a resample.
    off = tl.load(off_ptr)
    uniform = tl.load(off_ptr + 1)
    lw_in = tl.load(lw_ptr + cols, mask=cmask, other=0.0)
    lw_in = tl.where(uniform > 0.5, -log_n, lw_in - off)
    lw = lw_in + OBS_LL(x_new, rows, z_ptr, p_ptr, NX)
    tl.store(lw_out_ptr + cols, lw, mask=cmask)

    # Partials row: [max, Σe, Σe², Σe·x (nx), Σe·x⊗x (nx²)], e = exp(lw − max).
    m = tl.max(tl.where(cmask, lw, float("-inf")), axis=0)
    m = tl.where(m > float("-inf"), m, 0.0)  # all −inf block: e = 0, not NaN
    e = tl.where(cmask, tl.exp(lw - m), 0.0)
    xe = tl.where(mask2, x_new * e[None, :], 0.0)
    xm = tl.where(mask2, x_new, 0.0)
    base = part_ptr + pid * PART_W
    tl.store(base, m)
    tl.store(base + 1, tl.sum(e, axis=0))
    tl.store(base + 2, tl.sum(e * e, axis=0))
    r_idx = tl.arange(0, NXP)
    tl.store(base + 3 + r_idx, tl.sum(xe, axis=1), mask=r_idx < NX)
    for i in tl.static_range(NX):
        exx_i = tl.sum(xe * _row(xm, rows, i)[None, :], axis=1)
        tl.store(base + 3 + NX + i * NX + r_idx, exx_i, mask=r_idx < NX)


def launch(x, lw, off_u, z, lq, params, eps, model, seed, x_out, lw_out, part, block):
    """Enqueue one B1 launch on the current stream of ``x``'s device."""
    nx, n = x.shape
    grid = (triton.cdiv(n, block),)
    with torch.cuda.device(x.device):
        _fused_step_kernel[grid](
            x, lw, z, off_u, lq, params, x if eps is None else eps,
            x_out, lw_out, part,
            seed, n, math.log(n),
            NX=nx, NXP=triton.next_power_of_2(nx), BLOCK=block,
            PART_W=part.shape[1], G=model.g_tl, OBS_LL=model.obs_loglik_tl,
            READ_EPS=eps is not None,
            num_warps=4,
        )


# --- Triton members of the shipped pointwise models (ops/fused_pf.py) ------
@triton.jit
def sv_g(x, rows, p_ptr, NX: tl.constexpr):
    """SV transition mean α·x; p = (α, β)."""
    return tl.load(p_ptr) * x


@triton.jit
def sv_obs_loglik(x, rows, z_ptr, p_ptr, NX: tl.constexpr):
    """log p(z | x) + const for z ~ N(0, β² eˣ); p = (α, β)."""
    x0 = _row(x, rows, 0)
    z0 = tl.load(z_ptr)
    beta = tl.load(p_ptr + 1)
    var = beta * beta * tl.exp(x0)
    return -0.5 * (z0 * z0 / var + tl.log(var))


@triton.jit
def linear_g(x, rows, p_ptr, NX: tl.constexpr):
    """x' = A·x with A (nx, nx) row-major in p[: nx²]."""
    out = tl.zeros_like(x)
    for j in tl.static_range(NX):
        a_col = tl.load(p_ptr + rows * NX + j, mask=rows < NX, other=0.0)
        out += a_col * _row(x, rows, j)[None, :]
    return out


@triton.jit
def linear_obs_first_loglik(x, rows, z_ptr, p_ptr, NX: tl.constexpr):
    """−(z − x[0])² / 2r with r = p[nx²]."""
    d = tl.load(z_ptr) - _row(x, rows, 0)
    return -0.5 * d * d / tl.load(p_ptr + NX * NX)
