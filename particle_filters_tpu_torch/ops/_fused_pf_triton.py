"""Kernel B1 in Triton: the fused SIR propagate-and-weight step, finished in
one launch.

Replaces ``particle_filters_tpu/ops/fused_pf.py::_fused_kernel`` including
its ``finalize`` branch: the launch leaves the packed moments row
``[log_z, ess, mean (nx), Σw·x⊗x (nx²)]``, the no-resample carry
``(log_z, 0)`` and the resample trigger ``ess < thresh·N``, so no torch op
combines anything after it. This module imports ``triton`` at the top, so
only the CUDA launcher in ``fused_pf.py`` and the Triton members of the
pointwise models import it.

Why Triton and not CUDA C++: the kernel is one elementwise pass with a
reduction, and its model functions are the user's, as they are in the JAX
package, where ``g_vec``/``obs_loglik_vec`` are traced into the Pallas body.
Here they are ``@triton.jit`` functions handed to the kernel as
``tl.constexpr`` arguments, so each model compiles its own kernel; a CUDA
C++ kernel would fix the model when it is compiled.

What bounds it on the H100: bytes. Per particle it reads x (4·nx B) and the
log-weight (4 B) and writes both back, 16 B at nx = 1. The design:

- A persistent grid: a few programs per SM (``programs``), each walking
  tiles of 4·Q particles and carrying its partials online (a tile whose
  maximum log-weight exceeds the running one rescales Σe, Σe², Σe·x and
  Σe·x⊗x by exp(m_old − m_new)), per lane where it can, so a tile costs one
  block-wide reduction at nx = 1. The walk is software-pipelined: every load
  of the next tile is issued before this tile computes, and all of a tile's
  stores come after its loads (a load behind a store to a pointer that may
  alias it waits for the store). Loads and stores are 16 B a thread on
  contiguous particles.
- Four normals per Philox call: one Philox4x32-10 call (``tl.randint4x``,
  the call ``tl.randn4x`` makes) keyed on (step seed, global quarter index)
  gives two uniform pairs (on a rank of a sharded filter the tile index and
  the quarter count are global: the shard's first tile ``tile0`` and the
  whole cloud's ``nq``, so S ranks draw the normals one launch over all N
  particles would, where each rank's count is a multiple of the tile), and both Box-Muller outputs of each pair are
  used: the tile's four quarters take one normal each. Triton's ``tl.randn``
  spends one Philox call on every normal. The Box-Muller transform runs on
  the card's approximate ``lg2``/``sin``/``cos`` (``.approx.ftz.f32``,
  absolute error about 1e-6 on (−π, π)): with libdevice's accurate
  functions (``tl.randn4x``) the kernel took about 3 µs more at N = 2²⁰
  than with injected normals, and 1 µs more with these (PERF.md).
- The finish in the last program: every program writes its partials row
  ``[m, Σe, Σe², Σe·x, Σe·x⊗x]`` and takes a ticket from the caller's
  int32 counter (an acq_rel atomic after a block barrier). The program that
  draws the last ticket reads all rows past L1 (``.cg``), combines them in
  program order (deterministic, no float atomics; the algebra of
  ``fused_pf._combine_partials``), writes the row, the carry and the
  trigger, and sets the counter back to 0 for the next launch or graph
  replay.
- Deciding on the card (``DECIDE``, the fused SIR filter's captured run): the
  kernel loads its Philox seed from the run's seeds on the device, reads its
  particles from the resample's buffer where ``off_u`` flags a resample (one
  pointer select a program, no copy), and its finish writes the next step's
  ``off_u`` in place of the carry: (0, 1) where the trigger is set, (log_z, 0)
  otherwise, the value the host chooses on the eager path. Nothing of the
  step then needs the host, so a run of steps can be captured.

Model functions take ``(x, rows, p_ptr, NX)`` (``g``, returning the
propagated (NXP, Q) tile) and ``(x, rows, z_ptr, p_ptr, NX)``
(``obs_loglik``, returning (Q,)): ``x`` is an (NXP, Q) particle tile, NXP
the power of two ≥ nx, ``rows`` the (NXP, 1) row index, ``p_ptr`` the
model's scalars and ``z_ptr`` the observation.
"""

from __future__ import annotations

import math

import torch
import triton
import triton.language as tl

NUM_WARPS = 4
_LN2 = tl.constexpr(0.6931471805599453)
_TWO_PI = tl.constexpr(6.283185307179586)


@triton.jit
def _row(x, rows, i):
    """Row ``i`` of an (NXP, Q) tile as a (Q,) vector."""
    return tl.sum(tl.where(rows == i, x, 0.0), axis=0)


@triton.jit
def _lg2_approx(x):
    return tl.inline_asm_elementwise("lg2.approx.ftz.f32 $0, $1;", "=f,f", [x],
                                     dtype=tl.float32, is_pure=True, pack=1)


@triton.jit
def _sin_approx(x):
    return tl.inline_asm_elementwise("sin.approx.ftz.f32 $0, $1;", "=f,f", [x],
                                     dtype=tl.float32, is_pure=True, pack=1)


@triton.jit
def _cos_approx(x):
    return tl.inline_asm_elementwise("cos.approx.ftz.f32 $0, $1;", "=f,f", [x],
                                     dtype=tl.float32, is_pure=True, pack=1)


@triton.jit
def _box_muller(i1, i2):
    """Two independent normals from two uint32 words (the angle taken in
    (−π, π), where the approximate sine and cosine are accurate)."""
    u1 = tl.maximum(1.0e-7, tl.uint_to_uniform_float(i1))
    theta = _TWO_PI * (tl.uint_to_uniform_float(i2) - 0.5)
    r = tl.sqrt(-2.0 * _LN2 * _lg2_approx(u1))
    return r * _cos_approx(theta), r * _sin_approx(theta)


@triton.jit
def _randn4(seed, offset):
    """Four normals from one Philox4x32-10 call per offset."""
    i1, i2, i3, i4 = tl.randint4x(seed, offset)
    n1, n2 = _box_muller(i1, i2)
    n3, n4 = _box_muller(i3, i4)
    return n1, n2, n3, n4


@triton.jit
def _load_rows(ptr, rows, cols, n, NX: tl.constexpr):
    """The (NXP, Q) tile of an (nx, N) row-major array at particles ``cols``."""
    mask = (rows < NX) & (cols < n)[None, :]
    return tl.load(ptr + rows * n + cols[None, :], mask=mask, other=0.0)


@triton.jit
def _store_rows(ptr, val, rows, cols, n, NX: tl.constexpr):
    mask = (rows < NX) & (cols < n)[None, :]
    tl.store(ptr + rows * n + cols[None, :], val, mask=mask)


@triton.jit
def _propagate(x, lw, eps, cols, rows, n, z_ptr, lq_ptr, p_ptr, off, uniform, log_n,
               NX: tl.constexpr, G: tl.constexpr, OBS_LL: tl.constexpr):
    """Propagate and weight Q loaded particles; returns x' (0 off the tile)
    and lw' (−inf off the tile). No load or store of the particle arrays."""
    cmask = cols < n
    # x' = g(x) + Lq·ε, Lq lower-triangular (nx ≤ 10), unrolled by column.
    noise = tl.zeros_like(x)
    for j in tl.static_range(NX):
        lq_col = tl.load(lq_ptr + rows * NX + j, mask=rows < NX, other=0.0)
        noise += lq_col * _row(eps, rows, j)[None, :]
    x_new = G(x, rows, p_ptr, NX) + noise
    # Lazy normalization: the carried log-weight minus the pending log-Z,
    # or the implicit uniform −log N right after a resample.
    lw_in = tl.where(uniform > 0.5, -log_n, lw - off)
    lw_new = lw_in + OBS_LL(x_new, rows, z_ptr, p_ptr, NX)
    return (tl.where((rows < NX) & cmask[None, :], x_new, 0.0),
            tl.where(cmask, lw_new, float("-inf")))


@triton.jit
def _load_tile(x_ptr, lw_ptr, rows, ca, n, Q: tl.constexpr, NX: tl.constexpr):
    """The four quarters of a tile, from particle ``ca[0]`` on: x and lw."""
    return (_load_rows(x_ptr, rows, ca, n, NX), _load_rows(x_ptr, rows, ca + Q, n, NX),
            _load_rows(x_ptr, rows, ca + 2 * Q, n, NX),
            _load_rows(x_ptr, rows, ca + 3 * Q, n, NX),
            tl.load(lw_ptr + ca, mask=ca < n, other=0.0),
            tl.load(lw_ptr + ca + Q, mask=ca + Q < n, other=0.0),
            tl.load(lw_ptr + ca + 2 * Q, mask=ca + 2 * Q < n, other=0.0),
            tl.load(lw_ptr + ca + 3 * Q, mask=ca + 3 * Q < n, other=0.0))


@triton.jit
def _load_eps_tile(eps_ptr, rows, ca, n, Q: tl.constexpr, NX: tl.constexpr):
    return (_load_rows(eps_ptr, rows, ca, n, NX), _load_rows(eps_ptr, rows, ca + Q, n, NX),
            _load_rows(eps_ptr, rows, ca + 2 * Q, n, NX),
            _load_rows(eps_ptr, rows, ca + 3 * Q, n, NX))


@triton.jit
def _exx_tile(xa, ea, xb, eb, xc, ec, xd, ed, rows, ri,
              NX: tl.constexpr, NXP: tl.constexpr):
    """Σ e·x⊗x over the four quarters as an (NXP, NXP) tile."""
    out = tl.zeros((NXP, NXP), dtype=tl.float32)
    for i in tl.static_range(NX):
        xe_i = (xa * (ea * _row(xa, rows, i))[None, :] + xb * (eb * _row(xb, rows, i))[None, :]
                + xc * (ec * _row(xc, rows, i))[None, :] + xd * (ed * _row(xd, rows, i))[None, :])
        out += tl.where(ri[:, None] == i, tl.sum(xe_i, axis=1)[None, :], 0.0)
    return out


@triton.jit(do_not_specialize=["seed"])
def _fused_step_kernel(
    x_ptr, lw_ptr, z_ptr, off_ptr, lq_ptr, p_ptr, eps_ptr, xr_ptr, seed_ptr,
    x_out_ptr, lw_out_ptr, part_ptr, row_ptr, carry_ptr, trig_ptr, count_ptr,
    seed, n, n_tiles, tile0, nq, log_n, thresh_n,
    NX: tl.constexpr, NXP: tl.constexpr, Q: tl.constexpr, PART_W: tl.constexpr,
    NXXP: tl.constexpr, FINISH: tl.constexpr, G: tl.constexpr,
    OBS_LL: tl.constexpr, READ_EPS: tl.constexpr, DECIDE: tl.constexpr,
):
    pid = tl.program_id(0)
    nprog = tl.num_programs(0)
    rows = tl.arange(0, NXP)[:, None]
    ri = tl.arange(0, NXP)
    lanes = tl.arange(0, Q)
    # Philox offsets per state row: one per (global tile, lane), nq a row.
    off = tl.load(off_ptr)
    uniform = tl.load(off_ptr + 1)
    if DECIDE:  # the seed from the run's seeds; after a resample, its particles
        seed = tl.load(seed_ptr)
        x_ptr = tl.where(uniform > 0.5, xr_ptr, x_ptr)

    zero = tl.sum(tl.zeros((2,), dtype=tl.float32), axis=0)
    m_run = zero - float("inf")
    # Per-lane sums, rescaled with the running maximum and reduced once at
    # the end; Σe·x⊗x is reduced per tile (its (NXP, NXP, Q) lanes would not fit).
    s_run = tl.zeros((Q,), dtype=tl.float32)
    s2_run = tl.zeros((Q,), dtype=tl.float32)
    ex_run = tl.zeros((NXP, Q), dtype=tl.float32)
    exx_run = tl.zeros((NXP, NXP), dtype=tl.float32)
    # The loop is software-pipelined: the next tile's loads are in flight
    # while this tile computes (a tile past the end loads nothing: masked).
    xa, xb, xc, xd, la, lb, lc, ld = _load_tile(x_ptr, lw_ptr, rows, pid * (4 * Q) + lanes,
                                                n, Q, NX)
    if READ_EPS:  # test hook: normals from a tensor
        ea_n, eb_n, ec_n, ed_n = _load_eps_tile(eps_ptr, rows, pid * (4 * Q) + lanes, n, Q, NX)
    for tile in range(pid, n_tiles, nprog):
        ca = tile * (4 * Q) + lanes
        nxt = ca + nprog * (4 * Q)
        xa_n, xb_n, xc_n, xd_n, la_n, lb_n, lc_n, ld_n = _load_tile(x_ptr, lw_ptr, rows, nxt,
                                                                    n, Q, NX)
        if READ_EPS:
            e0, e1, e2, e3 = ea_n, eb_n, ec_n, ed_n
            ea_n, eb_n, ec_n, ed_n = _load_eps_tile(eps_ptr, rows, nxt, n, Q, NX)
        else:  # one Philox call, four normals: one per quarter
            e0, e1, e2, e3 = _randn4(seed, rows * nq + (tile0 + tile) * Q + lanes[None, :])
        xa, la = _propagate(xa, la, e0, ca, rows, n, z_ptr, lq_ptr, p_ptr, off, uniform,
                            log_n, NX, G, OBS_LL)
        xb, lb = _propagate(xb, lb, e1, ca + Q, rows, n, z_ptr, lq_ptr, p_ptr, off, uniform,
                            log_n, NX, G, OBS_LL)
        xc, lc = _propagate(xc, lc, e2, ca + 2 * Q, rows, n, z_ptr, lq_ptr, p_ptr, off,
                            uniform, log_n, NX, G, OBS_LL)
        xd, ld = _propagate(xd, ld, e3, ca + 3 * Q, rows, n, z_ptr, lq_ptr, p_ptr, off,
                            uniform, log_n, NX, G, OBS_LL)
        _store_rows(x_out_ptr, xa, rows, ca, n, NX)
        _store_rows(x_out_ptr, xb, rows, ca + Q, n, NX)
        _store_rows(x_out_ptr, xc, rows, ca + 2 * Q, n, NX)
        _store_rows(x_out_ptr, xd, rows, ca + 3 * Q, n, NX)
        tl.store(lw_out_ptr + ca, la, mask=ca < n)
        tl.store(lw_out_ptr + ca + Q, lb, mask=ca + Q < n)
        tl.store(lw_out_ptr + ca + 2 * Q, lc, mask=ca + 2 * Q < n)
        tl.store(lw_out_ptr + ca + 3 * Q, ld, mask=ca + 3 * Q < n)

        # Online partials: rescale the running sums to the new maximum.
        m_new = tl.maximum(m_run, tl.max(tl.maximum(tl.maximum(la, lb),
                                                    tl.maximum(lc, ld)), axis=0))
        m_ref = tl.where(m_new > float("-inf"), m_new, 0.0)  # all −inf: e = 0, not NaN
        c = tl.exp(m_run - m_ref)
        ea = tl.exp(la - m_ref)
        eb = tl.exp(lb - m_ref)
        ec = tl.exp(lc - m_ref)
        ed = tl.exp(ld - m_ref)
        s_run = s_run * c + (ea + eb + ec + ed)
        s2_run = s2_run * (c * c) + (ea * ea + eb * eb + ec * ec + ed * ed)
        ex_run = ex_run * c + (xa * ea[None, :] + xb * eb[None, :] + xc * ec[None, :]
                               + xd * ed[None, :])
        exx_run = exx_run * c + _exx_tile(xa, ea, xb, eb, xc, ec, xd, ed, rows, ri, NX, NXP)
        m_run = m_new
        xa, xb, xc, xd, la, lb, lc, ld = xa_n, xb_n, xc_n, xd_n, la_n, lb_n, lc_n, ld_n

    # This program's partials row: [m, Σe, Σe², Σe·x (nx), Σe·x⊗x (nx²)].
    base_p = part_ptr + pid * PART_W
    tl.store(base_p, tl.where(m_run > float("-inf"), m_run, 0.0))
    tl.store(base_p + 1, tl.sum(s_run, axis=0))
    tl.store(base_p + 2, tl.sum(s2_run, axis=0))
    tl.store(base_p + 3 + ri, tl.sum(ex_run, axis=1), mask=ri < NX)
    tl.store(base_p + 3 + NX + ri[:, None] * NX + ri[None, :], exx_run,
             mask=(ri[:, None] < NX) & (ri[None, :] < NX))
    tl.debug_barrier()  # every thread's row stores precede the release below
    ticket = tl.atomic_add(count_ptr, 1, sem="acq_rel")
    if ticket == nprog - 1:  # the last program: every row is written
        tl.debug_barrier()
        fr = tl.arange(0, FINISH)
        cx = tl.arange(0, NXXP)
        # One pass over the rows in program order, each lane rescaling its
        # sums to its running maximum; then the lanes, to the global one.
        m_l = tl.full((FINISH,), float("-inf"), dtype=tl.float32)
        z_l = tl.zeros((FINISH,), dtype=tl.float32)
        w2_l = tl.zeros((FINISH,), dtype=tl.float32)
        ex_l = tl.zeros((FINISH, NXP), dtype=tl.float32)
        exx_l = tl.zeros((FINISH, NXXP), dtype=tl.float32)
        for r0 in range(0, nprog, FINISH):
            r = r0 + fr
            rmask = r < nprog
            rp = part_ptr + r * PART_W
            mv = tl.load(rp, mask=rmask, other=float("-inf"), cache_modifier=".cg")
            sv = tl.load(rp + 1, mask=rmask, other=0.0, cache_modifier=".cg")
            e2v = tl.load(rp + 2, mask=rmask, other=0.0, cache_modifier=".cg")
            exv = tl.load(rp[:, None] + 3 + ri[None, :],
                          mask=rmask[:, None] & (ri[None, :] < NX), other=0.0,
                          cache_modifier=".cg")
            exxv = tl.load(rp[:, None] + 3 + NX + cx[None, :],
                           mask=rmask[:, None] & (cx[None, :] < NX * NX), other=0.0,
                           cache_modifier=".cg")
            m_new = tl.maximum(m_l, mv)
            m_ref = tl.where(m_new > float("-inf"), m_new, 0.0)
            a = tl.exp(m_l - m_ref)
            b = tl.exp(mv - m_ref)
            z_l = z_l * a + sv * b
            w2_l = w2_l * (a * a) + e2v * (b * b)
            ex_l = ex_l * a[:, None] + exv * b[:, None]
            exx_l = exx_l * a[:, None] + exxv * b[:, None]
            m_l = m_new
        m_g = tl.max(m_l, axis=0)
        scale = tl.exp(m_l - m_g)  # 0 on lanes that held no row
        z_acc = z_l * scale
        w2_acc = w2_l * (scale * scale)
        ex_acc = ex_l * scale[:, None]
        exx_acc = exx_l * scale[:, None]
        z = tl.sum(z_acc, axis=0)
        log_z = m_g + tl.log(tl.maximum(z, 1e-30))
        ess = (z * z) / tl.maximum(tl.sum(w2_acc, axis=0), 1e-30)
        tl.store(row_ptr, log_z)
        tl.store(row_ptr + 1, ess)
        tl.store(row_ptr + 2 + ri, tl.sum(ex_acc, axis=0) / z, mask=ri < NX)
        tl.store(row_ptr + 2 + NX + cx, tl.sum(exx_acc, axis=0) / z, mask=cx < NX * NX)
        resample = ess < thresh_n
        if DECIDE:  # the next step's off_u: uniform after a resample, else log Z pending
            tl.store(carry_ptr, tl.where(resample, zero, log_z))
            tl.store(carry_ptr + 1, tl.where(resample, zero + 1.0, zero))
        else:
            tl.store(carry_ptr, log_z)
            tl.store(carry_ptr + 1, zero)
        tl.store(trig_ptr, resample.to(tl.int32))
        tl.store(count_ptr, 0)  # clean for the next launch or graph replay


def quarter(nx: int) -> int:
    """Particles per quarter tile: 16 B a thread at nx = 1 (4 floats × 32
    lanes × NUM_WARPS), fewer as the (NXP, Q) tile grows."""
    nxp = triton.next_power_of_2(nx)
    return max(32, 4 * 32 * NUM_WARPS // nxp)


def finish_rows(nx: int) -> int:
    """Partials rows the finishing program reads at once: 512 at nx = 1,
    fewer as a row grows."""
    return max(32, 512 // triton.next_power_of_2(nx * nx))


def launch(x, lw, off_u, z, lq, params, eps, model, seed, thresh_n,
           x_out, lw_out, row_out, carry_out, trigger, counter, part, programs,
           shard=(0, 1), x_res=None, seeds=None):
    """Enqueue one B1 launch on the current stream of ``x``'s device, on at
    most ``programs`` programs (``part`` holds a row for each), as rank
    ``shard[0]`` of ``shard[1]`` of a cloud of ``shard[1]·N`` particles.
    With ``seeds`` (a device tensor whose first entry is the step's seed;
    ``seed`` is then not read) the launch decides on the card (the module's
    note): after a resample it reads its particles from ``x_res`` and its
    finish writes the next step's ``off_u`` into ``carry_out``.
    Returns the number of programs launched (the partials rows written)."""
    nx, n = x.shape
    rank, ranks = shard
    q = quarter(nx)
    n_tiles = triton.cdiv(n, 4 * q)
    grid = (min(n_tiles, programs),)
    with torch.cuda.device(x.device):
        _fused_step_kernel[grid](
            x, lw, z, off_u, lq, params, x if eps is None else eps,
            x if x_res is None else x_res, x if seeds is None else seeds,
            x_out, lw_out, part, row_out, carry_out, trigger, counter,
            seed, n, n_tiles, rank * n_tiles, ranks * n_tiles * q, math.log(n * ranks),
            thresh_n,
            NX=nx, NXP=triton.next_power_of_2(nx), Q=q, PART_W=part.shape[1],
            NXXP=triton.next_power_of_2(nx * nx), FINISH=finish_rows(nx),
            G=model.g_tl, OBS_LL=model.obs_loglik_tl, READ_EPS=eps is not None,
            DECIDE=seeds is not None, num_warps=NUM_WARPS,
        )
    return grid[0]


# --- Triton members of the shipped pointwise models (ops/fused_pf.py) ------
@triton.jit
def sv_g(x, rows, p_ptr, NX: tl.constexpr):
    """SV transition mean α·x; p = (α, β)."""
    return tl.load(p_ptr) * x


@triton.jit
def sv_obs_loglik(x, rows, z_ptr, p_ptr, NX: tl.constexpr):
    """log p(z | x) + const for z ~ N(0, β² eˣ); p = (α, β). Spelled
    −½(z²/β²·e⁻ˣ + x + 2 log β): no log and no division a particle."""
    x0 = _row(x, rows, 0)
    z0 = tl.load(z_ptr)
    beta = tl.load(p_ptr + 1)
    return -0.5 * ((z0 * z0 / (beta * beta)) * tl.exp(-x0) + x0 + 2.0 * tl.log(beta))


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
