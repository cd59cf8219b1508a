"""Port parity of the profiling slice: the prep of the windowed resample
probes, the plain versions of probes X1–X3 against the JAX package's Pallas
probes in interpret mode, the timing utilities and the small-N step
profile, on the CPU. Also: the port's entry points default to the card.

X1 and X2 sum telescoping f32 differences over up to Q·128 terms in another
order than the TPU probes, so their values are held at atol 1e-5 on N(0, 1)
particles, the bar of ``benchmarks/exp_resample_dma.py:175``; ranks, ``a0``
and windows are held exactly. The CUDA kernels' premise is tested here too:
the windows both probes get are sorted, and on them a search and a scan give
what the TPU kernels give, while on shuffled windows they do not. So does
the build key of the CUDA libraries, which covers the shared headers, and
their one call seam (``ops/_nvcc.py::Kernel``): the signature set once, the
stream last, an error that names its kernel, and every wrapper's signature
equal to its C entry point's.
"""

import contextlib
import ctypes
import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks import exp_kernel_var as jkv
from benchmarks import exp_resample_dma as jrd
from particle_filters_tpu.ops import resample_pallas as rp
from particle_filters_tpu.resampling.hard import _systematic_starts as jax_starts
from particle_filters_tpu_torch import FusedSIRFilter, ParticleFilter, simulate_sv_1d
from particle_filters_tpu_torch.benchmarks import _slope
from particle_filters_tpu_torch.benchmarks import exp_kernel_var as tkv
from particle_filters_tpu_torch.benchmarks import exp_resample_dma as trd
from particle_filters_tpu_torch.benchmarks import profile_small_n as tsn
from particle_filters_tpu_torch.interop import params_from_jax, state_from_jax
from particle_filters_tpu_torch.ops import (
    _nvcc,
    launch_probe,
    resample,
    sinkhorn_tile,
    span_resample,
    systematic_starts,
    window_resample,
)
from particle_filters_tpu_torch.ops.fused_pf import SVModel
from particle_filters_tpu_torch.ops.launch_probe import add_one, add_one_reference
from particle_filters_tpu_torch.ops.resample import resample_by_starts_reference
from particle_filters_tpu_torch.ops.resample_blocked import (
    SUB,
    fine_chunks,
    leading_starts,
    rank_window,
)
from particle_filters_tpu_torch.ops.span_resample import (
    Q,
    ROWS,
    SG,
    span_checks,
    span_compare_sum,
    span_compare_sum_reference,
    span_resample_values,
)
from particle_filters_tpu_torch.ops.window_resample import (
    window_compare_sum,
    window_compare_sum_reference,
)
from particle_filters_tpu_torch.resampling.hard import _child_run_ends_u
from particle_filters_tpu_torch.simulators.stochastic_volatility import SV1DResults
from particle_filters_tpu_torch.utils.timing import Timer, profiler_trace

torch.set_num_threads(1)

TOL = 1e-5  # f32 telescoping sums in two orders (module note)


def _weights(n, case, rng):
    if case == "point mass":
        w = np.zeros(n)
        w[n // 3] = 1.0
    elif case == "desert":  # relative weight 1e-3 on the first half
        w = np.where(np.arange(n) < n // 2, 1e-3, 1.0)
    else:
        w = np.exp(float(case) * rng.standard_normal(n))
    return (w / w.sum()).astype(np.float32)


def _inputs(n, case="1.0", seed=0):
    """numpy-made weights, uniform and N(0, 1) particles; the child-run
    starts of systematic resampling (int32 torch) and the particles."""
    rng = np.random.default_rng(seed)
    w = _weights(n, case, rng)
    u = np.float32(rng.random())
    p = rng.standard_normal((n, 1)).astype(np.float32)
    t = _child_run_ends_u(torch.from_numpy(w), n, torch.tensor(u))
    starts = torch.cat([t.new_zeros(1), t[:-1]])
    return starts, torch.from_numpy(p)


# --- the prep: leading starts, rank_window, windows -------------------------
@pytest.mark.parametrize("case", ["1.0", "3.0", "point mass"])
@pytest.mark.parametrize("n", [3000, 16384])  # 3000: a ragged last sub-group
def test_rank_window_matches_jax(n, case):
    starts, _ = _inputs(n, case)
    n_fc = -(-n // SUB)
    n_subs_pad = -(-n_fc // 64) * 64
    scf = leading_starts(starts, n_fc)
    s = np.asarray(starts)
    jscf = np.concatenate([s, np.full(n_fc * SUB - n, 2**30, np.int32)]).reshape(n_fc, SUB)[:, 0]
    np.testing.assert_array_equal(scf.numpy(), jscf)
    a0, a_hi = rank_window(scf, n_subs_pad)
    ja0, ja_hi = rp._rank_window(jnp.asarray(jscf), n_subs_pad)
    assert a0.dtype == a_hi.dtype == torch.int32
    np.testing.assert_array_equal(a0.numpy(), np.asarray(ja0))
    np.testing.assert_array_equal(a_hi.numpy(), np.asarray(ja_hi))


@pytest.mark.parametrize("q", [3, 4])
def test_make_inputs_windows_match_jax(monkeypatch, q):
    """The port's windows from the JAX script's own starts and particles,
    bit for bit, sentinel rows included (N cut to 2^14, SG = 8)."""
    n, sg = 1 << 14, 8
    monkeypatch.setattr(jkv, "N", n)
    js_win, jd_win = jkv.make_inputs(q, sg)
    key = jax.random.PRNGKey(0)
    w0 = jax.nn.softmax(jax.random.normal(key, (n,), jnp.float32))
    p = jax.random.normal(jax.random.fold_in(key, 1), (n, 1), jnp.float32)
    starts = jax_starts(key, w0, n)
    s_win, d_win = tkv.windows(torch.from_numpy(np.array(starts)),
                               torch.from_numpy(np.array(p)), q, sg)
    np.testing.assert_array_equal(s_win.numpy(), np.asarray(js_win))
    np.testing.assert_array_equal(d_win.numpy(), np.asarray(jd_win))
    assert float(s_win.max()) == n + 256  # the last windows reach the sentinel rows


def test_fine_chunks_sentinels_and_bases():
    n, extra = 3000, 4
    starts, p = _inputs(n)
    starts_f, diffs, base = fine_chunks(starts, p, 64, extra)
    n_rows = -(-n // SUB) + extra
    assert starts_f.shape == diffs.shape == (n_rows, SUB) and base.shape == (n_rows, 1)
    flat_s, flat_d = starts_f.view(-1), diffs.view(-1)
    np.testing.assert_array_equal(flat_s[:n].numpy(), starts.numpy().astype(np.float32))
    assert bool((flat_s[n:] == 64 * SUB + 256).all()) and bool((flat_d[n:] == 0).all())
    p0 = p[:, 0].numpy()
    prev = np.concatenate([np.zeros(1, np.float32), p0[:-1]])
    np.testing.assert_array_equal(flat_d[:n].numpy(), p0 - prev)
    np.testing.assert_array_equal(base[1:n // SUB + 1, 0].numpy(),
                                  p[SUB - 1::SUB, 0].numpy()[: n // SUB])


# --- X1 ---------------------------------------------------------------------
def _jax_kern_v0(s_win, d_win, sg, transpose, sum_only):
    """``kern_v0``'s pallas_call as ``build_call`` builds it, at any S."""
    num_super, _, w = s_win.shape
    out_shape = (num_super, sg, SUB) if transpose else (num_super, SUB, sg)
    blk = (1, sg, SUB) if transpose else (1, SUB, sg)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            functools.partial(jkv.kern_v0, sg=sg, transpose=transpose, sum_only=sum_only),
            grid=(num_super,),
            in_specs=[
                pl.BlockSpec((1, sg, w), lambda s: (s, 0, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, sg, 1, w), lambda s: (s, 0, 0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec(blk, lambda s: (s, 0, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        )
        return np.asarray(call(jnp.asarray(s_win), jnp.asarray(d_win)))


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("sum_only", [False, True])
@pytest.mark.parametrize("q", [3, 4])
def test_x1_plain_matches_kern_v0(q, sum_only, transpose):
    sg = 8
    starts, p = _inputs(2 * sg * SUB, seed=q)  # S = 2 super-groups
    s_win, d_win = tkv.windows(starts, p, q, sg)
    before = window_compare_sum.launches
    got = window_compare_sum(s_win, d_win, sum_only=sum_only, transpose=transpose)
    assert window_compare_sum.launches == before  # CPU tensors take the plain version
    want = _jax_kern_v0(s_win.numpy(), d_win.numpy(), sg, transpose, sum_only)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    if sum_only:  # counts are exact
        np.testing.assert_array_equal(got.numpy(), want)


def test_x1_telescopes_to_the_resampled_values():
    """Window sums plus chunk bases are B2's values (the probe's premise)."""
    n, q, sg = 16384, 4, 8
    starts, p = _inputs(n, "1.5")
    s_win, d_win = tkv.windows(starts, p, q, sg)
    n_fc = n // SUB
    a0 = tkv._a0_ceil(torch.clamp(starts.view(n_fc, SUB)[:, 0], 0, n), n_fc)
    _, _, base = fine_chunks(starts, p, n_fc, q)
    got = window_compare_sum_reference(s_win, d_win).view(n_fc, SUB) + base[a0.long()]
    want = resample_by_starts_reference(p, starts).view(n_fc, SUB)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


def test_x1_wrapper_checks():
    s_win, d_win = torch.zeros(2, 8, 384), torch.zeros(2, 8, 1, 384)
    with pytest.raises(ValueError, match="d_win"):
        window_compare_sum(s_win, d_win[:, :, 0])
    with pytest.raises(ValueError, match="multiple"):
        window_compare_sum(s_win[..., :200], d_win[..., :200])
    with pytest.raises(TypeError):
        window_compare_sum(s_win.double(), d_win)
    big = torch.zeros((1 << 17) + 1, 1, SUB)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        window_compare_sum(big, big[:, :, None])


# --- X2 ---------------------------------------------------------------------
def test_x2_matches_jax_dma_kernel_and_b2():
    n = 64 * SUB * 2  # two super-groups: the JAX script's check
    starts, p = _inputs(n, "1.0", seed=5)
    a0, _ = trd.rank_a0(starts, n, n // SUB)
    ja0, _ = jrd.rank_a0(jnp.asarray(starts.numpy()), n, n // SUB)
    np.testing.assert_array_equal(a0.numpy(), np.asarray(ja0))
    got = span_resample_values(starts, p, a0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jrd.dma_resample_values(
            jnp.asarray(starts.numpy()), jnp.asarray(p.numpy()), ja0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), resample_by_starts_reference(p, starts).numpy(),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("case", ["point mass", "desert", "3.0"])
def test_x2_span_budget_and_window(case):
    """A point mass keeps every a0 in one chunk (spanD = Q); a weight desert
    spreads one super-group's first outputs over hundreds of chunks; heavy
    lognormal weights (σ = 3) leave some sub-groups' ancestors past their
    Q = 3 chunk window within the span budget."""
    n = 65536
    starts, p = _inputs(n, case)
    a0, _ = trd.rank_a0(starts, n, n // SUB)
    span, uncovered = span_checks(starts, a0).tolist()
    if case == "point mass":
        assert (span, uncovered) == (3, 0)
        np.testing.assert_allclose(span_resample_values(starts, p, a0).numpy(),
                                   resample_by_starts_reference(p, starts).numpy(),
                                   rtol=0, atol=TOL)
    elif case == "desert":
        assert span > ROWS
        with pytest.raises(ValueError, match="spanD"):
            span_resample_values(starts, p, a0)
    else:
        assert span <= ROWS and uncovered > 0
        with pytest.raises(ValueError, match="window"):
            span_resample_values(starts, p, a0)


def test_x2_wrapper_checks():
    starts, p = _inputs(8192)
    a0, _ = trd.rank_a0(starts, 8192, 64)
    with pytest.raises(ValueError, match="multiple"):
        span_resample_values(starts[:4096], p[:4096], a0[:32])
    with pytest.raises(ValueError, match="particles"):
        span_resample_values(starts, p.repeat(1, 2), a0)
    starts_f, diffs, base = fine_chunks(starts, p, 64, ROWS - 1)  # one row short
    with pytest.raises(ValueError, match="rows"):
        span_compare_sum(starts_f, diffs, base, a0)


# --- the kernels' premise: sorted windows, a search and a scan --------------
# The CUDA kernels of X1 and X2 take a window's count as an upper-bound
# search over its starts and its sum from a scan of its differences, which
# is the windowed function only where the window is sorted; they check that
# and walk any other window.
PREMISE_N = 1 << 14
PREMISE_CASES = ["0.3", "1.0", "3.0", "point mass"]  # lognormal sigma, or a point mass
X2_CASES = PREMISE_CASES + ["desert"]
X2_N = 65536  # where the desert leaves super-groups over the span budget


def _sorted_rows(a):
    return (a[..., 1:] >= a[..., :-1]).all(-1)


def _search_scan(s, d, pos):
    """(counts, sums) of rows ``s``, ``d`` (R, W) at positions ``pos`` (R, P):
    j = #{s ≤ pos} by search, the sum the scan of d at j − 1 (0 at j = 0)."""
    j = torch.searchsorted(s, pos, right=True)
    scan = torch.cat([torch.zeros(s.shape[0], 1), torch.cumsum(d, dim=1)], dim=1)
    return j.to(torch.float32), torch.gather(scan, 1, j)


def _x1_formula(s_win, d_win, sum_only, transpose):
    n_super, sg, w = s_win.shape
    pos = torch.arange(n_super * sg * SUB, dtype=torch.float32).view(-1, SUB)
    counts, sums = _search_scan(s_win.reshape(-1, w), d_win.reshape(-1, w), pos)
    out = (counts if sum_only else sums).view(n_super, sg, SUB)
    return out if transpose else out.transpose(1, 2).contiguous()


def _x2_windows(starts_f, diffs, a0):
    rows = a0.long()[:, None] + torch.arange(Q)
    return starts_f[rows].reshape(a0.shape[0], -1), diffs[rows].reshape(a0.shape[0], -1)


def _x2_formula(starts_f, diffs, base, a0):
    s, d = _x2_windows(starts_f, diffs, a0)
    pos = torch.arange(a0.shape[0] * SUB, dtype=torch.float32).view(-1, SUB)
    _, sums = _search_scan(s, d, pos)
    return (sums + base[a0.long()]).view(-1, 1)


def _jax_dma_kernel(starts_f, diffs, base, a0):
    """``_dma_kernel``'s pallas_call as ``dma_resample_values`` builds it,
    on the given fine-chunk arrays (exp_resample_dma.py:105-127)."""
    n_rows = starts_f.shape[0]
    num_super = a0.shape[0] // jrd.SG
    pad = np.zeros((n_rows, jrd.ROW_W - 2 * SUB - 1), np.float32)
    mega = np.concatenate([starts_f.numpy(), diffs.numpy(), base.numpy(), pad], axis=1)
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            jrd._dma_kernel,
            grid_spec=pltpu.PrefetchScalarGridSpec(
                num_scalar_prefetch=1,
                grid=(num_super,),
                in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
                out_specs=pl.BlockSpec((1, jrd.SG, SUB), lambda s, a0ref: (s, 0, 0),
                                       memory_space=pltpu.VMEM),
                scratch_shapes=[pltpu.VMEM((jrd.ROWS, jrd.ROW_W), jnp.float32),
                                pltpu.SemaphoreType.DMA(())],
            ),
            out_shape=jax.ShapeDtypeStruct((num_super, jrd.SG, SUB), jnp.float32),
        )(jnp.asarray(a0.numpy()), jnp.asarray(mega))
    return np.asarray(out).reshape(-1, 1)


def _x2_chunks(case, n=X2_N):
    starts, p = _inputs(n, case)
    a0, _ = trd.rank_a0(starts, n, n // SUB)
    return fine_chunks(starts, p, n // SUB, ROWS), a0


def _in_budget(a0):
    """Each output's super-group has a span within ROWS (the TPU kernel's
    DMA budget), as an (N, 1) mask."""
    a0s = a0.view(-1, SG)
    ok = a0s[:, -1] + Q - a0s[:, 0] <= ROWS
    return ok[:, None].expand(-1, SG * SUB).reshape(-1, 1)


def _shuffle_rows(rng, *arrays):
    """``arrays`` with each last-axis row permuted, one permutation a row."""
    shape = (-1, arrays[0].shape[-1])
    perm = torch.from_numpy(np.argsort(rng.random(arrays[0].reshape(shape).shape), axis=1))
    return tuple(torch.gather(a.reshape(shape), 1, perm).reshape(a.shape) for a in arrays)


@pytest.mark.parametrize("case", PREMISE_CASES)
@pytest.mark.parametrize("variant", range(len(tkv.VARIANTS)))
def test_x1_windows_are_sorted(variant, case):
    """Every window ``exp_kernel_var.windows`` builds is sorted, the
    sentinel rows past N included."""
    _, q, sg, _, _ = tkv.VARIANTS[variant]
    starts, p = _inputs(PREMISE_N, case)
    s_win, _ = tkv.windows(starts, p, q, sg)
    if case != "point mass":  # whose windows all sit at its one chunk
        assert float(s_win.max()) == PREMISE_N + 256  # the last windows reach the sentinel rows
    assert bool(_sorted_rows(s_win).all())


@pytest.mark.parametrize("case", X2_CASES)
def test_x2_windows_are_sorted(case):
    """Every X2 window, rows a0[b] … a0[b] + Q − 1 of ``fine_chunks``, is
    sorted, also where the wrapper refuses the weights (σ = 3, a desert)."""
    (starts_f, diffs, _), a0 = _x2_chunks(case)
    s, _ = _x2_windows(starts_f, diffs, a0)
    assert bool(_sorted_rows(s).all())


@pytest.mark.parametrize("case", PREMISE_CASES)
@pytest.mark.parametrize("variant", range(len(tkv.VARIANTS)))
def test_x1_search_scan_equals_kern_v0(variant, case):
    _, q, sg, transpose, sum_only = tkv.VARIANTS[variant]
    starts, p = _inputs(PREMISE_N, case)
    s_win, d_win = tkv.windows(starts, p, q, sg)
    got = _x1_formula(s_win, d_win, sum_only, transpose).numpy()
    want = _jax_kern_v0(s_win.numpy(), d_win.numpy(), sg, transpose, sum_only)
    if sum_only:  # counts are exact
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("case", X2_CASES)
def test_x2_search_scan_equals_dma_kernel(case):
    """Within the span budget the formula equals the TPU kernel; everywhere
    it equals the plain version (the TPU kernel cannot stage an over-budget
    span)."""
    chunks, a0 = _x2_chunks(case)
    got = _x2_formula(*chunks, a0)
    np.testing.assert_allclose(got.numpy(), span_compare_sum_reference(*chunks, a0).numpy(),
                               rtol=0, atol=TOL)
    ok = _in_budget(a0)
    assert bool(ok.any()) and (case != "desert" or not bool(ok.all()))
    # Over-budget super-groups get their first chunk's window, which the TPU
    # kernel can stage (an interpreted read past its scratch raises); only
    # the others are compared.
    a0s = a0.view(-1, SG)
    a0_jax = torch.where(ok.view(-1, SG, SUB)[:, :, 0], a0s, a0s[:, :1]).reshape(-1)
    want = _jax_dma_kernel(*chunks, a0_jax)
    np.testing.assert_allclose(got.numpy()[ok.numpy()], want[ok.numpy()], rtol=0, atol=TOL)


@pytest.mark.parametrize("transpose,sum_only", [(True, False), (True, True), (False, False)])
def test_x1_shuffled_windows_need_the_walk(transpose, sum_only):
    """With each window's entries shuffled the search-and-scan formula is
    wrong, while the plain version (a walk) still equals the TPU kernel:
    why the CUDA kernel walks a window that fails its sortedness check."""
    starts, p = _inputs(PREMISE_N, "1.0")
    s_win, d_win = _shuffle_rows(np.random.default_rng(7), *tkv.windows(starts, p, 4, 64))
    assert not bool(_sorted_rows(s_win).any())
    plain = window_compare_sum_reference(s_win, d_win, sum_only=sum_only, transpose=transpose)
    want = _jax_kern_v0(s_win.numpy(), d_win.numpy(), 64, transpose, sum_only)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=TOL)
    formula = _x1_formula(s_win, d_win, sum_only, transpose)
    assert float((formula - plain).abs().max()) > 1.0


def test_x1_walk_of_a_shuffled_window_needs_compensation():
    """The kernels' walk in their order (a lane's 4 terms of each vector
    summed, then added into the sum), against the exact sum in f64: in a
    shuffled window the partial sums do not telescope, so a plain f32 sum
    drifts past TOL, while Kahan's compensation, as the kernels add it,
    stays well inside."""
    starts, p = _inputs(PREMISE_N, "1.0")
    s_win, d_win = _shuffle_rows(np.random.default_rng(7), *tkv.windows(starts, p, 4, 64))
    s, d = s_win.reshape(-1, 512), d_win.reshape(-1, 512)
    pos = torch.arange(s.shape[0] * SUB, dtype=torch.float32).view(-1, SUB)
    exact = torch.zeros(pos.shape, dtype=torch.float64)
    plain, total, comp = (torch.zeros(pos.shape) for _ in range(3))
    for x0 in range(0, s.shape[1], 4):
        group = torch.zeros(pos.shape)
        for x in range(x0, x0 + 4):
            term = torch.where(s[:, x:x + 1] <= pos, d[:, x:x + 1], 0.0)
            exact += term.double()
            plain += term
            group += term
        y = group - comp
        new = total + y
        comp = (new - total) - y
        total = new
    plain_err = float((plain.double() - exact).abs().max())
    kahan_err = float((total.double() - exact).abs().max())
    assert plain_err > TOL, f"plain f32 walk drifts {plain_err:.3e}"
    assert kahan_err < TOL / 2, f"compensated walk drifts {kahan_err:.3e}"


def test_x2_shuffled_rows_need_the_walk():
    chunks, a0 = _x2_chunks("1.0", n=SG * SUB * 2)
    shuffled = (*_shuffle_rows(np.random.default_rng(8), *chunks[:2]), chunks[2])
    plain = span_compare_sum_reference(*shuffled, a0)
    np.testing.assert_allclose(plain.numpy(), _jax_dma_kernel(*shuffled, a0), rtol=0, atol=TOL)
    np.testing.assert_allclose(plain.numpy(), span_compare_sum_reference(*chunks, a0).numpy(),
                               rtol=0, atol=TOL)  # a row's order does not change its sum
    assert float((_x2_formula(*shuffled, a0) - plain).abs().max()) > 1.0


def test_build_key_covers_headers(tmp_path, monkeypatch):
    """A library's build key changes when a shared header's bytes change
    (so an edit of the header rebuilds every source that includes it) and
    stays the same when nothing does."""
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_nvcc, "CSRC", tmp_path)
    key = _nvcc.build_key("a.cu")
    assert _nvcc.build_key("a.cu") == key
    (tmp_path / "shared.cuh").write_text("// v2\n")
    assert _nvcc.build_key("a.cu") != key
    (tmp_path / "shared.cuh").write_text("// v1\n")
    assert _nvcc.build_key("a.cu") == key
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _nvcc.build_key("a.cu") != key


class _Symbol:
    """Stands in for a library's entry point: records each call and each
    assignment of its signature, and returns ``err``."""

    def __init__(self):
        self.calls, self.signatures, self.err = [], [], 0

    @property
    def argtypes(self):
        return self.signatures[-1]

    @argtypes.setter
    def argtypes(self, types):
        self.signatures.append(types)

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class _Lib:
    def __init__(self, symbol):
        self.pf_probe = symbol


def test_kernel_seam_sets_the_signature_once_and_names_a_failed_kernel(monkeypatch):
    """``_nvcc.Kernel``: each launch enters the device and passes its stream
    last; the entry point's signature is set on the first launch only; a
    non-zero CUDA error raises, naming the kernel."""
    symbol = _Symbol()
    lib = _Lib(symbol)
    entered = []

    @contextlib.contextmanager
    def on_device(device):
        entered.append(device)
        yield 77

    monkeypatch.setattr(_nvcc, "load_library", lambda name, *sources: lib)
    monkeypatch.setattr(_nvcc, "on_device", on_device)
    kernel = _nvcc.Kernel("probe kernel", "pf_probe", ("probe.cu",), "pf_probe",
                          (ctypes.c_void_p, ctypes.c_int))
    kernel("cuda:0", 10, 1)
    kernel("cuda:1", 20, 2)
    symbol.err = 700
    with pytest.raises(RuntimeError, match="probe kernel launch failed: CUDA error 700"):
        kernel("cuda:0", 30, 3)
    assert symbol.signatures == [[ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]]
    assert symbol.restype is ctypes.c_int
    assert symbol.calls == [(10, 1, 77), (20, 2, 77), (30, 3, 77)]
    assert entered == ["cuda:0", "cuda:1", "cuda:0"]


def _ctype(param: str):
    """The ctypes type of one C parameter: a pointer, an int or a float."""
    if "*" in param:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[param.split()[0]]


@pytest.mark.parametrize("kernel", [
    pytest.param(resample._KERNEL, id="B2"), pytest.param(systematic_starts._KERNEL, id="S"),
    pytest.param(window_resample._KERNEL, id="X1"), pytest.param(span_resample._KERNEL, id="X2"),
    pytest.param(launch_probe._KERNEL, id="X3"), pytest.param(sinkhorn_tile._DUAL, id="OT dual"),
    pytest.param(sinkhorn_tile._PROJECT, id="OT projection"),
    pytest.param(sinkhorn_tile._VJP, id="OT VJP")])
def test_kernel_signature_matches_its_c_entry(kernel):
    """Each wrapper's signature is its C entry point's, parameter by
    parameter, the stream last: ctypes would pass a mistyped argument
    without complaint."""
    src = "".join((_nvcc.CSRC / s).read_text() for s in kernel.sources)
    params = re.search(r'extern "C" int %s\(([^)]*)\)' % kernel.symbol, src).group(1)
    *params, stream = (p.strip() for p in params.split(","))
    assert stream == "void* stream"
    assert list(kernel.argtypes) == [_ctype(p) for p in params]


# --- X3 ---------------------------------------------------------------------
def test_x3_plain_matches_noop_kernel():
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)

    def _noop_kernel(x_ref, o_ref):  # profile_small_n.py:137-138
        o_ref[:, :] = x_ref[:, :] + 1.0

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            _noop_kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32))(jnp.asarray(x)))
    before = add_one.launches
    got = add_one(torch.from_numpy(x))
    assert add_one.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(add_one_reference(torch.from_numpy(x)).numpy(), want)
    with pytest.raises(ValueError, match="tile"):
        add_one(torch.zeros(4, 128))


# --- timing, slope, the small-N profile ------------------------------------
def test_timer_and_profiler_trace(tmp_path):
    timer = Timer()
    with timer.phase("a", sync=torch.ones(3)):
        pass
    out = timer.time_fn("b", lambda x: {"y": (x * 2, [x])}, torch.ones(4))
    assert torch.equal(out["y"][0], torch.full((4,), 2.0))
    with timer.phase("a"):
        pass
    s = timer.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert s["a"]["min_ms"] <= s["a"]["mean_ms"] <= s["a"]["max_ms"]
    with profiler_trace(str(tmp_path)):
        torch.ones(8).sum()
    assert any(f.name.endswith(".json") for f in tmp_path.iterdir())


def test_slope_on_cpu():
    def build(m):
        return lambda: torch.stack([torch.ones(16) * i for i in range(m)]).sum()
    per = _slope.slope("cpu loop", build, 2, 4, reps=2)
    assert math.isfinite(per)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _slope.graph_slope("graph", build, 2, 4)


@pytest.fixture(scope="module")
def small_n_builders():
    ys = simulate_sv_1d(8, tsn.ALPHA, tsn.SIGMA, 1.0, seed=42, device="cpu").Y
    return ys, tsn.loop_builders(1024, "cpu", ys)


@pytest.mark.parametrize("variant", ["full", "no-resample", "kernel+comb", "kernel-only",
                                     "minimal", "launch"])
def test_profile_small_n_variants_run_on_cpu(small_n_builders, variant):
    _, builders = small_n_builders
    out = builders[variant](4)()
    assert out.numel() == 1 and bool(torch.isfinite(out))


def test_profile_small_n_full_equals_filter_run(small_n_builders):
    ys, builders = small_n_builders
    m = 4
    pf, state0 = tsn.make_pf(1024, "cpu")
    (pt, _, _), hist = pf.run(torch.Generator().manual_seed(3), state0, ys[:m, None])
    assert torch.equal(builders["full"](m)(), torch.sum(hist["mean"]) + pt[0])


def test_profile_n_on_cpu():
    res = tsn.profile_n(1024, "cpu", m_lo=2, m_hi=4, reps=1)
    assert set(res["eager"]) == {"full", "no-resample", "kernel+comb", "kernel-only",
                                 "minimal", "launch"}
    assert res["graph"] == {}  # CUDA graphs need the card


def test_exp_resample_dma_parts_on_cpu():
    rows = trd.span_table("cpu", n=16384, sigmas=(0.3, 2.0))
    assert [r[0] for r in rows] == [0.3, 2.0]
    assert all(3 <= r[3] <= ROWS and r[1] <= 1.0 for r in rows)
    assert trd.check_against_b2(16384, "cpu") <= TOL


# --- entry points default to the card ---------------------------------------
def _load_default(tmp_path):
    simulate_sv_1d(10, 0.9, 0.2, 1.0, device="cpu").save(str(tmp_path / "sv"))
    return SV1DResults.load(str(tmp_path / "sv")).X


_DEFAULT_DEVICE_CASES = {
    "FusedSIRFilter": lambda _: FusedSIRFilter(SVModel(0.9), [[0.04]], Np=64).Lq,
    "ParticleFilter": lambda _: ParticleFilter(
        lambda x, u: x, None, [[0.04]], None, Np=64, obs_loglik=lambda x, z: -x[0]).Q,
    "simulate_sv_1d": lambda _: simulate_sv_1d(10, 0.9, 0.2, 1.0).X,
    "SV1DResults.load": _load_default,
    "state_from_jax": lambda _: state_from_jax(
        (np.zeros((8, 8)), np.zeros((8, 8)), np.zeros(2)))[0],
    "params_from_jax": lambda _: params_from_jax([[0.04]])[0],
}


@pytest.mark.parametrize("entry", sorted(_DEFAULT_DEVICE_CASES))
def test_entry_points_default_to_the_card(tmp_path, entry):
    make = _DEFAULT_DEVICE_CASES[entry]
    if torch.cuda.is_available():
        assert make(tmp_path).device.type == "cuda"
    else:  # no quiet fall-back to the CPU: torch's own error
        with pytest.raises((AssertionError, RuntimeError)):
            make(tmp_path)
