"""Kernel S's paths on the CPU (``ops/systematic_starts.py``): which tensors
reach the kernel's wrapper, what the wrapper refuses, the launch plan, and
the plain chain bit for bit against a frozen copy of the chain as it stood
before the kernel.

No GPU is needed: a CUDA tensor is stood in for by a CPU tensor whose
``device`` reads ``cuda``, and the library by a stub that records the call.
The kernel itself is held against its plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from particle_filters_tpu_torch.core.block_cumsum import blocked_cumsum
from particle_filters_tpu_torch.ops import _nvcc
from particle_filters_tpu_torch.ops import systematic_starts as ss
from particle_filters_tpu_torch.ops.fused_pf import FusedSIRFilter, SVModel
from particle_filters_tpu_torch.resampling import hard


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lives on the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _cuda_like(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_CudaLike)


class _Stub:
    """Stands in for the built library: records each call's arguments and
    returns ``err``."""

    def __init__(self, err: int = 0):
        self.calls = []

        def pf_systematic_starts(w, log_z, u, scratch, out, rows, n, tiles, m, starts_form,
                                 stream):
            self.calls.append({"w": w, "log_z": log_z, "u": u, "scratch": scratch, "out": out,
                               "rows": rows, "n": n, "tiles": tiles, "m": m,
                               "starts_form": starts_form})
            return err

        self.pf_systematic_starts = pf_systematic_starts  # takes argtypes, as ctypes' does


def _stub_seam(monkeypatch, lib):
    """The kernels' one call seam (``ops/_nvcc.py``) loads ``lib`` and
    launches on stream 0 without entering a device."""
    monkeypatch.setattr(_nvcc, "load_library", lambda name, *sources: lib)
    monkeypatch.setattr(_nvcc, "on_device", lambda device: contextlib.nullcontext(0))


@pytest.fixture
def stub(monkeypatch):
    lib = _Stub()
    _stub_seam(monkeypatch, lib)
    return lib


def _weights(b, n, seed=0, sigma=2.0):
    z = torch.from_numpy(np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32))
    return torch.softmax(sigma * z, dim=-1)


def _u(b, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).random(b).astype(np.float32))


# --- the chain as it stood before kernel S (frozen copy) -----------------------
def _frozen_running_max(x):
    n = x.shape[-1]
    if n <= 256:
        return torch.cummax(x, dim=-1).values
    rows = -(-n // 256)
    pad = x[..., -1:].expand(x.shape[:-1] + (rows * 256 - n,))
    padded = torch.cat([x, pad], dim=-1).view(x.shape[:-1] + (rows, 256))
    within = torch.cummax(padded, dim=-1).values
    carry = _frozen_running_max(within[..., -1])
    out = torch.cat(
        [within[..., :1, :], torch.maximum(within[..., 1:, :], carry[..., :-1, None])],
        dim=-2,
    )
    return out.flatten(-2)[..., :n]


def _frozen_run_ends(weights, m, u):
    cdf = _frozen_running_max(blocked_cumsum(weights))
    cdf = cdf / cdf[..., -1:]
    u = torch.as_tensor(u, dtype=cdf.dtype, device=cdf.device)
    t = torch.ceil(m * cdf - u[..., None])
    return t.clamp_(0.0, m).to(torch.int32)


def _frozen_batched_starts(weights, u):
    b, n = weights.shape
    t = _frozen_run_ends(weights, n, u)
    offsets = torch.arange(b, dtype=torch.int32, device=weights.device)[:, None] * n
    return (torch.cat([t.new_zeros((b, 1)), t[:, :-1]], dim=1) + offsets).view(-1)


# --- dispatch ------------------------------------------------------------------
@pytest.mark.parametrize("b,n", [(1, 3000), (100, 200), (3, 20000)])
def test_cuda_tensors_reach_the_kernel(stub, b, n):
    """batched_starts (starts form) and _child_run_ends_u (run-ends form,
    1-D and 2-D weights, a 0-d u) reach the wrapper with the
    plan's sizes; the launches are counted, one a pass."""
    w, u = _cuda_like(_weights(b, n)), _cuda_like(_u(b))
    p = ss.plan(b, n)
    before = ss.systematic_starts.launches
    starts = hard.batched_starts(w, u)
    assert starts.shape == (b * n,) and starts.dtype == torch.int32
    t = hard._child_run_ends_u(w, n, u)
    assert t.shape == (b, n)
    t1 = hard._child_run_ends_u(_cuda_like(_weights(1, n)[0]), 7, _cuda_like(torch.tensor(0.25)))
    assert t1.shape == (n,)
    assert ss.systematic_starts.launches == before + p.passes * 2 + ss.plan(1, n).passes
    forms = [(c["rows"], c["n"], c["tiles"], c["m"], c["starts_form"]) for c in stub.calls]
    assert forms == [(b, n, p.tiles, n, 1), (b, n, p.tiles, n, 0),
                     (1, n, ss.plan(1, n).tiles, 7, 0)]
    assert stub.calls[0]["w"] == w.data_ptr() and stub.calls[0]["u"] == u.data_ptr()
    assert stub.calls[0]["out"] == starts.data_ptr() and stub.calls[0]["out"] % 16 == 0


def test_cpu_tensors_take_the_plain_chain(stub):
    """CPU tensors never reach the library: the plain chain's results."""
    w, u = _weights(4, 5000), _u(4)
    assert torch.equal(hard.batched_starts(w, u), ss.starts_reference(w, u))
    assert torch.equal(hard._child_run_ends_u(w, 5000, u), ss.run_ends_reference(w, 5000, u))
    assert stub.calls == []


def test_cuda_tensor_never_falls_back(monkeypatch):
    """A launch error raises: the plain chain never stands in on the card."""
    lib = _Stub(err=700)
    _stub_seam(monkeypatch, lib)
    monkeypatch.setattr(ss, "run_ends_reference", lambda *a: pytest.fail("fell back"))
    monkeypatch.setattr(ss, "starts_reference", lambda *a: pytest.fail("fell back"))
    w, u = _cuda_like(_weights(2, 300)), _cuda_like(_u(2))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        hard.batched_starts(w, u)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        hard._child_run_ends_u(w, 300, u)
    assert len(lib.calls) == 2


def test_past_2_24_batched_starts_take_the_exact_path(stub, monkeypatch):
    """N > 2²⁴ never reaches kernel S: the exact integer run ends."""
    n = (1 << 24) + 8
    seen = []
    monkeypatch.setattr(hard, "exact_child_run_ends_u",
                        lambda w, m, u: seen.append(m) or torch.zeros((1, m), dtype=torch.int32))
    starts = hard.batched_starts(_cuda_like(torch.empty((1, n))), _cuda_like(torch.zeros(1)))
    assert seen == [n] and starts.shape == (n,) and stub.calls == []


# --- the wrapper's checks ------------------------------------------------------
BAD = ("f64 weights", "f64 u", "1-D weights", "u of another shape", "CPU weights", "CPU u",
       "strided weights", "strided u", "M past 2^24", "M of 0", "N past 2^24")


def _bad_input(label):
    """(exception, weights, u, M) of one input the wrapper refuses."""
    w, u, m = _cuda_like(_weights(2, 64)), _cuda_like(_u(2)), 64
    return {
        "f64 weights": (TypeError, _cuda_like(_weights(2, 64).double()), u, m),
        "f64 u": (TypeError, w, _cuda_like(_u(2).double()), m),
        "1-D weights": (ValueError, _cuda_like(_weights(1, 64)[0]), _cuda_like(_u(1)), m),
        "u of another shape": (ValueError, w, _cuda_like(_u(1)), m),
        "CPU weights": (ValueError, _weights(2, 64), _u(2), m),
        "CPU u": (ValueError, w, _u(2), m),
        "strided weights": (ValueError, _cuda_like(_weights(2, 128)[:, ::2]), u, m),
        "strided u": (ValueError, w, _cuda_like(_u(4)[::2]), m),
        "M past 2^24": (ValueError, w, u, (1 << 24) + 1),
        "M of 0": (ValueError, w, u, 0),
        "N past 2^24": (ValueError, _cuda_like(torch.empty((1, (1 << 24) + 1))),
                        _cuda_like(_u(1)), m),
    }[label]


@pytest.mark.parametrize("label", BAD)
def test_wrapper_refuses(stub, label):
    """Type, device, shape, contiguity and the sizes are checked before any
    launch."""
    exc, w, u, m = _bad_input(label)
    with pytest.raises(exc):
        ss._launch(w, u, m, starts_form=False)
    if w.device.type == "cuda":
        with pytest.raises(exc):
            ss.systematic_run_ends(w, m, u)
    assert stub.calls == []


@pytest.mark.parametrize("entry", ["systematic_resample", "systematic_counts",
                                   "resample_indices", "systematic_resample_values"])
def test_card_paths_refuse_f64_weights(stub, monkeypatch, entry):
    """Below 2²⁴ the card's systematic entries take float32 weights (every
    filter of the port holds them): float64 weights on the card raise
    TypeError before any launch, never a result of another precision."""
    monkeypatch.setattr(hard, "_uniform",
                        lambda gen, shape, like: _cuda_like(torch.rand(shape, dtype=like.dtype)))
    w = _cuda_like(_weights(1, 300)[0].double())
    call = {
        "systematic_resample": lambda: hard.systematic_resample(None, w),
        "systematic_counts": lambda: hard.systematic_counts(None, w),
        "resample_indices": lambda: hard.resample_indices("systematic", None, w),
        "systematic_resample_values": lambda: hard.systematic_resample_values(
            None, _cuda_like(torch.zeros((300, 1), dtype=torch.float64)), w=w),
    }[entry]
    with pytest.raises(TypeError, match="float32"):
        call()
    assert stub.calls == []


def test_starts_form_needs_m_equal_n(stub):
    """The starts form is M = N by construction: the wrapper passes n as M."""
    w, u = _cuda_like(_weights(3, 500)), _cuda_like(_u(3))
    ss.systematic_starts(w, u)
    assert stub.calls[-1]["m"] == 500 and stub.calls[-1]["starts_form"] == 1


# --- the plan ------------------------------------------------------------------
@pytest.mark.parametrize("b,n,tiles,passes,scratch", [
    (1, 1 << 24, 2048, 3, 2 * 2048 + 1),
    (1, 1 << 20, 128, 3, 2 * 128 + 1),
    (1, 3000, 1, 1, 0),
    (100, 200, 1, 1, 0),
    (100, 10_000, 2, 3, 2 * 200 + 100),
    (1, ss.TILE, 1, 1, 0),
    (2, ss.TILE + 1, 2, 3, 2 * 4 + 2),
])
def test_plan(b, n, tiles, passes, scratch):
    """One pass for a row of at most one tile (the flows' clouds of 200),
    three above it; the scratch holds two f64 words a tile and one a row;
    pass 2's share of a row's tiles fits the kernel's 8 a thread."""
    p = ss.plan(b, n)
    assert (p.tiles, p.passes, p.scratch) == (tiles, passes, scratch)
    assert -(-p.tiles // 256) <= 8


def test_starts_are_aligned_for_b2(stub):
    """The starts form is its own allocation (not a view into the scratch),
    so B2 stages it with 16-byte copies without a clone."""
    for b, n in ((1, 3000), (100, 200), (100, 10_000)):
        starts = ss.systematic_starts(_cuda_like(_weights(b, n)), _cuda_like(_u(b)))
        assert starts.data_ptr() % 16 == 0 and starts.is_contiguous()
        assert stub.calls[-1]["scratch"] != starts.data_ptr()


# --- the CPU results, bit for bit as before ------------------------------------
@pytest.mark.parametrize("b,n", [(1, 3000), (7, 20000)])
def test_cpu_chain_bit_equal_to_frozen(b, n):
    """batched_starts and _child_run_ends_u on the CPU give the frozen
    chain's bits, also at point masses and equal weights."""
    u = _u(b)
    for w in (_weights(b, n), torch.full((b, n), 1.0 / n),
              torch.nn.functional.one_hot(torch.arange(b) % n, n).float()):
        assert torch.equal(hard.batched_starts(w, u), _frozen_batched_starts(w, u))
        assert torch.equal(hard._child_run_ends_u(w, n, u), _frozen_run_ends(w, n, u))
        assert torch.equal(hard._child_run_ends_u(w[0], 999, u[0]),
                           _frozen_run_ends(w[0], 999, u[0]))


@pytest.mark.parametrize("n", [4096, 20000])
def test_fused_run_bit_equal_to_frozen_chain(monkeypatch, n):
    """FusedSIRFilter.run on the CPU: the same history and state as with the
    frozen chain in place of the starts (fed exp(logw − log Z), since the
    filter hands its log-weights and the step's log Z to the starts)."""
    def run():
        f = FusedSIRFilter(SVModel(0.95, 1.0), [[0.04]], Np=n, device="cpu")
        gen = torch.Generator().manual_seed(5)
        z = torch.from_numpy(np.random.default_rng(2).standard_normal((40, 1))
                             .astype(np.float32) * 2.0)
        st, hist = f.run(gen, f.initialize(gen, [0.0], [[0.4]]), z)
        return st, hist

    st, hist = run()
    assert bool(hist["resampled"].any())
    monkeypatch.setattr(hard, "systematic_starts", lambda w, u, log_z=None: _frozen_batched_starts(
        w if log_z is None else torch.exp(w - log_z[:, None]), u))
    st0, hist0 = run()
    for a, b in zip(st, st0):
        assert torch.equal(a, b)
    for k in hist:
        assert torch.equal(hist[k], hist0[k]), k


# --- the log-domain input ------------------------------------------------------
def _logw(b, n, seed=3, shift=-7.5):
    """Unnormalized log-weights (B, N) and their log-normalizers (B,)."""
    lw = 2.0 * torch.from_numpy(np.random.default_rng(seed).standard_normal((b, n))
                                .astype(np.float32)) + shift
    return lw, torch.logsumexp(lw, dim=-1)


@pytest.mark.parametrize("b,n", [(1, 3000), (100, 200), (1, ss.TILE), (1, 20000), (3, 20000)])
def test_log_domain_plain_equals_chain_of_exp(b, n):
    """On the CPU the log-domain input is the chain fed exp(logw − log_z):
    rows of one tile (one pass on the card) and of three tiles (three
    passes), through batched_starts and systematic_starts (the starts form)
    and _child_run_ends_u (the run-ends form) alike; each row is counted
    once in ``log_rows`` a call."""
    lw, lz = _logw(b, n)
    u = _u(b)
    w = torch.exp(lw - lz[:, None])
    before = ss.systematic_starts.log_rows
    assert torch.equal(hard.batched_starts(lw, u, log_z=lz), ss.starts_reference(w, u))
    assert torch.equal(ss.systematic_starts(lw, u, log_z=lz), ss.starts_reference(w, u))
    assert torch.equal(hard._child_run_ends_u(lw, n, u, log_z=lz), ss.run_ends_reference(w, n, u))
    assert ss.systematic_starts.log_rows == before + 3 * b


@pytest.mark.parametrize("b,n", [(1, 3000), (3, 20000)])
def test_log_domain_reaches_the_kernel(stub, b, n):
    """A CUDA tensor with log_z reaches the kernel with the log-weights and
    a pointer to log_z, the plan's sizes and launches, in the starts form
    and the run-ends form; without log_z the pointer is null (the linear
    mode)."""
    lw, lz = _logw(b, n)
    lw, lz, u = _cuda_like(lw), _cuda_like(lz), _cuda_like(_u(b))
    p = ss.plan(b, n)
    launches, rows = ss.systematic_starts.launches, ss.systematic_starts.log_rows
    hard.batched_starts(lw, u, log_z=lz)
    hard.batched_starts(_cuda_like(_weights(b, n)), u)
    hard._child_run_ends_u(lw, 7, u, log_z=lz)
    assert ss.systematic_starts.launches == launches + 3 * p.passes
    assert ss.systematic_starts.log_rows == rows + 2 * b
    log_call, lin_call, ends_call = stub.calls
    assert log_call["w"] == lw.data_ptr() and log_call["log_z"] == lz.data_ptr()
    assert (log_call["rows"], log_call["n"], log_call["tiles"], log_call["starts_form"]) == (
        b, n, p.tiles, 1)
    assert lin_call["log_z"] is None
    assert (ends_call["log_z"], ends_call["m"], ends_call["starts_form"]) == (lz.data_ptr(), 7, 0)


LOG_Z_BAD = ("f64 log_z", "log_z of another shape", "CPU log_z", "strided log_z")


@pytest.mark.parametrize("label", LOG_Z_BAD)
def test_wrapper_refuses_log_z(stub, label):
    """log_z is checked with the weights, before any launch; nothing is
    counted."""
    w, u = _cuda_like(_logw(2, 64)[0]), _cuda_like(_u(2))
    lz = {"f64 log_z": _cuda_like(torch.zeros(2, dtype=torch.float64)),
          "log_z of another shape": _cuda_like(torch.zeros(3)),
          "CPU log_z": torch.zeros(2),
          "strided log_z": _cuda_like(torch.zeros(4)[::2])}[label]
    rows = ss.systematic_starts.log_rows
    with pytest.raises(ValueError, match="log_z"):
        ss.systematic_starts(w, u, log_z=lz)
    assert stub.calls == [] and ss.systematic_starts.log_rows == rows


def _degenerate(label, n=3000):
    """(log-weights (1, N), log_z (1,)) of a degenerate cloud."""
    lw = torch.full((1, n), -math.inf)
    if label == "all -inf":  # log Z −inf, as logsumexp gives it
        return lw, torch.logsumexp(lw, -1)
    if label == "all -inf, guarded log Z":  # as kernel B1's row holds it
        return lw, torch.log(torch.tensor([1e-30]))
    if label == "one finite weight":
        lw[0, 1234] = 3.25
        return lw, torch.logsumexp(lw, -1)
    if label == "+inf log Z":
        lw = _logw(1, n)[0]
        lw[0, 77] = math.inf
        return lw, torch.logsumexp(lw, -1)
    raise ValueError(label)


@pytest.mark.parametrize("label", ["all -inf", "all -inf, guarded log Z", "one finite weight",
                                   "+inf log Z"])
def test_degenerate_clouds_as_before(label):
    """Degenerate clouds give the starts of the normalized path (the
    log-weights through log_normalize, then the chain): every weight 0, one
    weight 1, or NaN where a log-weight is +inf, as before."""
    lw, lz = _degenerate(label)
    u = _u(1)
    want = hard.batched_starts(hard._weights_from(None, lw), u)
    assert torch.equal(hard.batched_starts(lw, u, log_z=lz), want)
    w = ss.linear_weights(lw, lz)
    assert torch.equal(w.isnan(), hard._weights_from(None, lw).isnan())


def test_log_z_goes_with_logw_alone():
    """log_z without logw, or beside w, is refused."""
    p, (lw, lz) = torch.zeros((1, 64, 1)), _logw(1, 64)
    with pytest.raises(ValueError, match="log_z"):
        hard.systematic_resample_values_batched(None, p, w=torch.softmax(lw, -1), log_z=lz)
    with pytest.raises(ValueError, match="log_z"):
        hard.systematic_resample_values_batched(None, p, log_z=lz)


def test_past_2_24_log_z_takes_the_exact_path(stub, monkeypatch):
    """Past 2²⁴ the log-weights are normalized as without log_z and go to
    the exact integer run ends (the starts and the run-ends form alike); no
    row is counted in the log domain."""
    n = (1 << 24) + 8
    seen = []
    monkeypatch.setattr(hard, "exact_child_run_ends_u",
                        lambda w, m, u: seen.append(float(w.sum())) or torch.zeros(
                            (1, m), dtype=torch.int32))
    lw = torch.full((1, n), -3.0)
    rows = ss.systematic_starts.log_rows
    starts = hard.batched_starts(lw, torch.zeros(1), log_z=torch.tensor([7.0]))
    ends = hard._child_run_ends_u(lw, n, torch.zeros(1), log_z=torch.tensor([7.0]))
    assert starts.shape == (n,) and ends.shape == (1, n)
    assert stub.calls == [] and ss.systematic_starts.log_rows == rows
    assert seen == [pytest.approx(1.0, rel=1e-3)] * 2


# --- the callers -----------------------------------------------------------------
def _resample_as_before(self, generator, particles, logw, log_z):
    """FusedSIRFilter._resample on one device as it stood before the
    log-domain input: the log-weights normalized in the resample."""
    p = particles.view(self.n, 1) if self.nx == 1 else particles.T
    p_new = hard.systematic_resample_values(generator, p, logw=logw)
    return (p_new.view(self.n) if self.nx == 1 else p_new.T.contiguous()), True


def _fused_run(nx, n, T=60):
    from particle_filters_tpu_torch.ops.fused_pf import LinearObsFirstModel

    if nx == 1:
        f = FusedSIRFilter(SVModel(0.95, 1.0), [[0.04]], Np=n, device="cpu")
    else:
        f = FusedSIRFilter(LinearObsFirstModel([[0.9, 0.1], [0.0, 0.8]], 0.05),
                           [[0.04, 0.0], [0.0, 0.09]], Np=n, device="cpu")
    gen = torch.Generator().manual_seed(5)
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((T, 1)).astype(np.float32)
                         * 2.0)
    return f.run(gen, f.initialize(gen, [0.0] * nx, 0.4 * np.eye(nx)), z)


@pytest.mark.parametrize("nx,n", [(1, 4096), (1, 20000), (2, 4096)])
def test_fused_history_as_with_the_normalized_path(monkeypatch, nx, n):
    """FusedSIRFilter.run on the CPU: the resample flags equal, and the ESS,
    log-evidence and means within f32 rounding of those of the path that
    normalized the log-weights in the resample (the weights differ only by
    the normalizer's rounding); one log-domain row a resample step."""
    rows = ss.systematic_starts.log_rows
    st, hist = _fused_run(nx, n)
    n_res = int(hist["resampled"].sum())
    assert n_res > 0 and ss.systematic_starts.log_rows == rows + n_res
    monkeypatch.setattr(FusedSIRFilter, "_resample", _resample_as_before)
    st0, hist0 = _fused_run(nx, n)
    assert ss.systematic_starts.log_rows == rows + n_res
    assert torch.equal(hist["resampled"], hist0["resampled"])
    for k in ("ess", "log_evidence", "mean"):
        torch.testing.assert_close(hist[k], hist0[k], msg=k)
    torch.testing.assert_close(st[0], st0[0])


def _pf_run():
    from particle_filters_tpu_torch.models import ParticleFilter

    model = SVModel(0.95, 1.0)
    pf = ParticleFilter(lambda x, u: model.g(x), None, Q=[[0.04]], R=None, Np=2048,
                        resample_thresh=0.5, obs_loglik=model.obs_loglik, device="cpu")
    gen = torch.Generator().manual_seed(1)
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((30, 1)).astype(np.float32)
                         * 2.0)
    _, hist = pf.run(gen, pf.initialize(gen, [0.0], [[0.4]]), z)
    assert bool(hist["resampled"].any())


def _other_caller(label):
    lw, _ = _logw(1, 3000)
    gen = torch.Generator().manual_seed(0)
    return {
        "flows' batched values": lambda: hard.systematic_resample_values_batched(
            gen, torch.randn((10, 200, 3)), logw=_logw(10, 200)[0]),
        "values from logw": lambda: hard.systematic_resample_values(
            gen, torch.randn((3000, 1)), logw=lw[0]),
        "ParticleFilter": _pf_run,
        "systematic_resample": lambda: hard.systematic_resample(gen, logw=lw[0]),
        "systematic_counts": lambda: hard.systematic_counts(gen, logw=lw[0]),
        "resample_indices": lambda: hard.resample_indices("systematic", gen, logw=lw[0]),
        "run ends": lambda: hard._child_run_ends(gen, torch.softmax(lw, -1), 3000),
    }[label]


@pytest.mark.parametrize("label", ["flows' batched values", "values from logw", "ParticleFilter",
                                   "systematic_resample", "systematic_counts",
                                   "resample_indices", "run ends"])
def test_other_callers_take_the_linear_path(label):
    """Every caller that passes no log_z (the flows, ParticleFilter, the
    counts and index paths, the run ends) leaves ``log_rows`` unchanged."""
    rows = ss.systematic_starts.log_rows
    _other_caller(label)()
    assert ss.systematic_starts.log_rows == rows


def test_flows_reach_the_kernel_in_the_linear_mode(stub, monkeypatch):
    """The flows' batched values resample on a CUDA tensor calls kernel S
    with a null log_z."""
    normalized = hard._weights_from
    monkeypatch.setattr(hard, "_weights_from", lambda w, logw: _cuda_like(normalized(w, logw)))
    monkeypatch.setattr(hard, "resample_by_starts", lambda p, s: p)
    monkeypatch.setattr(hard, "_uniform",
                        lambda gen, shape, like: _cuda_like(torch.rand(shape)))
    hard.systematic_resample_values_batched(None, _cuda_like(torch.zeros((10, 200, 3))),
                                            logw=_logw(10, 200)[0])
    assert [(c["rows"], c["n"], c["log_z"]) for c in stub.calls] == [(10, 200, None)]
