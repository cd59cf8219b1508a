"""The gradient through the Sinkhorn-OT resampler: the tile VJP's plain
version, the whole-run gradient of ``DPF_OT``'s log-evidence, and the route a
call that needs a gradient takes.

On the CPU:

- ``ops/sinkhorn_tile.py::sinkhorn_tile_vjp_reference`` (the VJP kernels'
  algebra: a row and a column pass a half-update and for the projection, each
  recomputing the softmax or the plan from the saved potentials and k·τ,
  the cotangents of f and g carried with their (1 − δ)) against the dense
  path's autograd, for the cloud and log a, over ε, the damping, the number
  of iterations and d; in float64 (where the plain version's scales are
  unrounded, so both compute one function) and in float32.
- The program's whole-run gradient of the log-evidence in (α, σ, β) (CPU,
  the dense path's autograd) against the plain reference
  ``h100_bench/configs/sv_dpf_ot_grad.py`` at N = 64, T = 5, and both against
  central differences of the reference's log-evidence in float64.
- The route on a stubbed card (a CPU tensor whose ``device`` reads ``cuda``,
  the library a stub that records its calls): a call that needs the
  gradient runs the dual loop keeping its history, the projection, and in
  the backward the VJP, with the counters raised by the launch plan; a
  backward asked to build a graph (a second derivative) raises.

On the card (``cuda`` marker): the VJP kernels against the plain version,
the tile gradient against the dense autograd, the backward's memory at
N = 8192, and a backward run twice, bit for bit. Run on a GPU host with

    python -m pytest tests/test_torch_sinkhorn_vjp.py -q -m cuda --noconftest
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from h100_bench import harness
from particle_filters_tpu_torch.models.dpf import DPF_OT
from particle_filters_tpu_torch.ops import _nvcc
from particle_filters_tpu_torch.ops import sinkhorn_tile as st
from particle_filters_tpu_torch.resampling import ot

torch.set_num_threads(1)


def _problem(n, d, dtype=torch.float32, seed=0, device="cpu"):
    """A cloud, normalized log masses, uniform log b and a cotangent of the
    new particles."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = 0.64 * torch.randn((n, d), generator=g, device=device).to(dtype)
    log_a = torch.log_softmax(torch.randn((n,), generator=g, device=device).to(dtype), 0)
    cot = torch.randn((n, d), generator=g, device=device).to(dtype)
    return x, log_a, torch.full((n,), -math.log(n), dtype=dtype, device=device), cot


def _dense_grads(x, log_a, cot, **kw):
    """The dense path's autograd: d⟨cot, new particles⟩ / d(x, log a)."""
    xx, la = x.clone().requires_grad_(True), log_a.clone().requires_grad_(True)
    out, _ = ot._torch_resample(xx, la, tol=1e-6, return_diagnostics=False, **kw)
    return torch.autograd.grad(torch.sum(out * cot), (xx, la))


def _plain_grads(x, log_a, log_b, cot, **kw):
    *_, saved = st.sinkhorn_tile_reference(x, log_a, log_b, keep=True, **kw)
    new_x = st.sinkhorn_tile_reference(x, log_a, log_b, **kw)[2]
    return st.sinkhorn_tile_vjp_reference(x, log_a, log_b, saved, new_x, cot,
                                          epsilon=kw["epsilon"], damping=kw["damping"])


def _rel(a, b):
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


# The plain VJP against the dense autograd, the largest gap over the largest
# gradient entry. float64: both compute one function (the plain version's
# scales unrounded), so they differ by float64 rounding alone (~1e-14 read).
# float32: each of the 100 half-updates re-rounds a logsumexp of terms divided
# by ε, and each pass sums N terms in another order (tiles of 32 against the
# dense path's rows): ≤ 2e-5 read over these cases; a bfloat16 backward (8
# bits, ~4e-3 a rounding) is far outside 1e-4.
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("n_iters", [1, 7, 50])
@pytest.mark.parametrize("damping", [0.5, 1.0])
@pytest.mark.parametrize("epsilon", [0.1, 0.5])
def test_vjp_reference_matches_dense_autograd(epsilon, damping, n_iters, d, dtype):
    x, log_a, log_b, cot = _problem(37, d, dtype, seed=n_iters + 10 * d)
    kw = dict(epsilon=epsilon, n_iters=n_iters, damping=damping)
    gx, gla = _dense_grads(x, log_a, cot, **kw)
    px, pla = _plain_grads(x, log_a, log_b, cot, **kw)
    assert float(gx.abs().max()) > 0 and float(gla.abs().max()) > 0
    assert _rel(px, gx) <= TOL[dtype]
    assert _rel(pla, gla) <= TOL[dtype]


def test_vjp_reference_tile_width_changes_only_rounding():
    x, log_a, log_b, cot = _problem(100, 3, seed=4)
    kw = dict(epsilon=0.1, n_iters=10, damping=0.5)
    *_, saved = st.sinkhorn_tile_reference(x, log_a, log_b, keep=True, **kw)
    new_x = st.sinkhorn_tile_reference(x, log_a, log_b, **kw)[2]
    tiled = st.sinkhorn_tile_vjp_reference(x, log_a, log_b, saved, new_x, cot, epsilon=0.1,
                                           damping=0.5)
    whole = st.sinkhorn_tile_vjp_reference(x, log_a, log_b, saved, new_x, cot, epsilon=0.1,
                                           damping=0.5, tile=100)
    for a, b in zip(tiled, whole):
        assert _rel(a, b) <= 1e-5


def test_reference_keeps_what_the_kernels_save():
    """The history the forward keeps: f and g after every iteration (row 0
    zeros, the last row the loop's f and g), and each half-update's k·τ, the
    one that re-forms its output."""
    x, log_a, log_b, _ = _problem(20, 2, seed=5)
    f, g, _, _, (pots, lse) = st.sinkhorn_tile_reference(x, log_a, log_b, epsilon=0.2,
                                                         n_iters=4, damping=0.5, keep=True)
    assert pots.shape == (5, 2, 20) and lse.shape == (4, 2, 20)
    assert torch.equal(pots[0], torch.zeros(2, 20))
    assert torch.equal(pots[-1, 0], f) and torch.equal(pots[-1, 1], g)
    _, k, _ = st.scales(0.2)
    np.testing.assert_allclose(pots[1, 0].numpy(), (0.5 * lse[0, 0] / k).numpy(), rtol=1e-6)


# ------------------------- the whole run's gradient -----------------------------

GRAD = harness.load_module("configs", "sv_dpf_ot_grad")
N, T = 64, 5
CFG = dict(harness.load_json("configs", "sv_dpf_ot_grad"), steps=T)
PARAMS = ("alpha", "sigma", "beta")


def _inputs(seed):
    """One sequence, the initial normals and the (T, N) transition noise."""
    gen = torch.Generator().manual_seed(seed)
    _, ys = GRAD.simulate(CFG, 1, gen, torch.device("cpu"))
    e0 = torch.randn((N,), generator=gen)
    vs = torch.randn((T, N), generator=gen)
    return ys[0], e0, vs


def _program_grads(ys, e0, vs):
    """The program's log-evidence and its gradient in (α, σ, β): ``DPF_OT``
    with the parameters in its closures and its initial cloud's std."""
    alpha, sigma, beta = (torch.tensor(CFG[k], requires_grad=True) for k in PARAMS)
    noise = iter(vs)

    def transition(generator, x, t):
        return alpha * x + sigma * next(noise)[:, None]

    def loglik(x, y, t):
        x = x[:, 0]
        return -0.5 * (y * y / (beta * beta) * torch.exp(-x) + x + 2 * torch.log(beta))

    filt = DPF_OT(N, 1, transition, loglik, epsilon=CFG["epsilon"],
                  n_sinkhorn_iters=CFG["sinkhorn_iters"], damping=CFG["damping"], device="cpu")
    std0 = sigma / torch.sqrt(1 - alpha * alpha)
    _, _, log_z = filt.run_filter(None, ys[:, None], [0.0], std0.reshape(1, 1),
                                  init_eps=e0[:, None], return_log_evidence=True)
    return log_z.detach(), torch.stack(torch.autograd.grad(log_z, (alpha, sigma, beta)))


def _central_differences(ys, e0, vs, h=1e-5):
    """The reference's log-evidence differenced in float64, each parameter
    moved by ±h."""
    out = []
    for k in PARAMS:
        lz = [GRAD.run(dict(CFG, **{k: CFG[k] + s * h}), e0.double(), ys.double(), vs.double(),
                       dtype=torch.float64)["log_evidence"].double() for s in (1, -1)]
        out.append((lz[0] - lz[1]) / (2 * h))
    return torch.stack(out)


SEEDS = (3, 2**33 + 17)


@pytest.mark.parametrize("seed", SEEDS)
def test_program_gradient_matches_the_plain_reference(seed):
    """The program's whole-run gradient (the dense path's autograd through
    every step and all 50 iterations) against the reference's own run from
    the same draws: they differ by the cost's rounding (x² − 2xy + y²
    against (x − y)², ~1e-6 of the plan's exponents), ≤ 1e-6 of the
    gradient's norm read; the log-evidence as ``sv_dpf_ot``'s test holds it."""
    ys, e0, vs = _inputs(seed)
    log_z, grads = _program_grads(ys, e0, vs)
    ref = GRAD.run(CFG, e0, ys, vs)
    assert float(torch.linalg.norm(ref["grads"])) > 1.0
    assert float(torch.max(torch.abs(grads - ref["grads"])) / torch.linalg.norm(ref["grads"])) \
        <= 2e-5
    assert abs(float(log_z) - float(ref["log_evidence"])) <= 1e-5


@pytest.mark.parametrize("seed", SEEDS)
def test_gradients_match_central_differences_in_float64(seed):
    """The reference's autograd in float64 (checkpointed half-updates, β's
    gradient through its own log) against central differences of its
    log-evidence at h = 1e-5 (truncation ~h², rounding ~1e-11): within 1e-6
    of the norm; the program's float32 gradient within float32's share,
    1e-4 of the norm (it reads ≤ 1e-5)."""
    ys, e0, vs = _inputs(seed)
    fd = _central_differences(ys, e0, vs)
    ref = GRAD.run(CFG, e0.double(), ys.double(), vs.double(), dtype=torch.float64)
    norm = float(torch.linalg.norm(fd))
    assert float(torch.max(torch.abs(ref["grads"] - fd))) / norm <= 1e-6
    _, grads = _program_grads(ys, e0, vs)
    assert float(torch.max(torch.abs(grads.double() - fd))) / norm <= 1e-4


def test_bfloat16_control_fails_the_gradient_tolerance():
    """The reference in bfloat16 throughout, the gradient included, lies far
    outside the program's 2e-5 of the norm."""
    ys, e0, vs = _inputs(SEEDS[0])
    ref = GRAD.run(CFG, e0, ys, vs)
    ctl = GRAD.control(CFG, e0, ys, vs)
    gap = float(torch.max(torch.abs(ctl["grads"] - ref["grads"])) / torch.linalg.norm(ref["grads"]))
    assert gap > 1e-3


# ------------------------------- the route --------------------------------------


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lives on the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _cuda_like(t):
    return t.as_subclass(_CudaLike)


class _Stub:
    """Stands in for the built library: records each entry's call."""

    def __init__(self):
        self.calls = []

        def pf_sinkhorn_dual(x, log_a, log_b, f, g, delta, saved, lse, n, d, n_iters, eps, k,
                             xs, damping, stream):
            kind = "dual" if saved is None else "dual with history"
            self.calls.append((kind, dict(f=f, lse=lse is not None, n=n, n_iters=n_iters)))
            return 0

        def pf_sinkhorn_project(x, log_a, f, g, out, n, d, eps, k, xs, stream):
            self.calls.append(("project", dict(n=n, d=d)))
            return 0

        def pf_sinkhorn_vjp(x, log_a, log_b, saved, lse, x_out, grad_out, grad_x, grad_log_a,
                            cot_f, cot_g, n, d, n_iters, eps, k, xs, damping, stream):
            self.calls.append(("vjp", dict(n=n, d=d, n_iters=n_iters, damping=damping)))
            return 0

        self.pf_sinkhorn_dual = pf_sinkhorn_dual
        self.pf_sinkhorn_project = pf_sinkhorn_project
        self.pf_sinkhorn_vjp = pf_sinkhorn_vjp


@pytest.fixture
def stub(monkeypatch):
    lib = _Stub()
    monkeypatch.setattr(_nvcc, "load_library", lambda name, *sources: lib)
    monkeypatch.setattr(_nvcc, "on_device", lambda device: contextlib.nullcontext(0))
    # autograd hands the backward plain CPU tensors: let them read ``cuda`` too
    vjp = ot.sinkhorn_tile_vjp
    monkeypatch.setattr(ot, "sinkhorn_tile_vjp", lambda x, la, lb, saved, new_x, cot, **kw: vjp(
        *map(_cuda_like, (x, la, lb)), tuple(map(_cuda_like, saved)), _cuda_like(new_x),
        _cuda_like(cot), **kw))
    return lib


@pytest.mark.parametrize("what", ["particles", "weights"])
def test_gradient_call_keeps_the_history_and_runs_the_vjp(stub, what):
    x, log_a, _, cot = _problem(64, 2, seed=6)
    w = torch.exp(log_a)
    x, w = _cuda_like(x), _cuda_like(w)
    (x if what == "particles" else w).requires_grad_(True)
    before = (st.sinkhorn_tile.launches, ot.sinkhorn_ot_resample.half_updates,
              ot.sinkhorn_ot_resample.vjp_half_updates)
    new_x, _ = ot.sinkhorn_ot_resample(x, w, epsilon=0.2, n_iters=7, damping=0.25)
    assert [c[0] for c in stub.calls] == ["dual with history", "project"]
    dual = stub.calls[0][1]
    assert dual == dict(f=None, lse=True, n=64, n_iters=7)
    assert st.sinkhorn_tile.launches == before[0] + st.launches(7)
    assert ot.sinkhorn_ot_resample.half_updates == before[1] + 14
    assert ot.sinkhorn_ot_resample.vjp_half_updates == before[2]
    torch.autograd.grad(torch.sum(new_x * _cuda_like(cot)), x if what == "particles" else w)
    assert [c[0] for c in stub.calls] == ["dual with history", "project", "vjp"]
    assert stub.calls[2][1] == dict(n=64, d=2, n_iters=7, damping=0.25)
    assert st.sinkhorn_tile.launches == before[0] + st.launches(7) + st.vjp_launches(7)
    assert ot.sinkhorn_ot_resample.vjp_half_updates == before[2] + 14


def test_call_without_the_gradient_is_unchanged(stub):
    """The same call under ``no_grad`` launches the plain dual loop (no
    history) and the projection, and nothing else."""
    x, log_a, _, _ = _problem(64, 1, seed=7)
    x = _cuda_like(x).requires_grad_(True)
    before = st.sinkhorn_tile.launches
    with torch.no_grad():
        ot.sinkhorn_ot_resample(x, _cuda_like(torch.exp(log_a)), n_iters=5)
    assert [c[0] for c in stub.calls] == ["dual", "project"]
    assert stub.calls[0][1]["f"] is not None and not stub.calls[0][1]["lse"]
    assert st.sinkhorn_tile.launches == before + st.launches(5)


def test_second_derivative_through_the_tile_route_raises(stub):
    """The tile backward's kernels build no graph: a backward asked to build
    one raises before it launches, where it would otherwise drop the
    resampler's share of the second derivative; without ``create_graph`` the
    same call runs the VJP."""
    x, log_a, _, cot = _problem(16, 1, seed=11)
    x = _cuda_like(x).requires_grad_(True)
    new_x, _ = ot.sinkhorn_ot_resample(x, _cuda_like(torch.exp(log_a)), n_iters=3)
    loss = torch.sum(new_x**2 * _cuda_like(cot))  # its cotangent depends on x
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(loss, x, create_graph=True, retain_graph=True)
    assert [c[0] for c in stub.calls] == ["dual with history", "project"]
    torch.autograd.grad(loss, x)
    assert [c[0] for c in stub.calls] == ["dual with history", "project", "vjp"]


def test_vjp_launch_plan():
    assert [st.vjp_launches(i) for i in (0, 1, 50)] == [2, 6, 202]


def test_vjp_wrapper_refuses_a_short_history(stub):
    x, log_a, log_b, cot = (_cuda_like(t) for t in _problem(8, 1, seed=8))
    saved = (_cuda_like(torch.zeros(4, 2, 8)), _cuda_like(torch.zeros(2, 2, 8)))
    with pytest.raises(ValueError):
        st.sinkhorn_tile_vjp(x, log_a, log_b, saved, x, cot, epsilon=0.1, damping=0.5)
    assert stub.calls == []


# ------------------------------- on the card ------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tile_forward(x, log_a, log_b, n_iters=50, epsilon=0.1, damping=0.5):
    n = x.shape[0]
    saved = (log_a.new_empty((n_iters + 1, 2, n)), log_a.new_empty((n_iters, 2, n)))
    f, g, _ = st.sinkhorn_tile(x, log_a, log_b, epsilon=epsilon, n_iters=n_iters,
                               damping=damping, saved=saved)
    return saved, st.tile_projection(x, log_a, f, g, epsilon=epsilon)


# Kernels against the plain version on the same saved history: ex2.approx
# (2 ulp) against torch.exp2 and sums in another order (a warp's partners,
# then 16 warps in order, against tiles of 32), over 202 passes: ≤ 1.1e-5 of
# the largest entry read at these sizes (N = 64 to 8192); bfloat16 would be
# ~4e-3.
KERNEL_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("n", [64, 1000, 8192])
def test_vjp_kernels_match_plain(cuda_device, n, d):
    x, log_a, log_b, cot = _problem(n, d, seed=7, device=cuda_device)
    saved, new_x = _tile_forward(x, log_a, log_b)
    before = st.sinkhorn_tile.launches
    gx, gla = st.sinkhorn_tile_vjp(x, log_a, log_b, saved, new_x, cot, epsilon=0.1, damping=0.5)
    torch.cuda.synchronize()
    assert st.sinkhorn_tile.launches == before + st.vjp_launches(50)
    tile = 256 if n > 1000 else st.TILE  # the plain version's tiles: rounding only
    px, pla = st.sinkhorn_tile_vjp_reference(x, log_a, log_b, saved, new_x, cot, epsilon=0.1,
                                             damping=0.5, tile=tile)
    assert torch.isfinite(gx).all() and torch.isfinite(gla).all()
    assert _rel(gx, px) <= KERNEL_TOL and _rel(gla, pla) <= KERNEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3])
def test_tile_gradient_matches_dense_autograd(cuda_device, d):
    """The tile route's gradient for the cloud and the weights against the
    dense path's autograd on the card at N = 1024 (the dense path forms the
    N × N cost): ≤ 1.2e-5 of the largest entry read, 1e-4 allowed as above."""
    x, log_a, _, cot = _problem(1024, d, seed=3, device=cuda_device)
    w = torch.exp(log_a)

    def grads(route):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if route == "tile":
            out, _ = ot.sinkhorn_ot_resample(xx, ww, epsilon=0.1, n_iters=50, damping=0.5)
        else:
            wc = torch.clamp(ww, min=1e-12)
            out, _ = ot._torch_resample(xx, torch.log(wc / (torch.sum(wc) + 1e-12)),
                                        epsilon=0.1, n_iters=50, tol=1e-6, damping=0.5,
                                        return_diagnostics=False)
        return torch.autograd.grad(torch.sum(out * cot), (xx, ww))

    before = ot.sinkhorn_ot_resample.vjp_half_updates
    tx, tw = grads("tile")
    assert ot.sinkhorn_ot_resample.vjp_half_updates == before + 100
    dx, dw = grads("dense")
    assert _rel(tx, dx) <= KERNEL_TOL and _rel(tw, dw) <= KERNEL_TOL


@pytest.mark.cuda
def test_backward_allocates_nothing_n_squared(cuda_device):
    """One resample's backward at N = 8192 allocates under 64 MB above the
    saved state (an N × N float32 tensor is 256 MB), and runs twice bit for
    bit: the passes combine their partials in a fixed order, with no
    atomics."""
    x, log_a, _, cot = _problem(8192, 1, seed=9, device=cuda_device)
    xx = x.clone().requires_grad_(True)
    out, _ = ot.sinkhorn_ot_resample(xx, torch.exp(log_a), epsilon=0.1, n_iters=50,
                                     damping=0.5)
    loss = torch.sum(out * cot)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (g1,) = torch.autograd.grad(loss, xx, retain_graph=True)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - held < 64 * 2**20
    (g2,) = torch.autograd.grad(loss, xx)
    assert torch.equal(g1, g2)
