"""The Sinkhorn tile kernels' plain version and the dispatch of
``resampling/ot.py::sinkhorn_ot_resample``, on the CPU.

- ``ops/sinkhorn_tile.py::sinkhorn_tile_reference`` (the kernels' algebra:
  base-2 arguments, the h-form damped half-update, τ_g as τ_f with (f,
  log a), the projection exp(g/ε)·Σ exp((h − C)/ε)·x, a running max a row
  over column tiles of 32) against the dense torch path: the new particles,
  the per-iteration dual changes and the potentials' moments, to f32
  rounding (the tolerances of the dense path against the JAX package, for
  the same reason: each of the 100 half-updates re-rounds a logsumexp of
  terms divided by ε). N = 1, 7, 100 and 513 (none a multiple of the
  tile), d = 1 and 3; a spread cloud, and a point mass (one weight near 1,
  the rest at the 1e-12 floor) with a particle 8σ out, whose row needs its
  own running max (a global shift underflows it to a zero sum).
- Dispatch: CPU tensors never load the kernels; a float32 cloud on the card
  takes them (a CUDA tensor stood in for by a CPU tensor whose ``device``
  reads ``cuda``, the library by a stub that records its calls), with the
  counters raised by the launch plan; a call that needs autograd's gradient
  takes them too (through the tile VJP: ``tests/test_torch_sinkhorn_vjp.py``),
  while one under ``torch.func`` (``grad``, or ``vmap`` with tensor ε and
  damping, as ``examples/ex08_dpf_ot_tuning.py``'s sweep) keeps the torch
  ops even where the cloud is on the card.

The kernels themselves are held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from particle_filters_tpu_torch.models.dpf import DPF_OT
from particle_filters_tpu_torch.ops import _nvcc
from particle_filters_tpu_torch.ops import sinkhorn_tile as st
from particle_filters_tpu_torch.resampling import ot

torch.set_num_threads(1)

TOLS = {0.1: dict(rtol=2e-4, atol=2e-5), 0.01: dict(rtol=1e-3, atol=1e-4)}
CASES = [("spread", 0.1, 0.5), ("point mass, 8 sigma out", 0.1, 0.5),
         ("point mass, 8 sigma out", 0.01, 1.0)]


def _cloud(n, d, case, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    if case == "spread":
        return x, torch.softmax(torch.randn((n,), generator=g), 0)
    w = torch.full((n,), 1e-12)
    w[0] = 1.0
    x[-1] = 8.0
    return x, w / w.sum()


def _log_masses(w, min_val=1e-12):
    wc = torch.clamp(w, min=min_val)
    return torch.log(wc / (torch.sum(wc) + min_val)), torch.full_like(w, -math.log(w.shape[0]))


@pytest.mark.parametrize("case,epsilon,damping", CASES)
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("n", [1, 7, 100, 513])
def test_reference_matches_dense(n, d, case, epsilon, damping):
    x, w = _cloud(n, d, case)
    kw = dict(epsilon=epsilon, n_iters=50, damping=damping)
    dense, _, diag = ot.sinkhorn_ot_resample(x, w, return_diagnostics=True, **kw)
    f, g, plain, hist = st.sinkhorn_tile_reference(x, *_log_masses(w), **kw)
    tol = TOLS[epsilon]
    assert torch.isfinite(plain).all()
    np.testing.assert_allclose(plain.numpy(), dense.numpy(), **tol)
    np.testing.assert_allclose(hist.numpy(), diag["convergence_history"].numpy(), **tol)
    duals = diag["dual_variables"]
    for v, name in ((f, "f"), (g, "g")):
        np.testing.assert_allclose(float(torch.mean(v)), float(duals[f"{name}_mean"]), **tol)
        np.testing.assert_allclose(float(torch.std(v, unbiased=False)),
                                   float(duals[f"{name}_std"]), **tol)


@pytest.mark.parametrize("n", [100, 513])
def test_reference_tile_width_changes_only_rounding(n):
    """The running max over tiles of 32 against one tile of every column."""
    x, w = _cloud(n, 3, "point mass, 8 sigma out", seed=1)
    kw = dict(epsilon=0.1, n_iters=20, damping=0.5)
    tiled = st.sinkhorn_tile_reference(x, *_log_masses(w), **kw)
    whole = st.sinkhorn_tile_reference(x, *_log_masses(w), tile=n, **kw)
    for a, b in zip(tiled, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOLS[0.1])


def test_running_max_is_per_row():
    """A row whose arguments all lie ~1000 below the others' (a particle far
    from every other, its own h low): one shift for all rows underflows its
    sum to 0; the running max a row, over tiles of 32, keeps its log-sum."""
    g = torch.Generator().manual_seed(2)
    a = 3.0 * torch.randn((5, 70), generator=g)
    a[-1] -= 1000.0
    assert float(torch.exp2(a[-1] - a.max()).sum()) == 0.0
    top, acc = st._running_lse2(lambda cols: a[:, cols], 70, a)
    exact = torch.logsumexp(a.double() * math.log(2), 1) / math.log(2)
    np.testing.assert_allclose((top + torch.log2(acc[:, 0])).numpy(), exact.numpy(), rtol=1e-6)


def test_launch_plan():
    assert [st.launches(i) for i in (0, 1, 50)] == [1, 3, 101]


# ------------------------------- dispatch ----------------------------------


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
            assert saved is None and lse is None  # no history kept without a gradient
            self.calls.append(("dual", dict(delta=delta, n=n, d=d, n_iters=n_iters, eps=eps,
                                            k=k, xs=xs, damping=damping)))
            return 0

        def pf_sinkhorn_project(x, log_a, f, g, out, n, d, eps, k, xs, stream):
            self.calls.append(("project", dict(n=n, d=d, eps=eps, k=k, xs=xs)))
            return 0

        self.pf_sinkhorn_dual = pf_sinkhorn_dual
        self.pf_sinkhorn_project = pf_sinkhorn_project


class _Refuse:
    """A library that must not be reached."""

    def __getattr__(self, name):
        raise AssertionError(f"the kernels were reached ({name})")


@pytest.fixture
def stub(monkeypatch):
    lib = _Stub()
    monkeypatch.setattr(_nvcc, "load_library", lambda name, *sources: lib)
    monkeypatch.setattr(_nvcc, "on_device", lambda device: contextlib.nullcontext(0))
    return lib


@pytest.fixture
def refuse(monkeypatch):
    def load(name, *sources):
        raise AssertionError("the kernels were loaded")

    monkeypatch.setattr(_nvcc, "load_library", load)


def test_cpu_calls_never_load_the_kernels(refuse):
    x, w = _cloud(40, 1, "spread")
    before = ot.sinkhorn_ot_resample.half_updates
    ot.sinkhorn_ot_resample(x, w, n_iters=5, return_diagnostics=True)
    assert ot.sinkhorn_ot_resample.half_updates == before + 10
    filt = DPF_OT(32, 1, lambda g, p, t: 0.9 * p + 0.1 * torch.randn(p.shape, generator=g),
                  lambda p, y, t: -0.5 * (p[:, 0] - y[0]) ** 2, n_sinkhorn_iters=5, device="cpu")
    ps, _ = filt.run_filter(torch.Generator().manual_seed(0), torch.zeros((3, 1)), [0.0], [[1.0]])
    assert torch.isfinite(ps).all()


@pytest.mark.parametrize("diagnostics", [False, True])
@pytest.mark.parametrize("d", [1, 3])
def test_card_cloud_takes_the_kernels(stub, d, diagnostics):
    x, w = _cloud(64, d, "spread")
    launches, halves = st.sinkhorn_tile.launches, ot.sinkhorn_ot_resample.half_updates
    out = ot.sinkhorn_ot_resample(_cuda_like(x), _cuda_like(w), epsilon=0.2, n_iters=7,
                                  damping=0.25, return_diagnostics=diagnostics)
    assert [c[0] for c in stub.calls] == ["dual", "project"]
    eps, k, xs = st.scales(0.2)
    dual, project = stub.calls[0][1], stub.calls[1][1]
    assert dual == dict(delta=dual["delta"], n=64, d=d, n_iters=7, eps=eps, k=k, xs=xs,
                        damping=0.25)
    assert (dual["delta"] is not None) == diagnostics
    assert project == dict(n=64, d=d, eps=eps, k=k, xs=xs)
    assert st.sinkhorn_tile.launches == launches + st.launches(7)
    assert ot.sinkhorn_ot_resample.half_updates == halves + 14
    assert out[0].shape == (64, d) and len(out) == (3 if diagnostics else 2)
    np.testing.assert_allclose(out[1].numpy(), np.full(64, 1 / 64), rtol=1e-6)


@pytest.mark.parametrize("what", ["float64", "d = 5", "tensor epsilon", "tensor damping",
                                  "particles need the gradient", "weights need the gradient"])
def test_what_keeps_the_torch_ops_on_the_card(monkeypatch, what):
    x, w = _cloud(16, 5 if what == "d = 5" else 2, "spread")
    eps, damping = 0.1, 0.5
    if what == "float64":
        x, w = x.double(), w.double()
    elif what == "tensor epsilon":
        eps = torch.tensor(0.1)
    elif what == "tensor damping":
        damping = torch.tensor(0.5)
    if "gradient" not in what:
        assert not ot._on_tiles(_cuda_like(x), _cuda_like(w), eps, damping)
        return
    # autograd's gradient takes the tile kernels on the card (their VJP in
    # the backward) and the torch ops on the CPU; under torch.func (here
    # its grad, on a cloud that reads ``cuda``) the torch ops stay
    argnum = 0 if what.startswith("particles") else 1
    (x, w)[argnum].requires_grad_(True)
    assert ot._on_tiles(_cuda_like(x), _cuda_like(w), eps, damping)
    assert not ot._on_tiles(x, w, eps, damping)
    monkeypatch.setattr(ot, "_on_card", lambda t: True)
    routes = []

    def probe(xx, ww):
        routes.append(ot._on_tiles(xx, ww, eps, damping))
        return torch.sum(xx) + torch.sum(ww)

    torch.func.grad(probe, argnums=argnum)(x.detach(), w.detach())
    assert routes == [False]


def test_gradient_reaches_the_particles_through_the_torch_ops(monkeypatch):
    """On the CPU autograd differentiates the torch ops; on the card a
    ``torch.func.grad`` keeps them (the library is never reached) and gives
    the same gradient."""
    x, w = _cloud(24, 2, "spread")
    c = torch.arange(48.0).reshape(24, 2) % 3 - 1.0

    def functional(xx):
        new_p, _ = ot.sinkhorn_ot_resample(xx, w, epsilon=0.1, n_iters=20)
        return torch.sum(torch.tanh(new_p) * c)

    xx = x.clone().requires_grad_(True)
    functional(xx).backward()
    on_cpu = xx.grad
    monkeypatch.setattr(ot, "_on_card", lambda t: True)
    monkeypatch.setattr(_nvcc, "load_library", lambda name, *sources: _Refuse())
    on_card = torch.func.grad(functional)(x)
    assert torch.isfinite(on_card).all() and float(on_card.abs().max()) > 0
    assert torch.equal(on_card, on_cpu)


def test_vmapped_sweep_keeps_the_torch_ops_and_matches_each_call(monkeypatch):
    """ε and damping as batched 0-d tensors, as ex08's sweep hands them,
    against each cell's call on the CPU."""
    x, w = _cloud(30, 1, "spread")
    grid = [(0.05, 0.5), (0.1, 1.0), (0.2, 0.7)]
    each = [ot.sinkhorn_ot_resample(x, w, epsilon=e, damping=d, n_iters=15)[0] for e, d in grid]
    clouds = torch.stack([x, x + 0.5])
    each_cloud = [ot.sinkhorn_ot_resample(c, w, n_iters=15)[0] for c in clouds]
    monkeypatch.setattr(ot, "_on_card", lambda t: True)
    monkeypatch.setattr(_nvcc, "load_library", lambda name, *sources: _Refuse())
    eps = torch.tensor([e for e, _ in grid])
    damp = torch.tensor([d for _, d in grid])

    def one(e, d):
        return ot.sinkhorn_ot_resample(x, w, epsilon=e, damping=d, n_iters=15)[0]

    batched = torch.func.vmap(one)(eps, damp)
    for i in range(len(grid)):
        np.testing.assert_allclose(batched[i].numpy(), each[i].numpy(), rtol=1e-5, atol=1e-6)
    # a vmapped cloud with Python numbers keeps them too
    moved = torch.func.vmap(lambda p: ot.sinkhorn_ot_resample(p, w, n_iters=15)[0])(clouds)
    for i in range(2):
        np.testing.assert_allclose(moved[i].numpy(), each_cloud[i].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("what", ["on the CPU", "d = 5", "float64", "not contiguous",
                                  "a short vector"])
def test_wrapper_refuses_what_the_kernels_do_not_take(stub, what):
    x, w = _cloud(8, 5 if what == "d = 5" else 2, "spread")
    log_a, log_b = _log_masses(w)
    if what == "float64":
        x = x.double()
    elif what == "not contiguous":
        x = torch.cat([x, x], 1)[:, ::2]
    elif what == "a short vector":
        log_b = log_b[:-1]
    if what != "on the CPU":
        x, log_a, log_b = (_cuda_like(t) for t in (x, log_a, log_b))
    with pytest.raises((ValueError, TypeError)):
        st.sinkhorn_tile(x, log_a, log_b, epsilon=0.1, n_iters=3, damping=0.5)
    assert stub.calls == []
