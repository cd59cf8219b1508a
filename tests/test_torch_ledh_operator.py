"""The LEDH flow applies Aⁱ as an operator and never forms it
(``models/ledh_particle_filter.py``: ``LEDHFlowPF._per_particle_factors``,
``_lambda_step`` and ``_apply_flow_matrix``).

- On the CPU, in float64: every λ-step's η, η̄ and log-det of
  ``_lambda_step`` against the explicit form built here (the lines the
  operator form replaced: Y = LK⁻¹W, G = sym(W − YᵀY), Aⁱ = −½PG,
  (I + λAⁱ), (I + 2λAⁱ)), on a uniform grid and on a temper schedule, at
  d = 4, 16, 64 and 144, with each particle's own Jacobian and with one
  Jacobian for all particles.
- On the CPU, the operations one λ-step of ``LEDHFlowPF._flow`` dispatches
  under ``vmap`` (trials × particles), for both kinds of Jacobian: no
  d-wide triangular solve and no d×d by d×d product over the particles
  but the two that form W (none where the Jacobian is shared, and no
  copy of the factor a particle), no more operations than the explicit
  form dispatched, and two operator applies.
- On the card (``cuda`` marker): one step of the skew-t LEDH at d = 144
  against the explicit form in float64 on the card, the program in
  float64 and in float32. Run on a GPU host with

    python -m pytest tests/test_torch_ledh_operator.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from particle_filters_tpu_torch.core.linalg import chol_solve, chol_with_jitter, symmetrize
from particle_filters_tpu_torch.models import ExtendedKalmanFilter, GaussianTracker
from particle_filters_tpu_torch.models.ledh_particle_filter import LEDHConfig, LEDHFlowPF

F64 = torch.float64
BETA = np.array([0.0, 0.02, 0.07, 0.15, 0.3, 0.5, 0.72, 0.9, 1.0], np.float32)


def explicit_step(filt, lam, dlam, one_minus_c, eta, etabar, eta0, P, P_inv, z, I):
    """One particle's λ-step with Aⁱ formed, as the flow computed it before
    it applied Aⁱ as an operator: ``(η, η̄, log-det)``."""
    Hi = filt.Jh(eta)
    ei = filt.h(eta) - Hi @ eta
    W = symmetrize(Hi.T @ (filt.R_inv @ Hi))
    jit_eye = 1e-8 * I
    LK = torch.linalg.cholesky(P_inv / lam + W + jit_eye)
    L_num = torch.linalg.cholesky(P_inv / lam + one_minus_c * W + jit_eye)
    Y = torch.linalg.solve_triangular(LK, W, upper=False)
    G = symmetrize(W - Y.T @ Y)
    Ai = -0.5 * P @ G
    u = P @ (Hi.T @ (filt.R_inv @ (z - ei)))
    bi = (I + 2.0 * lam * Ai) @ ((I + lam * Ai) @ u + Ai @ eta0)
    logdet = 2.0 * (torch.sum(torch.log(torch.diagonal(L_num)))
                    - torch.sum(torch.log(torch.diagonal(LK))))
    return eta + dlam * (Ai @ eta + bi), etabar + dlam * (Ai @ etabar + bi), logdet


def one_minus_c(lam, dlam):
    """1 − ε/(2λ) in float32, as ``LEDHFlowPF._flow`` computes it."""
    c = np.float32(dlam) / (np.float32(2.0) * np.float32(lam))
    return float(np.float32(1.0) - c)


def explicit_flow(filt, eta0, P, z, beta_schedule=None):
    """``_flow``'s particles and log-dets with :func:`explicit_step`, one
    trial (eta0 (n, d)), in the inputs' dtype."""
    I = torch.eye(eta0.shape[-1], dtype=eta0.dtype, device=eta0.device)
    P_inv = chol_solve(chol_with_jitter(P, initial=1e-9), I)
    step = torch.func.vmap(explicit_step, in_dims=(None,) * 4 + (0, 0, 0) + (None,) * 4)
    eta, etabar, theta = eta0, eta0, torch.zeros(eta0.shape[0], dtype=eta0.dtype,
                                                 device=eta0.device)
    for lam, dlam in filt._grid(beta_schedule):
        eta, etabar, logdet = step(filt, lam, dlam, one_minus_c(lam, dlam), eta, etabar,
                                   eta0, P, P_inv, z, I)
        theta = theta + logdet
    return eta, theta


def dense_problem(d, n, seed, dtype=F64, n_lambda_steps=8, trials=None, jacobian="dense"):
    """An LEDH filter with a random SPD R, and a cloud, a random SPD P and
    counts z (a leading trial axis when ``trials``). With ``jacobian``
    "dense", h(x) = Hx + 0.1 sin x (H dense, so every particle's Jacobian
    is dense and its own); with "shared", h(x) = Hx, whose Jacobian H is
    the same for every particle (as SNLG's identity is)."""
    g = torch.Generator().manual_seed(seed)
    H = torch.randn(d, d, generator=g, dtype=dtype) / d**0.5
    B = torch.randn(d, d, generator=g, dtype=dtype) / d**0.5
    R = B @ B.T + 0.5 * torch.eye(d, dtype=dtype)
    lead = () if trials is None else (trials,)
    A = torch.randn(lead + (d, d), generator=g, dtype=dtype) / d**0.5
    P = A @ A.mT + 0.5 * torch.eye(d, dtype=dtype)
    eta0 = torch.randn(lead + (n, d), generator=g, dtype=dtype)
    z = torch.randn(lead + (d,), generator=g, dtype=dtype)

    def h(x):
        return H @ x + 0.1 * torch.sin(x) if jacobian == "dense" else H @ x

    def jh(x):
        return H + 0.1 * torch.diag(torch.cos(x)) if jacobian == "dense" else H

    def sq(a, b):
        return -0.5 * torch.sum((a - b) ** 2)

    ekf = ExtendedKalmanFilter(lambda x, u: x, h, torch.eye(d), R, device="cpu")
    filt = LEDHFlowPF(GaussianTracker(ekf), lambda x, u, v: x + v, h, jh, sq,
                      lambda zz, x: sq(zz, h(x)), R,
                      LEDHConfig(n_particles=n, n_lambda_steps=n_lambda_steps), device="cpu")
    # The filter keeps R in float32; the flow reads R⁻¹ only.
    filt.R_inv = torch.linalg.inv(R)
    return filt, eta0, P, z


@pytest.mark.parametrize("jacobian", ["dense", "shared"])
@pytest.mark.parametrize("schedule", ["grid", "beta"])
@pytest.mark.parametrize("d", [4, 16, 64, 144])
def test_operator_form_matches_the_explicit_flow_matrix(d, schedule, jacobian):
    """Each λ-step of ``_lambda_step`` (as ``_flow`` runs it) from the same
    inputs as the explicit form, vmapped over the particles, with each
    particle's own Jacobian and with one Jacobian for all. rtol 1e-6 at
    float64: the two orders of the same products and solves differ by
    rounding (~1e-12 relative at d = 64), times cond(K); the 1e-8 jitter
    is in both."""
    filt, eta0, P, z = dense_problem(d, n=6, seed=d, jacobian=jacobian)
    I = torch.eye(d, dtype=F64)
    P_inv = chol_solve(chol_with_jitter(P, initial=1e-9), I)
    beta = BETA if schedule == "beta" else None
    ref = torch.func.vmap(explicit_step, in_dims=(None,) * 4 + (0, 0, 0) + (None,) * 4)
    eta, etabar = eta0, eta0
    for lam, dlam in filt._grid(beta):
        args = (lam, dlam, one_minus_c(lam, dlam), eta, etabar, eta0, P, P_inv, z, I)
        got, want = filt._lambda_step(*args), ref(filt, *args)
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=1e-6, atol=1e-9)
        eta, etabar = got[0], got[1]


class _Record(TorchDispatchMode):
    """Every operation dispatched while ``on``, with its arguments and
    its output."""

    def __init__(self):
        super().__init__()
        self.on, self.ops = False, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.on:
            self.ops.append((func, args, kwargs, out))
        return out


# Operations dispatched from the first λ-step's start to the end of
# ``_flow`` (cond(S⁰), the flow, the log-dets) at d = 16, B = 2, n = 8 by
# the explicit form, on the dense problem and on the shared Jacobian's:
# 833 and 719, counted 2026-10-18 on torch 2.13.0+cpu.
EXPLICIT_FORM_OPS = {"dense": 833, "shared": 719}


@pytest.mark.parametrize("jacobian", ["dense", "shared"])
def test_one_lambda_step_applies_the_operator_and_forms_no_flow_matrix(monkeypatch, jacobian):
    """One λ-step of ``_flow`` vmapped over B = 2 trials (as ``run_trials``
    runs it) of n = 8 particles at d = 16: no more operations than the
    explicit form, and two applies. With each particle's own Jacobian,
    every triangular solve takes at most 4 right-hand sides (``left=False``
    solves take them as rows), and the only d×d by d×d products over all
    B·n particles are R⁻¹Hⁱ and Hⁱᵀ(R⁻¹Hⁱ). With one Jacobian for all,
    every solve is with one factor a trial against all its particles'
    rows, no d×d by d×d product runs over the particles, and no operation
    writes B·n d×d matrices: the factor is never copied once a particle."""
    d, B, n = 16, 2, 8
    filt, eta0, P, z = dense_problem(d, n, seed=3, dtype=torch.float32, n_lambda_steps=1,
                                     trials=B, jacobian=jacobian)
    filt.R_inv = filt.R_inv.float()
    rec = _Record()
    cond = filt._cond_first_particle

    def record_from_here(*a, **k):
        rec.on = True  # the λ-loop's first operation
        return cond(*a, **k)

    monkeypatch.setattr(filt, "_cond_first_particle", record_from_here)
    monkeypatch.setattr(LEDHFlowPF, "operator_applies", 0)
    with rec:
        torch.func.vmap(lambda e, p, zz: filt._flow(e, None, p, zz, None))(eta0, P, z)

    solves = [(a, k) for f, a, k, _ in rec.ops
              if f is torch.ops.aten.linalg_solve_triangular.default]
    assert solves
    if jacobian == "dense":
        widths = [b.shape[-1] if k.get("left", True) else b.shape[-2] for (_, b, *_), k in solves]
        assert max(widths) <= 4, widths
    else:
        assert all(tuple(a.shape) == (B, d, d) for (a, *_), _ in solves)
        rows = [tuple(b.shape) for (_, b, *_), k in solves if not k.get("left", True)]
        assert rows == [(B, n * 4, d)] * 2 + [(B, n, d)] * 2, rows
        big = [f for f, _, _, out in rec.ops if isinstance(out, torch.Tensor)
               and out.untyped_storage().nbytes() >= B * n * d * d * out.element_size()]
        assert not big, big

    products = (torch.ops.aten.bmm.default, torch.ops.aten.mm.default,
                torch.ops.aten.baddbmm.default, torch.ops.aten.addmm.default)
    wide = []
    for f, a, _, _ in rec.ops:
        if f in products:
            x, y = (a[1], a[2]) if f in products[2:] else (a[0], a[1])
            if (tuple(x.shape[-2:]) == tuple(y.shape[-2:]) == (d, d)
                    and int(np.prod(x.shape[:-2])) == B * n):
                wide.append(f)
    assert len(wide) == (2 if jacobian == "dense" else 0), wide

    assert len(rec.ops) <= EXPLICIT_FORM_OPS[jacobian], len(rec.ops)
    assert LEDHFlowPF.operator_applies == 2


def skewt_step_gaps(device, n=200, trials=2):
    """One step of the skew-t LEDH at d = 144 (the committed data's first
    counts, the UKF tracker's P, N(0, Σ) clouds and the column's process
    noise) through ``_flow``: the gaps of its particles to the explicit form
    in float64, per coordinate in units of the float64 cloud's std, as
    (p50, p90, p99, max), of the program in float32 (``operator``), of the
    explicit form in float32 (``formed``) and of the program in float64
    (``operator64``)."""
    from particle_filters_tpu_torch.benchmarks import skewt

    _, Z, Sigma, LQ = skewt.load_data(device)
    filt, noise = skewt.make_flow("ledh", n, Sigma, LQ)
    d = Sigma.shape[0]
    gen = torch.Generator(device=device).manual_seed(11)
    x0 = torch.randn((trials, n, d), generator=gen, device=device) @ LQ.T
    eta0 = skewt.AL * x0 + noise(gen, trials * n, d).view(trials, n, d)
    _, _, P = filt.tracker.predict(filt.tracker.init(torch.zeros(d, device=device), Sigma))
    P, z = symmetrize(P), Z[:trials, 0]

    def program():
        return torch.func.vmap(lambda e, zz: filt._flow(e, None, P_, zz, None)[0])(eta0_, z_)

    P_, eta0_, z_ = P, eta0, z
    out = {"operator": program(),
           "formed": torch.stack([explicit_flow(filt, eta0[b], P, z[b])[0]
                                  for b in range(trials)])}
    R_inv = filt.R_inv
    filt.R_inv = torch.linalg.inv(filt.R.double())
    P_, eta0_, z_ = P.double(), eta0.double(), z.double()
    want = torch.stack([explicit_flow(filt, eta0_[b], P_, z_[b])[0] for b in range(trials)])
    prev = torch.get_default_dtype()
    torch.set_default_dtype(F64)  # the flow's identity in the inputs' precision
    try:
        out["operator64"] = program()
    finally:
        torch.set_default_dtype(prev)
        filt.R_inv = R_inv
    std = want.std(dim=1, keepdim=True)
    gaps = {}
    for name, x in out.items():
        g = ((x.double() - want).abs() / std).flatten()
        gaps[name] = [g.quantile(q).item() for q in (0.5, 0.9, 0.99)] + [g.max().item()]
    return gaps


@pytest.mark.cuda
def test_skewt_step_on_the_card_matches_the_explicit_form_in_float64():
    """One step of the skew-t LEDH (d = 144, B = 2 trials of n = 200) on the
    card against the explicit form in float64 on the card. In float64 the
    program's particles lie within 1e-4 of the cloud's std at every
    coordinate. In float32 the step rounds to ~1e-4 of the std at the
    median and ~1e-2 at the worst coordinate whichever form computes it
    (cond(P) ≈ 2e4, so P⁻¹ alone carries ~1e-4 relative error): the
    program's float32 gaps, at each of p50, p90, p99 and the max, stay
    within 1.25 times the explicit form's in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's float32 flow)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gaps = skewt_step_gaps(torch.device("cuda"))
    for name, g in gaps.items():
        print(f"skew-t LEDH step, {name}, against the float64 explicit form: gap p50/p90/p99/max "
              f"{g} of the cloud's std")
    assert gaps["operator64"][-1] <= 1e-4
    for got, formed in zip(gaps["operator"], gaps["formed"]):
        assert got <= 1.25 * formed
