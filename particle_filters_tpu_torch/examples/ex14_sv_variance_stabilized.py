"""The variance-stabilized (log-squared) observation transform on the SV
model: the port's twin of ``examples/14_sv_variance_stabilized.py``.

    python -m particle_filters_tpu_torch.examples.ex14_sv_variance_stabilized [--device cpu]

On one SV realization (α = 0.91, σ = 1, β = 0.5, T = 2000) each filter runs
twice: on the raw observation y_t = β e^{x_t/2} w_t (the EKF and UKF
linearize h(x) = β e^{x/2} on |y|; the PF takes the exact heteroscedastic
likelihood) and on z_t = log y_t² = x_t + log β² + ε_t, ε_t = log w_t² of
mean ψ(½) − log ½ and variance π²/2, which makes the observation linear in
x_t. Reports RMSE and the 95 % NEES coverage, and for the PFs (N = 1000,
systematic resampling through kernel B2 at ESS < N/2) Neff mean/min, the
resample rate and ms/step.

The trajectory is the JAX package's (its PRNG draws it): ``simulate_sv_1d(
2000, 0.91, 1.0, 0.5, seed=123)`` written once on the CPU into
``benchmarks/data/sv_vs_t2000.npz`` with the JAX package's EKF/UKF RMSE and
coverage in both forms and its PF RMSEs in both forms over 8 keys
(``tests/test_torch_ex14.py`` regenerates the file and holds it equal).
The transform is the JAX script's ``log(y² + 1e-300)`` in f32, where the
constant rounds to 0 and a subnormal y² is flushed to 0: y = 0 and
|y| < ~1.1e-19 give −inf there, and here.

Gates: the EKF's and UKF's RMSE within ``KF_ATOL`` of the JAX package's in
both forms (both filters are deterministic), and the mean of each form's PF
RMSEs over the given seeds against the JAX package's keys by the z test of
``benchmarks/_stats.py`` that takes the spread of the JAX package's keys for
both samples (p ≥ 1e-3; a few seeds' own standard deviation is too noisy
for Welch's). A run cut to the first ``T_CUT`` steps is held to the JAX
package's values over those steps (the file's ``_cut`` entries: the Kalman
rows' RMSE over them, and 32 keys' PF runs of ``T_CUT`` steps).
"""

from __future__ import annotations

import argparse
import math
import pathlib
import time

import numpy as np
import torch
from scipy.stats import chi2

from particle_filters_tpu_torch.benchmarks._stats import P_MIN, reference_sd_z, summary, welch_z
from particle_filters_tpu_torch.models import (
    ExtendedKalmanFilter,
    ParticleFilter,
    UnscentedKalmanFilter,
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_tpu_torch.utils.timing import card_line, resolve_device, sync

DATA = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "data"
        / "sv_vs_t2000.npz")
T, ALPHA, SIGMA, BETA = 2000, 0.91, 1.0, 0.5
T_CUT = 500  # the cut run's steps (``chip_smoke.py``)
MU_EPS = -1.2703628454614782  # E[log W²], W ~ N(0, 1)
VAR_EPS = math.pi**2 / 2.0  # Var[log W²]
P0 = SIGMA**2 / (1 - ALPHA**2)
NP = 1000
PF_SEEDS = 8
WELCH_SEEDS = 40  # seeds a form of ``pf_welch``'s comparison
KF_ATOL = 1e-3
FORMS = ("std", "vs")


def load_data(device, path=DATA):
    with np.load(str(path)) as f:
        return {k: torch.as_tensor(f[k], device=device) for k in f.files}


def vs_transform(y: torch.Tensor) -> torch.Tensor:
    """z = log(y² + 1e-300) in f32, as the JAX script computes it: the
    constant rounds to 0, and XLA flushes a subnormal y² to 0 (on the CPU
    and the TPU), so y² under f32's smallest normal gives −inf, as y = 0
    does. PyTorch keeps subnormals; the flush is made here."""
    y2 = y * y
    y2 = torch.where(y2 < torch.finfo(y2.dtype).tiny, torch.zeros_like(y2), y2)
    return torch.log(y2 + 1e-300)


def coverage(means, variances, truth) -> float:
    """Fraction of steps whose NEES (m − x)²/P lies in the 95 % χ²₁ band."""
    lo, hi = chi2.ppf(0.025, df=1), chi2.ppf(0.975, df=1)
    nees = (means - truth) ** 2 / variances
    return torch.mean(((nees >= lo) & (nees <= hi)).to(torch.float32)).item()


def _rmse(means, truth) -> float:
    return torch.sqrt(torch.mean((means - truth) ** 2)).item()


def _g(x, u):
    return ALPHA * x


def kalman_filters(device):
    """``{(name, form): (filter, state factory)}``: the EKF and UKF (α = 1)
    on |y| with h = β e^{x/2}, R = β², and on z with h = x + log β² + ψ,
    R = π²/2."""
    h_std = lambda x: BETA * torch.exp(0.5 * x)  # noqa: E731
    h_vs = lambda x: x + math.log(BETA**2) + MU_EPS  # noqa: E731
    Q = [[SIGMA**2]]
    out = {}
    for form, h, R in (("std", h_std, [[BETA**2]]), ("vs", h_vs, [[VAR_EPS]])):
        out[("ekf", form)] = (ExtendedKalmanFilter(_g, h, Q, R, device=device), make_ekf_state)
        out[("ukf", form)] = (UnscentedKalmanFilter(_g, h, Q, R, alpha=1.0, device=device),
                              make_ukf_state)
    return out


def observations(data, form: str):
    """The PF's (T, 1) input of a form: y, or z = log y²."""
    y = data["Y"]
    return (y if form == "std" else vs_transform(y))[:, None]


def run_kalman(device, data, t: int = T) -> dict:
    """``{"ekf_std": {...}, ...}``: means, variances, RMSE, coverage and
    seconds (to a sync, after a 2-step warm-up) of each Kalman row over the
    first ``t`` steps."""
    X = data["X"][:t]
    out = {}
    for (name, form), (filt, make) in kalman_filters(device).items():
        zs = data["Y"].abs()[:, None] if form == "std" else observations(data, form)
        zs = zs[:t]

        def run(z, filt=filt, make=make):
            _, m, P = filt.run(make(torch.zeros(1), [[P0]], device=device), z)
            return m[:, 0], P[:, 0, 0]

        run(zs[:2])
        sync(device)
        t0 = time.perf_counter()
        m, P = run(zs)
        sync(device)
        out[f"{name}_{form}"] = {"means": m, "vars": P, "rmse": _rmse(m, X),
                                 "coverage": coverage(m, P, X), "s": time.perf_counter() - t0}
    return out


def ll_std(x, z):
    """The exact likelihood of the raw observation, y ~ N(0, β² e^x)."""
    var = BETA**2 * torch.exp(x[0])
    return -0.5 * (z[0] ** 2 / var + torch.log(var))


def ll_logsq(x, z):
    """The log-χ²₁ likelihood of z: ε = z − x − log β²,
    p(ε) ∝ exp(ε/2 − e^ε/2)."""
    e = z[0] - x[0] - math.log(BETA**2)
    return 0.5 * e - 0.5 * torch.exp(e)


def run_pf(device, data, form: str, seed: int, n: int = NP, t: int = T) -> dict:
    """One PF run of a form over the first ``t`` steps (N = ``n``, the
    degeneracy panel on, as the JAX script runs it): RMSE, coverage, Neff
    mean/min, resample fraction, ms/step (to a sync) and the resample
    steps."""
    X = data["X"][:t]
    pf = ParticleFilter(_g, None, [[SIGMA**2]], None, Np=n,
                        obs_loglik=ll_std if form == "std" else ll_logsq,
                        resample_thresh=0.5, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    st = pf.initialize(gen, [0.0], [[P0]])
    sync(device)
    t0 = time.perf_counter()
    _, hist = pf.run(gen, st, observations(data, form)[:t], track_degeneracy=True)
    sync(device)
    s = time.perf_counter() - t0
    m, P = hist["mean"][:, 0], hist["cov"][:, 0, 0]
    return {"rmse": _rmse(m, X), "coverage": coverage(m, P, X),
            "ess_mean": hist["ess"].mean().item(), "ess_min": hist["ess"].min().item(),
            "resample_frac": hist["resampled"].float().mean().item(),
            "resample_steps": int(hist["resampled"].sum()),
            "ms_per_step": s / X.shape[0] * 1e3}


def run_all(device="cuda", data=None, seeds: int = PF_SEEDS, t: int = T) -> dict:
    """The Kalman rows and ``seeds`` PF runs of each form (seeds 0, 1, …)
    over the first ``t`` steps (``T`` or ``T_CUT``)."""
    if t not in (T, T_CUT):
        raise ValueError(f"t must be {T} or {T_CUT}, the steps the JAX references cover.")
    device = resolve_device(device)
    data = load_data(device) if data is None else data
    return {"kalman": run_kalman(device, data, t),
            "pf": {form: [run_pf(device, data, form, s, t=t) for s in range(seeds)]
                   for form in FORMS}, "t": t}


def _ref(data, name: str, t: int):
    return data[f"jax_{name}" + ("" if t == T else "_cut")]


def gates(res, data) -> dict:
    """``{row: (value, reference, held)}``: each Kalman RMSE against the JAX
    package's over the same steps within ``KF_ATOL``; each PF form's p
    against the JAX package's keys (≥ ``P_MIN``)."""
    t, out = res["t"], {}
    for key, r in res["kalman"].items():
        want = float(_ref(data, f"{key}_rmse", t))
        out[key] = (r["rmse"], want, abs(r["rmse"] - want) <= KF_ATOL)
    for form, rows in res["pf"].items():
        _, p = reference_sd_z([r["rmse"] for r in rows],
                              *summary([float(v) for v in _ref(data, f"pf_{form}_rmse", t)]))
        out[f"pf_{form}"] = (p, P_MIN, p >= P_MIN)
    return out


def pf_welch(res, data) -> dict:
    """``{form: (mean, sd, n, z, p)}``: Welch's test of each form's PF RMSEs
    against the JAX package's keys over the same steps. For runs of many
    seeds (``WELCH_SEEDS`` at ``T_CUT``, against 32 keys), whose own spread
    is a fair estimate; it resolves a shift of ~3.5 standard errors of the
    difference, ~0.003 there."""
    out = {}
    for form, rows in res["pf"].items():
        rmses = [r["rmse"] for r in rows]
        z, p = welch_z(rmses, *summary([float(v) for v in _ref(data, f"pf_{form}_rmse", res["t"])]))
        out[form] = (*summary(rmses), z, p)
    return out


def print_tables(res, data, card: str) -> None:
    g, t = gates(res, data), res["t"]
    names = {"std": "standard", "vs": "log-var"}
    print(f"ex14 SV alpha={ALPHA}, sigma={SIGMA}, beta={BETA}, first {t} of {T} steps:")
    for key, r in res["kalman"].items():
        name, form = key.split("_")
        cover = (f" (JAX {float(data[f'jax_{key}_coverage']) * 100:5.1f}%)" if t == T else "")
        print(f"{name.upper()} {names[form]:9s} RMSE {r['rmse']:7.4f} (JAX package "
              f"{g[key][1]:.4f})   coverage {r['coverage'] * 100:5.1f}%{cover}   "
              f"{r['s'] / t * 1e3:.4f} ms/step  [{card}]")
    for form, rows in res["pf"].items():
        mean, sd, n = summary([r["rmse"] for r in rows])
        jm, jsd, jn = summary([float(v) for v in _ref(data, f"pf_{form}_rmse", t)])
        r0 = rows[0]
        print(f"PF {names[form]:9s} N={NP}: RMSE {mean:.4f} ± {sd:.4f} over {n} seeds (JAX "
              f"package {jm:.4f} ± {jsd:.4f}, {jn} keys; p {g[f'pf_{form}'][0]:.4f})   "
              f"seed 0: coverage {r0['coverage'] * 100:5.1f}%, Neff mean/min "
              f"{r0['ess_mean']:6.1f}/{r0['ess_min']:6.1f}, resample "
              f"{r0['resample_frac'] * 100:4.1f}%, {r0['ms_per_step']:.4f} ms/step  [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    data = load_data(device)
    print_tables(run_all(device, data), data, card_line(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
