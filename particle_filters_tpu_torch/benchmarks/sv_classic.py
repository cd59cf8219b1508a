"""``bench_sv_classic``'s column on the port: the EKF and UKF on the
log-squared observations and the SIR particle filter at N = 2000 on the
stochastic-volatility model (α 0.95, σ 0.2, β 1, T = 2000).

    python -m particle_filters_tpu_torch.benchmarks.sv_classic

The data is the JAX package's seed-42 trajectory, written once on the CPU
into ``data/sv_t2000.npz`` with the JAX package's reference values
(``tests/test_torch_sv_columns.py`` regenerates it and holds it equal).
Gates: the EKF's and UKF's RMSE within 1e-3 relative of the JAX package's;
the SIR PF's RMSEs over ``SEEDS`` seeds against the JAX package's over its
8 keys by the Welch test of ``benchmarks/_stats.py`` (p ≥ 1e-3). The
Kalman rows are the standard Gaussianization: y = log(z² + 1e-8) ≈ x +
log β² + log W², log W² of mean −1.2704 and variance π²/2.
"""

from __future__ import annotations

import math
import pathlib
import sys
import time

import numpy as np
import torch

from particle_filters_tpu_torch.benchmarks._stats import P_MIN, summary, welch_z
from particle_filters_tpu_torch.models import (
    ExtendedKalmanFilter,
    ParticleFilter,
    UnscentedKalmanFilter,
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_tpu_torch.ops.resample import resample_by_starts
from particle_filters_tpu_torch.utils.timing import card_line, sync

DATA = pathlib.Path(__file__).resolve().parent / "data" / "sv_t2000.npz"
T, ALPHA, SIGMA, BETA, N_PF = 2000, 0.95, 0.2, 1.0, 2000
KF_RTOL = 1e-3
SEEDS = 8


def load_data(device, path=DATA):
    with np.load(str(path)) as f:
        return {k: torch.as_tensor(f[k], device=device) for k in f.files}


def sv_obs_loglik(x, z):
    var = BETA**2 * torch.exp(x[0])
    return -0.5 * (z[0] ** 2 / var + torch.log(var))


def _rmse(means, x) -> float:
    return torch.sqrt(torch.mean((means.reshape(-1) - x) ** 2)).item()


def run_kalman(device, data, t=T):
    """The EKF and UKF over the first ``t`` steps: ``{name: {"means",
    "rmse", "s"}}`` (seconds to a sync, after a 2-step warm-up)."""
    X, Y = data["X"][:t], data["Y"][:t]
    y_log = torch.log(Y**2 + 1e-8)[:, None]
    gm = lambda x, u: ALPHA * x  # noqa: E731
    hm = lambda x: x + math.log(BETA**2) - 1.2704  # noqa: E731
    Q, R = [[SIGMA**2]], [[math.pi**2 / 2]]
    out = {}
    for name, filt, make in (
        ("ekf", ExtendedKalmanFilter(gm, hm, Q, R, device=device), make_ekf_state),
        ("ukf", UnscentedKalmanFilter(gm, hm, Q, R, alpha=1.0, device=device),
         make_ukf_state),
    ):
        def run(z, filt=filt, make=make):
            return filt.run(make(torch.zeros(1), torch.eye(1), device=device), z)[1][:, 0]

        run(y_log[:2])
        sync(device)
        t0 = time.perf_counter()
        means = run(y_log)
        sync(device)
        out[name] = {"means": means, "rmse": _rmse(means, X), "s": time.perf_counter() - t0}
    return out


def run_pf(device, data, t=T, n=N_PF, seeds=SEEDS):
    """The SIR PF over the first ``t`` steps, one run a seed: ``{"rmses",
    "s" (the first run's, after a 2-step warm-up), "resample_steps",
    "b2_launches"}`` (B2 counted over all runs, set to 0 just before)."""
    X, zs = data["X"][:t], data["Y"][:t, None]
    var0 = SIGMA**2 / (1 - ALPHA**2)
    pf = ParticleFilter(lambda x, u: ALPHA * x, None, Q=[[SIGMA**2]], R=None, Np=n,
                        obs_loglik=sv_obs_loglik, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    pf.run(gen, pf.initialize(gen, [0.0], [[var0]]), zs[:2])
    rmses, secs, steps = [], [], 0
    resample_by_starts.launches = 0
    for seed in range(seeds):
        gen = torch.Generator(device=device).manual_seed(seed)
        st = pf.initialize(gen, [0.0], [[var0]])
        sync(device)
        t0 = time.perf_counter()
        _, hist = pf.run(gen, st, zs)
        sync(device)
        secs.append(time.perf_counter() - t0)
        rmses.append(_rmse(hist["mean"][:, 0], X))
        steps += int(hist["resampled"].sum())
    return {"rmses": rmses, "s": secs[0], "resample_steps": steps,
            "b2_launches": resample_by_starts.launches}


def run_column(device="cuda", data=None, t=T, n_pf=N_PF, seeds=SEEDS):
    device = torch.device(device)
    data = load_data(device) if data is None else data
    return {**run_kalman(device, data, t), "pf": run_pf(device, data, t, n_pf, seeds), "t": t}


def gates(res, data, full=True):
    """``{gate: (value, held)}``: the Kalman RMSEs against the JAX
    package's within ``KF_RTOL``, the PF's Welch p against the JAX
    package's 8 keys (≥ ``P_MIN``). ``full=False`` (a cut run) evaluates
    them without holding them to the full column's references."""
    out = {}
    for name in ("ekf", "ukf"):
        want = float(data[f"jax_{name}_rmse"])
        got = res[name]["rmse"]
        out[f"{name} RMSE within {KF_RTOL:g} of the JAX package's {want:.6f}"] = (
            got, abs(got - want) <= KF_RTOL * want)
    p = pf_p(res, data)
    out[f"pf RMSEs against the JAX package's 8 keys, Welch p >= {P_MIN}"] = (p, p >= P_MIN)
    if not full:
        out = {k: (v, True) for k, (v, _) in out.items()}
    return out


def pf_p(res, data) -> float:
    """The Welch p of the PF's RMSEs against the JAX package's 8 keys."""
    return welch_z(res["pf"]["rmses"], *summary([float(v) for v in data["jax_pf_rmse"]]))[1]


def print_column(res, data, card: str) -> None:
    t = res["t"]
    for name in ("ekf", "ukf"):
        r = res[name]
        print(f"sv_classic {name}: RMSE {r['rmse']:.6f} (JAX package "
              f"{float(data[f'jax_{name}_rmse']):.6f}), {r['s'] / t * 1e3:.4f} ms/step  [{card}]")
    r = res["pf"]
    mean, sd, n = summary(r["rmses"])
    jm, jsd, jn = summary([float(v) for v in data["jax_pf_rmse"]])
    print(f"sv_classic pf N={N_PF}: RMSE {mean:.4f} ± {sd:.4f} over {n} seeds (JAX package "
          f"{jm:.4f} ± {jsd:.4f}, {jn} keys), Welch p {pf_p(res, data):.4f}; "
          f"{r['s'] / t * 1e3:.4f} ms/step; {r['resample_steps']} resample steps, "
          f"B2 {r['b2_launches']}  [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("sv_classic needs a CUDA device.", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = load_data("cuda")
    print_column(run_column("cuda", data), data, card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
