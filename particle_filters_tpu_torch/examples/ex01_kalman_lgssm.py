"""The Kalman filter on a simulated LGSSM: NEES consistency, RMSE and
coverage, the port's twin of ``examples/01_kalman_lgssm.py``.

    python -m particle_filters_tpu_torch.examples.ex01_kalman_lgssm [--device cpu]

The README's 2-D system (A = [[0.9, 0.5], [0, 0.7]], B = diag(√0.05, √0.02),
C = I, D = √0.1·I, Σ = I), T = 1000 steps, simulated for each of the JAX
script's 10 seeds by the port's ``simulate_lgssm`` (its own draws: the JAX
package's PRNG is not reproduced) and filtered by ``kalman_filter_general``
with the Joseph update. Reports the mean over seeds of the RMSE, the mean
NEES and the 95 % coverage.

Gate: the mean NEES over the S seeds and T steps inside the two-sided χ²
band of a consistent filter at ``P_MIN`` = 1e-3, [χ²_{P/2}(S·T·nx),
χ²_{1−P/2}(S·T·nx)] / (S·T): the steps' NEES taken as independent χ²_nx
draws (the JAX package's per-seed means spread 0.066 about 2.03, the 0.063
that independence predicts).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from scipy.stats import chi2

from particle_filters_tpu_torch.benchmarks._stats import P_MIN
from particle_filters_tpu_torch.models import kalman_filter_general
from particle_filters_tpu_torch.simulators import simulate_lgssm
from particle_filters_tpu_torch.utils.diagnostics import coverage_95, nees, rmse
from particle_filters_tpu_torch.utils.timing import card_line, resolve_device, sync

A = np.array([[0.9, 0.5], [0.0, 0.7]], np.float32)
B = np.diag([np.sqrt(0.05), np.sqrt(0.02)]).astype(np.float32)
C = np.eye(2, dtype=np.float32)
D = (np.sqrt(0.1) * np.eye(2)).astype(np.float32)
SIGMA = np.eye(2, dtype=np.float32)
Q, R = B @ B.T, D @ D.T
T = 1000
SEEDS = (42, 7, 123, 2024, 9999, 1, 2, 3, 4, 5)


def filter_seed(X, Y, device) -> dict:
    """The Joseph-form Kalman filter on one (X, Y) sequence: its results and
    RMSE, mean NEES and coverage."""
    res = kalman_filter_general(Y, A, C, np.eye(2, dtype=np.float32), Q, R,
                                x0=np.zeros(2, np.float32), P0=SIGMA, use_joseph=True,
                                device=device)
    return {"kf": res, "rmse": rmse(res.x_filt, X).item(),
            "nees": nees(res.x_filt, res.P_filt, X).mean().item(),
            "coverage": coverage_95(res.x_filt, res.P_filt, X).item()}


def nees_band(n_seeds: int, t: int = T, nx: int = 2, p: float = P_MIN):
    """The two-sided χ² band of the mean NEES of a consistent filter over
    ``n_seeds`` × ``t`` steps, at level ``p``."""
    dof = n_seeds * t * nx
    lo, hi = chi2.ppf(p / 2, dof), chi2.ppf(1 - p / 2, dof)
    return lo / (n_seeds * t), hi / (n_seeds * t)


def run_all(device="cuda", seeds=SEEDS, t: int = T) -> dict:
    """Each seed simulated and filtered on ``device``; the means over seeds
    and the seconds of the filtering (to a sync)."""
    device = resolve_device(device)
    rows, secs = [], 0.0
    for seed in seeds:
        data = simulate_lgssm(A, B, C, D, SIGMA, t, seed=seed, device=device)
        sync(device)
        t0 = time.perf_counter()
        r = filter_seed(data.X, data.Y, device)
        sync(device)
        secs += time.perf_counter() - t0
        rows.append(r)
    mean = lambda k: float(np.mean([r[k] for r in rows]))  # noqa: E731
    return {"rows": rows, "rmse": mean("rmse"), "nees": mean("nees"),
            "coverage": mean("coverage"), "band": nees_band(len(seeds), t), "s": secs,
            "t": t}


def gates(res) -> dict:
    """``{gate: (value, held)}``: the mean NEES inside the χ² band."""
    lo, hi = res["band"]
    return {f"mean NEES in [{lo:.4f}, {hi:.4f}]": (res["nees"], lo <= res["nees"] <= hi)}


def print_tables(res, card: str) -> None:
    lo, hi = res["band"]
    n = len(res["rows"])
    print(f"ex01 {n}-seed Monte Carlo (T={res['t']}, nx=2): RMSE {res['rmse']:.4f} (reference "
          f"0.1915), mean NEES {res['nees']:.4f} (expected 2.0; chi^2 band at p={P_MIN}: "
          f"[{lo:.4f}, {hi:.4f}]), 95% cover {res['coverage'] * 100:.1f}% (reference 93.5%); "
          f"{res['s'] / (n * res['t']) * 1e3:.4f} ms/step  [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    res = run_all(device)
    print_tables(res, card_line(device))
    return 0 if all(held for _, held in gates(res).values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
