"""Particle degeneracy of the SIR PF on the SV model: the port's twin of
``examples/15_pf_degeneracy_analysis.py``.

    python -m particle_filters_tpu_torch.examples.ex15_pf_degeneracy_analysis [--device cpu]

``ParticleFilter.run(track_degeneracy=True)`` records the degeneracy panel
(ESS, normalized weight entropy, Gini coefficient, max weight, the fraction
of ancestors that survive a resample, the resample events) on the SV model
(α = 0.91, σ = 1, β = 0.5, T = 2000; the JAX package's seed-123 trajectory,
``ex14_sv_variance_stabilized.DATA``), with the notebook's regularization
jitter after a resample. Then the notebook's four experiments:

1. the particle count Np over ``NP_SWEEP`` (thresh 0.5);
2. the resample threshold (0.3, 0.5, 0.7) crossed with the method:
   systematic through kernel B2, stratified and multinomial through
   ``resample_indices`` (Np = 1000);
3. robustness over ``SEEDS`` seeds (the JAX script vmaps 16 keys; here a
   loop of runs);
4. the boundary thresholds 1e-9 (never resample) and 1 + 1e-9 (always).

The trigger is the host comparison ``ess < thresh·N`` in f32 (the Python
product rounds to f32 against the f32 ESS, as the JAX package's weakly typed
product does): at 1e-9·N no ESS ≥ 1 triggers, at (1 + 1e-9)·N = N every
ESS below N does. Gate: the boundary runs' resample fractions exactly 0 and
1, every panel finite.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from particle_filters_tpu_torch.examples.ex14_sv_variance_stabilized import (
    ALPHA,
    BETA,
    P0,
    SIGMA,
    ll_std,
    load_data,
)
from particle_filters_tpu_torch.models import ParticleFilter
from particle_filters_tpu_torch.utils.timing import card_line, resolve_device, sync

NP = 1000
NP_SWEEP = (100, 500, 1000, 2000, 5000)
THRESHOLDS = (0.3, 0.5, 0.7)
METHODS = ("systematic", "stratified", "multinomial")
SEEDS = 16
BOUNDARY = ((1e-9, "never resample"), (1.0 + 1e-9, "always resample"))
# The JAX script's keys: PRNGKey(1) for the baseline, 2, 3 and 4 for
# experiments 1, 2 and 4, split(PRNGKey(10), 16) for experiment 3.
SEED_BASE, SEED_NP, SEED_THRESH, SEED_BOUNDARY, SEED_ROBUST = 1, 2, 3, 4, 10


def run_pf(device, data, n: int, seed: int, thresh: float = 0.5,
           method: str = "systematic", regularize: bool = True) -> dict:
    """One run with the degeneracy panel: its history."""
    pf = ParticleFilter(lambda x, u: ALPHA * x, None, [[SIGMA**2]], None, Np=n,
                        obs_loglik=ll_std, resample_thresh=thresh, resample_method=method,
                        regularize_after_resample=regularize, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    st = pf.initialize(gen, [0.0], [[P0]])
    _, hist = pf.run(gen, st, data["Y"][:, None], track_degeneracy=True)
    return hist


def panel(hist, truth, n: int) -> dict:
    """The panel's summary: RMSE, ESS mean/min (and over Np), entropy mean,
    Gini and max weight mean/max, resample fraction, and the surviving
    fraction's mean/min over the resample steps (NaN without one)."""
    res = hist["resampled"]
    uf = hist["unique_frac"][res]
    nan = float("nan")
    return {
        "rmse": torch.sqrt(torch.mean((hist["mean"][:, 0] - truth) ** 2)).item(),
        "ess_mean": hist["ess"].mean().item(), "ess_min": hist["ess"].min().item(),
        "ess_frac": hist["ess"].mean().item() / n,
        "entropy_mean": hist["entropy"].mean().item(),
        "gini_mean": hist["gini"].mean().item(), "gini_max": hist["gini"].max().item(),
        "maxw_mean": hist["max_weight"].mean().item(),
        "maxw_max": hist["max_weight"].max().item(),
        "resample_frac": res.float().mean().item(),
        "unique_mean": uf.mean().item() if uf.numel() else nan,
        "unique_min": uf.min().item() if uf.numel() else nan,
        "finite": all(bool(torch.isfinite(v.float()).all()) for v in hist.values()),
    }


def run_all(device="cuda", data=None, n: int = NP, nps=NP_SWEEP, thresholds=THRESHOLDS,
            methods=METHODS, seeds: int = SEEDS, t: int | None = None) -> dict:
    """The baseline and the four experiments over the first ``t`` steps (all
    when None), each with its seconds (to a sync). ``n`` is the Np of the
    baseline and experiments 2-4."""
    device = resolve_device(device)
    data = load_data(device) if data is None else data
    data = {k: data[k][:t] for k in ("X", "Y")}
    X = data["X"]
    out, secs = {}, {}

    def timed(name, fn):
        sync(device)
        t0 = time.perf_counter()
        out[name] = fn()
        sync(device)
        secs[name] = time.perf_counter() - t0

    def one(np_, seed, thresh=0.5, method="systematic"):
        return panel(run_pf(device, data, np_, seed, thresh, method), X, np_)

    timed("baseline", lambda: one(n, SEED_BASE))
    timed("np", lambda: {k: one(k, SEED_NP) for k in nps})
    timed("thresh", lambda: {(th, m): one(n, SEED_THRESH, th, m) for th in thresholds
                             for m in methods})
    timed("seeds", lambda: [one(n, SEED_ROBUST + i)["rmse"] for i in range(seeds)])
    timed("boundary", lambda: {label: one(n, SEED_BOUNDARY, th) for th, label in BOUNDARY})
    out.update(seconds=secs, n=n, t=X.shape[0])
    return out


def gates(res) -> dict:
    """``{gate: (value, held)}``: the boundary fractions exactly 0 and 1,
    every panel finite."""
    b = res["boundary"]
    panels = ([res["baseline"]] + list(res["np"].values()) + list(res["thresh"].values())
              + list(b.values()))
    return {
        "never resample: resample_frac == 0": (b["never resample"]["resample_frac"],
                                               b["never resample"]["resample_frac"] == 0.0),
        "always resample: resample_frac == 1": (b["always resample"]["resample_frac"],
                                                b["always resample"]["resample_frac"] == 1.0),
        "finite panels and seed RMSEs": (None, all(p["finite"] for p in panels)
                                         and all(math.isfinite(r) for r in res["seeds"])),
    }


def print_tables(res, card: str) -> None:
    b, s, n = res["baseline"], res["seconds"], res["n"]
    print(f"ex15 SV alpha={ALPHA}, sigma={SIGMA}, beta={BETA}, T={res['t']}:")
    print(f"ex15 baseline (Np={n}, thresh=0.5, systematic, regularized): RMSE "
          f"{b['rmse']:.4f}; ESS mean/min {b['ess_mean']:.1f} / {b['ess_min']:.1f}; entropy "
          f"mean {b['entropy_mean']:.4f}; gini mean/max {b['gini_mean']:.4f} / "
          f"{b['gini_max']:.4f}; max-w mean/max {b['maxw_mean']:.4f} / {b['maxw_max']:.4f}; "
          f"resample {b['resample_frac'] * 100:.1f}%; unique after resample mean "
          f"{b['unique_mean']:.3f}, min {b['unique_min']:.3f}; {s['baseline']:.3f} s  [{card}]")
    print(f"ex15 experiment 1, particle count (thresh 0.5), {s['np']:.3f} s  [{card}]:")
    print(f"  {'Np':>6s} {'RMSE':>8s} {'ESS/Np':>8s} {'resample%':>10s} {'unique':>8s}")
    for k, p in res["np"].items():
        print(f"  {k:6d} {p['rmse']:8.4f} {p['ess_frac']:8.3f} "
              f"{p['resample_frac'] * 100:9.1f}% {p['unique_mean']:8.3f}")
    print(f"ex15 experiment 2, threshold x method (Np={n}), {s['thresh']:.3f} s  [{card}]:")
    print(f"  {'thresh':>7s} {'method':>12s} {'RMSE':>8s} {'resample%':>10s} {'ESS mean':>9s}")
    for (th, m), p in res["thresh"].items():
        print(f"  {th:7.1f} {m:>12s} {p['rmse']:8.4f} {p['resample_frac'] * 100:9.1f}% "
              f"{p['ess_mean']:9.1f}")
    r = torch.tensor(res["seeds"], dtype=torch.float64)
    print(f"ex15 experiment 3, {r.numel()} seeds (a loop of runs): RMSE {r.mean().item():.4f} "
          f"± {r.std(unbiased=False).item():.4f}; {s['seeds']:.3f} s  [{card}]")
    print(f"ex15 experiment 4, boundary thresholds (Np={n}), {s['boundary']:.3f} s  [{card}]:")
    for label, p in res["boundary"].items():
        print(f"  {label:16s} RMSE {p['rmse']:8.4f}   ESS min {p['ess_min']:8.1f}   "
              f"resample {p['resample_frac'] * 100:5.1f}%")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    res = run_all(device)
    print_tables(res, card_line(device))
    for gate, (value, held) in gates(res).items():
        print(f"  gate {gate}: {value} {'held' if held else 'NOT HELD'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
