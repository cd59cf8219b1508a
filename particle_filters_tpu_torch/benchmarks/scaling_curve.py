"""The north-star scaling curve on the port: particle-steps/s against N, the
twin of ``benchmarks/scaling_curve.py``.

    python -m particle_filters_tpu_torch.benchmarks.scaling_curve [--out rows.json] [--device cpu]

Each N runs ``bench.py``'s workload (``FusedSIRFilter`` on the SV model,
α = 0.95, σ = 0.2, β = 1, resampling at ESS < N/2) at N = 2¹⁴, 2¹⁶, 2¹⁸,
2²⁰ and 2²² (the JAX script's) and 2²⁴, the largest N on the f32 run ends.
Time per step is the slope protocol of ``_slope.slope``: the best run
of ``m_hi`` steps minus the best of ``m_lo`` = 200, over
``m_hi − m_lo``, so the fixed cost of a run cancels; m_hi is 8000 for N ≤
2¹⁶ and 1700 above, as the JAX script takes them. On the card
``FusedSIRFilter.run`` is itself one CUDA graph replay a run, captured on
its first run of each length (the warm-up). Each row also has the resample
fraction of the last m_hi run and the card's busy share of one profiled run
of m_lo steps (the union of its device intervals over the wall time of an
unprofiled run of the same length), the number that says whether the host
or the card sets the pace at that N.

Writes JSON only, and only with ``--out``: no figure (the card's machine has
no matplotlib). Raises without a card unless given ``--device cpu``, where
B1's and B2's plain versions run and the busy share is not measured.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from particle_filters_tpu_torch.benchmarks._slope import slope
from particle_filters_tpu_torch.benchmarks.bench import (
    ALPHA,
    BASELINE_PARTICLE_STEPS_PER_SEC,
    BETA,
    SIGMA,
    initial_state,
    sv_filter,
)
from particle_filters_tpu_torch.simulators import simulate_sv_1d
from particle_filters_tpu_torch.utils.timing import (
    card,
    card_line,
    profile_device,
    resolve_device,
    sync,
)

LOG2_N = (14, 16, 18, 20, 22, 24)
M_LO = 200
REPS = 4  # timed runs of each length after a warm-up, as the JAX script takes


def m_hi_for(n: int) -> int:
    """The JAX script's long run: 8000 steps up to 2¹⁶ particles, 1700 above."""
    return 8000 if n <= (1 << 16) else 1700


def busy_share(run, device) -> float | None:
    """The card's busy time in one profiled ``run()`` (the union of its
    device intervals) over the wall time of an unprofiled one (both to a
    sync); None off the card or where the profiler saw no device time."""
    if device.type != "cuda":
        return None
    sync(device)
    t0 = time.perf_counter()
    run()
    sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_device(run)
    return prof.busy_ms / wall_ms if prof.top else None


def measure(n: int, device="cuda", m_lo: int = M_LO, m_hi: int | None = None,
            reps: int = REPS) -> dict:
    """One row of the curve at N = ``n``."""
    device = resolve_device(device)
    t_start = time.perf_counter()
    m_hi = m_hi_for(n) if m_hi is None else m_hi
    sv = simulate_sv_1d(m_hi, ALPHA, SIGMA, BETA, seed=42, device=device)
    filt = sv_filter(n, device)
    state0 = initial_state(filt, device)
    hists = {}

    def build_loop(m):
        gen = torch.Generator(device=device).manual_seed(2)
        zs = sv.Y[:m, None]

        def loop():
            _, hists[m] = filt.run(gen, state0, zs)
            return hists[m]["mean"]

        return loop

    per_step = slope(f"N=2^{n.bit_length() - 1}", build_loop, m_lo, m_hi, reps)
    hist = hists[m_hi]
    t_slope = time.perf_counter()
    busy = busy_share(build_loop(m_lo), device)
    return {
        "n_particles": n,
        "log2_n": n.bit_length() - 1,
        "n_steps": m_lo,
        "m_hi": m_hi,
        "ms_per_step": per_step * 1e3,
        "particle_steps_per_sec": n / max(per_step, 1e-12),
        "resample_frac": hist["resampled"].float().mean().item(),
        "finite": all(bool(torch.isfinite(v.float()).all()) for v in hist.values()),
        "busy": busy,
        "wall_s": {"slope": t_slope - t_start, "busy": time.perf_counter() - t_slope},
    }


def curve(device="cuda", log2_n=LOG2_N, reps: int = REPS, m_hi=None) -> list:
    """The rows at N = 2^k for k in ``log2_n`` (``m_hi`` overrides the JAX
    script's long run, for small checks)."""
    return [measure(1 << k, device, reps=reps, m_hi=m_hi) for k in log2_n]


def format_row(r: dict) -> str:
    busy = "not measured" if r["busy"] is None else f"{r['busy']:.3f}"
    return (f"N=2^{r['log2_n']}: {r['ms_per_step']:.4f} ms/step, "
            f"{r['particle_steps_per_sec']:.4e} particle-steps/s, resample "
            f"{r['resample_frac']:.3f}, device busy {busy} (measured in "
            f"{r['wall_s']['slope']:.1f} s + {r['wall_s']['busy']:.1f} s)")


def write_rows(path, rows, device) -> None:
    """The rows as JSON, beside the card's name and power limit."""
    name, limit = card(device)
    with open(path, "w") as f:
        json.dump({"device": name, "power_limit_w": limit,
                   "baseline": BASELINE_PARTICLE_STEPS_PER_SEC, "rows": rows}, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the rows here as JSON")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    label = card_line(device)
    rows = []
    for k in LOG2_N:
        rows.append(measure(1 << k, device))
        print(f"{format_row(rows[-1])}  [{label}]", flush=True)
    if args.out:
        write_rows(args.out, rows, device)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
