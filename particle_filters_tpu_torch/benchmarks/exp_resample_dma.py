"""Probe X2 against kernel B2 (port of ``benchmarks/exp_resample_dma.py``).

X2 (``ops/span_resample.py``) stages, per super-group of 64 sub-groups, one
contiguous span of fine-chunk rows instead of gathering Q rows per
sub-group. The span's length ``spanD`` depends on the weights. This script,
in the JAX script's three parts:

  1. ``spanD`` and ESS/N on lognormal weights softmax(σ·z), σ ∈ {0.3, 1,
     1.5, 2, 3}, N = 2^20: is the budget of ROWS = 128 rows a real path?
  2. X2 against B2 (``ops/resample.py::resample_by_starts``) on the same
     starts, at N = 16384 and N = 2^20, within 1e-5 (the JAX script's bar:
     X2 telescopes f32 differences, B2 copies);
  3. both timed by the graph slope at N = 2^20 (m 8 → 72, best of 4: the
     JAX script's lengths), each step drawing its starts (and, for X2,
     ranking ``a0`` and checking its path on the device) inside the loop,
     as the JAX script does.

Parts 2 and 3 use lognormal σ = 1 weights (ESS ≈ 0.37·N), where each
sub-group's ancestors fit X2's Q = 3 chunk window, as in the JAX script.

Run on a GPU host::

    python -m particle_filters_tpu_torch.benchmarks.exp_resample_dma
"""

from __future__ import annotations

import sys

import torch

from particle_filters_tpu_torch.benchmarks._slope import graph_slope
from particle_filters_tpu_torch.ops.resample import resample_by_starts
from particle_filters_tpu_torch.ops.resample_blocked import SUB, leading_starts, rank_window
from particle_filters_tpu_torch.ops.span_resample import (
    Q,
    ROWS,
    SG,
    span_checks,
    span_resample_unchecked,
    span_resample_values,
    span_rows,
)
from particle_filters_tpu_torch.resampling.hard import _systematic_starts

N = 1 << 20
N_SMALL = SG * SUB * 2  # two super-groups
SIGMAS = (0.3, 1.0, 1.5, 2.0, 3.0)
M_LO, M_HI, REPS = 8, 72, 4  # the JAX script's
TOL = 1e-5


def rank_a0(starts, n, n_subs_pad):
    """``(a0, a_hi)`` of ``ops.resample_blocked.rank_window`` on the
    leading starts, padded to ``n_subs_pad`` chunks."""
    return rank_window(leading_starts(starts, n_subs_pad), n_subs_pad)


def span_table(device, n=N, sigmas=SIGMAS, seed=0):
    """Part 1: ``[(σ, ESS/N, max sub-group span, spanD)]``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(n, generator=gen, device=device)
    rows = []
    for sigma in sigmas:
        w = torch.softmax(sigma * z, 0)
        ess = float(1.0 / torch.sum(w * w) / n)
        starts = _systematic_starts(gen, w, n)
        a0, a_hi = rank_a0(starts, n, n // SUB)
        rows.append((sigma, ess, int(torch.max(a_hi - a0)), int(span_rows(a0))))
        print(f"  sigma={sigma}: ESS/N={ess:.3f} span(sub)={rows[-1][2]} "
              f"spanD={rows[-1][3]} (budget {ROWS - Q})", flush=True)
    return rows


def check_against_b2(n, device, seed=2):
    """Part 2: max |X2 − B2| on one set of starts (lognormal σ = 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.softmax(torch.randn(n, generator=gen, device=device), 0)
    p = torch.randn((n, 1), generator=gen, device=device)
    starts = _systematic_starts(gen, w, n)
    a0, _ = rank_a0(starts, n, n // SUB)
    err = float((span_resample_values(starts, p, a0) - resample_by_starts(p, starts)).abs().max())
    print(f"  X2 vs B2 (N={n}): max |X2 - B2| = {err:.3e}", flush=True)
    if not err <= TOL:
        raise RuntimeError(f"X2 disagrees with B2 at N={n}: {err:.3e} > {TOL}")
    return err


def time_against_b2(device, n=N, m_lo=M_LO, m_hi=M_HI, reps=REPS):
    """Part 3: graph-slope seconds per resample, B2 and X2, starts drawn
    in the loop from the default generator (which a CUDA graph can
    capture); returns ``(b2, x2)``."""
    gen = torch.Generator(device=device).manual_seed(0)
    w0 = torch.softmax(torch.randn(n, generator=gen, device=device), 0)
    p = torch.randn((n, 1), generator=gen, device=device)
    worst = []  # each X2 loop's worst span_checks, read after the timing

    def build_b2(m):
        def run():
            c = p
            for _ in range(m):
                c = resample_by_starts(c, _systematic_starts(None, w0, n))
            return c
        return run

    def build_x2(m):
        def run():
            c = p
            top = torch.zeros(2, dtype=torch.int32, device=device)
            for _ in range(m):
                starts = _systematic_starts(None, w0, n)
                a0, _ = rank_a0(starts, n, n // SUB)
                top = torch.maximum(top, span_checks(starts, a0))
                c = span_resample_unchecked(starts, c, a0)
            worst.append(top)
            return c
        return run

    t_b2 = graph_slope("B2 resample", build_b2, m_lo, m_hi, reps)
    t_x2 = graph_slope("X2 span", build_x2, m_lo, m_hi, reps)
    span, uncovered = torch.stack(worst).max(0).values.tolist()
    if span > ROWS or uncovered:
        raise RuntimeError(f"X2 left its path in the timed loop: spanD {span}, "
                           f"{uncovered} uncovered sub-groups.")
    return t_b2, t_x2


def run_all(device="cuda"):
    """The three parts: ``(span table, max |X2 − B2|, (t_B2, t_X2))``."""
    print(f"spanD (rows a {SG}-sub-group super-group needs) on lognormal weights, N={N}:")
    table = span_table(device)
    err = max(check_against_b2(n, device) for n in (N_SMALL, N))
    print(f"B2 and X2 with their starts, N={N}, graph slope m {M_LO} -> {M_HI}, "
          f"best of {REPS}:")
    return table, err, time_against_b2(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_resample_dma needs a CUDA device.", file=sys.stderr)
        return 1
    print(f"card: {torch.cuda.get_device_name(0)}")
    run_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
