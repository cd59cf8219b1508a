"""Decompose the per-step time of the fused SIR path at small N (port of
``benchmarks/profile_small_n.py``).

Every variant is a loop of m steps whose result feeds the next step,
timed by the slope protocol (``_slope``). The variants peel one stage at a
time:

  full         ``FusedSIRFilter.run``, resample when ESS < N/2 (SV model)
  no-resample  the same with threshold 0: the resample is never taken,
               but its test (one device→host read per step) stays
  kernel+comb  ``fused_step`` (kernel B1) with its in-kernel row folded into
               the carry: each step's ``off_u`` is the previous step's
               ``(log_z, 0)``, and the row lands in a preallocated history
  kernel-only  ``fused_step`` alone, on a fixed ``off_u``
  minimal      ``c * 1.0000001 + 1e-12`` on a same-shape tensor: the
               floor of a loop of small torch ops (two launches a step;
               XLA fused them into one)
  launch       probe X3 (``ops/launch_probe.py``) in a loop: the floor
               cost of one kernel launch

The eager slope of each variant is what a Python loop pays. The four
variants with no host read per step are also captured in a CUDA graph and
replayed (``graph_slope``): the card's own time per step, which bounds what
capturing the filter's step could recover. The JAX script's ``block`` knob
(particles per Pallas grid step) has no counterpart: kernel B1 runs a
persistent grid of ``ops.fused_pf.PROGRAMS_PER_SM`` programs per SM and
finishes the moments in its last program, so "combine" (kernel+comb minus
kernel-only) is what chaining the carry costs.

Run on a GPU host, at the JAX script's loop lengths (m 100 → 1700, best of
4)::

    python -m particle_filters_tpu_torch.benchmarks.profile_small_n 14 16 20
"""

from __future__ import annotations

import math
import sys

import torch

from particle_filters_tpu_torch.benchmarks._slope import graph_slope, slope
from particle_filters_tpu_torch.ops.fused_pf import (
    FusedSIRFilter,
    StepWork,
    SVModel,
    fused_step,
    row_width,
)
from particle_filters_tpu_torch.ops.launch_probe import TILE, add_one
from particle_filters_tpu_torch.simulators import simulate_sv_1d

ALPHA, SIGMA = 0.95, 0.2
M_LO, M_HI, REPS = 100, 1700, 4  # the JAX script's
_NO_HOST_SYNC = ("kernel+comb", "kernel-only", "minimal", "launch")


def make_pf(n, device, resample_thresh=0.5):
    pf = FusedSIRFilter(SVModel(ALPHA, 1.0), [[SIGMA**2]], Np=n,
                        resample_thresh=resample_thresh, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    state0 = pf.initialize(gen, [0.0], [[SIGMA**2 / (1 - ALPHA**2)]])
    return pf, state0


def loop_builders(n, device, ys):
    """``{variant: build_loop}`` at N = ``n`` over the observations ``ys``
    (at least m of them); each ``build_loop(m)`` returns the loop's run
    function, which returns a tensor of the last step."""
    pf, state0 = make_pf(n, device)

    def build_full(m, thresh):
        pf_t, _ = make_pf(n, device, resample_thresh=thresh)
        zs = ys[:m, None]

        def run():
            gen = torch.Generator(device=device).manual_seed(3)
            (pt, _, _), hist = pf_t.run(gen, state0, zs)
            return torch.sum(hist["mean"]) + pt[0]
        return run

    def build_kernel(m, with_carry):
        zs = ys[:m, None].contiguous()
        gen = torch.Generator(device=device).manual_seed(3)
        seeds = pf._draw_seeds(gen, m)
        off0 = torch.zeros(2, device=device)
        work = StepWork(1, device)
        rows = torch.empty((m, row_width(1)), device=device)

        def run():
            x, lw, off = state0[0].view(1, n), state0[1], off0
            for t in range(m):
                x, lw, _ = fused_step(x, lw, off, zs[t], pf.Lq, pf.params, pf.model,
                                      seed=seeds[t], work=work, row_out=rows[t])
                if with_carry:
                    off = work.carry
            return x[0, 0] + lw[0] + rows[-1, 0]
        return run

    def build_minimal(m):
        def run():
            c = state0[0]
            for _ in range(m):
                c = c * 1.0000001 + 1e-12
            return c[0]
        return run

    def build_launch(m):
        x0 = torch.zeros(TILE, device=device)

        def run():
            c = x0
            for _ in range(m):
                c = add_one(c)
            return c[0, 0]
        return run

    return {
        "full": lambda m: build_full(m, 0.5),
        "no-resample": lambda m: build_full(m, 0.0),
        "kernel+comb": lambda m: build_kernel(m, True),
        "kernel-only": lambda m: build_kernel(m, False),
        "minimal": build_minimal,
        "launch": build_launch,
    }


def profile_n(n, device, m_lo=M_LO, m_hi=M_HI, reps=REPS):
    """Eager (and, on a CUDA device, graph) seconds per step of every
    variant at N = ``n``: ``{"eager": {...}, "graph": {...}}``."""
    print(f"N = 2^{int(math.log2(n))} = {n}", flush=True)
    ys = simulate_sv_1d(m_hi, ALPHA, SIGMA, 1.0, seed=42, device=device).Y
    builders = loop_builders(n, device, ys)
    eager = {k: slope(k, b, m_lo, m_hi, reps) for k, b in builders.items()}
    graph = {}
    if torch.device(device).type == "cuda":
        graph = {k: graph_slope(k, builders[k], m_lo, m_hi, reps) for k in _NO_HOST_SYNC}
    us = {k: 1e6 * v for k, v in eager.items()}
    print(f"  => eager: resample branch {us['full'] - us['no-resample']:.3f} | "
          f"untaken branch + host read {us['no-resample'] - us['kernel+comb']:.3f} | "
          f"combine {us['kernel+comb'] - us['kernel-only']:.3f} | "
          f"B1 step {us['kernel-only']:.3f} (loop floor {us['minimal']:.3f}, "
          f"launch floor {us['launch']:.3f}) us", flush=True)
    if graph:
        g = {k: 1e6 * v for k, v in graph.items()}
        print(f"  => graph: combine {g['kernel+comb'] - g['kernel-only']:.3f} | "
              f"B1 step {g['kernel-only']:.3f} (loop floor {g['minimal']:.3f}, "
              f"launch floor {g['launch']:.3f}) us", flush=True)
    return {"n": n, "eager": eager, "graph": graph}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_small_n needs a CUDA device.", file=sys.stderr)
        return 1
    print(f"card: {torch.cuda.get_device_name(0)}")
    for logn in [int(a) for a in sys.argv[1:]] or [14, 16, 20]:
        profile_n(1 << logn, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
