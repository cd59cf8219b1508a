"""The slope protocol of the JAX package's probes
(``benchmarks/profile_kernels.py:23``), eager and in a CUDA graph.

``build_loop(m)`` returns a function that runs m chained steps on the card
and returns a tensor of the last step. Each loop is run to its end behind
one ``torch.cuda.synchronize()``, and the time per step is

    (min t(m_hi) − min t(m_lo)) / (m_hi − m_lo),

so the fixed cost of starting a loop and waiting for it cancels.

- :func:`slope` runs the loop eagerly: each step pays the host's enqueue
  (Python, the wrappers, the launches) unless the card is slower.
- :func:`graph_slope` captures each loop once in a CUDA graph and replays
  it: the card's time per step without the host's enqueue. A loop whose
  steps read a value back on the host cannot be captured.

Each probe passes the lengths of its JAX script.
"""

from __future__ import annotations

import time

import torch

from particle_filters_tpu_torch.utils.timing import block_until_ready


def _slope_of(label, run_lo, run_hi, m_lo, m_hi, reps, unit):
    block_until_ready(run_lo())  # first calls: builds, compiles, allocations
    block_until_ready(run_hi())
    ts_lo, ts_hi = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        block_until_ready(run_lo())
        ts_lo.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        block_until_ready(run_hi())
        ts_hi.append(time.perf_counter() - t0)
    per = (min(ts_hi) - min(ts_lo)) / (m_hi - m_lo)
    print(f"  {label:14s}: {per * 1e6:9.3f} us/step ({unit}, m {m_lo}->{m_hi}, "
          f"best of {reps})", flush=True)
    return per


def slope(label, build_loop, m_lo=4, m_hi=12, reps=3):
    """Eager seconds per step of ``build_loop``'s loop."""
    return _slope_of(label, build_loop(m_lo), build_loop(m_hi), m_lo, m_hi, reps, "eager")


def _captured(run):
    """``run`` captured in a CUDA graph, after a warm-up on a side stream;
    returns a function that replays it and returns its output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()

    def replay():
        graph.replay()
        return out

    return replay


def graph_slope(label, build_loop, m_lo=4, m_hi=12, reps=3):
    """Device seconds per step of ``build_loop``'s loop, replayed from a
    CUDA graph. Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_slope needs a CUDA device.")
    lo, hi = _captured(build_loop(m_lo)), _captured(build_loop(m_hi))
    return _slope_of(label, lo, hi, m_lo, m_hi, reps, "graph")
