"""Wall-clock timing synchronised with the device, and ``torch.profiler``
traces (PyTorch port of ``particle_filters_tpu/utils/timing.py``).

PyTorch returns before the card has finished, so a phase that hands its
result to ``sync`` waits for the card (``torch.cuda.synchronize``) before
the clock stops, where the JAX package calls ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch


def block_until_ready(tree):
    """Wait for the card if any tensor in ``tree`` (a tensor or nested
    tuples, lists and dict values of them) lies on it; return ``tree``."""
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
                return tree
        elif isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (tuple, list)):
            stack.extend(t)
    return tree


class Timer:
    """Accumulating named phase timer with device synchronization."""

    def __init__(self) -> None:
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase; pass ``sync=result`` tensors to wait for the card."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            block_until_ready(sync)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for its outputs, record elapsed time, return outputs."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        block_until_ready(out)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.records.items():
            out[name] = {
                "total_s": sum(ts),
                "mean_ms": 1e3 * sum(ts) / len(ts),
                "count": len(ts),
                "min_ms": 1e3 * min(ts),
                "max_ms": 1e3 * max(ts),
            }
        return out


@contextlib.contextmanager
def timed(label: str = ""):
    """Simple timed block printing elapsed milliseconds."""
    t0 = time.perf_counter()
    yield
    print(f"[{label}] {1e3 * (time.perf_counter() - t0):.2f} ms")


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """``torch.profiler`` trace of the host and, where there is one, the
    card; written to ``logdir`` as a Chrome trace (chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(logdir)
    with torch.profiler.profile(activities=acts, on_trace_ready=handler) as prof:
        yield prof
