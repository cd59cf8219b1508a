"""Wall-clock timing synchronised with the device, and ``torch.profiler``
traces (PyTorch port of ``particle_filters_tpu/utils/timing.py``).

PyTorch returns before the card has finished, so a phase that hands its
result to ``sync`` waits for the card (``torch.cuda.synchronize``) before
the clock stops, where the JAX package calls ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Dict, List

import torch


def sync(device) -> None:
    """Wait for the card when ``device`` is a CUDA device."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (an entry
    point runs on the card unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this runs on the card; pass --device cpu "
                           "(device='cpu') to check the path on the CPU.")
    return device


def card(device="cuda"):
    """(name, power limit in W) of the first card, as ``nvidia-smi`` reads
    them; ("cpu", None) for a CPU device."""
    if torch.device(device).type != "cuda":
        return "cpu", None
    row = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    name, limit = (field.strip() for field in row.split(","))
    return name, float(limit)


def card_line(device="cuda") -> str:
    """The card's name and power limit in ``nvidia-smi``'s CSV form, to
    print beside a time; "cpu" for a CPU device."""
    name, limit = card(device)
    return name if limit is None else f"{name}, {limit:.2f} W"


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


def kernel_records(fn):
    """Run ``fn()`` once under ``torch.profiler`` (host and card) to a
    ``torch.cuda.synchronize()``: ``[(device µs, count, name)]`` of the card's
    kernel records only (an operator's record repeats its kernels' time), so
    their sum is the card's busy time in that run. Empty where the profiler
    saw no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


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
