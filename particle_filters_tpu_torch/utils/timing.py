"""Wall-clock timing synchronised with the device, and ``torch.profiler``
traces (PyTorch port of ``particle_filters_tpu/utils/timing.py``).

PyTorch returns before the card has finished, so a phase that hands its
result to ``sync`` waits for the card (``torch.cuda.synchronize``) before
the clock stops, where the JAX package calls ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional

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


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceProfile(NamedTuple):
    """One profiled call: its wall ms to a sync, the card's busy ms in it,
    and its device operations that took most time, [(ms, count, name)]."""

    wall_ms: float
    busy_ms: float
    top: list


def device_time(events, top: Optional[int] = 8):
    """``(busy ms, top ops)`` of the events of a Chrome trace that
    ``torch.profiler`` exported. Busy is the union of the card's kernel,
    copy and set intervals: launches that overlap count once, and the
    program's spans on the device timeline (``gpu_user_annotation``) not at
    all. The ops sum each name's intervals: [(ms, count, name)], the
    ``top`` largest (all where None)."""
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    busy_us, end = 0.0, -math.inf
    for ts, dur in sorted((float(e["ts"]), float(e["dur"])) for e in ops):
        busy_us += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    by_name: Dict[str, List[float]] = {}
    for e in ops:
        row = by_name.setdefault(e["name"], [0.0, 0])
        row[0] += float(e["dur"]) * 1e-3
        row[1] += 1
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()), reverse=True)
    return busy_us * 1e-3, rows[:top]


def profile_device(fn, top: Optional[int] = 8) -> DeviceProfile:
    """Run ``fn()`` once under ``torch.profiler`` (host and, where there is
    one, the card) to a sync, and reduce its trace by :func:`device_time`.
    Busy 0 and no ops where the profiler saw no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return DeviceProfile(wall_ms, *device_time(events, top))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program (``pf.sir.b1``, ...) in a profiler's
    trace: ``torch.profiler.record_function(name)`` while a torch profiler
    records, else one shared null context. The switch is the flag the
    profiler sets itself, so a span costs a global read when nothing
    records, where a bare ``record_function`` builds its range every time."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """``torch.profiler`` trace of the host and, where there is one, the
    card; written to ``logdir`` as a Chrome trace (chrome://tracing), where
    the program's :func:`span` ranges sit over the kernels they launched."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(logdir)
    with torch.profiler.profile(activities=acts, on_trace_ready=handler) as prof:
        yield prof
