"""The traced run's reduction: ``torch.profiler`` over a window of whole
units, exported as a Chrome trace and reduced to what the per-layer readers
read: device intervals (kernels, copies, sets) and their union, kernel time
by name, the host's runtime calls, and the device's idle gaps labelled by
what the host was doing.

Times in the trace are microseconds on one clock for host and device.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import Counter

WINDOW = "h100_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def capture(fn):
    """Run ``fn()`` (which ends in a sync) under the profiler, inside a range
    that marks the traced window: ``(Trace, fn's result)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events), out


def _union(intervals):
    """Merged (start, end) intervals of a list of (start, end)."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """The events of one traced window, reduced."""

    def __init__(self, events: list) -> None:
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        window = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not window:
            raise ValueError("the trace has no window range.")
        self.t0 = float(window[0]["ts"])
        self.t1 = self.t0 + float(window[0]["dur"])
        inside = [e for e in spans if self.t0 <= float(e["ts"]) <= self.t1]
        self.device = [(e["name"], float(e["ts"]), float(e["dur"])) for e in inside
                       if e.get("cat") in DEVICE_CATS]
        self.host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in inside
                     if e.get("cat") in HOST_CATS and e["name"] != WINDOW]
        self.runtime = Counter(e["name"] for e in inside
                               if e.get("cat") in ("cuda_runtime", "cuda_driver"))
        busy = [(max(ts, self.t0), min(ts + dur, self.t1)) for _, ts, dur in self.device]
        self.busy = _union([(s, e) for s, e in busy if e > s])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def device_s(self, patterns=None) -> float:
        """Seconds of device operations whose name holds any of ``patterns``
        (all of them where None), summed over operations."""
        return sum(dur for name, _, dur in self.device
                   if patterns is None or any(p in name for p in patterns)) * 1e-6

    def runtime_calls(self, patterns) -> int:
        """Host runtime and driver calls whose name holds any of ``patterns``."""
        return sum(n for name, n in self.runtime.items() if any(p in name for p in patterns))

    def top_ops(self, k: int = 10):
        """The ``k`` device operations that took most time: [[name, s]]."""
        by = Counter()
        for name, _, dur in self.device:
            by[name[:160]] += dur * 1e-6
        return [[name, s] for name, s in by.most_common(k)]

    def gaps(self):
        """The device's idle intervals inside the window, (start, end) µs."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def idle_gaps(self, k: int = 10):
        """Idle seconds by what the host was doing: each gap is labelled by
        the innermost host operation or runtime call running at its middle
        ("host: between operations" where none ran); the ``k`` largest
        labels, [[label, s]]."""
        gaps = sorted(self.gaps(), key=lambda g: (g[0] + g[1]) / 2)
        host = sorted((ts, ts + dur, dur, name) for name, ts, dur in self.host)
        by, active, j = Counter(), [], 0
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            while j < len(host) and host[j][0] <= mid:
                heapq.heappush(active, (host[j][1], host[j][2], host[j][3]))
                j += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            label = min(active, key=lambda a: a[1])[2] if active else "host: between operations"
            by[label[:160]] += (g1 - g0) * 1e-6
        return [[name, s] for name, s in by.most_common(k)]
