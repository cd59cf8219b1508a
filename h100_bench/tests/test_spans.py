"""The idle readers of the program's spans (``spans.py``) on recorded event
lists, in the style of ``test_metrics.py``: gaps split by overlap, nested
spans giving the idle to the innermost, the readers plus the idle under no
span equal to ``device_idle.*``, and nothing read from a trace without
``pf.`` spans (the program before it had them)."""

from __future__ import annotations

import pytest

from h100_bench import harness, spans, trace
from h100_bench.tests.test_metrics import EVENTS, _x

SIR = ["idle_b1_launch.sir", "idle_trigger.sir", "idle_resample.sir", "idle_loop.sir"]
FLOW = ["idle_advance.flow", "idle_resample.flow", "idle_loop.flow"]

# One SIR run in a 1000 µs window. Device: 50..60, B1 120..150, B2 400..420,
# 600..700. Gaps: [0, 50] (none 10, run 10, b1 30), [60, 120] (b1 40, run
# 20: crosses out of pf.sir.b1), [150, 400] (trigger 100, run 50, resample
# 100), [420, 600] (resample 30, run 150), [700, 1000] (run 200, none 100).
SIR_EVENTS = [
    _x(trace.WINDOW, "user_annotation", 0.0, 1000.0),
    _x("pf.sir.run", "user_annotation", 10.0, 890.0),
    _x("pf.sir.b1", "user_annotation", 20.0, 80.0),
    _x("pf.sir.trigger_read", "user_annotation", 150.0, 100.0),
    _x("pf.sir.resample", "user_annotation", 300.0, 150.0),
    _x("aten::item", "cpu_op", 160.0, 80.0),
    _x("cudaStreamSynchronize", "cuda_runtime", 170.0, 60.0),
    _x("cudaLaunchKernel", "cuda_runtime", 400.0, 10.0),
    _x("elementwise_kernel", "kernel", 50.0, 10.0),
    _x("_fused_step_kernel", "kernel", 120.0, 30.0),
    _x("merge_path_resample_kernel", "kernel", 400.0, 20.0),
    _x("scan_kernel", "kernel", 600.0, 100.0),
]
SIR_IDLE = {"idle_b1_launch.sir": 7.0, "idle_trigger.sir": 10.0, "idle_resample.sir": 13.0,
            "idle_loop.sir": 43.0}

# One flow call: run 100..900 holding advance 120..500, trigger_read
# 500..560, resample 560..700. Device: 200..480, 520..530, 600..650,
# 750..800. Gaps: [0, 200] (none 100, run 20, advance 80), [480, 520]
# (advance 20, trigger 20), [530, 600] (trigger 30, resample 40), [650, 750]
# (resample 50, run 50), [800, 1000] (run 100, none 100).
FLOW_EVENTS = [
    _x(trace.WINDOW, "user_annotation", 0.0, 1000.0),
    _x("pf.flow.run", "user_annotation", 100.0, 800.0),
    _x("pf.flow.advance", "user_annotation", 120.0, 380.0),
    _x("pf.flow.trigger_read", "user_annotation", 500.0, 60.0),
    _x("pf.flow.resample", "user_annotation", 560.0, 140.0),
    _x("aten::nonzero", "cpu_op", 505.0, 50.0),
    _x("void potrf_batched_kernel<float>", "kernel", 200.0, 280.0),
    _x("reduce_kernel", "kernel", 520.0, 10.0),
    _x("merge_path_resample_kernel", "kernel", 600.0, 50.0),
    _x("elementwise_kernel", "kernel", 750.0, 50.0),
]
FLOW_IDLE = {"idle_advance.flow": 10.0, "idle_resample.flow": 14.0, "idle_loop.flow": 17.0}


def read(name, tr):
    return harness.load_module("metrics", name).read(harness.Context(trace=tr))


@pytest.mark.parametrize("events,expect,idle", [(SIR_EVENTS, SIR_IDLE, "device_idle.sir"),
                                                (FLOW_EVENTS, FLOW_IDLE, "device_idle.flow")],
                         ids=["sir", "flow"])
def test_readers_split_by_overlap_and_sum_to_the_device_idle(events, expect, idle):
    tr = trace.Trace(events)
    got = {name: read(name, tr) for name in expect}
    assert got == pytest.approx(expect)
    untraced = 100.0 * spans.idle_split(tr)[None] / tr.window_s
    assert sum(got.values()) + untraced == pytest.approx(read(idle, tr), abs=1e-9)


def test_a_gap_crossing_out_of_a_span_is_split_not_labelled_by_its_middle():
    tr = trace.Trace(SIR_EVENTS)
    split = spans.idle_split(tr)
    assert split["pf.sir.b1"] == pytest.approx(70e-6)  # 30 of [0, 50], 40 of [60, 120]
    assert dict(tr.idle_gaps())["pf.sir.b1"] == pytest.approx(110e-6)  # both gaps whole


def test_nested_spans_give_the_idle_to_the_innermost():
    outer = _x("pf.flow.run", "user_annotation", 0.0, 100.0)
    mid = _x("pf.flow.resample", "user_annotation", 10.0, 80.0)
    inner = _x("pf.flow.trigger_read", "user_annotation", 20.0, 20.0)
    tr = trace.Trace([_x(trace.WINDOW, "user_annotation", 0.0, 100.0), outer, mid, inner,
                      _x("k", "kernel", 95.0, 5.0)])
    split = spans.idle_split(tr)
    assert split["pf.flow.trigger_read"] == pytest.approx(20e-6)
    assert split["pf.flow.resample"] == pytest.approx(60e-6)
    assert split["pf.flow.run"] == pytest.approx(15e-6)
    assert split[None] == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("name", SIR + FLOW)
def test_readers_find_nothing_without_their_spans(name):
    """The parent's trace holds no ``pf.`` span; a SIR trace no flow span,
    and a flow trace no SIR span."""
    assert read(name, trace.Trace(EVENTS)) is None
    other = FLOW_EVENTS if name.endswith(".sir") else SIR_EVENTS
    assert read(name, trace.Trace(other)) is None
    assert read(name, None) is None


def _nested(rng, lo, hi, depth, out):
    """Random spans nested inside [lo, hi] on whole microseconds."""
    t = lo
    while depth and t < hi - 2:
        s = rng.randrange(t, hi - 1)
        e = rng.randrange(s + 1, min(hi, s + 40) + 1)
        out.append(_x(rng.choice(["pf.sir.b1", "pf.sir.trigger_read", "pf.sir.resample"]),
                      "user_annotation", float(s), float(e - s)))
        _nested(rng, s, e, depth - 1, out)
        t = e


@pytest.mark.parametrize("seed", range(4))
def test_split_matches_a_microsecond_walk(seed):
    """On random nested spans and kernels, the split equals a walk over
    every microsecond of the window."""
    import random

    rng = random.Random(seed)
    events = [_x(trace.WINDOW, "user_annotation", 0.0, 400.0),
              _x("pf.sir.run", "user_annotation", 5.0, 380.0)]
    _nested(rng, 5, 385, 3, events)
    for _ in range(25):
        s = rng.randrange(0, 395)
        events.append(_x("k", "kernel", float(s), float(rng.randrange(1, 6))))
    tr = trace.Trace(events)
    host = [(ts, ts + dur, name) for name, ts, dur in tr.host]
    walk = {}
    for t in range(400):
        if any(s <= t and t + 1 <= e for s, e in tr.busy):
            continue
        cover = [(-s, e - s, name) for s, e, name in host if s <= t and t + 1 <= e]
        name = min(cover)[2] if cover else None  # the latest started, then the shortest
        walk[name] = walk.get(name, 0.0) + 1e-6
    split = spans.idle_split(tr)
    assert {k: v for k, v in split.items() if v > 1e-12} == pytest.approx(walk)
