"""The ``sv_dpf_ot_grad_n8192`` cell's readers on recorded event lists, its
spans as the card traces them, and what its entry and plain reference
import.

- ``vjp_roofline.otg`` counts the exponentials the traced backward steps
  need, whatever ran, over the union of the VJP kernels' intervals (launches
  that overlap count once); ``step_mfu.otg`` the forward's and the
  backward's configured work over the window. Neither reads anything
  without a trace, the steps or the kernels.
- ``pf.ot.vjp`` comes from autograd's device thread, after the caller's
  ``pf.ot.run`` has closed and while it waits in ``torch.autograd.grad``:
  ``idle_backward.otg`` takes the idle under it, and with the idle under the
  forward's spans and under none adds up to ``device_idle.otg``.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from h100_bench import harness, roofline, spans, trace
from h100_bench.tests import test_cells


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def read(metric, ctx):
    return harness.load_module("metrics", metric).read(ctx)


WINDOW = _x(trace.WINDOW, "user_annotation", 0.0, 1000.0)
SHAPE = {"particles": 8192, "sinkhorn_iters": 50}
VJP = "void (anonymous namespace)::sinkhorn_vjp_kernel<1, 0>((anonymous namespace)::VjpArgs)"


def test_vjp_roofline_counts_the_backward_exps_over_the_kernels_union():
    """N² × (2 × 50 + 1) exps a backward step at the SFU's rate, over the
    union of the VJP kernels' intervals: 100–300 and 250–400 overlap (a
    programmatic dependent launch) and count 300 µs, not 350, and one that
    runs past the window's end counts to the end (50 µs); the forward's
    kernel is not the backward's."""
    events = [WINDOW, _x(VJP, "kernel", 100.0, 200.0), _x(VJP, "kernel", 250.0, 150.0),
              _x("void (anonymous namespace)::sinkhorn_tile_kernel<1, false>(...)", "kernel",
                 500.0, 400.0), _x(VJP, "kernel", 950.0, 100.0)]
    ctx = harness.Context(trace=trace.Trace(events), shape=SHAPE,
                          counts={"steps": 3, "backward_steps": 2})
    mod = harness.load_module("metrics", "vjp_roofline.otg")
    want = 100.0 * 2 * 8192**2 * 101 / (132 * 16 * 1.98e9) / 350e-6
    assert read("vjp_roofline.otg", ctx) == pytest.approx(want)
    assert mod.vjp_exps(8192, 50) == 8192**2 * 101


@pytest.mark.parametrize("ctx", [
    harness.Context(),
    harness.Context(trace=trace.Trace([WINDOW, _x("k", "kernel", 10.0, 10.0)]), shape=SHAPE,
                    counts={"steps": 3, "backward_steps": 2}),
    harness.Context(trace=trace.Trace([WINDOW, _x(VJP, "kernel", 10.0, 10.0)]), shape=SHAPE,
                    counts={"steps": 3})], ids=["no trace", "no VJP kernel", "no backward"])
def test_vjp_roofline_reads_nothing_without_the_backward(ctx):
    assert read("vjp_roofline.otg", ctx) is None


def test_step_mfu_counts_forward_and_backward_work():
    """``step_mfu.ot``'s count for every step and every backward step, at
    67 TFLOP/s, over the window."""
    events = [WINDOW, _x("k", "kernel", 10.0, 900.0)]
    ctx = harness.Context(trace=trace.Trace(events), shape=SHAPE,
                          counts={"steps": 3, "backward_steps": 2})
    ops = (3 + 2) * 8192**2 * 101 * 2
    assert read("step_mfu.otg", ctx) == pytest.approx(100.0 * ops / roofline.FP32_OPS_PER_S / 1e-3)
    assert read("step_mfu.otg", harness.Context(trace=trace.Trace([WINDOW]), shape=SHAPE,
                                                counts={"steps": 0})) is None


# One value-and-gradient unit in a 1000 µs window. The caller's thread (tid
# 1): pf.ot.run 0–400 holding a step 50–350 with its sinkhorn 100–250 and
# project 250–300; then it waits in autograd.grad. Autograd's device thread
# (tid 2): pf.ot.vjp 450–850. Device: 120–240, 260–290, 460–600, 620–840.
# Idle: run 0–50 and 350–400 (100), step 50–100 and 300–350 (100), sinkhorn
# 100–120 and 240–250 (30), project 250–260 and 290–300 (20), none 400–450
# and 850–1000 (200), vjp 450–460, 600–620, 840–850 (40): 490 in all.
UNIT = [WINDOW,
        _x("pf.ot.run", "user_annotation", 0.0, 400.0),
        _x("pf.ot.step", "user_annotation", 50.0, 300.0),
        _x("pf.ot.sinkhorn", "user_annotation", 100.0, 150.0),
        _x("pf.ot.project", "user_annotation", 250.0, 50.0),
        _x("autograd::engine::evaluate_function: _TileSinkhornBackward", "cpu_op", 440.0, 420.0,
           tid=2),
        _x("pf.ot.vjp", "user_annotation", 450.0, 400.0, tid=2),
        _x("k", "kernel", 120.0, 120.0), _x("k", "kernel", 260.0, 30.0),
        _x(VJP, "kernel", 460.0, 140.0), _x(VJP, "kernel", 620.0, 220.0)]


@pytest.mark.parametrize("metric,idle_us", [("idle_backward.otg", 40.0),
                                            ("device_idle.otg", 490.0),
                                            ("idle_sinkhorn.ot", 30.0),
                                            ("idle_step.ot", 100.0 + 20.0),
                                            ("idle_loop.ot", 100.0)])
def test_backward_span_splits_the_idle(metric, idle_us):
    ctx = harness.Context(trace=trace.Trace(UNIT))
    assert read(metric, ctx) == pytest.approx(100.0 * idle_us / 1000.0)


def test_idle_under_the_spans_and_none_is_the_device_idle():
    tr = trace.Trace(UNIT)
    split = spans.idle_split(tr)
    assert split[None] == pytest.approx(200e-6)
    assert sum(split.values()) == pytest.approx((1.0 - tr.busy_s / tr.window_s) * tr.window_s)


def test_backward_reader_reads_nothing_without_the_span():
    """The parent's program has no ``pf.ot.vjp``: nothing to read."""
    events = [e for e in UNIT if e["name"] != "pf.ot.vjp"]
    assert read("idle_backward.otg", harness.Context(trace=trace.Trace(events))) is None
    assert read("idle_backward.otg", harness.Context()) is None


def test_cell_is_rehearsed_by_test_cells():
    """``test_cells.py`` finds the cell by its workload file, with no edit:
    its two runs and one fault case a fault."""
    mod = harness.load_module("entries", "dpf_ot_grad")
    assert "sv_dpf_ot_grad_n8192" in test_cells.CELLS
    assert test_cells.entry("sv_dpf_ot_grad_n8192") is mod
    assert len(mod.FAULTS) == 6


def _imports(code: str) -> list:
    """The modules of JAX, of either package and of interop that ``code``
    leaves imported, in a fresh interpreter."""
    tail = ("\nimport json\nprint(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'particle_filters_tpu', 'particle_filters_tpu_torch')"
            " or m.endswith('.interop'))))")
    res = subprocess.run([sys.executable, "-c", "import sys\n" + code + tail],
                         cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_reference_imports_no_program_and_no_jax():
    assert _imports("from h100_bench import harness\n"
                    "harness.load_module('configs', 'sv_dpf_ot_grad')") == []


def test_entry_imports_no_jax_and_no_columns():
    mods = _imports("from h100_bench import harness\n"
                    "harness.load_module('entries', 'dpf_ot_grad')\n"
                    "from particle_filters_tpu_torch.models import dpf")
    assert "particle_filters_tpu_torch.models.dpf" in mods
    assert [m for m in mods if m.split(".")[0] in ("jax", "particle_filters_tpu")
            or m.endswith(".interop") or "_torch.benchmarks" in m] == []


def test_control_fails_the_cells_limits():
    """The bfloat16 control (the reference's run, gradient included, in
    bfloat16) in the program's place at N = 256, T = 8 fails the N = 8192
    cell's own limits (on the card it is run at the cell's size by
    ``h100_bench.calibrate --control``)."""
    import torch

    real = harness.load_json("workloads", "sv_dpf_ot_grad_n8192")
    cfg = dict(harness.load_json("configs", "sv_dpf_ot_grad"), steps=8)
    mod = harness.load_module("entries", "dpf_ot_grad")
    entry = mod.Entry(dict(real, particles=256, sequences=2), cfg, 2**33 + 99,
                      torch.device("cpu"))
    entry.free()
    checks, failed, _ = entry.check(control=True)
    assert failed == 1 and checks["grad_gap"][0] > checks["grad_gap"][1], checks
