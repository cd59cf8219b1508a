"""The ``sv_dpf_ot_n8192`` cell's readers on recorded event lists, and what its
entry and its plain reference import.

- ``step_mfu.ot`` counts the configured Sinkhorn work of the traced steps,
  whatever ran; it reads nothing without a trace or steps.
- ``idle_sinkhorn.ot``, ``idle_step.ot`` and ``idle_loop.ot`` split the idle
  by the ``pf.ot.*`` spans and, with ``device_idle.ot``'s idle under no span,
  add up to it; a program without the spans (the parent's) reads nothing.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from h100_bench import harness, roofline, trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def read(metric, ctx):
    return harness.load_module("metrics", metric).read(ctx)


WINDOW = _x(trace.WINDOW, "user_annotation", 0.0, 1000.0)
SHAPE = {"particles": 8192, "sinkhorn_iters": 50}


def test_step_mfu_counts_the_configured_work():
    """N² cells × (2 × 50 + 1) passes × 2 operations a step at 67 TFLOP/s,
    over the window; kernels' names and the program's counter play no part."""
    events = [WINDOW, _x("void at::native::reduce_kernel<...>", "kernel", 10.0, 900.0)]
    ctx = harness.Context(trace=trace.Trace(events), shape=SHAPE,
                          counts={"steps": 3, "half_updates": 0})
    ops = 3 * 8192**2 * 101 * 2
    want = 100.0 * ops / roofline.FP32_OPS_PER_S / 1e-3
    assert read("step_mfu.ot", ctx) == pytest.approx(want)
    assert read("step_mfu.ot", ctx) == pytest.approx(
        100.0 * roofline.least_s(0.0, ops) / ctx.trace.window_s)
    assert read("step_mfu.ot", harness.Context(trace=trace.Trace([WINDOW]), shape=SHAPE,
                                               counts={"steps": 0})) is None
    assert read("step_mfu.ot", harness.Context()) is None


SPANS = [_x("pf.ot.run", "user_annotation", 0.0, 1000.0),
         _x("pf.ot.step", "user_annotation", 100.0, 800.0),
         _x("pf.ot.sinkhorn", "user_annotation", 200.0, 500.0),
         _x("pf.ot.project", "user_annotation", 750.0, 100.0)]
# Device busy 50–150, 300–600, 760–800. Idle under: run 0–50 and 900–1000
# (150); step 150–200, 700–750 and 850–900 (150); sinkhorn 200–300 and 600–700
# (200); project 750–760 and 800–850 (60): 560 in all.
KERNELS = [_x("k", "kernel", 50.0, 100.0), _x("k", "kernel", 300.0, 300.0),
           _x("k", "kernel", 760.0, 40.0)]


@pytest.mark.parametrize("metric,idle_us", [("idle_sinkhorn.ot", 200.0),
                                            ("idle_step.ot", 150.0 + 60.0),
                                            ("idle_loop.ot", 150.0),
                                            ("device_idle.ot", 560.0)])
def test_idle_readers_split_the_idle_by_span(metric, idle_us):
    ctx = harness.Context(trace=trace.Trace([WINDOW] + SPANS + KERNELS))
    assert read(metric, ctx) == pytest.approx(100.0 * idle_us / 1000.0)


@pytest.mark.parametrize("metric", ["idle_sinkhorn.ot", "idle_step.ot", "idle_loop.ot"])
def test_idle_readers_read_nothing_without_the_spans(metric):
    assert read(metric, harness.Context(trace=trace.Trace([WINDOW] + KERNELS))) is None
    assert read(metric, harness.Context()) is None


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
    """The plain reference imports no module of the port, of the JAX package
    or of JAX."""
    assert _imports("from h100_bench import harness\n"
                    "harness.load_module('configs', 'sv_dpf_ot')") == []


def test_entry_imports_no_jax_and_no_columns():
    """The entry, with the program it drives, imports neither JAX, the JAX
    package, an interop module nor the port's benchmark columns."""
    mods = _imports("from h100_bench import harness\n"
                    "harness.load_module('entries', 'dpf_ot_run')\n"
                    "from particle_filters_tpu_torch.models import dpf")
    assert "particle_filters_tpu_torch.models.dpf" in mods
    assert [m for m in mods if m.split(".")[0] in ("jax", "particle_filters_tpu")
            or m.endswith(".interop") or "_torch.benchmarks" in m] == []


def test_ot_control_fails_the_cells_limits():
    """The bfloat16 control in the program's place at N = 512, T = 10 fails
    the N = 8192 cell's own limits (on the card it is run at the cell's
    size by ``h100_bench.calibrate --control``)."""
    import torch

    real = harness.load_json("workloads", "sv_dpf_ot_n8192")
    cfg = dict(harness.load_json("configs", "sv_dpf_ot"), steps=10)
    mod = harness.load_module("entries", "dpf_ot_run")
    entry = mod.Entry(dict(real, particles=512, sequences=2), cfg, 2**33 + 99,
                      torch.device("cpu"))
    entry.free()
    checks, failed, _ = entry.check(control=True)
    assert failed == 1 and checks["particle_gap_p50"][0] > checks["particle_gap_p50"][1], checks
