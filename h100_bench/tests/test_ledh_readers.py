"""The LEDH cell's readers on recorded event lists, in the style of
``test_metrics.py`` and ``test_spans.py``: ``factor_roofline.ledh`` (the
factored matrices' d³/3 operations over the union of the Cholesky kernels'
intervals) and ``idle_factors.ledh`` (idle under ``pf.ledh.factors``, the
innermost span inside ``pf.flow.advance``), and the entry's counter."""

from __future__ import annotations

import pytest
import torch

from h100_bench import harness, roofline, trace
from h100_bench.tests.test_metrics import _x

# One λ-step's factors in a 1000 µs window: advance 100..900 holding
# factors 150..450. Device: two POTRF launches 200..300 and 280..400
# (overlapping: their union is 200 µs), a GEMM 500..600. Gaps: [0, 200]
# (none 100, advance 50, factors 50), [400, 500] (factors 50, advance 50),
# [600, 1000] (advance 300, none 100).
EVENTS = [
    _x(trace.WINDOW, "user_annotation", 0.0, 1000.0),
    _x("pf.flow.advance", "user_annotation", 100.0, 800.0),
    _x("pf.ledh.factors", "user_annotation", 150.0, 300.0),
    _x("void potrf_syrk_T16_nc_kernel<float, 5, 4>", "kernel", 200.0, 100.0),
    _x("void potrf_syrk_nc_kernel<float>", "kernel", 280.0, 120.0),
    _x("ampere_sgemm_32x32_sliced1x4_nn", "kernel", 500.0, 100.0),
]


def read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_factor_roofline_counts_ops_over_the_union_of_potrf_intervals():
    tr = trace.Trace(EVENTS)
    ctx = harness.Context(trace=tr, shape={"dim": 400}, counts={"factored_matrices": 10})
    want = 100.0 * 10 * 400**3 / 3 / roofline.FP32_OPS_PER_S / 200e-6
    assert read("factor_roofline.ledh", ctx) == pytest.approx(want)


def test_factor_roofline_reads_nothing_without_the_counter_or_the_kernels():
    tr = trace.Trace(EVENTS)
    assert read("factor_roofline.ledh", harness.Context(trace=tr, shape={"dim": 400})) is None
    assert read("factor_roofline.ledh", harness.Context(
        trace=tr, shape={"dim": 400}, counts={"factored_matrices": 0})) is None
    no_potrf = trace.Trace([e for e in EVENTS if "potrf" not in e["name"]])
    assert read("factor_roofline.ledh", harness.Context(
        trace=no_potrf, shape={"dim": 400}, counts={"factored_matrices": 10})) is None


def test_idle_factors_takes_the_idle_under_the_inner_span():
    tr = trace.Trace(EVENTS)
    ctx = harness.Context(trace=tr)
    assert read("idle_factors.ledh", ctx) == pytest.approx(10.0)  # 100 µs of 1000
    assert read("idle_advance.flow", ctx) == pytest.approx(40.0)
    without = trace.Trace([e for e in EVENTS if e["name"] != "pf.ledh.factors"])
    assert read("idle_factors.ledh", harness.Context(trace=without)) is None


def test_the_entry_counts_factored_matrices_and_zeroes_them():
    from particle_filters_tpu_torch.models import LEDHFlowPF

    mod = harness.load_module("entries", "ledh_trials")
    traffic = dict(harness.load_json("workloads", "skewt_ledh200_d400"), **mod.TOY[0])
    config = dict(harness.load_json("configs", "skewt_d400"), **mod.TOY[1])
    entry = mod.Entry(traffic, config, 2**33 + 5, torch.device("cpu"))
    entry.unit(0)
    entry.reset_counts()
    assert entry.counts(0)["factored_matrices"] == LEDHFlowPF.factored_matrices == 0
    entry.unit(1)
    B, n, T, lam = config["trials"], traffic["particles"], config["steps"], config["lambda_steps"]
    assert entry.counts(1)["factored_matrices"] == 2 * B * n * lam * T
