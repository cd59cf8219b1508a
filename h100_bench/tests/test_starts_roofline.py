"""The reader of ``starts_roofline.sir`` on recorded event lists: a trace
with kernel S's three passes, and one without them (a program that
computes the starts by other ops), where it reads nothing."""

from __future__ import annotations

import pytest

from h100_bench import harness, roofline, trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _ctx(events, rows):
    return harness.Context(trace=trace.Trace(events), shape={"particles": rows, "dim": 1},
                           counts={"steps": 10, "b2_rows": rows, "resample_steps": 1})


WINDOW = _x(trace.WINDOW, "user_annotation", 0.0, 1000.0)
B2 = _x("(anonymous namespace)::merge_path_resample_kernel(float const*)", "kernel", 500.0, 5.0)


def read(ctx):
    return harness.load_module("metrics", "starts_roofline.sir").read(ctx)


def test_reads_the_three_passes():
    rows = 1 << 24
    events = [WINDOW, B2,
              _x("(anonymous namespace)::systematic_starts_tile_sums_kernel(float const*, "
                 "int, int, double*)", "kernel", 100.0, 30.0),
              _x("(anonymous namespace)::systematic_starts_tile_offsets_kernel(double*, int, "
                 "double*)", "kernel", 140.0, 5.0),
              _x("(anonymous namespace)::systematic_starts_write_kernel(float const*, ...)",
                 "kernel", 150.0, 45.0),
              _x("outside the window: systematic_starts_write_kernel", "kernel", 2000.0, 9.0)]
    want = 100.0 * rows * 8 / roofline.HBM_BYTES_PER_S / 80e-6
    assert read(_ctx(events, rows)) == pytest.approx(want)


def test_nothing_to_read_without_the_kernel():
    """The parent's program (the starts by torch ops): no such kernel, None."""
    events = [WINDOW, B2, _x("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n", "kernel", 100.0, 20.0),
              _x("void at::native::tensor_kernel_scan_innermost_dim_with_indices", "kernel",
                 130.0, 20.0)]
    assert read(_ctx(events, 1 << 24)) is None
    assert read(_ctx([WINDOW], 0)) is None
    assert read(harness.Context()) is None
