"""Every metric's reader on a recorded event list: a Chrome trace as
``torch.profiler`` exports it, reduced by ``trace.Trace``."""

from __future__ import annotations

import pytest

from h100_bench import harness, roofline, trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


# One window of 1000 µs: B1 twice, B2 once, a Cholesky, a copy overlapping
# the Cholesky; the host's launches, one sync, and the ops it ran.
EVENTS = [
    _x(trace.WINDOW, "user_annotation", 0.0, 1000.0),
    _x("_fused_step_kernel", "kernel", 100.0, 10.0),
    _x("_fused_step_kernel", "kernel", 300.0, 10.0),
    _x("(anonymous namespace)::merge_path_resample_kernel(float const*)", "kernel", 500.0, 5.0),
    _x("void potrf_batched_kernel<float>", "kernel", 600.0, 50.0),
    _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 640.0, 20.0),
    _x("cuLaunchKernel", "cuda_driver", 90.0, 5.0),
    _x("cuLaunchKernel", "cuda_driver", 290.0, 5.0),
    _x("cudaLaunchKernel", "cuda_runtime", 490.0, 5.0),
    _x("cudaLaunchKernel", "cuda_runtime", 590.0, 5.0),
    _x("cudaStreamSynchronize", "cuda_runtime", 700.0, 250.0),
    _x("aten::item", "cpu_op", 690.0, 270.0),
    _x("aten::mul", "cpu_op", 20.0, 60.0),
    _x("outside the window", "kernel", 2000.0, 5.0),
]


@pytest.fixture
def tr():
    return trace.Trace(EVENTS)


def test_trace_reduction(tr):
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx((10 + 10 + 5 + 60) * 1e-6)  # the copy overlaps
    assert tr.device_s(("_fused_step_kernel",)) == pytest.approx(20e-6)
    assert tr.runtime_calls(("LaunchKernel",)) == 4
    assert tr.runtime_calls(("Synchronize",)) == 1
    assert tr.top_ops(2)[0][0] == "void potrf_batched_kernel<float>"
    gaps = dict(tr.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(340e-6)  # 660 .. 1000
    assert gaps["aten::mul"] == pytest.approx(100e-6)  # 0 .. 100
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)


def _ctx(tr, **shape):
    return harness.Context(trace=tr, shape=shape, counts={
        "steps": 10, "b1_launches": 2, "b2_launches": 1, "b2_rows": 4096,
        "resample_steps": 1})


def read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_sir_readers(tr):
    ctx = _ctx(tr, particles=1 << 20, dim=1, steps=200)
    n = 1 << 20
    assert read("device_idle.sir", ctx) == pytest.approx(91.5)
    assert read("host_launches_per_step.sir", ctx) == pytest.approx(0.4)
    assert read("host_syncs_per_step.sir", ctx) == pytest.approx(0.1)
    b1 = 2 * 16 * n / roofline.HBM_BYTES_PER_S / 20e-6 * 100
    assert read("b1_roofline.sir", ctx) == pytest.approx(b1)
    b2 = 4096 * 12 / roofline.HBM_BYTES_PER_S / 5e-6 * 100
    assert read("b2_roofline.sir", ctx) == pytest.approx(b2)
    step = (10 * 16 * n + 4096 * 12) / roofline.HBM_BYTES_PER_S / 1e-3 * 100
    assert read("step_mfu.sir", ctx) == pytest.approx(step)


def test_flow_readers(tr):
    ctx = _ctx(tr, kind="ledh", trials=2, particles=3, dim=4, steps=10, lambda_steps=8)
    assert read("factor_share.flow", ctx) == pytest.approx(100 * 50 / 95)
    assert read("device_idle.flow", ctx) == pytest.approx(91.5)
    assert read("b2_roofline.flow", ctx) == pytest.approx(
        4096 * (2 * 4 + 1) * 4 / roofline.HBM_BYTES_PER_S / 5e-6 * 100)
    ops = 80 * roofline.ledh_ops(6, 4) + 10 * roofline.flow_weight_ops(6, 4)
    nbytes = (2 * 80 + 10) * 6 * 4 * 4  # at this toy size the bytes bound it
    assert read("step_mfu.flow", ctx) == pytest.approx(
        100 * roofline.least_s(nbytes, ops) / 1e-3)
    assert nbytes / roofline.HBM_BYTES_PER_S > ops / roofline.FP32_OPS_PER_S


def test_host_clock_readers():
    ctx = harness.Context(setup_s=12.5, unit_s=[0.1] * 19 + [0.3], window_s=2.2,
                          work={"particle_steps": 20 * 200 * 1024, "trials": 2000})
    assert read("setup_s", ctx) == 12.5
    assert read("particle_steps_per_s", ctx) == pytest.approx(20 * 200 * 1024 / 2.2)
    assert read("trials_per_s", ctx) == pytest.approx(2000 / 2.2)
    assert read("run_ms_p95", ctx) == pytest.approx(110.0)


def test_kernel_rooflines_absent_when_their_kernel_is():
    events = [e for e in EVENTS if "fused" not in e["name"] and "merge_path" not in e["name"]]
    ctx = _ctx(trace.Trace(events), particles=1 << 20, dim=1, steps=200)
    assert read("b1_roofline.sir", ctx) is None
    assert read("b2_roofline.sir", ctx) is None
