"""The program's spans (``utils.timing.span``): nothing is built while no
profiler records; under ``torch.profiler`` the SIR loop and the flow loop
mark one span per unit of work, each nested in its run, and the histories
stay bit-identical.

The flows run a 2×2 sensor grid, h(x) = x + 0.2 sin x, at a toy size; the
fused SIR filter the SV model at N = 2^12, T = 20 on its plain CPU step.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from particle_filters_tpu_torch.core import linalg
from particle_filters_tpu_torch.core.structs import stack_states
from particle_filters_tpu_torch.models import edh_particle_filter as edh
from particle_filters_tpu_torch.models import ledh_particle_filter as ledh
from particle_filters_tpu_torch.models.extended_kalman_filter import ExtendedKalmanFilter
from particle_filters_tpu_torch.models.trackers import GaussianTracker
from particle_filters_tpu_torch.ops.fused_pf import FusedSIRFilter, SVModel
from particle_filters_tpu_torch.simulators import simulate_sv_1d
from particle_filters_tpu_torch.utils import timing

torch.set_num_threads(1)

D, AL, SZ = 4, 0.9, 0.7
SIR_N, SIR_T = 1 << 12, 20
FLOW_B, FLOW_N, FLOW_T = 3, 32, 6


def test_span_off_builds_nothing(monkeypatch):
    """With no profiler active ``span`` hands back one shared null context
    and never builds a ``record_function``, in the filter's loop too."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert timing.span("pf.sir.b1") is timing.span("pf.flow.run")
    with timing.span("pf.sir.run") as inner:
        assert inner is None
    run, _ = _sir(0.5)
    run()


def test_span_on_is_a_profiler_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("pf.test"):
            torch.ones(3).sum()
    assert [e.name for e in prof.events()].count("pf.test") == 1
    assert not torch.autograd.profiler._is_profiler_enabled


def _sir(thresh):
    """A fused SIR run on the CPU from a fixed seed: ``(run, expected)``,
    ``expected(hist)`` the spans a run should emit given its history."""
    sv = simulate_sv_1d(SIR_T, 0.95, 0.2, 1.0, seed=3, device="cpu")
    filt = FusedSIRFilter(SVModel(0.95, 1.0), [[0.04]], Np=SIR_N, resample_thresh=thresh,
                          device="cpu")

    def run():
        gen = torch.Generator().manual_seed(7)
        state = filt.initialize(gen, [0.0], [[0.04 / (1 - 0.95**2)]])
        return filt.run(gen, state, sv.Y[:, None])

    def expected(hist):
        return {"pf.sir.run": 1, "pf.sir.b1": SIR_T, "pf.sir.trigger_read": SIR_T,
                "pf.sir.resample": int(hist["resampled"].sum())}

    return run, expected


def _flow(kind, ratio):
    """A batch of flow trials on the CPU from fixed seeds: ``(run, expected)``."""
    rng = np.random.default_rng(11)
    sigma = (0.5 * np.eye(D) + 0.1).astype(np.float32)
    lq = torch.from_numpy(np.linalg.cholesky(sigma))
    lr, eye = SZ * torch.eye(D), torch.eye(D)
    R = (SZ**2 * np.eye(D)).astype(np.float32)
    h = lambda x: x + 0.2 * torch.sin(x)  # noqa: E731
    parts = (lambda x, u, v: AL * x + v, h, lambda x: eye + 0.2 * torch.diag(torch.cos(x)),
             lambda xn, xo: linalg.mvn_logpdf_chol(xn, AL * xo, lq),
             lambda z, x: linalg.mvn_logpdf_chol(z, h(x), lr), R)
    track = GaussianTracker(ExtendedKalmanFilter(lambda x, u: AL * x, h, sigma, R, device="cpu"))
    mod, cfg = (edh, edh.EDHConfig) if kind == "edh" else (ledh, ledh.LEDHConfig)
    filt = getattr(mod, f"{kind.upper()}FlowPF")(
        track, *parts, cfg(n_particles=FLOW_N, n_lambda_steps=2, resample_ess_ratio=ratio),
        device="cpu")
    zs = torch.from_numpy((rng.standard_normal((FLOW_B, FLOW_T, D)) * 2.0).astype(np.float32))
    cov0 = torch.from_numpy(sigma)

    def run():
        gen = torch.Generator().manual_seed(5)
        states = stack_states([filt.init_from_gaussian(gen, torch.zeros(D), cov0)
                               for _ in range(FLOW_B)])
        tracks = stack_states([filt.tracker.init(torch.zeros(D), cov0)] * FLOW_B)
        sampler = lambda g, m, nx: 0.3 * torch.randn((m, nx), generator=g)  # noqa: E731
        return filt.run_trials(gen, states, tracks, zs, process_noise_sampler=sampler)

    def expected(hist):
        steps = int(hist["resampled"].any(dim=0).sum())
        read = FLOW_T if ratio > 0 else 0
        out = {"pf.flow.run": 1, "pf.flow.advance": FLOW_T, "pf.flow.trigger_read": read,
               "pf.flow.resample": steps}
        if kind == "ledh":  # one per λ-step: the vmapped per-particle factors
            out["pf.ledh.factors"] = FLOW_T * filt.cfg.n_lambda_steps
        return out

    return run, expected


CASES = [("sir", 0.5), ("sir", 0.9), ("edh", 0.5), ("ledh", 0.5), ("edh", 0.0), ("ledh", 0.0)]


def _case(kind, ratio):
    return _sir(ratio) if kind == "sir" else _flow(kind, ratio)


@pytest.mark.parametrize("kind,ratio", CASES, ids=[f"{k}-{r}" for k, r in CASES])
def test_spans_count_the_work_and_nest_in_their_run(kind, ratio):
    run, expected = _case(kind, ratio)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    spans = [e for e in prof.events() if e.name.startswith("pf.")]
    counts = {name: sum(e.name == name for e in spans) for name in expected(out[-1])}
    assert counts == expected(out[-1])
    assert {e.name for e in spans} <= set(counts)
    (outer,) = [e for e in spans if e.name.endswith(".run")]
    for e in spans:
        assert outer.time_range.start <= e.time_range.start <= e.time_range.end \
            <= outer.time_range.end, e.name
    if ratio > 0:
        resampled = out[-1]["resampled"]
        assert 0 < int(resampled.sum()) < resampled.numel()  # both branches ran


@pytest.mark.parametrize("kind", ["sir", "edh", "ledh"])
def test_histories_bit_identical_with_the_profiler_on(kind):
    run, _ = _case(kind, 0.5)
    off = run()
    with profile(activities=[ProfilerActivity.CPU]):
        on = run()
    a, b = _tensors(off), _tensors(on)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _tensors(tree) -> list:
    """Every tensor in nested tuples, dicts and dataclasses, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_device_time_is_the_union_of_device_intervals():
    """``timing.device_time``: overlapping kernels count once (a launch that
    starts while the one before ends), copies and sets count, and the
    program's spans on the device timeline (``gpu_user_annotation``) and
    host events count zero."""
    events = [
        _event("kernel", "k_a", 0.0, 10.0),
        _event("kernel", "k_b", 5.0, 10.0),  # overlaps k_a by 5 µs
        _event("kernel", "k_a", 40.0, 4.0),
        _event("gpu_memcpy", "Memcpy DtoH", 20.0, 2.0),
        _event("gpu_memset", "Memset", 21.0, 2.0),  # overlaps the copy by 1 µs
        _event("gpu_user_annotation", "pf.sir.b1", 0.0, 100.0),
        _event("user_annotation", "pf.sir.run", 0.0, 100.0),
        _event("cpu_op", "aten::add", 0.0, 50.0),
        {"ph": "f", "cat": "kernel", "name": "k_a", "ts": 0.0},  # a flow event
    ]
    busy_ms, ops = timing.device_time(events)
    assert busy_ms == pytest.approx((15.0 + 3.0 + 4.0) * 1e-3)
    assert ops == [(pytest.approx(0.014), 2, "k_a"), (pytest.approx(0.010), 1, "k_b"),
                   (pytest.approx(0.002), 1, "Memset"), (pytest.approx(0.002), 1, "Memcpy DtoH")]
    assert timing.device_time(events, top=1)[1] == ops[:1]
    assert timing.device_time([_event("gpu_user_annotation", "pf.ot.run", 0.0, 9.0)]) == (0.0, [])


def test_profile_device_on_the_cpu():
    """The whole reader on a CPU run with spans: its wall time, and no
    device time where the profiler saw none (the spans are not work)."""
    run, _ = _sir(0.5)
    prof = timing.profile_device(run)
    assert prof.wall_ms > 0 and prof.busy_ms == 0.0 and prof.top == []
