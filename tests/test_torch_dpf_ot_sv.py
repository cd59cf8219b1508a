"""The port's Sinkhorn-OT DPF (``models/dpf.py`` ``DPF_OT``) on the ``sv_dpf_ot``
configuration (SV, α 0.95, σ 0.2, β 0.6; ε 0.1, 50 dual iterations, damping
0.5) against its plain reference, ``h100_bench/configs/sv_dpf_ot.py``, at
N = 64, T = 5 on the CPU, and its control (the reference in bfloat16)
against the same tolerances; the log-evidence output, the resampler's
counter of Sinkhorn half-updates and the ``pf.ot.*`` spans.

The program's transition draws its noise from the generator it is handed; the
reference gets the same draws from a generator seeded alike, and the
program's own initial cloud.
"""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100_bench import harness
from particle_filters_tpu_torch.models.dpf import DPF_OT, aggregate_diagnostics, _stack_diags
from particle_filters_tpu_torch.resampling.ot import (
    pairwise_squared_distances,
    sinkhorn_ot_resample,
)
from particle_filters_tpu_torch.utils import timing

torch.set_num_threads(1)

N, T = 64, 5
REF = harness.load_module("configs", "sv_dpf_ot")
CFG = dict(harness.load_json("configs", "sv_dpf_ot"), steps=T)
A, S, B = CFG["alpha"], CFG["sigma"], CFG["beta"]
STD0 = S / math.sqrt(1 - A * A)
ITERS = CFG["sinkhorn_iters"]
SEEDS = (3, 2**33 + 17, 123456789)
# The tolerances: particles (the largest gap over particles and steps) and
# means in the reference cloud's std, the log-evidence in nats. The program
# forms the cost as x² − 2xy + y², the reference as (x − y)²: a few float32
# ulps of x² (~1e-7 of ~4) apart, which the 1/ε = 10 of the plan's exponents
# makes ~1e-6. Over these steps the largest particle gap reads 2e-6–7e-6 (the
# median ~1e-7), the means' gap and the log-evidence's ≤ 5e-7. The control,
# the reference computed in bfloat16 (8 bits) throughout, reads 0.10–0.27,
# 0.013–0.025 and 0.017–0.040: it fails all three.
PARTICLE_TOL, MEAN_TOL, LOGZ_TOL = 1e-4, 1e-5, 1e-5


def _filter():
    def transition(generator, x, t):
        return A * x + S * torch.randn(x.shape, generator=generator)

    def loglik(x, y, t):
        x = x[:, 0]
        return -0.5 * (y * y / (B * B) * torch.exp(-x) + x + 2 * math.log(B))

    return DPF_OT(N, 1, transition, loglik, epsilon=CFG["epsilon"], n_sinkhorn_iters=ITERS,
                  damping=CFG["damping"], device="cpu")


def _inputs(seed):
    """One sequence, the initial normals and the (T, N) transition noise."""
    dev = torch.device("cpu")
    _, ys = REF.simulate(CFG, 1, harness.generator(dev, seed, "data"), dev)
    eps0 = torch.randn((N, 1), generator=harness.generator(dev, seed, "init"))
    gen = harness.generator(dev, seed, "noise")
    vs = torch.stack([torch.randn((N, 1), generator=gen)[:, 0] for _ in range(T)])
    return ys[0], eps0, vs


def _program(seed, filt=None, **kw):
    ys, eps0, _ = _inputs(seed)
    filt = filt or _filter()
    return filt.run_filter(harness.generator(torch.device("cpu"), seed, "noise"), ys[:, None],
                           [0.0], [[STD0]], init_eps=eps0, **kw)


def _gaps(prog, ref):
    """Largest particle gap and mean gap (in the reference cloud's std, over
    the steps) and the log-evidences' gap."""
    px, rx = prog[0][1:, :, 0].double(), ref["particles"][1:, :, 0].double()
    std = torch.std(rx, dim=1)
    return (float(torch.max(torch.amax(torch.abs(px - rx), dim=1) / std)),
            float(torch.max(torch.abs(px.mean(1) - rx.mean(1)) / std)),
            abs(float(prog[2]) - float(ref["log_evidence"])))


@pytest.mark.parametrize("seed", SEEDS)
def test_matches_the_plain_reference(seed):
    prog = _program(seed, return_log_evidence=True)
    ys, _, vs = _inputs(seed)
    ref = REF.run(CFG, prog[0][0, :, 0], ys, vs)
    particles, mean, log_z = _gaps(prog, ref)
    assert particles < PARTICLE_TOL and mean < MEAN_TOL and log_z < LOGZ_TOL, (
        particles, mean, log_z)
    assert prog[2].shape == () and math.isfinite(float(prog[2]))
    assert torch.equal(prog[1], torch.full((T + 1, N), 1.0 / N))


@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_cost_fails_the_tolerance(seed):
    prog = _program(seed, return_log_evidence=True)
    ys, _, vs = _inputs(seed)
    ref = REF.control(CFG, prog[0][0, :, 0], ys, vs)
    particles, mean, log_z = _gaps(prog, ref)
    assert particles > PARTICLE_TOL and mean > MEAN_TOL and log_z > LOGZ_TOL, (
        particles, mean, log_z)


def _before(seed, diagnostics):
    """``run_filter`` as it was before the log-evidence, the counter and the
    spans: the same arithmetic written out, the dual loop's closures too."""
    ys, eps0, _ = _inputs(seed)
    filt, gen = _filter(), harness.generator(torch.device("cpu"), seed, "noise")
    eps, damping, min_val = filt.epsilon, filt.damping, filt.min_val
    p, w = filt.init_particles(gen, [0.0], [[STD0]], eps0)
    ps, ws, diags = [p], [w], []
    for t in range(T):
        pred = filt.transition_fn(gen, p, t)
        loglik = filt.obs_loglik_fn(pred, ys[t:t + 1], t)
        loglik = loglik - torch.amax(loglik).detach()
        w = torch.clamp(w * torch.exp(loglik), min=min_val)
        w = w / torch.sum(w)
        wc = torch.clamp(w, min=min_val)
        log_a = torch.log(wc / (torch.sum(wc) + min_val))
        log_b = torch.full((N,), -math.log(N))
        C = pairwise_squared_distances(pred, pred)

        def tau_f(g):
            return -eps * torch.logsumexp(log_b[None, :] + (g[None, :] - C) / eps, dim=1)

        def tau_g(f):
            return -eps * torch.logsumexp(log_a[:, None] + (f[:, None] - C) / eps, dim=0)

        f = torch.zeros(N)
        g = torch.zeros_like(f)
        deltas = []
        for _ in range(ITERS):
            f_new = (1.0 - damping) * f + damping * tau_f(g)
            g_new = (1.0 - damping) * g + damping * tau_g(f_new)
            deltas.append(torch.maximum(torch.amax(torch.abs(f_new - f)),
                                        torch.amax(torch.abs(g_new - g))))
            f, g = f_new, g_new
        P = torch.exp(log_a[:, None] + log_b[None, :] + (f[:, None] + g[None, :] - C) / eps)
        p, w_new = (P.T @ pred) * N, torch.exp(log_b)
        diags.append({"ot_distance": torch.sum(P * C),
                      "transport_plan_sparsity": torch.mean((P > 1e-6).float()),
                      "final_delta": deltas[-1], "converged": (deltas[-1] < 1e-6).float(),
                      "f_std": torch.std(f, unbiased=False),
                      "g_std": torch.std(g, unbiased=False), "ess_before": 1.0 / torch.sum(w * w)})
        w = w_new
        ps.append(p)
        ws.append(w)
    out = (torch.stack(ps), torch.stack(ws))
    return out + (aggregate_diagnostics(_stack_diags(diags)),) if diagnostics else out


def _flat(out):
    return [v for x in out for v in ([x[k] for k in sorted(x)] if isinstance(x, dict) else [x])]


@pytest.mark.parametrize("diagnostics", [False, True])
def test_log_evidence_off_leaves_the_outputs_as_before(diagnostics):
    seed = SEEDS[0]
    off = _program(seed, return_diagnostics=diagnostics)
    on = _program(seed, return_diagnostics=diagnostics, return_log_evidence=True)
    before = _before(seed, diagnostics)
    assert len(off) == len(before) == len(on) - 1
    assert all(torch.equal(a, b) for a, b in zip(_flat(off), _flat(before)))
    assert all(torch.equal(a, b) for a, b in zip(_flat(off), _flat(on[:-1])))


def test_counter_counts_half_updates(monkeypatch):
    """``sinkhorn_ot_resample.half_updates`` counts the half-updates the
    dual loop ran: 2 × iterations a step of ``DPF_OT``, and what a direct
    call with fewer iterations ran."""
    monkeypatch.setattr(sinkhorn_ot_resample, "half_updates", 0)
    filt = _filter()
    _program(SEEDS[0], filt)
    assert sinkhorn_ot_resample.half_updates == 2 * ITERS * T
    _program(SEEDS[1], filt, return_log_evidence=True)
    assert sinkhorn_ot_resample.half_updates == 2 * 2 * ITERS * T
    sinkhorn_ot_resample.half_updates = 0
    x = torch.zeros((N, 1))
    filt.step(torch.Generator().manual_seed(0), x, torch.full((N,), 1.0 / N), torch.tensor(0.5))
    assert sinkhorn_ot_resample.half_updates == 2 * ITERS
    sinkhorn_ot_resample(x, torch.full((N,), 1.0 / N), n_iters=3)
    assert sinkhorn_ot_resample.half_updates == 2 * ITERS + 6


def test_spans_count_the_steps_and_nest():
    """``pf.ot.run`` holds T ``pf.ot.step``; each step holds one
    ``pf.ot.sinkhorn`` and, after it, one ``pf.ot.project``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _program(SEEDS[0], return_log_evidence=True)
    spans = sorted((e for e in prof.events() if e.name.startswith("pf.")),
                   key=lambda e: e.time_range.start)
    names = [e.name for e in spans]
    assert names == ["pf.ot.run"] + ["pf.ot.step", "pf.ot.sinkhorn", "pf.ot.project"] * T

    def inside(e, outer):
        return (outer.time_range.start <= e.time_range.start <= e.time_range.end
                <= outer.time_range.end)

    run, rest = spans[0], spans[1:]
    for k in range(T):
        step, sinkhorn, project = rest[3 * k:3 * k + 3]
        assert inside(step, run) and inside(sinkhorn, step) and inside(project, step)
        assert sinkhorn.time_range.end <= project.time_range.start


def test_spans_off_build_nothing_and_on_change_nothing(monkeypatch):
    on_out = None
    with profile(activities=[ProfilerActivity.CPU]):
        on_out = _program(SEEDS[1], return_log_evidence=True)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off_out = _program(SEEDS[1], return_log_evidence=True)
    assert all(torch.equal(a, b) for a, b in zip(off_out, on_out))
    assert timing.span("pf.ot.run") is timing.span("pf.ot.step")
