"""The port's LEDH on the ``skewt_d400`` configuration (the skew-t sensor
network of the source notebook's d = 400 rows) against its plain reference,
``h100_bench/configs/skewt_d400.py``, on the CPU at toy trials and
particles; ``LEDHFlowPF.factored_matrices``; the ``pf.ledh.factors`` span.

- The program through the cell's entry (``h100_bench/entries/ledh_trials.py``:
  one ``run_trials`` call a step, as the benchmark drives it) on an 8×8
  lattice (d = 64), a square other than 144 and 400, so the program and the
  reference are shown to hold for any square d. Each step is compared with
  the reference's step from the program's previous state on the same
  counts, noise and uniforms, against the cell's own limits. On the CPU the
  gaps read 4e-7–1.3e-4 (``particle_gap_p50``), 3e-5–7.4e-4 (``_p90``), 0
  (``track_gap``: the tracker is the same code on the same inputs) and
  1.4e-6–6.5e-5 (``mean_gap_p50``) over five seeds: the operator form and
  the reference's formed Aⁱ round apart, times cond(K) (α₁ = 1e-3 makes Σ,
  and P, ill-conditioned). A planted fault fails the same limits.
- The counter: 2·B·n a λ-step with each particle's own Jacobian (the
  skew-t path), 2·B where one Jacobian serves every particle, summed over
  every λ-step and step of ``run_trials``.
- The span: one ``pf.ledh.factors`` a λ-step under a profiler, and the
  outputs bit for bit the same with the profiler recording and without.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100_bench import harness
from particle_filters_tpu_torch.core import linalg
from particle_filters_tpu_torch.core.structs import stack_states
from particle_filters_tpu_torch.models import (
    ExtendedKalmanFilter,
    GaussianTracker,
    LEDHConfig,
    LEDHFlowPF,
)

torch.set_num_threads(1)

CFG = harness.load_json("configs", "skewt_d400")
CELL = harness.load_json("workloads", "skewt_ledh200_d400")
ENTRY = harness.load_module("entries", CELL["entry"])
SEEDS = (3, 2**33 + 17, 123456789)


def _entry(seed, d, trials=2, steps=3, particles=16):
    cfg = dict(CFG, d=d, trials=trials, steps=steps)
    traffic = dict(CELL, particles=particles, check_units=1, reference_chunk=trials)
    return ENTRY.Entry(traffic, cfg, seed, torch.device("cpu"))


def test_the_reference_is_skewt_d144s():
    ref = harness.load_module("configs", "skewt_d400")
    d144 = harness.load_module("configs", "skewt_d144")
    for name in ("simulate", "PlainFilter", "control", "compare"):
        assert getattr(ref, name) is getattr(d144, name)
    assert CFG["d"] == 400 and CFG["trials"] == 20 and CFG["reduced"] == ["trials"]


@pytest.mark.parametrize("seed", SEEDS)
def test_program_matches_the_plain_reference_at_d64(seed):
    entry = _entry(seed, d=64)
    entry.reset_counts()
    entry.unit(0)
    counts = entry.counts(1)
    entry.free()
    checks, failed, _ = entry.check()
    assert failed == 0, checks
    assert all(v <= lim for v, lim in checks.values()), checks
    B, n, T, lam = 2, 16, 3, CFG["lambda_steps"]
    assert counts["factored_matrices"] == 2 * B * n * lam * T


@pytest.mark.parametrize("fault", ["an answer altered", "state unchanged after step 0"])
def test_a_planted_fault_fails_the_limits_at_d64(monkeypatch, fault):
    ENTRY.plant(monkeypatch, fault)
    entry = _entry(SEEDS[0], d=64)
    entry.unit(0)
    entry.free()
    checks, failed, _ = entry.check()
    assert failed == 1 and any(v > lim for v, lim in checks.values()), checks


def _small_filter(jacobian, d=4, n=8, lambda_steps=2):
    """A LEDH filter on h(x) = x + 0.2 sin x (each particle's own Jacobian)
    or h(x) = x (one Jacobian, the identity, for every particle, as SNLG's)."""
    eye = torch.eye(d)
    sigma = (0.5 * np.eye(d) + 0.1).astype(np.float32)
    lq = torch.from_numpy(np.linalg.cholesky(sigma))
    R = (0.49 * np.eye(d)).astype(np.float32)
    lr = 0.7 * eye
    if jacobian == "own":
        def h(x):
            return x + 0.2 * torch.sin(x)

        def jh(x):
            return eye + 0.2 * torch.diag(torch.cos(x))
    else:
        def h(x):
            return x

        def jh(x):
            return eye
    track = GaussianTracker(ExtendedKalmanFilter(lambda x, u: 0.9 * x, h, sigma, R, device="cpu"))
    return LEDHFlowPF(track, lambda x, u, v: 0.9 * x + v, h, jh,
                      lambda xn, xo: linalg.mvn_logpdf_chol(xn, 0.9 * xo, lq),
                      lambda z, x: linalg.mvn_logpdf_chol(z, h(x), lr), R,
                      LEDHConfig(n_particles=n, n_lambda_steps=lambda_steps,
                                 resample_ess_ratio=0.5), device="cpu"), torch.from_numpy(sigma)


@pytest.mark.parametrize("jacobian", ["own", "shared"])
def test_factored_matrices_counts_every_trials_factors(monkeypatch, jacobian):
    d, n, lam, B, T = 4, 8, 2, 3, 5
    filt, cov0 = _small_filter(jacobian, d, n, lam)
    gen = torch.Generator().manual_seed(5)
    states = stack_states([filt.init_from_gaussian(gen, torch.zeros(d), cov0) for _ in range(B)])
    tracks = stack_states([filt.tracker.init(torch.zeros(d), cov0)] * B)
    zs = torch.randn((B, T, d), generator=torch.Generator().manual_seed(11))
    monkeypatch.setattr(LEDHFlowPF, "factored_matrices", 0)
    filt.run_trials(gen, states, tracks, zs,
                    process_noise_sampler=lambda g, m, nx: 0.3 * torch.randn((m, nx), generator=g))
    per_trial = n if jacobian == "own" else 1
    assert LEDHFlowPF.factored_matrices == 2 * B * per_trial * lam * T


def _tensors(steps):
    return [s[k] for s in steps for k in sorted(s)]


def test_outputs_bit_identical_with_the_factors_span_recording():
    """At d = 16 (a 4×4 lattice), the outputs of every step with a profiler
    recording (one ``pf.ledh.factors`` range a λ-step) equal those without
    one bit for bit."""
    T = 3
    entry = _entry(SEEDS[1], d=16, steps=T, particles=20)
    off = entry._run(0, T)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = entry._run(0, T)
    spans = [e.name for e in prof.events() if e.name == "pf.ledh.factors"]
    assert len(spans) == CFG["lambda_steps"] * T
    a, b = _tensors(off), _tensors(on)
    assert len(a) == len(b) == 6 * T
    assert all(torch.equal(x, y) for x, y in zip(a, b))
