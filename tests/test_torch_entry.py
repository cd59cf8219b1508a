"""Port parity: the entry points of ``__graft_entry__.py`` and their twins in
``particle_filters_tpu_torch/entry.py``.

- ``entry(device="cpu")``, the fused step at N = 2²⁰ on B1's plain version,
  against the JAX package's ``entry_generic()`` step (what its ``entry()``
  runs off the TPU), and ``entry_generic(device="cpu")`` against the same:
  the posterior mean and the log-evidence increment within 5 combined
  Monte Carlo standard errors (the streams differ, Philox against
  threefry, so only statistics compare; the JAX generic prior's variance
  is 0.41, the fused one's σ²/(1 − α²) = 0.41026, a shift far below one
  standard error).
- No fallback: without a card ``entry()``, ``entry_generic()`` and
  ``dryrun_multichip`` raise, and ``entry()`` never calls the generic step;
  the dry run raises when fewer cards are visible than ranks asked for.
- ``dryrun_multichip(4, device="cpu")`` over gloo ranks, every phase's
  assertion held on every rank; the module's main on the CPU (the step,
  then the dry run over 8 ranks).
"""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from particle_filters_tpu_torch import entry as te

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import __graft_entry__ as graft  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_SE = 5.0


def _sv_loglik(x, z=te.Z0):
    return -0.5 * (z**2 / np.exp(x) + x)


def _from_cloud(x, logw):
    """(mean, its standard error, log-evidence increment, its standard
    error) of a step from uniform weights that did not resample: the
    weights are the likelihoods of the predicted particles ``x``."""
    x, logw = np.asarray(x, np.float64).reshape(-1), np.asarray(logw, np.float64)
    w = np.exp(logw - logw.max())
    w /= w.sum()
    ess = 1.0 / np.sum(w**2)
    mean = float(np.sum(w * x))
    ll = _sv_loglik(x)
    log_z = float(np.log(np.mean(np.exp(ll - ll.max()))) + ll.max())
    return mean, np.sqrt(np.sum(w * (x - mean) ** 2) / ess), log_z, np.sqrt(1 / ess - 1 / x.size)


@pytest.fixture(scope="module")
def jax_step():
    fn, args = graft.entry_generic()
    st = jax.jit(fn)(*args)
    return _from_cloud(np.asarray(st.particles), np.asarray(st.log_weights))


def _close(got, want):
    (m1, s1, z1, zs1), (m2, s2, z2, zs2) = got, want
    assert abs(m1 - m2) <= N_SE * np.hypot(s1, s2), (got, want)
    assert abs(z1 - z2) <= N_SE * np.hypot(zs1, zs2), (got, want)


def test_entry_step_against_jax(jax_step):
    step_fn, args = te.entry(CPU)
    assert args[1][0].shape == (te.N_ENTRY,)
    _, info = step_fn(*args)
    assert not bool(info["resampled"]) and 0 < float(info["ess"]) <= te.N_ENTRY
    ess, var = float(info["ess"]), float(info["cov"][0, 0])
    got = (float(info["mean"][0]), np.sqrt(var / ess), float(info["log_evidence"]),
           np.sqrt(1 / ess - 1 / te.N_ENTRY))
    _close(got, jax_step)


def test_entry_generic_against_jax(jax_step):
    step_fn, args = te.entry_generic(CPU)
    st = step_fn(*args)
    assert st.particles.shape == (te.N_GENERIC, 1)
    got = _from_cloud(st.particles.numpy(), st.log_weights.numpy())
    _close(got, jax_step)


def test_no_card_raises_without_fallback(monkeypatch):
    generic = te.entry_generic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(te, "entry_generic", lambda *a, **k: pytest.fail("entry() fell back"))
    for fn in (te.entry, generic, lambda: te.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_dry_run_needs_a_card_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        te.dryrun_multichip(2)


def test_dryrun_multichip_cpu(capsys):
    r = te.dryrun_multichip(4, CPU)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): mesh={'batch': 2, 'particles': 2}" in out
    assert np.isfinite(r["loss"]) and float(r["alpha"]) != te.DRY_ALPHA0
    for phase in ("pf", "fused", "edh"):
        assert r[phase]["mean"].shape == (te.DRY_T, 1 if phase != "edh" else 2)
    assert r["pf"]["exchange_ok"].all() and r["fused"]["resampled"].all()
    assert r["launches"] == {"B1": 0, "B2": 0}  # B1's and B2's plain versions ran


def test_dry_run_check_catches_a_failed_phase():
    r = te.dryrun_multichip(1, CPU)
    bad = {**r, "fused": {**r["fused"], "resampled": np.zeros_like(r["fused"]["resampled"])}}
    with pytest.raises(RuntimeError, match="cross-rank resample"):
        te.check_dry_run(bad)


def test_main_on_the_cpu(capsys):
    assert te.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "entry() ok" in out and "dryrun_multichip(8): mesh={'batch': 2, 'particles': 4}" in out
