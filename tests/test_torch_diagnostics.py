"""Port parity: ``utils/diagnostics`` and ``ParticleFilter.run(
track_degeneracy=True)`` against the JAX package.

The metrics take the same numpy inputs in both packages and agree to f32
rounding (rtol 1e-5; the Gini's sorted weighted sum 2e-5), the counts and
OMAT exactly (OMAT is f64 numpy on the host in both). The degeneracy panel:
entropy, Gini and max weight of one pre-resample weight vector equal the
JAX package's; the surviving-ancestor fraction is rebuilt from the draws of
the resample that ran, so it equals the fraction of distinct particles that
the resample left, and for the same u the systematic run ends behind it
equal the JAX package's counts (dyadic weights, so both cdfs are exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu.models import ParticleFilter as JPF
from particle_filters_tpu.resampling import hard as jhard
from particle_filters_tpu.utils import diagnostics as jd
from particle_filters_tpu_torch.models import ParticleFilter as TPF
from particle_filters_tpu_torch.resampling import hard as thard
from particle_filters_tpu_torch.utils import diagnostics as td

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def logw():
    """(T, N) log-weights: lognormal rows, a near point mass, a row with
    -inf entries and a uniform row."""
    rng = np.random.default_rng(0)
    lw = (rng.standard_normal((6, 500)) * np.array([0.3, 1.0, 3.0, 8.0, 1.0, 0.0])[:, None])
    lw[4, :100] = -np.inf
    return lw.astype(np.float32)


def test_errors_nees_and_coverage_match_jax():
    rng = np.random.default_rng(1)
    est, tru = rng.standard_normal((2, 40, 3)).astype(np.float32)
    for name in ("rmse", "mae", "mse"):
        np.testing.assert_allclose(float(getattr(td, name)(_t(est), _t(tru))),
                                   float(getattr(jd, name)(jnp.asarray(est), jnp.asarray(tru))),
                                   **TOL)
    A = rng.standard_normal((40, 3, 3)).astype(np.float32)
    covs = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    np.testing.assert_allclose(td.nees(_t(est), _t(covs), _t(tru)).numpy(),
                               np.asarray(jd.nees(jnp.asarray(est), jnp.asarray(covs),
                                                  jnp.asarray(tru))), rtol=1e-4, atol=1e-5)
    assert float(td.coverage_95(_t(est), _t(covs), _t(tru))) == float(
        jd.coverage_95(jnp.asarray(est), jnp.asarray(covs), jnp.asarray(tru)))


@pytest.mark.parametrize("normalized", [True, False])
def test_weight_metrics_match_jax(logw, normalized):
    np.testing.assert_allclose(td.weight_entropy(_t(logw), normalized).numpy(),
                               np.asarray(jd.weight_entropy(jnp.asarray(logw), normalized)),
                               **TOL)
    np.testing.assert_allclose(td.weight_gini(_t(logw)).numpy(),
                               np.asarray(jd.weight_gini(jnp.asarray(logw))), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(td.max_weight(_t(logw)).numpy(),
                               np.asarray(jd.max_weight(jnp.asarray(logw))), **TOL)
    rep_t, rep_j = td.degeneracy_report(_t(logw)), jd.degeneracy_report(jnp.asarray(logw))
    assert set(rep_t) == set(rep_j)
    for k in rep_j:
        np.testing.assert_allclose(rep_t[k].numpy(), np.asarray(rep_j[k]), rtol=2e-5, atol=2e-6,
                                   err_msg=k)


def test_weight_metric_edges():
    one = np.zeros((3, 1), np.float32)
    np.testing.assert_array_equal(td.weight_entropy(_t(one)).numpy(), np.ones(3))
    mass = np.full(16, -np.inf, np.float32)
    mass[5] = 0.0
    assert float(td.weight_entropy(_t(mass))) == 0.0 == float(jd.weight_entropy(jnp.asarray(mass)))
    assert float(td.max_weight(_t(mass))) == 1.0
    np.testing.assert_allclose(float(td.weight_gini(_t(mass))), 15 / 16, rtol=1e-6)
    np.testing.assert_allclose(float(td.weight_gini(_t(np.zeros(16, np.float32)))), 0.0,
                               atol=1e-6)


def test_unique_fraction_matches_jax():
    rng = np.random.default_rng(2)
    for a in (rng.integers(0, 64, 64), np.zeros(64, int), np.arange(64),
              np.array([-3, 0, 5, 64, 70, 5])):  # out of range: dropped
        a = a.astype(np.int32)
        assert float(td.unique_fraction(_t(a))) == float(jd.unique_fraction(jnp.asarray(a)))


def test_omat_matches_jax():
    rng = np.random.default_rng(3)
    est, tru = rng.random((2, 4, 2)) * 40
    for p in (1, 2):
        assert td.omat(est, tru, p) == jd.omat(est, tru, p)
    assert td.omat(_t(tru[[2, 0, 3, 1]]), _t(tru)) == 0.0  # any assignment of the truth


def _dyadic_logw(rng, n):
    c = rng.integers(1, 8, n).astype(np.float64)
    c[-1] += (1 << 12) - c.sum()
    return np.log(c / (1 << 12)).astype(np.float32)


def test_survivors_given_the_same_uniform_match_jax():
    """The port's systematic run ends for the JAX key's u equal the JAX
    package's counts; their nonzero fraction is the panel's unique_frac."""
    rng = np.random.default_rng(4)
    for k in range(5):
        lw = _dyadic_logw(rng, 512)
        key = jax.random.PRNGKey(k)
        u = torch.tensor(float(jax.random.uniform(key, (), jnp.float32)))
        t = thard._child_run_ends_u(torch.exp(_t(lw)), 512, u)
        counts = torch.diff(t, prepend=t.new_zeros(1))
        want = np.asarray(jhard.systematic_counts(key, logw=jnp.asarray(lw)))
        np.testing.assert_array_equal(counts.numpy(), want)
        assert float(torch.mean((counts > 0).float())) == float(np.mean(want > 0))


def _pfs(n, thresh=0.8):
    obs = lambda lib: (lambda x, z: -0.5 * (z[0] ** 2 / lib.exp(x[0]) + x[0]))  # noqa: E731
    jpf = JPF(lambda x, u: 0.9 * x, None, Q=np.array([[0.04]], np.float32), R=None, Np=n,
              obs_loglik=obs(jnp), resample_thresh=thresh)
    tpf = TPF(lambda x, u: 0.9 * x, None, Q=[[0.04]], R=None, Np=n, obs_loglik=obs(torch),
              resample_thresh=thresh, device="cpu")
    return jpf, tpf


def test_panel_of_one_step_matches_jax_and_the_resample_that_ran():
    """One update from a shared cloud: entropy, Gini and max weight equal
    the JAX package's for the same pre-resample weights, and unique_frac is
    the fraction of distinct particles the resample left."""
    n = 400
    jpf, tpf = _pfs(n)
    rng = np.random.default_rng(5)
    p = rng.standard_normal((n, 1)).astype(np.float32)
    z = np.array([1.7], np.float32)
    lw_pre = np.asarray(jax.vmap(lambda x: jpf._obs_loglik(x, jnp.asarray(z)))(jnp.asarray(p)))
    lw_pre = lw_pre - np.log(np.sum(np.exp(lw_pre.astype(np.float64))))
    st = tpf.initialize(torch.Generator().manual_seed(0), [0.0], [[1.0]])
    new, diag, _ = tpf._update(torch.Generator().manual_seed(1), st, z, _t(p),
                               track_degeneracy=True)
    assert diag["resampled"]
    for k, fn in (("entropy", jd.weight_entropy), ("gini", jd.weight_gini),
                  ("max_weight", jd.max_weight)):
        np.testing.assert_allclose(float(diag[k]), float(fn(jnp.asarray(lw_pre))), rtol=2e-5)
    distinct = torch.unique(new.particles).numel() / n
    assert float(diag["unique_frac"]) == pytest.approx(distinct, abs=1e-7)


def test_tracked_history_schema_and_run_unchanged():
    """The history gains the JAX package's panel keys, (T,) each, unique_frac
    1.0 on steps that did not resample; the rest of the run is the same as
    without the panel (it draws nothing from the generator)."""
    n, T = 300, 12
    jpf, tpf = _pfs(n)
    zs = (0.3 * np.random.default_rng(6).standard_normal((T, 1))).astype(np.float32)
    jst = jpf.initialize(jax.random.PRNGKey(0), jnp.zeros(1), jnp.array([[1.0]]))
    _, jh = jpf.run(jax.random.PRNGKey(1), jst, jnp.asarray(zs), track_degeneracy=True)
    st = tpf.initialize(torch.Generator().manual_seed(0), [0.0], [[1.0]])
    _, th = tpf.run(torch.Generator().manual_seed(1), st, zs, track_degeneracy=True)
    _, plain = tpf.run(torch.Generator().manual_seed(1), st, zs)
    assert set(th) == set(jh)
    for k in ("entropy", "gini", "max_weight", "unique_frac"):
        assert th[k].shape == (T,) and bool(torch.isfinite(th[k]).all())
    assert bool((th["unique_frac"][~th["resampled"]] == 1.0).all())
    assert bool((th["unique_frac"][th["resampled"]] < 1.0).all()) and bool(th["resampled"].any())
    for k, v in plain.items():
        assert torch.equal(th[k], v), k
    bad = TPF(lambda x, u: x, None, Q=[[0.04]], R=None, Np=64, resample_method="multinomial",
              obs_loglik=lambda x, z: -x[0] ** 2, resample_thresh=1.1, device="cpu")
    _, mh = bad.run(torch.Generator().manual_seed(2),
                    bad.initialize(torch.Generator().manual_seed(3), [0.0], [[1.0]]),
                    zs[:3], track_degeneracy=True)
    assert bool(mh["resampled"].all()) and bool((mh["unique_frac"] < 1.0).all())
