"""Port parity: ``examples/14_sv_variance_stabilized.py`` and its twin
``particle_filters_tpu_torch/examples/ex14_sv_variance_stabilized.py``.

- ``particle_filters_tpu_torch/benchmarks/data/sv_vs_t2000.npz`` holds the
  JAX package's SV trajectory (α 0.91, σ 1, β 0.5, seed 123, T = 2000) and
  its reference values on the CPU: the EKF's and UKF's RMSE and coverage in
  both forms, and per key (8 keys) the PF's RMSE in both forms (N = 1000);
  over the first ``T_CUT`` steps, the Kalman rows' RMSEs and 32 more keys'
  PF RMSEs from runs of ``T_CUT`` steps.
  Every value is regenerated here and held equal: the trajectory, the
  Kalman values, and the PF RMSEs of all 8 and all 32 keys.
- The EKF and UKF in both forms over the first ``T_KF`` steps: the port's
  means within 1e-4 of the JAX package's (f32 filters of order one), RMSE
  within 1e-5 relative, coverage within one step.
- The transform log(y² + 1e-300): equal to the JAX package's f32 values,
  −inf included (y = 0, and a y² under f32's smallest normal, which XLA
  flushes to 0).
- The PF in both forms at the example's size, one seed each: the port's
  RMSE against the JAX package's 8 keys by the module's gate (p ≥ 1e-3);
  and the cut run (the first ``T_CUT`` steps, 2 seeds) against its
  references.

Run this file as a script to write the data and print the JAX package's
reference values again (about a minute):

    JAX_PLATFORMS=cpu python tests/test_torch_ex14.py
"""

import os
import sys

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy.stats import chi2  # noqa: E402

from particle_filters_tpu.models import (  # noqa: E402
    ExtendedKalmanFilter,
    ParticleFilter,
    UnscentedKalmanFilter,
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_tpu.simulators import simulate_sv_1d  # noqa: E402
from particle_filters_tpu_torch.examples import ex14_sv_variance_stabilized as ex  # noqa: E402

torch.set_num_threads(1)
KEYS = 8
CUT_KEYS = 32  # the cut references' keys (100 ...), runs of T_CUT steps
T_KF = 500  # the Kalman rows' parity prefix (the port's EKF takes ~9 ms a step here)
CPU = torch.device("cpu")


def jax_data():
    sv = simulate_sv_1d(ex.T, ex.ALPHA, ex.SIGMA, ex.BETA, seed=123)
    return np.asarray(sv.X, np.float32), np.asarray(sv.Y, np.float32)


def jax_vs(Y):
    return np.asarray(jnp.log(jnp.asarray(Y) ** 2 + 1e-300))


def _coverage(m, P, X):
    lo, hi = chi2.ppf(0.025, df=1), chi2.ppf(0.975, df=1)
    nees = (np.asarray(m) - X) ** 2 / np.asarray(P)
    return float(np.mean((nees >= lo) & (nees <= hi)))


def _rmse(m, X):
    return float(np.sqrt(np.mean((np.asarray(m) - X) ** 2)))


def jax_kalman(X, Y):
    """The example's four Kalman rows: ``{key: (means, variances)}``."""
    g = lambda x, u: ex.ALPHA * x  # noqa: E731
    h_std = lambda x: ex.BETA * jnp.exp(0.5 * x)  # noqa: E731
    h_vs = lambda x: x + jnp.log(ex.BETA**2) + ex.MU_EPS  # noqa: E731
    Q, P0 = jnp.array([[ex.SIGMA**2]]), jnp.array([[ex.P0]])
    out = {}
    for form, h, R, z in (("std", h_std, [[ex.BETA**2]], np.abs(Y)),
                          ("vs", h_vs, [[ex.VAR_EPS]], jax_vs(Y))):
        R = jnp.array(R)
        for name, filt, make in (
            ("ekf", ExtendedKalmanFilter(g, h, Q, R), make_ekf_state),
            ("ukf", UnscentedKalmanFilter(g, h, Q, R, alpha=1.0), make_ukf_state),
        ):
            _, m, P = jax.jit(lambda zz, f=filt, mk=make: f.run(mk(jnp.zeros(1), P0), zz))(
                jnp.asarray(z)[:, None])
            out[f"{name}_{form}"] = (np.asarray(m)[:, 0], np.asarray(P)[:, 0, 0])
    return out


def jax_pf_rmses(X, Y, keys=range(KEYS), t=None):
    """The example's PF in both forms per key over the first ``t`` steps
    (all when None): ``{form: [rmse, ...]}``."""
    def ll_std(x, z):
        var = ex.BETA**2 * jnp.exp(x[0])
        return -0.5 * (z[0] ** 2 / var + jnp.log(var))

    def ll_logsq(x, z):
        e = z[0] - x[0] - jnp.log(ex.BETA**2)
        return 0.5 * e - 0.5 * jnp.exp(e)

    out = {}
    for form, ll, obs in (("std", ll_std, Y), ("vs", ll_logsq, jax_vs(Y))):
        pf = ParticleFilter(lambda x, u: ex.ALPHA * x, None, jnp.array([[ex.SIGMA**2]]), None,
                            Np=ex.NP, obs_loglik=ll, resample_thresh=0.5)
        run = jax.jit(lambda k, s, o, f=pf: f.run(k, s, o, track_degeneracy=True)[1]["mean"])
        rows = []
        for k in keys:
            key = jax.random.PRNGKey(k)
            st = pf.initialize(jax.random.fold_in(key, 0), jnp.zeros(1),
                               jnp.array([[ex.P0]]))
            m = np.asarray(run(jax.random.fold_in(key, 1), st, jnp.asarray(obs[:t])[:, None]))
            rows.append(_rmse(m[:, 0], X[:t]))
        out[form] = rows
    return out


def write_data(path=ex.DATA):
    X, Y = jax_data()
    arrays = {"X": X, "Y": Y}
    for key, (m, P) in jax_kalman(X, Y).items():
        arrays[f"jax_{key}_rmse"] = np.float64(_rmse(m, X))
        arrays[f"jax_{key}_rmse_cut"] = np.float64(_rmse(m[:ex.T_CUT], X[:ex.T_CUT]))
        arrays[f"jax_{key}_coverage"] = np.float64(_coverage(m, P, X))
    for form, rows in jax_pf_rmses(X, Y).items():
        arrays[f"jax_pf_{form}_rmse"] = np.asarray(rows)
    for form, rows in jax_pf_rmses(X, Y, keys=range(100, 100 + CUT_KEYS), t=ex.T_CUT).items():
        arrays[f"jax_pf_{form}_rmse_cut"] = np.asarray(rows)
    np.savez(path, **arrays)
    for k, v in arrays.items():
        if k not in ("X", "Y"):
            print(k, v.tolist() if v.ndim else float(v))


# --- tests -------------------------------------------------------------------
@pytest.fixture(scope="module")
def data():
    return ex.load_data(CPU)


def test_committed_data_is_the_jax_packages(data):
    X, Y = jax_data()
    np.testing.assert_array_equal(data["X"].numpy(), X)
    np.testing.assert_array_equal(data["Y"].numpy(), Y)
    for key, (m, P) in jax_kalman(X, Y).items():
        assert float(data[f"jax_{key}_rmse"]) == _rmse(m, X)
        assert float(data[f"jax_{key}_rmse_cut"]) == _rmse(m[:ex.T_CUT], X[:ex.T_CUT])
        assert float(data[f"jax_{key}_coverage"]) == _coverage(m, P, X)


@pytest.mark.parametrize("suffix, keys, t", [("", range(KEYS), None),
                                             ("_cut", range(100, 100 + CUT_KEYS), ex.T_CUT)],
                         ids=["whole_run", "cut"])
def test_committed_pf_references_are_the_jax_packages(data, suffix, keys, t):
    X, Y = jax_data()
    for form, rows in jax_pf_rmses(X, Y, keys=keys, t=t).items():
        np.testing.assert_array_equal(data[f"jax_pf_{form}_rmse{suffix}"].numpy(), rows)


def test_kalman_rows_match_jax(data):
    X, Y = data["X"].numpy()[:T_KF], data["Y"].numpy()[:T_KF]
    want = jax_kalman(X, Y)
    res = ex.run_kalman(CPU, data, t=T_KF)
    assert set(res) == set(want)
    for key, (m, P) in want.items():
        r = res[key]
        np.testing.assert_allclose(r["means"].numpy(), m, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["vars"].numpy(), P, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["rmse"], _rmse(m, X), rtol=1e-5)
        assert abs(r["coverage"] - _coverage(m, P, X)) <= 1.0 / T_KF


def test_vs_transform_matches_jax_with_its_infinities():
    y = np.array([0.0, -0.0, 1e-30, -3e-23, 1e-19, 0.37, -2.5, 40.0], np.float32)
    want = jax_vs(y)
    got = ex.vs_transform(torch.tensor(y)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[:5]).all() and np.isfinite(got[5:]).all()


def test_pf_rows_against_the_jax_keys(data):
    res = {"kalman": {}, "pf": {form: [ex.run_pf(CPU, data, form, 0)] for form in ex.FORMS},
           "t": ex.T}
    for form, rows in res["pf"].items():
        for r in rows:
            assert np.isfinite(r["rmse"]) and r["rmse"] < 1.5
            assert 0.2 <= r["resample_frac"] <= 0.5 and r["resample_steps"] > 0
            assert 0.0 < r["ess_min"] <= r["ess_mean"] <= ex.NP
    gates = ex.gates(res, data)
    assert set(gates) == {"pf_std", "pf_vs"}
    assert all(held for _, _, held in gates.values()), gates


def test_cut_run_meets_the_cut_references(data):
    res = ex.run_all(CPU, data, seeds=2, t=ex.T_CUT)
    assert res["kalman"]["ekf_vs"]["means"].shape == (ex.T_CUT,)
    gates = ex.gates(res, data)
    assert set(gates) == {"ekf_std", "ukf_std", "ekf_vs", "ukf_vs", "pf_std", "pf_vs"}
    assert all(held for _, _, held in gates.values()), gates
    welch = ex.pf_welch(res, data)
    assert set(welch) == set(ex.FORMS)
    for form, (mean, sd, n, z, p) in welch.items():
        assert n == 2 and mean == np.mean([r["rmse"] for r in res["pf"][form]])
        assert sd > 0 and np.isfinite(z) and 0.0 <= p <= 1.0
    with pytest.raises(ValueError, match="steps the JAX references cover"):
        ex.run_all(CPU, data, t=100)


if __name__ == "__main__":
    write_data()
