"""Port parity: the skew-t sensor network (simulator, filters, column)
against the JAX package, and the committed d = 144 data.

- Deterministic pieces (lattice, spatial covariance, its factor, γ given
  explicitly) equal the JAX package's exactly or to f32 rounding (rtol
  1e-6 on Σ, 5e-5 on L: two Cholesky orders of a factor whose nugget is
  1e-3).
- The simulators draw from other streams (Philox or the CPU's Mersenne
  against threefry), so their samples are held statistically: per-step
  means and variances of X and the count means over 2000 trials, within
  five standard errors of each other.
- The EKF, UKF, EDH and LEDH steps at d = 9 (as
  ``tests/integration/test_filters_skewt.py``) from one state and one
  process noise agree to rtol/atol 2e-4 over T = 5 (the flows' tolerance in
  ``test_torch_flows.py``), 1e-5 for the Kalman filters.
- ``particle_filters_tpu_torch/benchmarks/data/skewt_d144.npz`` equals what
  the JAX package writes for ``bench_skewt``'s config. Run this file as a
  script to write it again and print the JAX package's reference MSEs on it:

      JAX_PLATFORMS=cpu python tests/test_torch_skewt.py
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

from particle_filters_tpu.core.linalg import mvn_logpdf_chol  # noqa: E402
from particle_filters_tpu.models import (  # noqa: E402
    EDHConfig,
    EDHFlowPF,
    ExtendedKalmanFilter,
    GaussianTracker,
    LEDHConfig,
    LEDHFlowPF,
    UnscentedKalmanFilter,
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_tpu.simulators import sensor_network_skewt as jsk  # noqa: E402
from particle_filters_tpu_torch import interop  # noqa: E402
from particle_filters_tpu_torch.benchmarks import skewt as tbench  # noqa: E402
from particle_filters_tpu_torch.simulators import sensor_network_skewt as tsk  # noqa: E402

torch.set_num_threads(1)

CPU = "cpu"
M1, M2, AL = tbench.M1, tbench.M2, tbench.AL


def jax_config(d=tbench.D, T=tbench.T, n_trials=tbench.TRIALS, seed=42):
    """``bench_skewt``'s configs (``benchmarks/run_benchmarks.py:592-599``),
    without Λ, which the column does not read."""
    return (jsk.SkewTGridConfig(d=d, alpha0=1.0, alpha1=1e-3, beta=8.0),
            jsk.SkewTDynConfig(alpha=AL, nu=8.0, gamma_scale=0.1, seed=seed),
            jsk.SkewTMeasConfig(m1=M1, m2=M2),
            jsk.SkewTSimConfig(T=T, n_trials=n_trials, save_lambda=False))


def _jh(x):
    return M1 * jnp.exp(M2 * jnp.clip(x, -10, 10))


def jax_kalman_means(Z, Sigma):
    """``bench_skewt``'s EKF and UKF rows: (EKF means, UKF means)."""
    d = Sigma.shape[0]
    R = jnp.diag(_jh(jnp.zeros(d)))
    ekf = ExtendedKalmanFilter(lambda x, u: AL * x, _jh, Sigma, R, joseph=True, jitter=1e-4)
    ukf = UnscentedKalmanFilter(lambda x, u: AL * x, _jh, Sigma, R, alpha=0.5, jitter=1e-5)
    e = jax.jit(jax.vmap(lambda z: ekf.run(make_ekf_state(jnp.zeros(d), Sigma), z)[1]))(Z)
    u = jax.jit(jax.vmap(lambda z: ukf.run(make_ukf_state(jnp.zeros(d), Sigma), z)[1]))(Z)
    return np.asarray(e), np.asarray(u)


def jax_flow_column(X, Z, Sigma, LQ, kind, n, key, chunk=None):
    """One flow row of ``bench_skewt`` with flow key ``key``: (MSE, mean
    ESS). ``chunk`` runs the trials in groups of that many (their keys are
    the same slices of the one split), to bound the memory."""
    d = Sigma.shape[0]
    R = jnp.diag(_jh(jnp.zeros(d)))

    def poisson_ll(z, x):
        lam = _jh(x)
        return jnp.sum(z * jnp.log(lam + 1e-10) - lam)

    cls, cfg = ((EDHFlowPF, EDHConfig(n_particles=n, n_lambda_steps=8, flow_integrator="euler",
                                      resample_ess_ratio=0.5)) if kind == "edh" else
                (LEDHFlowPF, LEDHConfig(n_particles=n, n_lambda_steps=8,
                                        resample_ess_ratio=0.5)))
    tracker = GaussianTracker(UnscentedKalmanFilter(lambda x, u: AL * x, _jh, Sigma, R,
                                                    alpha=0.5, jitter=1e-5))
    filt = cls(tracker, lambda x, u, v: AL * x + v, _jh, jax.jacfwd(_jh),
               lambda xn, xo: mvn_logpdf_chol(xn, AL * xo, LQ), poisson_ll, R, cfg)
    ns = lambda k, n_, nx: jax.random.normal(k, (n_, nx)) @ LQ.T  # noqa: E731

    def run_one(k, z):
        st = filt.init_from_gaussian(k, jnp.zeros(d), Sigma)
        ts = tracker.init(jnp.zeros(d), Sigma)
        _, _, hist = filt.run(jax.random.fold_in(k, 1), st, ts, z, process_noise_sampler=ns)
        return hist["mean"], hist["ess"]

    keys = jax.random.split(key, Z.shape[0])
    run = jax.jit(jax.vmap(run_one))
    chunk = chunk or Z.shape[0]
    outs = [run(keys[i:i + chunk], Z[i:i + chunk]) for i in range(0, Z.shape[0], chunk)]
    means = np.concatenate([np.asarray(o[0]) for o in outs])
    ess = np.concatenate([np.asarray(o[1]) for o in outs])
    return float(np.mean((means - X) ** 2)), float(np.mean(ess))


# --- deterministic pieces ------------------------------------------------------
@pytest.mark.parametrize("d", [9, 144])
def test_lattice_covariance_and_factor_match_jax(d):
    R = tsk.make_lattice(d, device=CPU)
    np.testing.assert_array_equal(R.numpy(), np.asarray(jsk.make_lattice(d)))
    S_t = tsk.build_spatial_cov(R, 1.0, 1e-3, 8.0)
    S_j = np.asarray(jsk.build_spatial_cov(jsk.make_lattice(d), 1.0, 1e-3, 8.0))
    np.testing.assert_allclose(S_t.numpy(), S_j, rtol=1e-6, atol=1e-7)
    res_t = tsk.simulate_skewt_many(*jax_config(d=d, T=2, n_trials=2), device=CPU)
    res_j = jsk.simulate_skewt_many(*jax_config(d=d, T=2, n_trials=2))
    # Σ's nugget is 1e-3 against entries of order 1: the factor's small
    # entries round differently in two Cholesky orders, by up to 2.1e-5
    np.testing.assert_allclose(res_t.L.numpy(), np.asarray(res_j.L), rtol=1e-5, atol=5e-5)


def test_lattice_rejects_non_squares():
    for make in (tsk.make_lattice, jsk.make_lattice):
        with pytest.raises(ValueError, match="perfect square"):
            make(10)


def test_explicit_gamma_and_recursion_given_the_draws():
    g = np.linspace(-0.2, 0.3, 9).astype(np.float32)
    out = tsk.prepare_gamma_vector(None, 9, 0.1, g, device=CPU)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jsk.prepare_gamma_vector(None, 9, 0.1, g)))
    with pytest.raises(ValueError, match="incompatible"):
        tsk.prepare_gamma_vector(None, 4, 0.1, g, device=CPU)
    gen = torch.Generator().manual_seed(0)
    v = tsk.prepare_gamma_vector(gen, 16, 0.1, None, device=CPU)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(v)), 0.1, rtol=1e-6)


# --- sampled moments -----------------------------------------------------------
def test_inverse_gamma_moments_match_jax():
    """W ~ InvGamma(4, 4): mean 4/3, variance 16/(9·2) = 8/9, from 2e5 draws."""
    n = 200_000
    w_t = tsk.sample_inverse_gamma(torch.Generator().manual_seed(1), 4.0, 4.0, (n,),
                                   device=CPU).double().numpy()
    w_j = np.asarray(jsk.sample_inverse_gamma(jax.random.PRNGKey(1), 4.0, 4.0, (n,)),
                     np.float64)
    for w in (w_t, w_j):
        assert abs(w.mean() - 4.0 / 3.0) < 5 * np.sqrt(8.0 / 9.0 / n)
    assert abs(np.median(w_t) / np.median(w_j) - 1) < 0.01


def test_simulated_moments_match_jax():
    """Per-step means and variances of X and means of Z over 2000 trials
    (d = 9, T = 6, one shared γ), within five standard errors."""
    n = 2000
    gvec = np.linspace(-0.1, 0.1, 9).astype(np.float32)
    grid, dyn, meas, sim = jax_config(d=9, T=6, n_trials=n, seed=5)
    dyn = jsk.SkewTDynConfig(alpha=AL, nu=8.0, gamma_vec=gvec, seed=5)
    rj = jsk.simulate_skewt_many(grid, dyn, meas, sim)
    rt = tsk.simulate_skewt_many(tsk.SkewTGridConfig(**grid.__dict__),
                                 tsk.SkewTDynConfig(**dyn.__dict__),
                                 tsk.SkewTMeasConfig(**meas.__dict__),
                                 tsk.SkewTSimConfig(**sim.__dict__), device=CPU)
    assert rt.X.shape == (n, 6, 9) and rt.Z.dtype == torch.int32 and rt.Lambda is None
    for a_t, a_j in ((rt.X.double().numpy(), np.asarray(rj.X, np.float64)),
                     (rt.Z.double().numpy(), np.asarray(rj.Z, np.float64))):
        se = np.sqrt((a_t.var(0) + a_j.var(0)) / n)
        assert np.all(np.abs(a_t.mean(0) - a_j.mean(0)) < 5 * se + 1e-6)
    xt, xj = rt.X.double().numpy(), np.asarray(rj.X, np.float64)
    v_t, v_j = xt.var(0), xj.var(0)
    # the variance of a sample variance: (m4 − σ⁴)/n, heavy tails included
    se_v = np.sqrt(((xt - xt.mean(0)) ** 4).mean(0) / n + ((xj - xj.mean(0)) ** 4).mean(0) / n)
    assert np.all(np.abs(v_t - v_j) < 5 * se_v)
    single = tsk.simulate_skewt_trial(tsk.SkewTGridConfig(d=9), tsk.SkewTDynConfig(seed=3),
                                      tsk.SkewTMeasConfig(), tsk.SkewTSimConfig(T=4),
                                      device=CPU)
    assert single.X.shape == single.Lambda.shape == (4, 9)


# --- files ---------------------------------------------------------------------
def test_npz_interchange_both_ways(tmp_path):
    rj = jsk.simulate_skewt_many(*jax_config(d=9, T=3, n_trials=2))
    jsk.save_npz(str(tmp_path / "j.npz"), rj)
    back = tsk.load_npz(str(tmp_path / "j.npz"))
    assert set(back) == {"X", "Z", "Sigma", "L", "R", "gamma"}
    np.testing.assert_array_equal(back["Z"], np.asarray(rj.Z))
    assert back["Z"].dtype == np.int32
    port = interop.skewt_result_from_jax(rj, device=CPU)
    np.testing.assert_array_equal(port.X.numpy(), np.asarray(rj.X))
    rt = tsk.simulate_skewt_many(tsk.SkewTGridConfig(d=9), tsk.SkewTDynConfig(),
                                 tsk.SkewTMeasConfig(), tsk.SkewTSimConfig(T=3, n_trials=2),
                                 device=CPU)
    tsk.save_npz(str(tmp_path / "t.npz"), rt)
    fwd = jsk.load_npz(str(tmp_path / "t.npz"))
    assert set(fwd) == {"X", "Z", "Sigma", "L", "R", "gamma", "Lambda"}
    for k in fwd:
        np.testing.assert_array_equal(fwd[k], getattr(rt, "Lambda" if k == "Lambda" else k).numpy())


def test_committed_data_equals_jax():
    """The committed file is the JAX package's ``bench_skewt`` data."""
    want = jsk.simulate_skewt_many(*jax_config())
    got = tsk.load_npz(str(tbench.DATA))
    assert set(got) == {"X", "Z", "Sigma", "L", "R", "gamma"}
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=k)
    assert got["Z"].dtype == np.int32 and got["X"].shape == (100, 10, 144)


def test_committed_kalman_mses_match_jax_constants():
    """``JAX_MSE`` holds the JAX package's EKF and UKF MSEs on the committed
    data (the chip gate's reference), within 1e-6 relative."""
    X, Z, Sigma, _ = tbench.load_data(CPU)
    e, u = jax_kalman_means(jnp.asarray(Z.numpy()), jnp.asarray(Sigma.numpy()))
    for tag, means in (("ekf", e), ("ukf", u)):
        mse = float(np.mean((means - X.numpy()) ** 2))
        np.testing.assert_allclose(mse, tbench.JAX_MSE[tag], rtol=1e-6)


# --- filters at d = 9, given the same noise ------------------------------------
@pytest.fixture(scope="module")
def small():
    r = jsk.simulate_skewt_trial(jsk.SkewTGridConfig(d=9, alpha0=1.0, beta=8.0),
                                 jsk.SkewTDynConfig(alpha=AL, nu=8.0, seed=3),
                                 jsk.SkewTMeasConfig(m1=M1, m2=M2), jsk.SkewTSimConfig(T=15))
    return np.asarray(r.X), np.asarray(r.Z, np.float32), np.asarray(r.Sigma), np.asarray(r.L)


def test_kalman_filters_match_jax(small):
    X, Z, Sigma, _ = small
    e, u = jax_kalman_means(jnp.asarray(Z[None]), jnp.asarray(Sigma))
    te = tbench._ekf(torch.from_numpy(Z[None]), torch.from_numpy(Sigma))
    tu = tbench._ukf(torch.from_numpy(Z[None]), torch.from_numpy(Sigma))
    np.testing.assert_allclose(te.numpy(), e, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tu.numpy(), u, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["edh", "ledh"])
def test_flow_steps_match_jax(small, kind):
    """EDH (Euler) and LEDH with a UKF tracker and the Poisson likelihood:
    one state, one process noise, resampling off."""
    X, Z, Sigma, LQ = small
    d, n, T = 9, 64, 5
    R = np.eye(d, dtype=np.float32)
    tf, _ = tbench.make_flow(kind, n, torch.from_numpy(Sigma), torch.from_numpy(LQ))
    tf.cfg = type(tf.cfg)(**{**tf.cfg.__dict__, "resample_ess_ratio": 0.0})

    def poisson_ll(z, x):
        lam = _jh(x)
        return jnp.sum(z * jnp.log(lam + 1e-10) - lam)

    cls, cfg = ((EDHFlowPF, EDHConfig(n_particles=n, n_lambda_steps=8, flow_integrator="euler",
                                      resample_ess_ratio=0.0)) if kind == "edh" else
                (LEDHFlowPF, LEDHConfig(n_particles=n, n_lambda_steps=8)))
    jtrack = GaussianTracker(UnscentedKalmanFilter(lambda x, u: AL * x, _jh, Sigma, R,
                                                   alpha=0.5, jitter=1e-5))
    jf = cls(jtrack, lambda x, u, v: AL * x + v, _jh, jax.jacfwd(_jh),
             lambda xn, xo: mvn_logpdf_chol(xn, AL * xo, jnp.asarray(LQ)), poisson_ll, R, cfg)
    rng = np.random.default_rng(9)
    V = (rng.standard_normal((T, n, d)) @ LQ.T).astype(np.float32)
    jst = jf.init_from_gaussian(jax.random.PRNGKey(0), jnp.zeros(d), jnp.asarray(Sigma))
    jts = jtrack.init(jnp.zeros(d), jnp.asarray(Sigma))
    tst, tts = (interop.state_from_jax(s, device=CPU) for s in (jst, jts))
    jstep = jax.jit(lambda k, st, ts, z, v: jf.step(k, st, ts, z,
                                                    process_noise_sampler=lambda *_: v))
    gen = torch.Generator().manual_seed(0)
    for t in range(T):
        jst, jts = jstep(jax.random.PRNGKey(t), jst, jts, jnp.asarray(Z[t]), jnp.asarray(V[t]))
        tst, tts = tf.step(gen, tst, tts, Z[t],
                           process_noise_sampler=lambda g, n_, nx: torch.from_numpy(V[t]))
        for name in ("particles", "log_weights", "mean", "cov"):
            np.testing.assert_allclose(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
                                       rtol=2e-4, atol=2e-4, err_msg=f"{name}, t {t}")
        np.testing.assert_allclose(tts.mean.numpy(), np.asarray(jts.mean), rtol=2e-4, atol=2e-4)


def test_column_at_a_toy_size():
    """The whole column at d = 16, 3 trials, T = 4, on JAX-simulated data:
    the EKF and UKF rows equal the JAX package's filters on it; every flow
    is finite, near the EKF, records post-resample ESS ≤ N and launches no
    B2 on CPU tensors."""
    rj = jsk.simulate_skewt_many(*jax_config(d=16, T=4, n_trials=3))
    data = tuple(torch.from_numpy(np.asarray(a, np.float32))
                 for a in (rj.X, rj.Z, rj.Sigma, rj.L))
    flows = (("edh200", "edh", 48), ("edh10000", "edh", 96), ("ledh200", "ledh", 32))
    res = tbench.run_column(CPU, data=data, flows=flows)
    e, u = jax_kalman_means(jnp.asarray(data[1].numpy()), jnp.asarray(data[2].numpy()))
    for tag, means in (("ekf", e), ("ukf", u)):
        want = float(np.mean((means - data[0].numpy()) ** 2))
        np.testing.assert_allclose(res[tag]["mse"], want, rtol=1e-5)
    for tag, _, n in flows:
        r = res[tag]
        assert r["finite"] and np.isfinite(r["mse"]) and r["mse"] < 3.0 * res["ekf"]["mse"]
        assert r["b2_launches"] == 0 and 0 <= r["resampled"] <= 3 * 4
        assert 0 < r["ess"] <= n * (1 + 1e-5)


def main(parts):
    """Write the committed file and print the JAX package's MSEs on it
    (``parts`` picks some of them): ``kf`` the EKF and UKF, ``edh200``
    EDH-200 over flow keys 0-7 (the column's key is 7), ``big`` EDH-10000
    and LEDH-200 at key 7, in chunks of 10 trials."""
    res = jsk.simulate_skewt_many(*jax_config())
    jsk.save_npz(str(tbench.DATA), res)
    print("wrote", tbench.DATA, os.path.getsize(tbench.DATA), "bytes")
    X, Z, Sigma, L = (np.asarray(a, np.float32) for a in (res.X, res.Z, res.Sigma, res.L))
    if "kf" in parts:
        e, u = jax_kalman_means(jnp.asarray(Z), jnp.asarray(Sigma))
        print("JAX_MSE ekf", repr(float(np.mean((e - X) ** 2))), "ukf",
              repr(float(np.mean((u - X) ** 2))))
    if "big" in parts:
        for kind, n, tag in (("edh", 10000, "edh10000"), ("ledh", 200, "ledh200")):
            mse, ess = jax_flow_column(X, jnp.asarray(Z), jnp.asarray(Sigma), jnp.asarray(L),
                                       kind, n, jax.random.PRNGKey(7), chunk=10)
            print(f"{tag} flow key 7: MSE {mse!r}, ESS {ess!r}", flush=True)
    if "edh200" not in parts:
        return
    mses = []
    for k in range(8):
        mse, ess = jax_flow_column(X, jnp.asarray(Z), jnp.asarray(Sigma), jnp.asarray(L),
                                   "edh", 200, jax.random.PRNGKey(k))
        mses.append(mse)
        print(f"edh200 flow key {k}: MSE {mse!r}, ESS {ess!r}", flush=True)
    m = np.asarray(mses)
    print("edh200 over keys: mean", repr(float(m.mean())), "min", repr(float(m.min())), "max",
          repr(float(m.max())), "max |MSE - mean| / mean", repr(float(np.abs(m - m.mean()).max()
                                                                          / m.mean())))


if __name__ == "__main__":
    main(sys.argv[1:] or ("kf", "edh200", "big"))
