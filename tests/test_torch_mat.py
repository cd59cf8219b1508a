"""Port parity: multi-target acoustic tracking (simulator, filters, column)
against the JAX package, and the committed T = 40 data.

- Deterministic pieces (CV transition, the article's noise and starts, the
  sensor grid, the acoustic model, reflection) equal the JAX package's
  exactly or to f32 rounding (rtol 1e-6).
- The simulators draw from other streams, so their trajectories are held
  statistically: the per-step displacement moments over 4000 targets
  within five standard errors.
- The EKF and UKF agree with the JAX package's to 5e-4 over their first 10
  steps. Past that, and in the flow steps (128- and 64-particle EDH and
  LEDH clouds, one state and one process noise, resampling off), f32
  rounding is amplified past any fixed tolerance (h has gradients of order
  10², R = 0.01): there the port is held against the JAX package's own run
  in f64, no farther from it than twice the JAX package's f32 run.
- ``particle_filters_tpu_torch/benchmarks/data/mat_t40.npz`` equals what the
  JAX package gives for ``bench_mat_flows``' data. Run this file as a
  script to write it again and print the JAX package's reference OMATs:

      JAX_PLATFORMS=cpu python tests/test_torch_mat.py
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

from particle_filters_tpu.core import weights as jw  # noqa: E402
from particle_filters_tpu.core.linalg import mvn_logpdf_chol  # noqa: E402
from particle_filters_tpu.models import edh_particle_filter as jedh  # noqa: E402
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
from particle_filters_tpu.simulators import acoustic_tracking as jat  # noqa: E402
from particle_filters_tpu.utils.diagnostics import omat as jomat  # noqa: E402
from particle_filters_tpu_torch import interop  # noqa: E402
from particle_filters_tpu_torch.benchmarks import mat as tbench  # noqa: E402
from particle_filters_tpu_torch.simulators import acoustic_tracking as tat  # noqa: E402

torch.set_num_threads(1)

CPU = "cpu"
C, NX = tbench.C, tbench.NX


def jax_data(n_steps=tbench.T):
    """``bench_mat_flows``' data (``benchmarks/run_benchmarks.py:737-750``):
    the dataset's arrays, its noisy observations and the jittered start."""
    mat = jat.simulate_acoustic_dataset(jat.MATScenarioConfig(n_steps=n_steps, seed=7),
                                        jat.MATDynamicsConfig())
    key = jax.random.PRNGKey(0)
    zs = mat.Z + 0.1 * jax.random.normal(key, mat.Z.shape)
    x0 = jat.article_initial_states(C).reshape(-1) + 0.5 * jax.random.normal(key, (NX,))
    return {**{k: np.asarray(v) for k, v in mat.as_dict().items()},
            "zs": np.asarray(zs), "x0": np.asarray(x0)}


def jax_model(sensors):
    F = jnp.kron(jnp.eye(C), jat.build_cv_transition(1.0))
    Q = jnp.kron(jnp.eye(C), jat.article_process_noise_cov())
    LQ = jnp.linalg.cholesky(Q + 1e-8 * jnp.eye(NX))
    nz = sensors.shape[0]
    R, LR = 0.01 * jnp.eye(nz), 0.1 * jnp.eye(nz)

    def h(x):
        pos = x.reshape(C, 4)[:, :2]
        return jat.acoustic_measurement_model(pos[None], sensors, 10.0, 0.1)[0]

    return F, Q, LQ, R, LR, h


def jax_avg_omat(means, P):
    est = np.asarray(means)
    return float(np.mean([jomat(est[t].reshape(C, 4)[:, :2], np.asarray(P[t]))
                          for t in range(0, est.shape[0], tbench.OMAT_EVERY)]))


def jax_kalman_means(data):
    F, Q, _, R, _, h = jax_model(jnp.asarray(data["S"]))
    x0, zs, eye = jnp.asarray(data["x0"]), jnp.asarray(data["zs"]), jnp.eye(NX)
    ekf = ExtendedKalmanFilter(lambda x, u: F @ x, h, Q, R, jitter=1e-5)
    ukf = UnscentedKalmanFilter(lambda x, u: F @ x, h, Q, R, alpha=0.5, jitter=1e-5)
    return (np.asarray(jax.jit(lambda z: ekf.run(make_ekf_state(x0, eye), z)[1])(zs)),
            np.asarray(jax.jit(lambda z: ukf.run(make_ukf_state(x0, eye), z)[1])(zs)))


def jax_flow(data, kind, n=tbench.N):
    """The flow row of ``bench_mat_flows`` as a function of its key: the
    history means (T, 16)."""
    F, Q, LQ, R, LR, h = jax_model(jnp.asarray(data["S"]))
    tracker = GaussianTracker(ExtendedKalmanFilter(lambda x, u: F @ x, h, Q, R, jitter=1e-5))
    cls, cfg = ((EDHFlowPF, EDHConfig(n_particles=n, flow_integrator="euler"))
                if kind == "edh" else (LEDHFlowPF, LEDHConfig(n_particles=n)))
    filt = cls(tracker, lambda x, u, v: F @ x + v, h, jax.jacfwd(h),
               lambda xn, xo: mvn_logpdf_chol(xn, F @ xo, LQ),
               lambda z, x: mvn_logpdf_chol(z, h(x), LR), R, cfg)
    ns = lambda k, n_, nx: jax.random.normal(k, (n_, nx)) @ LQ.T  # noqa: E731
    x0, zs = jnp.asarray(data["x0"]), jnp.asarray(data["zs"])

    def run(key):
        st = filt.init_from_gaussian(key, x0, jnp.eye(NX))
        ts = tracker.init(x0, jnp.eye(NX))
        return filt.run(key, st, ts, zs, process_noise_sampler=ns)[2]["mean"]

    return filt, jax.jit(run)


# --- deterministic pieces --------------------------------------------------------
def test_deterministic_pieces_match_jax():
    np.testing.assert_array_equal(tat.build_cv_transition(0.5, CPU).numpy(),
                                  np.asarray(jat.build_cv_transition(0.5)))
    np.testing.assert_array_equal(tat.article_process_noise_cov(CPU).numpy(),
                                  np.asarray(jat.article_process_noise_cov()))
    np.testing.assert_array_equal(tat.article_initial_states(4, CPU).numpy(),
                                  np.asarray(jat.article_initial_states(4)))
    for make in (tat.article_initial_states, jat.article_initial_states):
        with pytest.raises(ValueError, match="n_targets == 4"):
            make(3) if make is jat.article_initial_states else make(3, CPU)
    for area, shape in (((40.0, 40.0), (5, 5)), ((30.0, 20.0), (3, 4))):
        np.testing.assert_allclose(tat.make_sensor_grid(area, shape, CPU).numpy(),
                                   np.asarray(jat.make_sensor_grid(area, shape)), rtol=1e-6)
    rng = np.random.default_rng(0)
    pos = (40 * rng.random((6, 3, 4, 2))).astype(np.float32)
    S = np.asarray(jat.make_sensor_grid((40.0, 40.0), (5, 5)))
    np.testing.assert_allclose(
        tat.acoustic_measurement_model(torch.from_numpy(pos), torch.from_numpy(S), 10.0,
                                       0.1).numpy(),
        np.asarray(jat.acoustic_measurement_model(jnp.asarray(pos), jnp.asarray(S), 10.0, 0.1)),
        rtol=1e-6)


def test_reflection_matches_jax():
    """Positions at, past and inside both walls, velocities flipped exactly
    where a wall was reached."""
    pos = np.array([-3.0, 0.0, 1e-7, 20.0, 39.999, 40.0, 41.5], np.float32)
    vel = np.linspace(-1, 1, pos.size).astype(np.float32)
    pt, vt = tat._reflect(torch.from_numpy(pos), torch.from_numpy(vel), 0.0, 40.0, 1e-6)
    pj, vj = jat._reflect(jnp.asarray(pos), jnp.asarray(vel), 0.0, 40.0, 1e-6)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_trajectory_moments_match_jax():
    """The CV recursion's increments over 4000 free targets (no walls): the
    per-step mean and variance of the velocity increments within five
    standard errors of the JAX package's, and of the article's V."""
    n, steps = 4000, 5
    area, dyn = (1e6, 1e6), jat.MATDynamicsConfig()
    xt = tat.simulate_cv_targets(steps, n, area, tat.MATDynamicsConfig(),
                                 torch.Generator().manual_seed(3), use_article_init=False,
                                 enforce_boundaries=False, device=CPU).double().numpy()
    xj = np.asarray(jat.simulate_cv_targets(steps, n, area, dyn, jax.random.PRNGKey(3),
                                            use_article_init=False, enforce_boundaries=False),
                    np.float64)
    V = np.asarray(jat.article_process_noise_cov(), np.float64)
    F = np.asarray(jat.build_cv_transition(1.0), np.float64)
    for x in (xt, xj):
        w = x[1:] - x[:-1] @ F.T  # the process noise of each step
        cov = np.einsum("tni,tnj->ij", w, w) / (w.shape[0] * n)
        np.testing.assert_allclose(cov, V, atol=5 * np.sqrt(2 * np.max(V) ** 2 / (4 * n)))
    for k in (2, 3):  # initial velocities ~ N(0, 0.5²), positions uniform
        assert abs(xt[0, :, k].std() - xj[0, :, k].std()) < 5 * 0.5 / np.sqrt(2 * n)
    assert abs(xt[0, :, 0].mean() - xj[0, :, 0].mean()) < 5 * 0.5e6 * 0.3 / np.sqrt(n)


def test_dataset_with_walls_stays_inside_and_reads_both_ways(tmp_path):
    cfg = tat.MATScenarioConfig(n_steps=60, seed=11)
    ds = tat.simulate_acoustic_dataset(cfg, tat.MATDynamicsConfig(), device=CPU)
    assert ds.X.shape == (60, 4, 4) and ds.Z.shape == (60, 25)
    assert bool(((ds.P >= 0) & (ds.P <= 40)).all())
    torch.testing.assert_close(ds.Z, tat.acoustic_measurement_model(ds.P, ds.S, 10.0, 0.1))
    ds.save_npz(str(tmp_path / "t.npz"))
    back = jat.MATDataset.load_npz(str(tmp_path / "t.npz"))
    for k, v in ds.as_dict().items():
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), v.numpy())
    jd = jat.simulate_acoustic_dataset(jat.MATScenarioConfig(n_steps=10, seed=7),
                                       jat.MATDynamicsConfig())
    jd.save_npz(str(tmp_path / "j.npz"))
    fwd = tat.MATDataset.load_npz(str(tmp_path / "j.npz"), device=CPU)
    conv = interop.mat_dataset_from_jax(jd, device=CPU)
    for k, v in jd.as_dict().items():
        np.testing.assert_array_equal(getattr(fwd, k).numpy(), np.asarray(v))
        np.testing.assert_array_equal(getattr(conv, k).numpy(), np.asarray(v))


def test_committed_data_equals_jax():
    want = jax_data()
    with np.load(str(tbench.DATA)) as f:
        got = {k: f[k] for k in f.files}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["zs"].shape == (40, 25) and got["x0"].shape == (16,)


def test_committed_kalman_omats_match_jax_constants():
    data = jax_data()
    e, u = jax_kalman_means(data)
    for tag, means in (("ekf", e), ("ukf", u)):
        np.testing.assert_allclose(jax_avg_omat(means, data["P"]), tbench.JAX_OMAT[tag],
                                   rtol=1e-9)


def test_jax_flow_omats_are_the_jax_packages():
    """``JAX_FLOW_OMATS`` holds the JAX package's EDH OMATs by flow key on the
    committed data (keys 0 and 1 rerun here; LEDH's are from the same script,
    ``python tests/test_torch_mat.py``) and the quartiles are theirs."""
    data = jax_data()
    _, run = jax_flow(data, "edh")
    for k in (0, 1):
        got = jax_avg_omat(run(jax.random.PRNGKey(k)), data["P"])
        np.testing.assert_allclose(got, tbench.JAX_FLOW_OMATS["edh"][k], rtol=1e-6)
    for tag, omats in tbench.JAX_FLOW_OMATS.items():
        assert len(omats) == 16
        q1, med, q3 = tbench.JAX_FLOW_QUARTILES[tag]
        assert q1 < med < q3 and med == float(np.median(omats))


@pytest.mark.parametrize("shift", [0.0, 0.4, 1.5])
def test_rank_test_matches_scipy(shift):
    """The Mann-Whitney U and its two-sided normal-approximation p-value,
    against scipy's (which also corrects the variance for ties: one tie here)."""
    stats = pytest.importorskip("scipy.stats")
    rng = np.random.default_rng(3)
    a = list(rng.normal(shift, 1.0, 32))
    b = list(rng.normal(0.0, 1.0, 16))
    a[0] = b[0]
    u, p = tbench.rank_test(a, b)
    want = stats.mannwhitneyu(a, b, alternative="two-sided", method="asymptotic",
                              use_continuity=False)
    assert u == want.statistic
    np.testing.assert_allclose(p, want.pvalue, rtol=1e-3)


# --- filters, given the same noise ------------------------------------------------
@pytest.fixture(scope="module")
def data():
    return jax_data()


def _tdata(data):
    return {k: torch.from_numpy(np.array(data[k], np.float32)) for k in ("P", "S", "zs", "x0")}


def _f64(data):
    return {k: np.asarray(v, np.float64) if v.dtype.kind == "f" else v for k, v in data.items()}


def test_kalman_filters_match_jax(data):
    """The first 10 steps' means agree with the JAX package's to 5e-4 + 1e-4
    relative (coordinates of order 10); over
    all 40 the EKF's rounding grows (its S = HPHᵀ + R is ill conditioned),
    so the OMAT is held against the JAX package's own run in f64: the port
    no farther from it than twice the JAX package's f32 run, plus 1e-4
    relative."""
    e, u = jax_kalman_means(data)
    with jax.enable_x64(True):
        e64, u64 = jax_kalman_means(_f64(data))
    td = _tdata(data)
    for kind, want, exact in (("ekf", e, e64), ("ukf", u, u64)):
        got = tbench._kalman_means(kind, td).numpy()
        np.testing.assert_allclose(got[:10], want[:10], rtol=1e-4, atol=5e-4, err_msg=kind)
        o_port, o_jax, o_64 = (jax_avg_omat(m, data["P"]) for m in (got, want, exact))
        assert abs(o_port - o_64) <= 2 * abs(o_jax - o_64) + 1e-4 * o_64, (kind, o_port,
                                                                            o_jax, o_64)


def _flow_step(data, kind, n, dtype, seed):
    """One step of the JAX package's flow (resampling off) in ``dtype``
    from a seeded cloud with the seeded noise ``V``: (particles, V, state,
    tracker state)."""
    d = data if dtype == np.float32 else _f64(data)
    jf, _ = jax_flow(d, kind, n)
    jf.cfg = type(jf.cfg)(**{**jf.cfg.__dict__, "resample_ess_ratio": 0.0})
    _, _, LQ, _, _, _ = jax_model(jnp.asarray(d["S"]))
    rng = np.random.default_rng(seed)
    V = (rng.standard_normal((n, NX)) @ np.asarray(LQ, np.float64).T).astype(dtype)
    p0 = (np.asarray(d["x0"], np.float64) + rng.standard_normal((n, NX))).astype(dtype)
    logw = jnp.full((n,), -np.log(n), dtype)
    mean, cov = jw.weighted_mean_cov(jnp.asarray(p0), logw)
    st = jedh.FlowPFState(particles=jnp.asarray(p0), weights=jnp.exp(logw), log_weights=logw,
                          mean=mean, cov=cov,
                          diagnostics={"condition_numbers": jnp.zeros(8, dtype),
                                       "resampled": jnp.asarray(False)})
    ts = jf.tracker.init(jnp.asarray(d["x0"]), jnp.eye(NX, dtype=dtype))
    out, _ = jf.step(jax.random.PRNGKey(0), st, ts, jnp.asarray(d["zs"][0]),
                     process_noise_sampler=lambda *_: jnp.asarray(V))
    return np.asarray(out.particles, np.float64), V, st, ts


@pytest.mark.parametrize("kind,n", [("edh", 128), ("ledh", 64)])
def test_flow_steps_match_jax(data, kind, n):
    """One step from one cloud and one noise, resampling off, three seeds.
    The acoustic h has gradients of order 10² where a target nears a
    sensor and R = 0.01, so LEDH's Woodbury G = W − YᵀY cancels entries of
    order 10⁶ and its f32 step is rounding: the JAX package's own f32 step
    lies a median 0.12 per particle from its f64 step. So both f32 steps
    are held against the JAX package's f64 step: the port's particles (the
    median over particles of the largest coordinate error) no farther from
    it than three times the JAX package's f32 step, plus 1e-3 (coordinates
    of order 10; EDH's f32 steps lie ~1e-4 from f64). The weights are not
    compared: near a sensor the log-likelihood moves by ~10² for 10⁻³ of
    position, so the weighted means of two f32 steps can part by 10⁻²
    where their particles agree to 10⁻⁴."""
    tf, _ = tbench.make_flow(kind, n, _tdata(data)["S"])
    tf.cfg = type(tf.cfg)(**{**tf.cfg.__dict__, "resample_ess_ratio": 0.0})
    for seed in range(3):
        p32, V, st, ts = _flow_step(data, kind, n, np.float32, seed)
        with jax.enable_x64(True):
            p64, *_ = _flow_step(data, kind, n, np.float64, seed)
        tst, tts = (interop.state_from_jax(s, device=CPU) for s in (st, ts))
        out, _ = tf.step(torch.Generator(), tst, tts, data["zs"][0],
                         process_noise_sampler=lambda g, n_, nx: torch.from_numpy(V))
        pt = out.particles.double().numpy()
        err = lambda a: float(np.median(np.abs(a - p64).max(axis=1)))  # noqa: E731
        assert err(pt) <= 3 * err(p32) + 1e-3, (seed, err(pt), err(p32))


def test_column_at_a_toy_size(data):
    """The column on the committed data cut to T = 10, 3 seeds of 64
    particles: the EKF and UKF OMATs equal the JAX package's on the same
    data; the flows are finite and launch no B2 on CPU tensors; LEDH never
    resamples."""
    td = _tdata(data)
    cut = {k: (v[:10] if k in ("P", "zs") else v) for k, v in td.items()}
    res = tbench.run_column(CPU, data=cut, seeds=3, n_particles=64)
    jcut = {**data, "zs": data["zs"][:10], "P": data["P"][:10]}
    e, u = jax_kalman_means(jcut)
    for tag, means in (("ekf", e), ("ukf", u)):
        np.testing.assert_allclose(res[tag]["omat"], jax_avg_omat(means, jcut["P"]), atol=1e-3)
    for tag in tbench.FLOWS:
        r = res[tag]
        assert r["finite"] and len(r["omats"]) == 3 and r["q1"] <= r["median"] <= r["q3"]
        assert r["b2_launches"] == 0
    assert res["ledh"]["resampled"] == 0
    omats, hist, launches = tbench.flow_omats("edh", torch.Generator().manual_seed(1), cut,
                                              seeds=2, n_particles=64)
    assert len(omats) == 2 and np.isfinite(omats).all() and launches == 0
    assert hist["mean"].shape == (2, 10, tbench.NX)


def main():
    """Write the committed file and print the JAX package's OMATs on it: the
    EKF and UKF, and each flow's over flow keys 0-15."""
    data = jax_data()
    np.savez_compressed(str(tbench.DATA), **data)
    print("wrote", tbench.DATA, os.path.getsize(tbench.DATA), "bytes")
    e, u = jax_kalman_means(data)
    base = {"ekf": jax_avg_omat(e, data["P"]), "ukf": jax_avg_omat(u, data["P"])}
    print("JAX_OMAT", {k: repr(v) for k, v in base.items()})
    spread = {"ekf": 0.0, "ukf": 0.0}
    for seed in range(4):  # the observations moved by one ulp, a seeded ±1 pattern
        sign = np.random.default_rng(seed).choice([-1.0, 1.0], data["zs"].shape)
        zp = np.nextafter(data["zs"], np.where(sign > 0, np.float32(np.inf), np.float32(-np.inf)))
        for tag, means in zip(("ekf", "ukf"), jax_kalman_means({**data, "zs": zp})):
            rel = abs(jax_avg_omat(means, data["P"]) - base[tag]) / base[tag]
            spread[tag] = max(spread[tag], rel)
    print("JAX_ULP_SPREAD", {k: repr(v) for k, v in spread.items()})
    for kind in tbench.FLOWS:
        _, run = jax_flow(data, kind)
        omats = [jax_avg_omat(run(jax.random.PRNGKey(k)), data["P"]) for k in range(16)]
        q = np.percentile(omats, [25, 50, 75], method="linear")
        print(f"{kind} OMAT by key:", [repr(o) for o in omats])
        print(f"{kind} quartiles (q1, median, q3):", tuple(repr(float(v)) for v in q), flush=True)


if __name__ == "__main__":
    main()
