"""Port parity: the Kalman family (KF, EKF, UKF, trackers) and its data
(LGSSM and SNLG simulators) against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.
Deterministic filters agree to f32 rounding: rtol/atol 1e-5 on states of
order one over 10–30 steps (f32 matmuls and Cholesky solves in two
orders), 1e-4 on the log-likelihood sum. Simulators draw from different
streams, so their recursions are held against numpy given the same noise,
their files are read by the other package, and their deterministic parts
(grid, kernel) are compared directly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu.models import extended_kalman_filter as jekf
from particle_filters_tpu.models import kalman_filter as jkf
from particle_filters_tpu.models import trackers as jtr
from particle_filters_tpu.models import unscented_kalman_filter as jukf
from particle_filters_tpu.simulators import lgssm as jlg
from particle_filters_tpu.simulators import sensor_network_lg as jsn
from particle_filters_tpu_torch import interop
from particle_filters_tpu_torch.benchmarks import snlg as tbench
from particle_filters_tpu_torch.models import extended_kalman_filter as tekf
from particle_filters_tpu_torch.models import kalman_filter as tkf
from particle_filters_tpu_torch.models import trackers as ttr
from particle_filters_tpu_torch.models import unscented_kalman_filter as tukf
from particle_filters_tpu_torch.simulators import lgssm as tlg
from particle_filters_tpu_torch.simulators import sensor_network_lg as tsn

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- Kalman filter ---------------------------------------------------------
@pytest.fixture(scope="module")
def lg_system():
    rng = np.random.default_rng(0)
    A = np.array([[0.9, 0.5], [0.0, 0.7]], np.float32)
    Q = np.diag([0.05, 0.02]).astype(np.float32)
    C = np.array([[1.0, 0.0], [0.3, 1.0], [0.0, 2.0]], np.float32)
    R = (0.1 * np.eye(3)).astype(np.float32)
    Y = rng.standard_normal((30, 3)).astype(np.float32)
    return A, Q, C, R, Y


@pytest.mark.parametrize("joseph", [False, True])
@pytest.mark.parametrize("varying", [False, True])
def test_kalman_filter_general(lg_system, joseph, varying):
    A, Q, C, R, Y = lg_system
    N = Y.shape[0]
    Phi = np.stack([A * (1.0 + 0.01 * k) for k in range(N)]) if varying else A
    B = np.array([[1.0], [0.5]], np.float32)
    U = np.random.default_rng(1).standard_normal((N, 1)).astype(np.float32)
    G = np.eye(2, dtype=np.float32)
    x0, P0 = np.zeros(2, np.float32), np.eye(2, dtype=np.float32)
    kw = dict(B=B, U=U, use_joseph=joseph)
    j = jkf.kalman_filter_general(jnp.asarray(Y), jnp.asarray(Phi), C, G, Q, R,
                                  x0=x0, P0=P0, **{k: jnp.asarray(v) if k != "use_joseph" else v
                                                   for k, v in kw.items()})
    t = tkf.kalman_filter_general(Y, Phi, C, G, Q, R, x0=x0, P0=P0, device=CPU, **kw)
    for name in ("x_pred", "P_pred", "x_filt", "P_filt", "K", "innov", "S"):
        np.testing.assert_allclose(getattr(t, name).numpy(), _np(getattr(j, name)), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(float(t.loglik), float(j.loglik), rtol=1e-4)


def test_kalman_filter_validates_like_jax(lg_system):
    A, Q, C, R, Y = lg_system
    with pytest.raises(ValueError, match="leading length"):
        tkf.kalman_filter_general(Y, np.stack([A] * 3), C, np.eye(2), Q, R,
                                  x0=np.zeros(2), P0=np.eye(2), device=CPU)
    with pytest.raises(ValueError, match="2D"):
        tkf.kalman_filter_general(Y[0], A, C, np.eye(2), Q, R, x0=np.zeros(2),
                                  P0=np.eye(2), device=CPU)


def test_kalman_filter_vmapped_over_sequences(lg_system):
    """torch.func.vmap over sequences equals one call per sequence (the
    batched SNLG column runs the KF so)."""
    A, Q, C, R, _ = lg_system
    Ys = _t(np.random.default_rng(2).standard_normal((3, 10, 3)).astype(np.float32))
    run = lambda y: tkf.kalman_filter_general(y, A, C, np.eye(2), Q, R, x0=np.zeros(2),  # noqa: E731
                                              P0=np.eye(2), device=CPU).x_filt
    batched = torch.func.vmap(run)(Ys)
    for b in range(3):
        torch.testing.assert_close(batched[b], run(Ys[b]), rtol=1e-6, atol=1e-6)


# --- EKF / UKF / trackers -------------------------------------------------------
NX = 3
Q3 = (0.05 * np.eye(NX) + 0.01).astype(np.float32)
R3 = np.diag([0.2, 0.1, 0.3]).astype(np.float32)


def _g(lib):
    return lambda x, u: 0.9 * x + 0.1 * lib.sin(x) + (0.0 if u is None else u)


def _h(lib):
    def h(x):
        return lib.stack([0.2 * x[0] ** 2 + x[1], x[1] + x[2], lib.exp(0.25 * x[2])])

    return h


def _zs(T=12, seed=3):
    return np.random.default_rng(seed).standard_normal((T, NX)).astype(np.float32)


M0 = np.array([0.1, -0.2, 0.3], np.float32)
P0 = (0.5 * np.eye(NX)).astype(np.float32)


@pytest.mark.parametrize("joseph,jitter", [(False, 0.0), (True, 1e-4)])
def test_ekf_run(joseph, jitter):
    jf = jekf.ExtendedKalmanFilter(_g(jnp), _h(jnp), Q3, R3, joseph=joseph, jitter=jitter)
    tf = tekf.ExtendedKalmanFilter(_g(torch), _h(torch), Q3, R3, joseph=joseph, jitter=jitter,
                                   device=CPU)
    zs = _zs()
    jfin, jm, jc = jf.run(jekf.make_ekf_state(M0, P0), jnp.asarray(zs))
    tfin, tm, tc = tf.run(tekf.make_ekf_state(M0, P0, device=CPU), zs)
    np.testing.assert_allclose(tm.numpy(), _np(jm), **TOL)
    np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)
    assert int(tfin.t) == int(jfin.t) == len(zs)


def test_ekf_with_controls_and_numerical_jacobians():
    us = (0.1 * np.random.default_rng(4).standard_normal((12, NX))).astype(np.float32)
    zs = _zs(seed=5)
    jf = jekf.ExtendedKalmanFilter(_g(jnp), _h(jnp), Q3, R3)
    tf = tekf.ExtendedKalmanFilter(_g(torch), _h(torch), Q3, R3, device=CPU)
    _, jm, _ = jf.run(jekf.make_ekf_state(M0, P0), jnp.asarray(zs), jnp.asarray(us))
    _, tm, _ = tf.run(tekf.make_ekf_state(M0, P0, device=CPU), zs, _t(us))
    np.testing.assert_allclose(tm.numpy(), _np(jm), **TOL)
    x = _t(M0)
    np.testing.assert_allclose(
        tekf.numerical_jacobian_g(_g(torch), x, None).numpy(),
        _np(jekf.numerical_jacobian_g(_g(jnp), jnp.asarray(M0), None)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tekf.numerical_jacobian_h(_h(torch), x).numpy(),
        _np(jekf.numerical_jacobian_h(_h(jnp), jnp.asarray(M0))), rtol=1e-4, atol=1e-4)
    # the AD default against the finite differences (f32, eps 1e-3)
    np.testing.assert_allclose(tf.jac_h(x).numpy(),
                               tekf.numerical_jacobian_h(_h(torch), x).numpy(), atol=2e-3)


@pytest.mark.parametrize("alpha,kappa,jitter", [(0.5, 0.0, 0.0), (1.0, 1.0, 1e-6)])
def test_ukf_run(alpha, kappa, jitter):
    jf = jukf.UnscentedKalmanFilter(_g(jnp), _h(jnp), Q3, R3, alpha=alpha, kappa=kappa,
                                    jitter=jitter)
    tf = tukf.UnscentedKalmanFilter(_g(torch), _h(torch), Q3, R3, alpha=alpha, kappa=kappa,
                                    jitter=jitter, device=CPU)
    np.testing.assert_allclose(tf.Wm.numpy(), _np(jf.Wm), rtol=1e-6)
    np.testing.assert_allclose(tf.Wc.numpy(), _np(jf.Wc), rtol=1e-6)
    zs = _zs(seed=6)
    _, jm, jc = jf.run(jukf.make_ukf_state(M0, P0), jnp.asarray(zs))
    _, tm, tc = tf.run(tukf.make_ukf_state(M0, P0, device=CPU), zs)
    np.testing.assert_allclose(tm.numpy(), _np(jm), **TOL)
    np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)


@pytest.mark.parametrize("kind", ["ekf", "ukf"])
def test_tracker_predict_update(kind):
    if kind == "ekf":
        jt = jtr.GaussianTracker(jekf.ExtendedKalmanFilter(_g(jnp), _h(jnp), Q3, R3))
        tt = ttr.EKFTracker(tekf.ExtendedKalmanFilter(_g(torch), _h(torch), Q3, R3, device=CPU))
    else:
        jt = jtr.GaussianTracker(jukf.UnscentedKalmanFilter(_g(jnp), _h(jnp), Q3, R3, alpha=0.5))
        tt = ttr.UKFTracker(tukf.UnscentedKalmanFilter(_g(torch), _h(torch), Q3, R3, alpha=0.5,
                                                       device=CPU))
    js, ts = jt.init(M0, P0), tt.init(M0, P0)
    for z in _zs(T=5, seed=7):
        js, jm, jc = jt.predict(js)
        ts, tm, tc = tt.predict(ts)
        np.testing.assert_allclose(tm.numpy(), _np(jm), **TOL)
        np.testing.assert_allclose(ts.past_mean.numpy(), _np(js.past_mean), **TOL)
        js, jm, jc = jt.update(js, jnp.asarray(z))
        ts, tm, tc = tt.update(ts, z)
        np.testing.assert_allclose(tm.numpy(), _np(jm), **TOL)
        np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)
    assert int(ts.t) == int(js.t) == 5


# --- LGSSM simulator ---------------------------------------------------------------
SYS = dict(
    A=np.array([[0.9, 0.5], [0.0, 0.7]], np.float32),
    B=np.diag([np.sqrt(0.05), np.sqrt(0.02)]).astype(np.float32),
    C=np.eye(2, dtype=np.float32),
    D=(np.sqrt(0.1) * np.eye(2)).astype(np.float32),
    Sigma=np.eye(2, dtype=np.float32),
)


def test_lgssm_recursion_given_noise():
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(2).astype(np.float32)
    V = rng.standard_normal((8, 2)).astype(np.float32)  # 3 burn-in + 5 kept
    W = rng.standard_normal((5, 2)).astype(np.float32)
    X, Y = tlg._lgssm_recursion(_t(x0), _t(V), _t(W), *(_t(SYS[k]) for k in "ABCD"))
    x, xs, ys = x0.astype(np.float64), [], []
    for v in V[:3]:
        x = SYS["A"] @ x + SYS["B"] @ v
    for v, w in zip(V[3:], W):
        xs.append(x)
        ys.append(SYS["C"] @ x + SYS["D"] @ w)
        x = SYS["A"] @ x + SYS["B"] @ v
    np.testing.assert_allclose(X.numpy(), np.array(xs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Y.numpy(), np.array(ys), rtol=1e-5, atol=1e-6)


def test_lgssm_simulate_validate_and_noise_covs():
    res = tlg.simulate_lgssm(*(SYS[k] for k in ("A", "B", "C", "D", "Sigma")), 400, seed=1,
                             burn_in=10, device=CPU)
    assert res.X.shape == (400, 2) and res.Y.shape == (400, 2) and res.X.dtype == torch.float32
    # the observation residual Y − C X is D w: its covariance is about DDᵀ
    resid = (res.Y - res.X @ _t(SYS["C"]).T).numpy()
    np.testing.assert_allclose(np.cov(resid.T), SYS["D"] @ SYS["D"].T, atol=0.03)
    with pytest.raises(ValueError, match="positive"):
        tlg.simulate_lgssm(*(SYS[k] for k in ("A", "B", "C", "D", "Sigma")), 0, device=CPU)
    with pytest.raises(ValueError, match="burn_in"):
        tlg.simulate_lgssm(*(SYS[k] for k in ("A", "B", "C", "D", "Sigma")), 5, burn_in=-1,
                           device=CPU)
    jp = jlg.LGSSMParams(*(jnp.asarray(SYS[k]) for k in ("A", "B", "C", "D", "Sigma")))
    tp = interop.lgssm_params_from_jax(jp, device=CPU)
    for a, b in zip(tlg.lgssm_noise_covs(tp), jlg.lgssm_noise_covs(jp)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6)


def test_lgssm_npz_interchangeable(tmp_path):
    jres = jlg.simulate_lgssm(*(SYS[k] for k in ("A", "B", "C", "D", "Sigma")), 20, seed=3)
    jres.to_file(str(tmp_path / "from_jax"))
    tres = tlg.LGSSMSimulationResult.from_file(str(tmp_path / "from_jax"), device=CPU)
    for k in ("X", "Y", "A", "B", "C", "D"):
        np.testing.assert_array_equal(getattr(tres, k).numpy(), _np(getattr(jres, k)))
    tres2 = tlg.simulate_lgssm(*(SYS[k] for k in ("A", "B", "C", "D", "Sigma")), 20, seed=4,
                               device=CPU)
    tres2.to_file(str(tmp_path / "from_port.npz"))
    with pytest.raises(FileExistsError):
        tres2.to_file(str(tmp_path / "from_port.npz"))
    back = jlg.LGSSMSimulationResult.from_file(str(tmp_path / "from_port.npz"))
    for k in ("X", "Y", "A", "B", "C", "D"):
        np.testing.assert_array_equal(_np(getattr(back, k)), getattr(tres2, k).numpy())


# --- SNLG simulator ----------------------------------------------------------------
@pytest.mark.parametrize("bad", [dict(d=10), dict(T=0), dict(sigmas=(1.0, -1.0)),
                                 dict(alpha1=-0.1), dict(beta=0.0)])
def test_snlg_config_validation(bad):
    with pytest.raises(ValueError):
        jsn.SNLGConfig(**bad)
    with pytest.raises(ValueError):
        tsn.SNLGConfig(**bad)


@pytest.mark.parametrize("d", [4, 64])
def test_snlg_grid_and_kernel(d):
    tc = tsn.make_grid_coords(d, device=CPU)
    jc = jsn.make_grid_coords(d)
    np.testing.assert_array_equal(tc.numpy(), _np(jc))
    np.testing.assert_allclose(tsn.se_kernel_cov(tc, 3.0, 20.0, 0.01).numpy(),
                               _np(jsn.se_kernel_cov(jc, 3.0, 20.0, 0.01)), rtol=1e-6, atol=1e-7)


def test_snlg_recursion_given_noise():
    cfg = tsn.SNLGConfig(d=4, T=6, trials=3, sigmas=(2.0, 0.5))
    L = torch.linalg.cholesky(tsn.se_kernel_cov(tsn.make_grid_coords(4, device=CPU), 3.0,
                                                20.0, 0.01))
    rng = np.random.default_rng(1)
    Ev, Ew = (rng.standard_normal((2, 3, 6, 4)).astype(np.float32) for _ in range(2))
    X, Z = tsn._snlg_recursion(L, cfg.alpha, torch.tensor(cfg.sigmas), _t(Ev), _t(Ew))
    Ln = L.numpy().astype(np.float64)
    x = np.zeros((2, 3, 4))
    for t in range(6):
        x = cfg.alpha * x + Ev[:, :, t] @ Ln.T
        np.testing.assert_allclose(X[:, :, t + 1].numpy(), x, rtol=1e-5, atol=1e-5)
        z = x + np.array(cfg.sigmas)[:, None, None] * Ew[:, :, t]
        np.testing.assert_allclose(Z[:, :, t].numpy(), z, rtol=1e-5, atol=1e-5)
    assert not X[:, :, 0].any()


def test_snlg_dataset_files_interchangeable(tmp_path):
    cfg = dict(d=4, T=5, trials=2, sigmas=(2.0, 1.0))
    tds = tsn.simulate_snlg_dataset(tsn.SNLGConfig(**cfg), device=CPU)
    assert tds.X.shape == (2, 2, 6, 4) and tds.Z.shape == (2, 2, 5, 4)
    tds.save_npz(str(tmp_path / "port.npz"))
    jds = jsn.SNLGDataset.load_npz(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(_np(jds.Z), tds.Z.numpy())
    assert jds.config == jsn.SNLGConfig(**cfg)
    jsim = jsn.simulate_snlg_dataset(jsn.SNLGConfig(**cfg))
    jsim.save_npz(str(tmp_path / "jax.npz"))
    back = tsn.SNLGDataset.load_npz(str(tmp_path / "jax.npz"), device=CPU)
    np.testing.assert_array_equal(back.X.numpy(), _np(jsim.X))
    assert back.config == tsn.SNLGConfig(**cfg)
    jsim.dump_config_json(str(tmp_path / "j.json"))
    back.dump_config_json(str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "j.json")) == json.load(open(tmp_path / "t.json"))
    conv = interop.snlg_dataset_from_jax(jsim, device=CPU)
    np.testing.assert_array_equal(conv.Sigma.numpy(), _np(jsim.Sigma))
    assert conv.config == back.config


def test_snlg_benchmark_data_is_bench_snlgs_stream():
    """The column's data: the seed-123 PCG64 stream that bench_snlg draws
    (its Σ from the JAX package's se_kernel_cov, trial-major, σ_z = 2 then 1)."""
    trials, steps, d = 2, 3, 64
    Sigma_j = np.asarray(jsn.se_kernel_cov(jsn.make_grid_coords(d), 3.0, 20.0, 0.01), np.float64)
    L = np.linalg.cholesky(Sigma_j)
    rng = np.random.default_rng(123)
    blocks = []
    for sz in (2.0, 1.0):
        X = np.zeros((trials, steps + 1, d))
        Z = np.zeros((trials, steps, d))
        for r in range(trials):
            x = np.zeros(d)
            for t in range(1, steps + 1):
                x = 0.9 * x + L @ rng.standard_normal(d)
                X[r, t] = x
                Z[r, t - 1] = x + sz * rng.standard_normal(d)
        blocks.append((X, Z))
    Sigma, *port_blocks = tbench.make_data(trials, steps, d)
    np.testing.assert_allclose(Sigma, Sigma_j, rtol=1e-6, atol=1e-7)
    for (Xj, Zj), (Xt, Zt) in zip(blocks, port_blocks):
        np.testing.assert_allclose(Xt, Xj, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(Zt, Zj, rtol=1e-5, atol=1e-5)


# --- interop ------------------------------------------------------------------------
def test_interop_round_trip_kalman_states():
    rng = np.random.default_rng(0)
    m, c = rng.standard_normal(3).astype(np.float32), P0
    for jstate in (jekf.make_ekf_state(m, c, t=4), jukf.make_ukf_state(m, c, t=2),
                   jtr.TrackerState(mean=jnp.asarray(m), cov=jnp.asarray(c),
                                    past_mean=jnp.asarray(-m), t=jnp.asarray(7, jnp.int32))):
        port = interop.state_from_jax(jstate, device=CPU)
        assert type(port).__name__ == type(jstate).__name__
        back = interop.to_numpy(port)
        for name, val in back.items():
            np.testing.assert_array_equal(val, _np(getattr(jstate, name)))
            assert val.dtype == _np(getattr(jstate, name)).dtype
        rebuilt = type(jstate)(**{k: jnp.asarray(v) for k, v in back.items()})
        jax.tree_util.tree_map(np.testing.assert_array_equal, rebuilt, jstate)
