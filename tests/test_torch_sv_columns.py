"""Port parity: the ``sv_classic`` and ``nlngssm_flows`` columns
(``benchmarks/run_benchmarks.py:98`` and ``:845``) at a toy size, and the
committed data they run on.

- ``particle_filters_tpu_torch/benchmarks/data/sv_t2000.npz`` holds the JAX
  package's SV trajectory (α 0.95, σ 0.2, β 1, seed 42, T = 2000; the
  nlngssm column's T = 1000 is its prefix) and the JAX package's reference
  values on the CPU: the EKF's and UKF's RMSE, and per key (8 keys) the SIR
  PF's RMSE at N = 2000 and EDH's, LEDH's and the KPF's at N = 500, over
  T = 1000 and over the first ``nlngssm.T_CUT`` steps of the same runs.
  The trajectory is regenerated here and held bit-equal.
- The EKF and UKF on the log-squared observations, first 200 steps: the
  port's means equal to the JAX package's within 1e-4 (f32 filters of
  order one over 200 steps), their RMSEs within 1e-5 relative.
- The whole columns at a toy size (T = 40; N = 200 for the SIR PF, 50 for
  the flows and the KPF, 2 seeds): finite, tracking (RMSE < 2), B2
  launched 0 times on the CPU (its plain version runs there), and the
  columns' gates evaluated as the modules state them.

Run this file as a script to write the data and print the JAX package's
reference values again (about a minute on 8 cores):

    JAX_PLATFORMS=cpu python tests/test_torch_sv_columns.py
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

from particle_filters_tpu.models import (  # noqa: E402
    EDHConfig,
    EDHFlowPF,
    ExtendedKalmanFilter,
    GaussianTracker,
    KernelParticleFilter,
    KPFConfig,
    LEDHConfig,
    LEDHFlowPF,
    Model,
    ParticleFilter,
    UnscentedKalmanFilter,
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_tpu.simulators import simulate_sv_1d  # noqa: E402
from particle_filters_tpu_torch.benchmarks import nlngssm as tnl  # noqa: E402
from particle_filters_tpu_torch.benchmarks import sv_classic as tsv  # noqa: E402

torch.set_num_threads(1)

AL, SG, BT = tsv.ALPHA, tsv.SIGMA, tsv.BETA
KEYS = 8


def jax_data():
    sv = simulate_sv_1d(tsv.T, AL, SG, BT, seed=42)
    return np.asarray(sv.X, np.float32), np.asarray(sv.Y, np.float32)


def _rmse(m, x):
    return float(np.sqrt(np.mean((np.asarray(m).reshape(-1) - x) ** 2)))


def jax_kalman(X, Y, t):
    """bench_sv_classic's EKF and UKF on the first ``t`` log-squared
    observations: (EKF means, UKF means)."""
    y_log = jnp.log(jnp.asarray(Y[:t]) ** 2 + 1e-8)[:, None]
    gm = lambda x, u: AL * x  # noqa: E731
    hm = lambda x: x + jnp.log(BT**2) - 1.2704  # noqa: E731
    Q, R = jnp.array([[SG**2]]), jnp.array([[np.pi**2 / 2]])
    ekf = ExtendedKalmanFilter(gm, hm, Q, R)
    ukf = UnscentedKalmanFilter(gm, hm, Q, R, alpha=1.0)
    me = jax.jit(lambda z: ekf.run(make_ekf_state(jnp.zeros(1), jnp.eye(1)), z)[1])(y_log)
    mu = jax.jit(lambda z: ukf.run(make_ukf_state(jnp.zeros(1), jnp.eye(1)), z)[1])(y_log)
    return np.asarray(me)[:, 0], np.asarray(mu)[:, 0]


def jax_pf_rmses(X, Y, keys=KEYS):
    def obs_ll(x, z):
        var = BT**2 * jnp.exp(x[0])
        return -0.5 * (z[0] ** 2 / var + jnp.log(var))

    pf = ParticleFilter(lambda x, u: AL * x, None, jnp.array([[SG**2]]), None, Np=tsv.N_PF,
                        obs_loglik=obs_ll)
    run = jax.jit(lambda k, s: pf.run(k, s, jnp.asarray(Y)[:, None])[1]["mean"])
    out = []
    for k in range(keys):
        key = jax.random.PRNGKey(k)
        st = pf.initialize(jax.random.fold_in(key, 0), jnp.zeros(1),
                           jnp.array([[SG**2 / (1 - AL**2)]]))
        out.append(_rmse(run(jax.random.fold_in(key, 1), st), X))
    return out


def jax_flow_rmses(X, Y, keys=KEYS):
    """bench_nlngssm_flows' EDH, LEDH and KPF per key: ``{name: (rmse over
    T, rmse over the first T_CUT steps)}`` lists."""
    T, N = tnl.T, tnl.N
    zs = jnp.asarray(Y[:T])[:, None]
    x = X[:T]
    g = lambda x, u, v: AL * x + (v if v is not None else 0.0)  # noqa: E731
    h = lambda x: jnp.zeros(1)  # noqa: E731
    jh = lambda x: jnp.zeros((1, 1))  # noqa: E731
    R = jnp.array([[tnl.R_NOM]])
    Q = jnp.array([[SG**2]])
    var0 = SG**2 / (1 - AL**2)

    def log_trans(xn, xo):
        return -0.5 * ((xn[0] - AL * xo[0]) ** 2 / SG**2)

    def log_like(z, xx):
        var = BT**2 * jnp.exp(xx[0])
        return -0.5 * (z[0] ** 2 / var + jnp.log(var))

    ns = lambda k, n, nx: SG * jax.random.normal(k, (n, nx))  # noqa: E731
    out = {}
    for name, cls, cfg in (
        ("edh", EDHFlowPF, EDHConfig(n_particles=N, n_lambda_steps=tnl.N_LAMBDA,
                                     flow_integrator="rk4")),
        ("ledh", LEDHFlowPF, LEDHConfig(n_particles=N, n_lambda_steps=tnl.N_LAMBDA,
                                        resample_ess_ratio=0.5)),
    ):
        tracker = GaussianTracker(UnscentedKalmanFilter(lambda x, u: AL * x, h, Q, R,
                                                        alpha=0.5))
        filt = cls(tracker, g, h, jh, log_trans, log_like, R, cfg)
        run = jax.jit(lambda k, s, t, f=filt: f.run(k, s, t, zs, process_noise_sampler=ns)[2])
        rows = []
        for k in range(keys):
            key = jax.random.PRNGKey(k)
            st = filt.init_from_gaussian(key, jnp.zeros(1), jnp.array([[var0]]))
            m = np.asarray(run(key, st, tracker.init(jnp.zeros(1),
                                                     jnp.array([[var0]])))["mean"])[:, 0]
            rows.append((_rmse(m, x), _rmse(m[:tnl.T_CUT], x[:tnl.T_CUT])))
            print(name, k, rows[-1], flush=True)
        out[name] = rows
    kpf = KernelParticleFilter(Model(H=h, JH=jh, R=R), KPFConfig(max_steps=tnl.KPF_MAX_STEPS))
    analyze = jax.jit(lambda Xp, y: kpf.analyze(Xp, y).particles)

    def kpf_run(key):
        def body(carry, inp):
            (Xp,) = carry
            k, z = inp
            Xp = AL * Xp + SG * jax.random.normal(k, Xp.shape)
            Xp = analyze(Xp, z)
            return (Xp,), jnp.mean(Xp)

        X0 = jnp.sqrt(var0) * jax.random.normal(key, (N, 1))
        return jax.lax.scan(body, (X0,), (jax.random.split(key, T), zs))[1]

    kpf_run = jax.jit(kpf_run)
    rows = []
    for k in range(keys):
        m = np.asarray(kpf_run(jax.random.PRNGKey(k)))
        rows.append((_rmse(m, x), _rmse(m[:tnl.T_CUT], x[:tnl.T_CUT])))
        print("kpf", k, rows[-1], flush=True)
    out["kpf"] = rows
    return out


def write_data(path=tsv.DATA):
    X, Y = jax_data()
    me, mu = jax_kalman(X, Y, tsv.T)
    pf = jax_pf_rmses(X, Y)
    print("pf", pf, flush=True)
    flows = jax_flow_rmses(X, Y)
    arrays = {"X": X, "Y": Y, "jax_ekf_rmse": np.float64(_rmse(me, X)),
              "jax_ukf_rmse": np.float64(_rmse(mu, X)), "jax_pf_rmse": np.asarray(pf)}
    for name, rows in flows.items():
        arrays[f"jax_{name}_rmse"] = np.asarray([r[0] for r in rows])
        arrays[f"jax_{name}_rmse_cut"] = np.asarray([r[1] for r in rows])
    np.savez(path, **arrays)
    for k, v in arrays.items():
        if k not in ("X", "Y"):
            print(k, v.tolist() if v.ndim else float(v))


# --- tests -------------------------------------------------------------------
@pytest.fixture(scope="module")
def data():
    return tsv.load_data("cpu")


def test_committed_data_is_the_jax_trajectory(data):
    X, Y = jax_data()
    np.testing.assert_array_equal(data["X"].numpy(), X)
    np.testing.assert_array_equal(data["Y"].numpy(), Y)
    for name in ("pf", "edh", "ledh", "kpf"):
        assert data[f"jax_{name}_rmse"].shape == (KEYS,)
    for name in ("edh", "ledh", "kpf"):
        assert data[f"jax_{name}_rmse_cut"].shape == (KEYS,)


def test_kalman_rows_match_jax(data):
    t = 200
    X, Y = data["X"].numpy(), data["Y"].numpy()
    me, mu = jax_kalman(X, Y, t)
    res = tsv.run_kalman(torch.device("cpu"), data, t)
    np.testing.assert_allclose(res["ekf"]["means"].numpy(), me, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["ukf"]["means"].numpy(), mu, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["ekf"]["rmse"], _rmse(me, X[:t]), rtol=1e-5)
    np.testing.assert_allclose(res["ukf"]["rmse"], _rmse(mu, X[:t]), rtol=1e-5)


def test_sv_classic_column_toy(data):
    res = tsv.run_column("cpu", data, t=40, n_pf=200, seeds=2)
    assert all(np.isfinite(r) and r < 2.0 for r in res["pf"]["rmses"])
    assert res["pf"]["b2_launches"] == 0 and res["pf"]["resample_steps"] > 0
    gates = tsv.gates(res, data, full=False)
    assert [g.split()[0] for g in gates] == ["ekf", "ukf", "pf"]
    assert all(np.isfinite(v) for v, _ in gates.values())


@pytest.mark.parametrize("name", ["edh", "ledh", "kpf"])
def test_nlngssm_column_toy(data, name):
    res = tnl.run_column("cpu", data, t=40, n=50, seeds=2, names=(name,))
    assert all(np.isfinite(r) and r < 2.0 for r in res[name]["rmses"])
    gates = tnl.gates(res, data, cut=True)
    assert [g.split()[0] for g in gates] == [name]
    assert all(np.isfinite(p) for p, _ in gates.values())


if __name__ == "__main__":
    write_data()
