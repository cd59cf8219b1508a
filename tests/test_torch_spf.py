"""Port parity: the stochastic particle flow against the JAX package, and
the committed SPF example-2 data.

Tolerances (f32):
- ``LinearGaussianBayes`` fields, scores and Kalman posterior to 1e-6
  relative (2×2 and 9×9 inverses of well-scaled matrices); κ₂ and dκ₂/dβ
  to 1e-5;
- ``linspace``: the λ grids (0 to 1) equal the JAX package's bit for bit,
  the β table's grid [−0.5, 1.5] within one ulp of 1.5;
- β* against the JAX package at n_grid = 101 (tabulated and exact
  right-hand sides, multisection and bisection): β to 1e-5 and β' to 1e-5
  relative, the JAX package's own root resolution being ~1e-6; at example
  1's near-singular prior (n_grid 201) β to 1e-4 and β' to 5e-5 relative
  (λ_min of M(β) crosses zero 7e-4 outside the domain, so eigenvalues a
  few ulps apart move the slope);
- ``bounded`` equal to the while-loop bracket bit for bit; a batch of
  problems equal to each solved alone to 1e-6;
- the SDE fed the JAX package's draws: the final cloud to 2e-6 relative of
  its scale with linear β, 1e-4 with optimal β (the β schedules differ at
  f32 resolution);
- ``benchmarks/data/spf_example2.npz``'s trajectories and observations
  equal to the JAX package's ``simulate`` draws (its ``jax_rmse``, the JAX
  package's filters' per-run RMSEs, are written by the script below).

Run as a script, this file prints the JAX package's example-1 RMSEs over 8
key sets on the CPU (``JAX_EX1`` of ``benchmarks/spf.py``) and writes
``spf_example2.npz`` again, with the JAX package's per-run RMSEs of its
three example-2 filters on the example's keys (``jax_rmse``; ~25 min on 8
cores, most of it the optimal SPF):

    JAX_PLATFORMS=cpu python tests/test_torch_spf.py
"""

import os
import sys

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from particle_filters_tpu.models import stochastic_particle_filter as js  # noqa: E402
from particle_filters_tpu_torch import interop  # noqa: E402
from particle_filters_tpu_torch.benchmarks import spf as tbench  # noqa: E402
from particle_filters_tpu_torch.models import stochastic_particle_filter as ts  # noqa: E402

torch.set_num_threads(1)

CPU = "cpu"


def make_models(n=2, d=2, obs_scale=0.2, prior_corr=0.3):
    """The JAX package's ``make_model`` in both packages."""
    P0 = (np.eye(n) + prior_corr * (np.ones((n, n)) - np.eye(n))).astype(np.float32)
    H = np.eye(d, n, dtype=np.float32)
    R = (obs_scale * np.eye(d)).astype(np.float32)
    m0 = np.arange(1, n + 1, dtype=np.float32)
    z = np.zeros(d, np.float32)
    return (js.LinearGaussianBayes.create(m0, P0, H, R, z),
            ts.LinearGaussianBayes.create(m0, P0, H, R, z, device=CPU))


def example1_models():
    sensors = jnp.array(tbench.SENSORS)
    x_prior = jnp.array(tbench.X_PRIOR)

    def h(x):
        dd = x[None, :] - sensors
        return jnp.arctan2(dd[:, 1], dd[:, 0])

    H = jax.jacfwd(h)(x_prior)
    z_adj = jnp.array(tbench.Z1) - (h(x_prior) - H @ x_prior)
    jm = js.LinearGaussianBayes.create(m0=x_prior, P0=jnp.diag(jnp.array(tbench.P_PRIOR_DIAG)),
                                       H=H, R=tbench.R1 * jnp.eye(2), z=z_adj)
    return jm, tbench.example1_model(CPU)


def _stack(models):
    return ts.LinearGaussianBayes(*[torch.stack([getattr(m, f.name) for m in models])
                                    for f in dataclasses.fields(ts.LinearGaussianBayes)])


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


# ------------------------------- the model -----------------------------------


def test_linear_gaussian_bayes_matches_jax():
    jm, tm = make_models(n=3, d=2, obs_scale=0.5, prior_corr=0.4)
    for f in dataclasses.fields(ts.LinearGaussianBayes):
        _close(getattr(tm, f.name), getattr(jm, f.name), 1e-6, 1e-6)
    x = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    _close(tm.grad_log_p0(torch.tensor(x)), jm.grad_log_p0(jnp.asarray(x)), 1e-6, 1e-6)
    _close(tm.grad_log_h(torch.tensor(x)), jm.grad_log_h(jnp.asarray(x)), 1e-6, 1e-6)
    for a, b in zip(tm.kalman_posterior(), jm.kalman_posterior()):
        _close(a, b, 1e-6, 1e-6)
    back = interop.linear_gaussian_bayes_from_jax(jm, device=CPU)
    for f in dataclasses.fields(ts.LinearGaussianBayes):
        assert torch.equal(getattr(back, f.name), torch.tensor(np.asarray(getattr(jm, f.name))))
    again = js.LinearGaussianBayes(**{k: jnp.asarray(v) for k, v in interop.to_numpy(tm).items()})
    _close(again.Mh, jm.Mh, 1e-6, 1e-6)
    assert tm.n == 3 and tm.d == 2 and tm.batch_shape == ()


def test_batched_model_equals_each_model():
    pairs = [make_models(obs_scale=s, prior_corr=c) for s, c in ((0.2, 0.3), (1.0, 0.0), (3.0, -0.2))]
    bm = _stack([t for _, t in pairs])
    x = torch.tensor(np.random.default_rng(1).standard_normal((3, 4, 2)).astype(np.float32))
    for i, (_, tm) in enumerate(pairs):
        _close(bm.grad_log_h(x)[i], tm.grad_log_h(x[i]), 1e-6, 1e-6)
        _close(bm.grad_log_p0(x)[i], tm.grad_log_p0(x[i]), 1e-6, 1e-6)
        _close(bm.kalman_posterior()[0][i], tm.kalman_posterior()[0], 1e-6, 1e-6)
    built = ts.LinearGaussianBayes.create(bm.m0, bm.P0, bm.H, bm.R, bm.z, device=CPU)
    _close(built.Mh, bm.Mh, 1e-6, 1e-6)
    assert built.batch_shape == (3,)


def test_shape_validation():
    with pytest.raises(ValueError, match="Inconsistent"):
        ts.LinearGaussianBayes.create(np.zeros(2), np.eye(3), np.eye(2), np.eye(2), np.zeros(2),
                                      device=CPU)


def test_kappa2_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((4, 4)).astype(np.float32)
    M = (a @ a.T + np.eye(4)).astype(np.float32)
    dM = np.diag([0.0, 1.0, 2.0, 0.5]).astype(np.float32)
    for x, y in zip(ts.kappa2_and_derivative(torch.tensor(M), torch.tensor(dM)),
                    js.kappa2_and_derivative(jnp.asarray(M), jnp.asarray(dM))):
        _close(x, y, 1e-5)
    k, dk = ts.kappa2_and_derivative(torch.diag(torch.tensor([1.0, 4.0])),
                                     torch.diag(torch.tensor([0.0, 1.0])))
    assert abs(float(k) - 4.0) < 1e-5 and abs(float(dk) - 1.0) < 1e-4


def test_chunked_eigh_equals_one_call(monkeypatch):
    """The eigendecomposition in chunks (cuSOLVER's batch limit on the
    card) equals one call, bit for bit."""
    a = torch.randn((3, 7, 4, 4), generator=torch.Generator().manual_seed(0))
    a = a @ a.mT
    w, V = torch.linalg.eigh(a)
    monkeypatch.setattr(ts, "EIGH_BATCH", 5)
    wc, Vc = ts.eigh(a)
    assert torch.equal(w, wc) and torch.equal(V, Vc)


def test_linspace_is_jaxs():
    for num in (51, 64, 101, 301, 1001):
        np.testing.assert_array_equal(ts.linspace(0.0, 1.0, num).numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, num, dtype=jnp.float32)))
    tab = ts.linspace(-0.5, 1.5, 2048).numpy()
    j = np.asarray(jnp.linspace(-0.5, 1.5, 2048, dtype=jnp.float32))
    assert np.all(np.abs(tab - j) <= np.spacing(np.float32(1.5)))  # an ulp of the end point


# ---------------------------------- β* ---------------------------------------


@pytest.mark.parametrize("rhs_mode,solver", [("tabulated", "multisection"),
                                             ("exact", "multisection"),
                                             ("tabulated", "bisection")])
def test_beta_star_matches_jax(rhs_mode, solver):
    jm, tm = make_models()
    a = js.solve_beta_star_bisection(jm.M0, jm.Mh, mu=0.2, n_grid=101, rhs_mode=rhs_mode,
                                     solver=solver)
    b = ts.solve_beta_star_bisection(tm.M0, tm.Mh, mu=0.2, n_grid=101, rhs_mode=rhs_mode,
                                     solver=solver)
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
    _close(b[1], a[1], 0, 1e-5)
    _close(b[2], a[2], 1e-5, 1e-6)
    assert float(b[1][0]) == 0.0 and float(b[1][-1]) == 1.0


def test_beta_star_near_singular_prior_matches_jax():
    jm, tm = example1_models()
    for f in ("M0", "Mh", "z"):
        _close(getattr(tm, f), getattr(jm, f), 1e-6, 1e-6)
    a = js.solve_beta_star_bisection(jm.M0, jm.Mh, mu=0.2, n_grid=201)
    b = ts.solve_beta_star_bisection(tm.M0, tm.Mh, mu=0.2, n_grid=201)
    _close(b[1], a[1], 0, 1e-4)
    _close(b[2], a[2], 5e-5)


def test_bounded_bracket_equals_while_loop():
    _, tm = make_models(obs_scale=0.2, prior_corr=0.0)
    kw = dict(mu=0.2, n_grid=51, solver="bisection", max_bisect_iter=30)
    for x, y in zip(ts.solve_beta_star_bisection(tm.M0, tm.Mh, bounded=False, **kw),
                    ts.solve_beta_star_bisection(tm.M0, tm.Mh, bounded=True, **kw)):
        assert torch.equal(x, y)


def test_batched_beta_star_equals_looped():
    models = [make_models(obs_scale=s, prior_corr=c)[1]
              for s, c in ((0.2, 0.3), (0.05, 0.0), (2.0, 0.5))]
    bm = _stack(models)
    mus = torch.tensor([0.2, 0.01, 0.5])
    _, bb, bd = ts.solve_beta_star_bisection(bm.M0, bm.Mh, mu=mus, n_grid=101)
    assert bb.shape == (3, 101)
    for i, m in enumerate(models):
        _, b, d = ts.solve_beta_star_bisection(m.M0, m.Mh, mu=float(mus[i]), n_grid=101)
        _close(bb[i], b, 0, 1e-6)
        _close(bd[i], d, 1e-6, 1e-6)


def test_mu_zero_is_linear_and_invalid_modes_raise():
    _, tm = make_models()
    lam, beta, _ = ts.solve_beta_star_bisection(tm.M0, tm.Mh, mu=0.0, n_grid=51)
    _close(beta, lam, 0, 1e-4)
    with pytest.raises(ValueError, match="rhs_mode"):
        ts.solve_beta_star_bisection(tm.M0, tm.Mh, mu=0.1, rhs_mode="bogus")
    with pytest.raises(ValueError, match="solver"):
        ts.solve_beta_star_bisection(tm.M0, tm.Mh, mu=0.1, solver="bogus")
    with pytest.raises(ValueError, match="beta_mode"):
        ts.run_generalized_spf(tm, N=10, n_steps=5, beta_mode="bogus")
    with pytest.raises(ValueError, match="Q_mode"):
        ts.run_generalized_spf(tm, N=10, n_steps=5, Q_mode="bogus")


# ---------------------------------- SDE --------------------------------------


@pytest.mark.parametrize("beta_mode,Q_mode,rtol", [("linear", "inv_M", 2e-6),
                                                   ("linear", "scaled_identity", 2e-6),
                                                   ("optimal", "inv_M", 1e-4)])
def test_sde_from_jax_draws(beta_mode, Q_mode, rtol):
    jm, tm = make_models(obs_scale=0.1)
    N, S = 64, 80
    key = jax.random.PRNGKey(3)
    k_init, k_noise = jax.random.split(key)
    eps0 = np.asarray(jax.random.normal(k_init, (N, 2), jnp.float32))
    noise = np.asarray(jax.random.normal(k_noise, (S, N, 2), jnp.float32))
    jX, jmean, jinfo = js.run_generalized_spf(jm, N=N, n_steps=S, beta_mode=beta_mode, mu=0.2,
                                              Q_mode=Q_mode, key=key)
    tX, tmean, tinfo = ts.run_generalized_spf(tm, N=N, n_steps=S, beta_mode=beta_mode, mu=0.2,
                                              Q_mode=Q_mode, normals=(eps0, noise))
    scale = float(np.abs(np.asarray(jX)).max())
    _close(tX, jX, 0, rtol * scale)
    _close(tmean, jmean, 0, rtol * scale)
    for k in ("lam", "beta", "betadot"):
        _close(tinfo[k], jinfo[k], 1e-5, 1e-5)


def test_runs_axis_equals_separate_runs():
    """Draws with a leading run axis on one model equal one call a run."""
    _, tm = make_models(obs_scale=0.3)
    g = torch.Generator().manual_seed(0)
    eps0, noise = ts.draw_spf_normals(g, 16, 2, 30, (3,))
    X, mean, _ = ts.run_generalized_spf(tm, N=16, n_steps=30, beta_mode="optimal", mu=0.1,
                                        normals=(eps0, noise))
    assert X.shape == (3, 16, 2) and mean.shape == (3, 2)
    for r in range(3):
        Xr, _, _ = ts.run_generalized_spf(tm, N=16, n_steps=30, beta_mode="optimal", mu=0.1,
                                          normals=(eps0[r], noise[:, r]))
        _close(X[r], Xr, 1e-6, 1e-6)


def test_spf_reaches_the_kalman_posterior():
    """The JAX package's golden case (informative observation, optimal β):
    the cloud's mean within 0.1 of the exact posterior mean."""
    _, tm = make_models(obs_scale=0.1, prior_corr=0.0)
    X, x_hat, info = ts.run_generalized_spf(tm, N=4000, n_steps=200, beta_mode="optimal",
                                            generator=torch.Generator().manual_seed(0))
    m_post, P_post = tm.kalman_posterior()
    _close(x_hat, m_post, 0, 0.1)
    _close(torch.cov(X.T), P_post, 0.35, 0.05)
    assert float(info["beta"][-1]) == 1.0


# ------------------------------ example 2 ------------------------------------


I3, Z3 = np.eye(3), np.zeros((3, 3))
A2 = tbench.GAMMA * np.block([[-I3, I3, Z3], [Z3, -I3, I3], [Z3, Z3, -I3]])


def jax_h_meas(s):
    x, y, z = s[0], s[1], s[2]
    return jnp.array([jnp.arctan2(x, y), jnp.arctan2(z, jnp.hypot(x, y))])


def jax_simulate(key):
    """``examples/10_spf_example2.py``'s ``simulate``."""
    A = jnp.asarray(A2)
    s0 = jnp.array([40.0, 40.0, 40.0, 8.0, 0.0, -3.0, 0.0, 0.0, 0.0])
    R = tbench.R2 * jnp.eye(2)

    def body(s, k):
        s = s + A @ s * tbench.DT
        z = jax_h_meas(s) + jax.random.multivariate_normal(k, jnp.zeros(2), R)
        return s, (s, z)

    _, (traj, zs) = jax.lax.scan(body, s0, jax.random.split(key, tbench.T2))
    return jnp.concatenate([s0[None], traj]), zs


def jax_example2_data():
    keys = jax.random.split(jax.random.PRNGKey(100), tbench.RUNS2)
    sim_keys = jax.vmap(lambda k: jax.random.split(k, 4)[0])(keys)
    traj, zs = jax.vmap(jax_simulate)(sim_keys)
    return np.asarray(traj), np.asarray(zs)


def test_committed_example2_data_is_the_jax_packages():
    traj, zs = jax_example2_data()
    d = np.load(tbench.DATA)
    np.testing.assert_array_equal(d["traj"], traj)
    np.testing.assert_array_equal(d["zs"], zs)


def test_example2_measurement_and_filters_at_a_toy_size():
    x = np.array([30.0, 20.0, 5.0, 1, 1, 1, 0, 0, 0], np.float32)
    _close(tbench.h_meas(torch.tensor(x)), jax_h_meas(jnp.asarray(x)), 1e-6)
    _close(torch.func.jacfwd(tbench.h_meas)(torch.tensor(x)),
           jax.jacfwd(jax_h_meas)(jnp.asarray(x)), 1e-5, 1e-7)
    res = tbench.run_example2(CPU, steps=1)
    for name in tbench.FILTERS2:
        assert res[name]["finite"] and set(res[name]["rmse"]) == set(tbench.BLOCKS)
    ex1 = tbench.run_example1(CPU, runs=2, sets=2)
    assert all(len(r["rmses"]) == 2 for r in ex1.values())
    assert all(r["finite"] for r in ex1.values())


# ------------------------------ the script -----------------------------------


def _jax_references():  # pragma: no cover - run by hand
    import time

    from particle_filters_tpu.models import ParticleFilter

    traj, zs = jax_example2_data()

    jm, _ = example1_models()
    x_true = jnp.array(tbench.X_TRUE)
    ex1 = {}
    for mode in ("linear", "optimal"):
        f = jax.jit(jax.vmap(lambda k: js.run_generalized_spf(
            jm, N=tbench.N1, n_steps=tbench.STEPS1, beta_mode=mode, mu=tbench.MU1, key=k)[1]))
        vals = []
        for s in range(8):
            means = f(jax.random.split(jax.random.PRNGKey(s), tbench.RUNS1))
            vals.append(float(jnp.mean(jnp.linalg.norm(means - x_true, axis=1))))
        ex1[mode] = vals
        print(mode, vals, flush=True)

    A = jnp.asarray(A2)
    P_upd = jnp.diag(jnp.array(tbench.P_UPDATE_DIAG))
    R = tbench.R2 * jnp.eye(2)
    s_prior = jnp.array(tbench.S_PRIOR0)

    def spf_filter(key, zs_, beta_mode):
        def body(x_est, inp):
            k, z = inp
            x_pred = x_est + A @ x_est * tbench.DT
            H = jax.jacfwd(jax_h_meas)(x_pred)
            z_adj = z - (jax_h_meas(x_pred) - H @ x_pred)
            model = js.LinearGaussianBayes.create(x_pred, P_upd, H, R, z_adj)
            _, x_hat, _ = js.run_generalized_spf(model, N=tbench.N_SPF, n_steps=tbench.STEPS2,
                                                 beta_mode=beta_mode, mu=tbench.MU2,
                                                 Q_mode="inv_M", key=k)
            return x_hat, x_hat

        _, ests = jax.lax.scan(body, s_prior, (jax.random.split(key, tbench.T2), zs_))
        return jnp.concatenate([s_prior[None], ests])

    def sir_filter(key, zs_):
        pf = ParticleFilter(g=lambda x, u: x + A @ x * tbench.DT, h=jax_h_meas,
                            Q=1e-4 * jnp.eye(9), R=R, Np=tbench.N_SIR, resample_thresh=0.5,
                            regularize_after_resample=True)
        k0, k1 = jax.random.split(key)
        st = pf.initialize(k0, s_prior, jnp.diag(jnp.array(tbench.P_PRIOR0_DIAG)))
        _, hist = pf.run(k1, st, zs_)
        return jnp.concatenate([s_prior[None], hist["mean"]])

    keys = jax.random.split(jax.random.PRNGKey(100), tbench.RUNS2)
    run = jax.jit(jax.vmap(lambda ko, kl, ks, z: {
        "spf_optimal": spf_filter(ko, z, "optimal"), "spf_linear": spf_filter(kl, z, "linear"),
        "sir_pf": sir_filter(ks, z)}))
    fk = [jax.vmap(lambda k: jax.random.split(k, 4)[i])(keys) for i in (1, 2, 3)]
    t0 = time.perf_counter()
    ests = run(*fk, jnp.asarray(zs))
    jax.block_until_ready(ests)
    print(f"example 2 on the example's keys: {time.perf_counter() - t0:.1f} s", flush=True)
    # Per-run RMSE: (filter, window, block, run), windows the first 10 steps
    # (chip_smoke's) and all 50.
    per_run = np.zeros((len(tbench.FILTERS2), len(tbench.WINDOWS2), len(tbench.BLOCKS),
                        tbench.RUNS2))
    for i, name in enumerate(tbench.FILTERS2):
        e = np.asarray(ests[name])
        for j, steps in enumerate(tbench.WINDOWS2):
            for k, sl in enumerate(tbench.BLOCKS.values()):
                err = e[:, :steps + 1, sl] - traj[:, :steps + 1, sl]
                per_run[i, j, k] = np.linalg.norm(err, axis=-1).mean(axis=1)
    np.savez(tbench.DATA, traj=traj, zs=zs, jax_rmse=per_run)
    print(f"wrote {tbench.DATA} with the per-run RMSEs; means over runs "
          f"{per_run.mean(-1).tolist()}")
    print(f"JAX_EX1 = {ex1!r}")


if __name__ == "__main__":
    _jax_references()
