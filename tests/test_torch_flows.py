"""Port parity: the EDH and LEDH flow filters against the JAX package, their
batched trials, the batched resample, and the SNLG column at a toy size.

Both packages start from one state (carried across by ``interop``) and take
the same process noise, numpy arrays returned by ``process_noise_sampler``,
one ``step`` call per t, with resampling off (the resample draws u from
different streams; it is checked separately given the same u). The model
is a 2×2 sensor grid with a nonlinear measurement h(x) = x + 0.2 sin x, so
the LEDH's per-particle Jacobians differ. Tolerances over T = 5 steps:
means, covariances and log-weights to rtol/atol 2e-4 (f32 flows of order
one, whose RK4/Euler sums and Cholesky solves round in other orders), the
condition numbers to rtol 1e-3 (power iteration, as in test_torch_linalg).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu.core import linalg as jlin
from particle_filters_tpu.core import weights as jw
from particle_filters_tpu.models import edh_particle_filter as jedh
from particle_filters_tpu.models import extended_kalman_filter as jekf
from particle_filters_tpu.models import kalman_filter as jkf
from particle_filters_tpu.models import ledh_particle_filter as jledh
from particle_filters_tpu.models import trackers as jtr
from particle_filters_tpu.models import unscented_kalman_filter as jukf
from particle_filters_tpu.resampling import hard as jhard
from particle_filters_tpu.simulators import sensor_network_lg as jsn
from particle_filters_tpu_torch import interop
from particle_filters_tpu_torch.benchmarks import snlg as tbench
from particle_filters_tpu_torch.core import linalg as tlin
from particle_filters_tpu_torch.core.structs import stack_states
from particle_filters_tpu_torch.models import edh_particle_filter as tedh
from particle_filters_tpu_torch.models import extended_kalman_filter as tekf
from particle_filters_tpu_torch.models import ledh_particle_filter as tledh
from particle_filters_tpu_torch.models import trackers as ttr
from particle_filters_tpu_torch.ops.resample import resample_by_starts
from particle_filters_tpu_torch.resampling import hard as thard

torch.set_num_threads(1)

D, T, AL, SZ = 4, 5, 0.9, 0.7
TOL = dict(rtol=2e-4, atol=2e-4)
CPU = "cpu"
SIGMA = np.asarray(jsn.se_kernel_cov(jsn.make_grid_coords(D), 1.0, 4.0, 0.05), np.float32)
LQ = np.linalg.cholesky(SIGMA.astype(np.float64) + 1e-6 * np.eye(D)).astype(np.float32)


def _model(lib, eye, chol):
    """(tracker args, flow callables) of the test model in ``lib``."""
    LQ_, LR = lib_arr(lib, LQ), SZ * eye
    g = lambda x, u, v: AL * x + v  # noqa: E731
    h = lambda x: x + 0.2 * lib.sin(x)  # noqa: E731
    jh = lambda x: eye + 0.2 * lib.diag(lib.cos(x))  # noqa: E731
    lt = lambda xn, xo: chol(xn, AL * xo, LQ_)  # noqa: E731
    ll = lambda z, x: chol(z, h(x), LR)  # noqa: E731
    return g, h, jh, lt, ll


def lib_arr(lib, a):
    return jnp.asarray(a) if lib is jnp else torch.from_numpy(np.array(a))


def _filters(kind, cfg_kw):
    R = (SZ**2 * np.eye(D)).astype(np.float32)
    jg, jh_, jjh, jlt, jll = _model(jnp, jnp.eye(D), jlin.mvn_logpdf_chol)
    tg, th, tjh, tlt, tll = _model(torch, torch.eye(D), tlin.mvn_logpdf_chol)
    jtrack = jtr.GaussianTracker(jekf.ExtendedKalmanFilter(lambda x, u: AL * x, jh_, SIGMA, R))
    ttrack = ttr.GaussianTracker(tekf.ExtendedKalmanFilter(lambda x, u: AL * x, th, SIGMA, R,
                                                           device=CPU))
    if kind == "edh":
        jf = jedh.EDHFlowPF(jtrack, jg, jh_, jjh, jlt, jll, R, jedh.EDHConfig(**cfg_kw))
        tf = tedh.EDHFlowPF(ttrack, tg, th, tjh, tlt, tll, R, tedh.EDHConfig(**cfg_kw),
                            device=CPU)
    else:
        jf = jledh.LEDHFlowPF(jtrack, jg, jh_, jjh, jlt, jll, R, jledh.LEDHConfig(**cfg_kw))
        tf = tledh.LEDHFlowPF(ttrack, tg, th, tjh, tlt, tll, R, tledh.LEDHConfig(**cfg_kw),
                              device=CPU)
    return jf, tf


def _trial_data(n, seed):
    """Initial cloud, observations and process noise of one trial."""
    rng = np.random.default_rng(seed)
    p0 = (rng.standard_normal((n, D)) @ LQ.T).astype(np.float32)
    zs = (rng.standard_normal((T, D)) * 1.5).astype(np.float32)
    V = (rng.standard_normal((T, n, D)) @ LQ.T).astype(np.float32)
    return p0, zs, V


def _jax_state(p0, n_lambda):
    logw = jw.uniform_logw(p0.shape[0])
    mean, cov = jw.weighted_mean_cov(jnp.asarray(p0), logw)
    return jedh.FlowPFState(particles=jnp.asarray(p0), weights=jnp.exp(logw), log_weights=logw,
                            mean=mean, cov=cov,
                            diagnostics={"condition_numbers": jnp.zeros(n_lambda),
                                         "resampled": jnp.asarray(False)})


CONFIGS = [
    ("edh", dict(n_particles=64, n_lambda_steps=4, resample_ess_ratio=0.0), {}),
    ("edh", dict(n_particles=128, n_lambda_steps=3, resample_ess_ratio=0.0,
                 flow_integrator="euler", cond_mode="eigh"), {}),
    ("ledh", dict(n_particles=64, n_lambda_steps=4), {}),
    ("ledh", dict(n_particles=96, n_lambda_steps=3, cond_mode="eigh"),
     dict(beta_schedule=np.array([0.0, 0.2, 0.55, 1.0], np.float32))),
]


@pytest.mark.parametrize("kind,cfg_kw,flow_kw", CONFIGS,
                         ids=["edh-rk4-power", "edh-euler-eigh", "ledh-power", "ledh-beta-eigh"])
def test_flow_steps_match_jax(kind, cfg_kw, flow_kw):
    jf, tf = _filters(kind, cfg_kw)
    n, n_lambda = cfg_kw["n_particles"], cfg_kw["n_lambda_steps"]
    jflow_kw = {k: jnp.asarray(v) for k, v in flow_kw.items()}
    jstep = jax.jit(lambda key, st, ts, z, v: jf.step(
        key, st, ts, z, process_noise_sampler=lambda k, n_, nx: v, **jflow_kw))
    for trial in range(2):
        p0, zs, V = _trial_data(n, 10 * trial + len(kind))
        jst = _jax_state(p0, n_lambda)
        jts = jf.tracker.init(jnp.zeros(D), jnp.asarray(SIGMA))
        tst = interop.state_from_jax(jst, device=CPU)
        tts = interop.state_from_jax(jts, device=CPU)
        gen = torch.Generator().manual_seed(0)
        for t in range(T):
            jst, jts = jstep(jax.random.PRNGKey(t), jst, jts, jnp.asarray(zs[t]),
                             jnp.asarray(V[t]))
            tst, tts = tf.step(gen, tst, tts, zs[t],
                               process_noise_sampler=lambda g, n_, nx: torch.from_numpy(V[t]),
                               **flow_kw)
            for name in ("particles", "log_weights", "mean", "cov"):
                np.testing.assert_allclose(getattr(tst, name).numpy(),
                                           np.asarray(getattr(jst, name)), **TOL,
                                           err_msg=f"{name}, trial {trial}, t {t}")
            np.testing.assert_allclose(tst.diagnostics["condition_numbers"].numpy(),
                                       np.asarray(jst.diagnostics["condition_numbers"]),
                                       rtol=1e-3)
            np.testing.assert_allclose(tts.mean.numpy(), np.asarray(jts.mean), **TOL)
            assert not bool(tst.diagnostics["resampled"])


def test_ledh_rejects_bad_beta_schedules():
    _, tf = _filters("ledh", dict(n_particles=8, n_lambda_steps=3))
    for bad in ([0.0, 0.5, 1.0], [0.0, 0.6, 0.5, 1.0], [0.1, 0.2, 0.5, 1.0],
                [0.0, 0.2, 0.5, 0.9]):
        with pytest.raises(ValueError, match="beta_schedule"):
            tf._grid(np.array(bad, np.float32))


def _dyadic_weights(rng, b, n):
    """Weights c/2^k with small integer c: every partial sum is exact in
    f32, so both packages see one cdf."""
    c = rng.integers(0, 8, (b, n)).astype(np.float64)
    c[:, -1] += (1 << 12) - c.sum(axis=1)  # each row sums to 2^12
    return (c / (1 << 12)).astype(np.float32)


def test_resample_step_given_the_same_u_matches_jax():
    """The flows' resample: the JAX package's systematic_resample_values
    (telescoped sums) and the port's values (copies through B2's plain
    version) for the same u, per cloud and for the batched clouds with a
    point-mass cloud among them."""
    rng = np.random.default_rng(0)
    b, n = 3, 256
    w = _dyadic_weights(rng, b, n)
    w[1] = 0.0
    w[1, 77] = 1.0
    p = rng.standard_normal((b, n, 6)).astype(np.float32)
    keys = [jax.random.PRNGKey(k) for k in range(b)]
    u = torch.tensor([float(jax.random.uniform(k, (), jnp.float32)) for k in keys])
    want = np.stack([np.asarray(jhard.systematic_resample_values(k, jnp.asarray(p[i]),
                                                                 w=jnp.asarray(w[i])))
                     for i, k in enumerate(keys)])
    starts = thard.batched_starts(torch.from_numpy(w), u)
    assert starts.shape == (b * n,) and bool((starts[1:] >= starts[:-1]).all())
    got = resample_by_starts(torch.from_numpy(p).reshape(b * n, 6), starts).view(b, n, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert bool((got[1] == torch.from_numpy(p[1, 77])).all())  # no cloud crossed
    for i in range(b):  # one cloud at a time: the same values
        t = thard._child_run_ends_u(torch.from_numpy(w[i]), n, u[i])
        s = torch.cat([t.new_zeros(1), t[:-1]])
        assert torch.equal(resample_by_starts(torch.from_numpy(p[i]), s), got[i])


def test_batched_resample_keeps_clouds_apart():
    gen = torch.Generator().manual_seed(3)
    p = torch.randn(4, 50, 3, generator=gen)
    logw = torch.randn(4, 50, generator=gen) * 3
    out = thard.systematic_resample_values_batched(gen, p, logw=logw)
    for b in range(4):  # every row of cloud b is one of cloud b's particles
        match = (out[b][:, None, :] == p[b][None, :, :]).all(-1).any(-1)
        assert bool(match.all())


def _sampler_from(arrays):
    """A process-noise sampler that hands out ``arrays`` in turn."""
    it = iter(arrays)
    return lambda gen, n, nx: torch.from_numpy(next(it)).reshape(n, nx)


@pytest.mark.parametrize("kind", ["edh", "ledh"])
def test_batched_trials_equal_per_trial_runs(kind):
    """run_trials (the step vmapped over trials) gives each trial what its
    own run gives it, from the same noise."""
    B, n = 3, 32
    _, tf = _filters(kind, dict(n_particles=n, n_lambda_steps=2, resample_ess_ratio=0.0))
    data = [_trial_data(n, 40 + b) for b in range(B)]
    states = [tf.init_from_gaussian(torch.Generator().manual_seed(b), torch.zeros(D),
                                    torch.from_numpy(SIGMA.copy())) for b in range(B)]
    tracks = [tf.tracker.init(torch.zeros(D), torch.from_numpy(SIGMA.copy())) for _ in range(B)]
    gen = torch.Generator().manual_seed(0)
    singles = [tf.run(gen, states[b], tracks[b], data[b][1],
                      process_noise_sampler=_sampler_from(data[b][2]))[2] for b in range(B)]
    zs = np.stack([d[1] for d in data])
    V = np.stack([d[2] for d in data], axis=1)  # (T, B, n, D)
    _, ts, hist = tf.run_trials(gen, stack_states(states), stack_states(tracks), zs,
                                process_noise_sampler=_sampler_from(list(V)))
    assert ts.mean.shape == (B, D)
    for b in range(B):
        for k, v in singles[b].items():
            tol = 1e-3 if k == "condition_numbers" else 1e-5  # power iteration
            torch.testing.assert_close(hist[k][b], v, rtol=tol, atol=1e-5, msg=k)


def test_resampling_steps_record_post_resample_ess():
    """A triggered step resamples through B2's path and records the ESS
    after it (≈ N), as the JAX package's history does; run_trials counts
    the same."""
    n = 64
    _, tf = _filters("edh", dict(n_particles=n, n_lambda_steps=2, resample_ess_ratio=1.0))
    p0, zs, _ = _trial_data(n, 5)
    st = tf.init_from_gaussian(torch.Generator().manual_seed(1), torch.zeros(D),
                               torch.from_numpy(SIGMA.copy()))
    ts = tf.tracker.init(torch.zeros(D), torch.from_numpy(SIGMA.copy()))
    _, _, hist = tf.run(torch.Generator().manual_seed(2), st, ts, zs)
    assert bool(hist["resampled"].all())
    torch.testing.assert_close(hist["ess"], torch.full((T,), float(n)), rtol=1e-5, atol=1e-3)
    _, _, hb = tf.run_trials(torch.Generator().manual_seed(2), stack_states([st, st]),
                             stack_states([ts, ts]), np.stack([zs, zs]))
    assert bool(hb["resampled"].all()) and hb["ess"].shape == (2, T)


def test_interop_round_trip_flow_state():
    p0, _, _ = _trial_data(16, 1)
    jst = _jax_state(p0, 3)
    port = interop.state_from_jax(jst, device=CPU)
    assert isinstance(port, tedh.FlowPFState)
    back = interop.to_numpy(port)
    for name in ("particles", "weights", "log_weights", "mean", "cov"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(jst, name)))
    for k, v in jst.diagnostics.items():
        np.testing.assert_array_equal(back["diagnostics"][k], np.asarray(v))
    rebuilt = jedh.FlowPFState(**{k: jax.tree_util.tree_map(jnp.asarray, v)
                                  for k, v in back.items()})
    jax.tree_util.tree_map(np.testing.assert_array_equal, rebuilt, jst)


def test_snlg_column_at_a_toy_size():
    """The whole slice: the SNLG column at d = 16, 2 trials, T = 4. The KF
    and UKF rows equal the JAX package's filters on the same data; the
    flows' MSEs are finite and near the KF's (the optimal filter here)."""
    trials, steps, d = 2, 4, 16
    flows = (("edh200", "edh", 64), ("ledh200", "ledh", 48), ("edh10000", "edh", 96))
    res = tbench.run_column("cpu", trials=trials, steps=steps, d=d, flows=flows)
    Sigma, (X, Z), _ = tbench.make_data(trials, steps, d)
    I = jnp.eye(d)
    kf = jax.vmap(lambda z: jkf.kalman_filter_general(
        z, AL * I, I, I, Sigma, 4.0 * I, x0=jnp.zeros(d), P0=Sigma).x_filt)(jnp.asarray(Z))
    ukf = jukf.UnscentedKalmanFilter(lambda x, u: AL * x, lambda x: x, Sigma, 4.0 * I, alpha=1.0)
    um = jax.vmap(lambda z: ukf.run(jukf.make_ukf_state(jnp.zeros(d), Sigma), z)[1])(
        jnp.asarray(Z))
    for tag, means in (("kf", kf), ("ukf", um)):
        want = float(np.mean((np.asarray(means) - X[:, 1:]) ** 2))
        np.testing.assert_allclose(res[tag]["mse"], want, rtol=1e-5)
    for tag, _, _ in flows:
        r = res[tag]
        assert np.isfinite(r["mse"]) and r["mse"] < 2.0 * res["kf"]["mse"]
        assert r["b2_launches"] == 0  # CPU tensors take B2's plain version
        assert 0 <= r["resampled"] <= trials * steps
