"""Port parity: the fused SIR filter, kernel B1's plain version and the
partials combine, against the JAX package (its Pallas kernel in interpret
mode for single steps and whole-filter runs)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from particle_filters_tpu.core import weights as jw
from particle_filters_tpu.ops.fused_pf import FusedSIRFilter as JaxFused
from particle_filters_tpu.ops.fused_pf import _combine_partials as jax_combine
from particle_filters_tpu_torch.interop import params_from_jax, state_from_jax
from particle_filters_tpu_torch.ops.fused_pf import (
    FusedSIRFilter,
    LinearObsFirstModel,
    StepWork,
    SVModel,
    _combine_partials,
    fused_step,
    fused_step_reference,
    partials_width,
)

torch.set_num_threads(1)

ALPHA, SIGMA, BETA = 0.9, 0.2, 1.0
A2 = np.array([[0.9, 0.1], [0.0, 0.8]], np.float32)
Q2 = np.diag([0.05, 0.02]).astype(np.float32)
R2 = 0.1


def _jax_sv_fused(n, **kw):
    return JaxFused(
        lambda x: ALPHA * x, lambda x, z: -0.5 * (z[0] ** 2 / jnp.exp(x) + x),
        Q=np.array([[SIGMA**2]]), Np=n, **kw,
    )


def _jax_nx2_fused(n, **kw):
    return JaxFused(
        lambda x: jnp.stack([0.9 * x[0, :] + 0.1 * x[1, :], 0.8 * x[1, :]]),
        lambda x, z: -0.5 * (z[0] - x[0, :]) ** 2 / R2, Q=Q2, Np=n, **kw,
    )


def test_combine_partials_matches_jax():
    nb, nx = 5, 2
    rng = np.random.default_rng(0)
    width = partials_width(nx)
    part = rng.random((nb, width)).astype(np.float32)
    part[:, 0] = 3.0 * rng.standard_normal(nb)  # block maxima
    padded = np.zeros((nb, 128), np.float32)
    padded[:, :width] = part
    jz, jess, jmean, jexx = jax_combine(jnp.asarray(padded), nx)
    tz, tess, tmean, texx = _combine_partials(torch.from_numpy(part), nx)
    for t, j in ((tz, jz), (tess, jess), (tmean, jmean), (texx, jexx)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("nx,uniform", [(1, False), (1, True), (2, False), (2, True)])
def test_fused_step_reference_matches_jax_weights(nx, uniform):
    """x' = g(x) + Lq·ε and its weights/moments, with the same ε, against
    the JAX package's log_normalize / ess_from_logw / weighted_mean_cov."""
    n = 3000  # not a multiple of the block: exercises the ragged tail
    rng = np.random.default_rng(nx + 2 * uniform)
    if nx == 1:
        model, Q = SVModel(ALPHA, BETA), np.array([[SIGMA**2]], np.float32)
    else:
        model, Q = LinearObsFirstModel(A2, R2), Q2
    _, Lq = params_from_jax(Q, device="cpu")
    x = (0.5 + rng.standard_normal((nx, n))).astype(np.float32)
    lw = (rng.standard_normal(n) - math.log(n)).astype(np.float32)
    eps = rng.standard_normal((nx, n)).astype(np.float32)
    z = np.array([0.6], np.float32)
    off_u = np.array([0.25, 1.0 if uniform else 0.0], np.float32)

    xt, lwt, row = fused_step_reference(
        *map(torch.from_numpy, (x, lw, off_u, z, eps)), Lq, model
    )
    # The same step spelled with numpy / the JAX package.
    Lq_np = Lq.numpy()
    gx = ALPHA * x if nx == 1 else A2 @ x
    x_ref = gx + Lq_np @ eps
    if nx == 1:
        ll = -0.5 * (z[0] ** 2 / np.exp(x_ref[0]) + x_ref[0])
    else:
        ll = -0.5 * (z[0] - x_ref[0]) ** 2 / R2
    lw_in = np.full(n, -np.log(np.float32(n)), np.float32) if uniform else lw - off_u[0]
    lw_ref = (lw_in + ll).astype(np.float32)
    np.testing.assert_allclose(xt.numpy(), x_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lwt.numpy(), lw_ref, rtol=1e-5, atol=1e-6)

    log_z, ess, mean, exx = row[0], row[1], row[2 : 2 + nx], row[2 + nx :]
    cov = exx.reshape(nx, nx) - torch.outer(mean, mean)
    _, jz = jw.log_normalize(jnp.asarray(lw_ref))
    jmean, jcov = jw.weighted_mean_cov(jnp.asarray(x_ref.T), jnp.asarray(lw_ref))
    np.testing.assert_allclose(float(log_z), float(jz), rtol=1e-5)
    np.testing.assert_allclose(float(ess), float(jw.ess_from_logw(jnp.asarray(lw_ref))),
                               rtol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("branch", ["finalize", "combine"])
@pytest.mark.parametrize("nx", [1, 2])
def test_fused_step_row_matches_jax_kernel(nx, branch):
    """One step through the JAX kernel (interpret mode) in its finalize
    branch (one block) and its combine branch (four blocks), against the
    port's plain B1 fed the JAX kernel's own normals, recovered as
    ε = Lq⁻¹(x' − g(x)); the trigger and carry against ``_step_core``'s."""
    n = 1024
    rng = np.random.default_rng(10 + nx)
    block = n if branch == "finalize" else n // 4
    if nx == 1:
        jf, model, Q = _jax_sv_fused(n, block=block), SVModel(ALPHA, BETA), [[SIGMA**2]]
    else:
        jf, model, Q = _jax_nx2_fused(n, block=block), LinearObsFirstModel(A2, R2), Q2
    _, Lq = params_from_jax(Q, device="cpu")
    x = (0.5 + rng.standard_normal((nx, n))).astype(np.float32)
    lw = (rng.standard_normal(n) - math.log(n)).astype(np.float32)
    off_u = np.array([0.25, 0.0], np.float32)
    z = np.array([0.6], np.float32)

    pt, lwj = jnp.asarray(x.reshape(jf.rows, jf.cols)), jnp.asarray(lw.reshape(jf.wrows, jf.wcols))
    seed_arr, z_pad = jf._seed_pair(7), jf._pad_obs(jnp.asarray(z))
    with pltpu.force_tpu_interpret_mode():
        xj, lwj2, rowj = jf._fused_step(seed_arr, jnp.asarray(off_u), pt, lwj, z_pad)
    xj = np.asarray(xj).reshape(nx, n)
    gx = ALPHA * x if nx == 1 else A2 @ x
    eps = np.linalg.solve(Lq.numpy().astype(np.float64), (xj - gx).astype(np.float64))

    x_t, lw_t = torch.from_numpy(x), torch.from_numpy(lw)
    work = StepWork(nx, "cpu")
    ess_frac = float(rowj[1]) / n
    for thresh, resamples in ((0.5 * ess_frac, False), (1.01, True)):
        xp, lwp, row = fused_step(
            x_t, lw_t, torch.from_numpy(off_u), torch.from_numpy(z), Lq,
            torch.tensor(model.params), model, seed=0,
            eps=torch.from_numpy(eps.astype(np.float32)), resample_thresh=thresh, work=work,
        )
        np.testing.assert_allclose(xp.numpy(), xj, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(lwp.numpy(), np.asarray(lwj2).reshape(n), rtol=1e-5, atol=1e-6)
        width = 2 + nx + nx * nx
        np.testing.assert_allclose(row.numpy(), np.asarray(rowj)[:width], rtol=1e-4, atol=1e-6)

        jf.resample_thresh = thresh
        with pltpu.force_tpu_interpret_mode():
            (_, _, off_j), (_, trig_j, _) = jf._step_core(
                seed_arr, jax.random.PRNGKey(3), (pt, lwj, jnp.asarray(off_u)), z_pad)
        assert bool(work.trigger.item()) == bool(trig_j) == resamples
        off_next = torch.tensor([0.0, 1.0]) if bool(work.trigger.item()) else work.carry
        np.testing.assert_allclose(off_next.numpy(), np.asarray(off_j), rtol=1e-4, atol=1e-6)


def test_fused_step_wrapper_cpu_path_and_checks():
    f = FusedSIRFilter(SVModel(ALPHA, BETA), [[SIGMA**2]], Np=512, device="cpu")
    x, lw, off_u = f.initialize(torch.Generator().manual_seed(0), [0.0], [[0.3]])
    x = x.view(1, -1)
    z = torch.tensor([0.2])
    before = fused_step.launches
    a = fused_step(x, lw, off_u, z, f.Lq, f.params, f.model, seed=5)
    b = fused_step(x, lw, off_u, z, f.Lq, f.params, f.model, seed=5)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert fused_step.launches == before  # CPU tensors take the plain version
    with pytest.raises(TypeError):
        fused_step(x.double(), lw, off_u, z, f.Lq, f.params, f.model, seed=5)
    with pytest.raises(ValueError):
        fused_step(x, lw[:-1], off_u, z, f.Lq, f.params, f.model, seed=5)
    with pytest.raises(ValueError, match="row_out"):
        fused_step(x, lw, off_u, z, f.Lq, f.params, f.model, seed=5, row_out=torch.empty(2))
    # The plain version leaves the carry and the trigger in the caller's work.
    work = StepWork(1, "cpu")
    _, _, row = fused_step(x, lw, off_u, z, f.Lq, f.params, f.model, seed=5,
                           resample_thresh=2.0, work=work)
    assert torch.equal(work.carry, torch.stack([row[0], torch.tensor(0.0)]))
    assert int(work.trigger.item()) == 1
    with pytest.raises(ValueError, match="nx <= 10"):
        FusedSIRFilter(LinearObsFirstModel(np.eye(11), 1.0), np.eye(11), Np=64, device="cpu")
    with pytest.raises(ValueError, match="model.nx"):
        FusedSIRFilter(SVModel(ALPHA), np.eye(2), Np=64, device="cpu")


def test_forced_resample_lazy_carry_is_uniform():
    """After a resample the carry keeps the stale log-weights plus the
    uniform flag; effective_logw materializes −log N."""
    for model, Q, z in ((SVModel(ALPHA), [[SIGMA**2]], [[3.0], [3.0]]),
                        (LinearObsFirstModel(A2, R2), Q2, [[1.5], [1.5]])):
        f = FusedSIRFilter(model, Q, Np=1024, resample_thresh=2.0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        st = f.initialize(gen, np.zeros(model.nx), np.eye(model.nx))
        st, hist = f.run(gen, st, z)
        assert bool(hist["resampled"].all())
        assert float(st[2][1]) == 1.0
        np.testing.assert_allclose(f.effective_logw(st).numpy(), -np.log(1024.0), atol=1e-6)


@pytest.mark.parametrize("nx", [1, 2])
def test_run_reads_its_initial_state_and_repeats(nx):
    """``run`` writes its outputs into buffers of its own: the caller's state
    is unchanged, and a second run from it gives the same history."""
    model, Q = (SVModel(ALPHA), [[SIGMA**2]]) if nx == 1 else (LinearObsFirstModel(A2, R2), Q2)
    f = FusedSIRFilter(model, Q, Np=1000, device="cpu")
    state0 = f.initialize(torch.Generator().manual_seed(2), np.zeros(nx), np.eye(nx))
    copy0 = tuple(t.clone() for t in state0)
    zs = np.linspace(-1.0, 1.0, 12, dtype=np.float32)[:, None]
    hists = [f.run(torch.Generator().manual_seed(3), state0, zs)[1] for _ in range(2)]
    for a, b in zip(state0, copy0):
        assert torch.equal(a, b)
    assert bool(hists[0]["resampled"].any())
    for k in hists[0]:
        assert torch.equal(hists[0][k], hists[1][k]), k


@pytest.mark.parametrize("nx", [1, 2])
def test_state_from_jax_round_trip(key, nx):
    jf = _jax_sv_fused(1024) if nx == 1 else _jax_nx2_fused(1024)
    jst = jf.initialize(key, np.zeros(nx), 0.3 * np.eye(nx))
    # a pending log-normalizer, so effective_logw has work to do
    jst = (jst[0], jst[1] + 0.5, jnp.array([0.5, 0.0], jnp.float32))
    tst = state_from_jax(tuple(np.asarray(a) for a in jst), device="cpu")
    assert tst[0].shape == ((1024,) if nx == 1 else (nx, 1024))
    assert tst[1].shape == (1024,)
    # the (8, N/8) layout is read row-major; (nx, N) stays
    np.testing.assert_array_equal(tst[0].numpy().reshape(jst[0].shape), np.asarray(jst[0]))
    np.testing.assert_array_equal(tst[1].numpy().reshape(jst[1].shape), np.asarray(jst[1]))
    np.testing.assert_array_equal(tst[2].numpy(), np.asarray(jst[2]))
    model = SVModel(ALPHA) if nx == 1 else LinearObsFirstModel(A2, R2)
    tf = FusedSIRFilter(model, [[SIGMA**2]] if nx == 1 else Q2, Np=1024, device="cpu")
    np.testing.assert_allclose(
        tf.effective_logw(tst).numpy(),
        np.asarray(jf.effective_logw(jst)).reshape(-1), rtol=1e-6,
    )


def _rmse(mean, xs):
    return float(np.sqrt(np.mean((np.asarray(mean) - xs) ** 2)))


@pytest.mark.parametrize("nx", [1, 2])
def test_whole_filter_matches_jax_fused(key, sv_data, nx):
    """Same zs through the JAX fused filter (Pallas interpret mode) and the
    port; the PRNG streams differ, so the RMSE/ESS bands of
    tests/unit/test_fused_pf.py hold them together."""
    T, n = 60, 4096
    if nx == 1:
        zs = np.asarray(sv_data.Y[:T, None])
        xs = np.asarray(sv_data.X[:T])
        jf = _jax_sv_fused(n, block=1024)
        tf = FusedSIRFilter(SVModel(ALPHA, BETA), [[SIGMA**2]], Np=n, device="cpu")
        m0, c0 = np.zeros(1), np.array([[0.21]])
    else:
        rng = np.random.default_rng(0)
        xs = np.zeros((T, 2), np.float32)
        x = np.zeros(2, np.float32)
        Lq = np.linalg.cholesky(Q2)
        for t in range(T):
            x = A2 @ x + Lq @ rng.standard_normal(2).astype(np.float32)
            xs[t] = x
        zs = (xs[:, :1] + np.sqrt(R2) * rng.standard_normal((T, 1))).astype(np.float32)
        jf = _jax_nx2_fused(n, block=1024)
        tf = FusedSIRFilter(LinearObsFirstModel(A2, R2), Q2, Np=n, device="cpu")
        m0, c0 = np.zeros(2), 0.3 * np.eye(2)

    jst = jf.initialize(key, m0, c0)
    with pltpu.force_tpu_interpret_mode():
        _, hj = jf.run(jax.random.fold_in(key, 1), jst, jnp.asarray(zs))
    gen = torch.Generator().manual_seed(0)
    _, ht = tf.run(gen, tf.initialize(gen, m0, c0), zs)

    assert set(ht) == set(hj)
    for k in hj:
        assert tuple(ht[k].shape) == tuple(hj[k].shape), k
    for v in ht.values():
        assert bool(torch.isfinite(v.float()).all())
    sel = (slice(None), 0) if nx == 1 else (slice(None),)
    rmse_j = _rmse(np.asarray(hj["mean"])[sel], xs)
    rmse_t = _rmse(ht["mean"].numpy()[sel], xs)
    assert rmse_t < (1.5 if nx == 1 else 0.5)
    assert abs(rmse_t - rmse_j) < 0.3 * max(rmse_t, rmse_j) + 0.05
    assert abs(float(ht["ess"].mean()) - float(np.mean(hj["ess"]))) < 0.35 * n
