"""Port parity: the general ParticleFilter against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu.models import ParticleFilter as JaxPF
from particle_filters_tpu.models import kalman_filter_general
from particle_filters_tpu_torch.interop import state_from_jax
from particle_filters_tpu_torch.models import ParticleFilter

torch.set_num_threads(1)

ALPHA, SIGMA, BETA = 0.9, 0.2, 1.0


def _sv_jax_obs(x, z):
    var = BETA**2 * jnp.exp(x[0])
    return -0.5 * (z[0] ** 2 / var + jnp.log(var))


def _sv_torch_obs(x, z):
    var = BETA**2 * torch.exp(x[0])
    return -0.5 * (z[0] ** 2 / var + torch.log(var))


def _sv_pair(Np, **kw):
    Q = np.array([[SIGMA**2]], np.float32)
    jpf = JaxPF(lambda x, u: ALPHA * x, None, Q, None, Np=Np, obs_loglik=_sv_jax_obs, **kw)
    tpf = ParticleFilter(lambda x, u: ALPHA * x, None, Q, None, Np=Np,
                         obs_loglik=_sv_torch_obs, device="cpu", **kw)
    return jpf, tpf


def _linear_pair(small_system, Np, **kw):
    s = small_system
    A = s["A"]
    jpf = JaxPF(lambda x, u: jnp.asarray(A) @ x, lambda x: x, s["Q"], s["R"], Np=Np, **kw)
    At = torch.from_numpy(A)
    tpf = ParticleFilter(lambda x, u: At @ x, lambda x: x, s["Q"], s["R"], Np=Np,
                         device="cpu", **kw)
    return jpf, tpf


def test_predict_with_injected_noise(key, small_system):
    jpf, tpf = _linear_pair(small_system, 300)
    st = jpf.initialize(key, np.zeros(2, np.float32), small_system["Sigma"])
    k = jax.random.fold_in(key, 1)
    x_jax = np.asarray(jpf.predict(k, st))
    eps = np.array(jax.random.normal(k, st.particles.shape, st.particles.dtype))
    x_port = tpf._propagate(torch.from_numpy(np.array(st.particles)), torch.from_numpy(eps))
    np.testing.assert_allclose(x_port.numpy(), x_jax, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["sv", "linear"])
def test_update_without_resampling(key, small_system, model):
    if model == "sv":
        jpf, tpf = _sv_pair(400, resample_thresh=0.0)
        z = np.array([0.7], np.float32)
        mean0, cov0 = np.zeros(1, np.float32), np.array([[0.2]], np.float32)
    else:
        jpf, tpf = _linear_pair(small_system, 400, resample_thresh=0.0)
        z = np.array([0.3, -0.2], np.float32)
        mean0, cov0 = np.zeros(2, np.float32), small_system["Sigma"]
    st = jpf.initialize(key, mean0, cov0)
    st = jpf.update(jax.random.fold_in(key, 2), st, jnp.asarray(z))  # non-uniform weights
    j_new, j_diag = jpf.update(jax.random.fold_in(key, 3), st, jnp.asarray(z),
                               return_diagnostics=True)
    t_new, t_diag = tpf.update(torch.Generator(), state_from_jax(st, device="cpu"), z,
                               return_diagnostics=True)
    assert not bool(j_diag["resampled"]) and not t_diag["resampled"]
    for name in ("log_weights", "mean", "cov", "particles"):
        np.testing.assert_allclose(
            getattr(t_new, name).numpy(), np.asarray(getattr(j_new, name)),
            rtol=1e-5, atol=1e-6,
        )
    np.testing.assert_allclose(float(t_diag["ess"]), float(j_diag["ess"]), rtol=1e-5)
    assert int(t_new.t) == int(j_new.t)


def test_history_schema_matches_jax(key):
    jpf, tpf = _sv_pair(256)
    zs = np.full((12, 1), 0.4, np.float32)
    st = jpf.initialize(key, np.zeros(1, np.float32), np.array([[0.3]], np.float32))
    _, hj = jpf.run(jax.random.fold_in(key, 1), st, jnp.asarray(zs))
    gen = torch.Generator().manual_seed(0)
    _, ht = tpf.run(gen, tpf.initialize(gen, [0.0], [[0.3]]), zs)
    assert set(ht) == set(hj)
    for k in hj:
        assert tuple(ht[k].shape) == tuple(hj[k].shape), k
        assert (ht[k].dtype == torch.bool) == (hj[k].dtype == jnp.bool_), k
    assert bool(ht["exchange_ok"].all())


def test_sv_tracking_bands_match_jax(key, sv_data):
    """RMSE and mean-ESS bands of tests/unit/test_fused_pf.py."""
    T, Np = 60, 4096
    zs = np.asarray(sv_data.Y[:T, None])
    xs = np.asarray(sv_data.X[:T])
    jpf, tpf = _sv_pair(Np)
    st = jpf.initialize(key, np.zeros(1, np.float32), np.array([[0.21]], np.float32))
    _, hj = jpf.run(jax.random.fold_in(key, 1), st, jnp.asarray(zs))
    gen = torch.Generator().manual_seed(1)
    _, ht = tpf.run(gen, tpf.initialize(gen, [0.0], [[0.21]]), zs)
    rmse_j = float(np.sqrt(np.mean((np.asarray(hj["mean"][:, 0]) - xs) ** 2)))
    rmse_t = float(np.sqrt(np.mean((ht["mean"][:, 0].numpy() - xs) ** 2)))
    assert rmse_t < 1.5
    assert abs(rmse_t - rmse_j) < 0.3 * max(rmse_t, rmse_j) + 0.05
    assert abs(float(ht["ess"].mean()) - float(np.mean(hj["ess"]))) < 0.35 * Np


def test_log_evidence_tracks_kf_loglik(small_system, lgssm_data):
    """As tests/unit/test_particle_filter.py::TestLogEvidence: Σ log p̂(z_t|·)
    matches the exact KF log-likelihood up to the dropped Gaussian constant."""
    s = small_system
    T = 100
    Y = np.asarray(lgssm_data.Y[:T])
    kf = kalman_filter_general(
        Y, s["A"], s["C"], np.eye(2, dtype=np.float32), s["Q"], s["R"],
        x0=np.zeros(2, np.float32), P0=s["Sigma"],
    )
    _, tpf = _linear_pair(s, 4000)
    gen = torch.Generator().manual_seed(2)
    _, hist = tpf.run(gen, tpf.initialize(gen, np.zeros(2, np.float32), s["Sigma"]), Y)
    pf_ll = float(hist["log_evidence"].sum())
    const = -T / 2 * (2 * np.log(2 * np.pi)
                      + np.linalg.slogdet(np.asarray(s["R"], np.float64))[1])
    assert abs((pf_ll + const) - float(kf.loglik)) < 0.03 * abs(float(kf.loglik)) + 3.0


@pytest.mark.parametrize("method", ["systematic", "multinomial", "stratified", "residual"])
def test_forced_resample_resets_weights(method):
    _, tpf = _sv_pair(200, resample_thresh=2.0, resample_method=method,
                      regularize_after_resample=(method == "systematic"))
    gen = torch.Generator().manual_seed(3)
    st = tpf.initialize(gen, [0.0], [[1.0]])
    st2, diag = tpf.step(gen, st, [50.0], return_diagnostics=True)
    assert diag["resampled"]
    np.testing.assert_allclose(st2.weights.numpy(), 1 / 200, rtol=1e-5)
    assert float(tpf.effective_sample_size(st2)) > 0.99 * 200
    if method == "systematic":  # jittered: no exact duplicates left
        assert len(np.unique(st2.particles.numpy())) > 0.8 * 200


def test_unported_options_raise():
    """``track_degeneracy`` is ported (``test_torch_diagnostics.py`` holds
    it against the JAX package) and runs; ``run_chunked`` is ported
    (``test_torch_checkpoint.py``) and rejects a chunk size below 1."""
    _, tpf = _sv_pair(16)
    gen = torch.Generator()
    _, hist = tpf.run(gen, tpf.initialize(gen, [0.0], [[1.0]]), np.zeros((2, 1)),
                      track_degeneracy=True)
    assert hist["unique_frac"].shape == (2,)
    with pytest.raises(ValueError, match="chunk_size"):
        tpf.run_chunked(gen, tpf.initialize(gen, [0.0], [[1.0]]), np.zeros((2, 1)), chunk_size=0)
    with pytest.raises(ValueError, match="obs_loglik"):
        ParticleFilter(lambda x, u: x, None, np.eye(1), None, device="cpu")
