"""Port parity: the SV simulator against numpy and the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu.simulators import stochastic_volatility as jsv
from particle_filters_tpu_torch.simulators import stochastic_volatility as tsv

torch.set_num_threads(1)

F32_EPS = np.finfo(np.float32).eps


def test_recursion_with_injected_noise_matches_numpy():
    """X is bit-exact to a numpy f32 loop; Y to 2 ulp (libm exp differs)."""
    rng = np.random.default_rng(0)
    n, alpha, sigma, beta = 300, 0.95, 0.2, 1.3
    V = rng.standard_normal(n - 1).astype(np.float32)
    W = rng.standard_normal(n).astype(np.float32)
    x0 = np.float32(0.7)

    X_ref = np.empty(n, np.float32)
    X_ref[0] = x0
    for t in range(1, n):
        X_ref[t] = np.float32(alpha) * X_ref[t - 1] + np.float32(sigma) * V[t - 1]
    Y_ref = np.float32(beta) * np.exp(np.float32(0.5) * X_ref) * W

    X, Y = tsv._sv_recursion(
        torch.tensor(x0), torch.from_numpy(V), torch.from_numpy(W), alpha, sigma, beta
    )
    np.testing.assert_array_equal(X.numpy(), X_ref)
    np.testing.assert_allclose(Y.numpy(), Y_ref, rtol=2 * F32_EPS, atol=0)


def test_simulate_shapes_seed_and_stationarity():
    a = tsv.simulate_sv_1d(20000, 0.9, 0.3, 1.0, seed=3, device="cpu")
    b = tsv.simulate_sv_1d(20000, 0.9, 0.3, 1.0, seed=3, device="cpu")
    assert a.X.shape == a.Y.shape == (20000,) and a.X.dtype == torch.float32
    assert torch.equal(a.X, b.X) and a.seed == 3 and a.n == 20000
    var0 = 0.3**2 / (1 - 0.9**2)
    assert abs(float(a.X.var()) / var0 - 1) < 0.15
    fixed = tsv.simulate_sv_1d(5, 0.9, 0.3, 1.0, x0=2.0, device="cpu")
    assert float(fixed.X[0]) == 2.0 and fixed.seed == 0


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(n=0), "n must be positive"),
        (dict(alpha=1.0), "alpha"),
        (dict(alpha=float("nan")), "alpha"),
        (dict(sigma=-0.1), "sigma"),
        (dict(beta=float("inf")), "beta"),
    ],
)
def test_validation_errors_match_jax(kw, match):
    args = dict(n=10, alpha=0.9, sigma=0.2, beta=1.0)
    args.update(kw)
    for simulate in (tsv.simulate_sv_1d, jsv.simulate_sv_1d):
        with pytest.raises(ValueError, match=match):
            simulate(args["n"], args["alpha"], args["sigma"], args["beta"])


def test_npz_cross_load(tmp_path):
    j = jsv.simulate_sv_1d(50, 0.9, 0.2, 1.0, seed=5)
    j.save(str(tmp_path / "from_jax"))
    t = tsv.SV1DResults.load(str(tmp_path / "from_jax"), device="cpu")
    np.testing.assert_array_equal(t.X.numpy(), np.asarray(j.X))
    np.testing.assert_array_equal(t.Y.numpy(), np.asarray(j.Y))
    assert (t.alpha, t.sigma, t.beta, t.n, t.seed) == (j.alpha, j.sigma, j.beta, j.n, j.seed)

    p = tsv.simulate_sv_1d(40, 0.8, 0.1, 2.0, device="cpu")
    p.save(str(tmp_path / "from_torch.npz"))
    back = jsv.SV1DResults.load(str(tmp_path / "from_torch.npz"))
    np.testing.assert_array_equal(np.asarray(back.X), p.X.numpy())
    np.testing.assert_array_equal(np.asarray(back.Y), p.Y.numpy())
    assert (back.alpha, back.sigma, back.beta, back.n, back.seed) == (0.8, 0.1, 2.0, 40, 0)


def test_ssm_callables_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(64).astype(np.float32)
    xn = rng.standard_normal(64).astype(np.float32)
    y = rng.standard_normal(64).astype(np.float32)
    jp = jsv.SV1DParams(alpha=0.9, sigma=0.2, beta=1.5)
    tp = tsv.SV1DParams(alpha=0.9, sigma=0.2, beta=1.5)
    np.testing.assert_allclose(
        tsv.sv_transition_logpdf(tp, torch.from_numpy(xn), torch.from_numpy(x)).numpy(),
        np.asarray(jsv.sv_transition_logpdf(jp, jnp.asarray(xn), jnp.asarray(x))),
        rtol=1e-6, atol=1e-5,
    )
    np.testing.assert_allclose(
        tsv.sv_obs_logpdf(tp, torch.from_numpy(y), torch.from_numpy(x)).numpy(),
        np.asarray(jsv.sv_obs_logpdf(jp, jnp.asarray(y), jnp.asarray(x))),
        rtol=1e-6, atol=1e-6,
    )
    gen = torch.Generator().manual_seed(0)
    xs = torch.zeros(100000)
    draw = tsv.sv_transition_sample(gen, tp, xs)
    assert draw.shape == xs.shape
    assert abs(float(draw.std()) - 0.2) < 0.005
