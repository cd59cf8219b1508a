"""Port parity: core weights, linalg and cumsum against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu.core import linalg as jlin
from particle_filters_tpu.core import weights as jw
from particle_filters_tpu.core.block_cumsum import blocked_cumsum
from particle_filters_tpu_torch.core import block_cumsum as tbc
from particle_filters_tpu_torch.core import linalg as tlin
from particle_filters_tpu_torch.core import weights as tw

torch.set_num_threads(1)

RTOL = ATOL = 1e-6


def _logw_cases():
    rng = np.random.default_rng(0)
    yield "normal", (3.0 * rng.standard_normal(257)).astype(np.float32)
    spiky = rng.standard_normal(64).astype(np.float32)
    spiky[5] = 40.0
    yield "spiky", spiky
    partial = rng.standard_normal(32).astype(np.float32)
    partial[::3] = -np.inf
    yield "some -inf", partial
    yield "all -inf", np.full(16, -np.inf, np.float32)


LOGW_CASES = list(_logw_cases())


@pytest.mark.parametrize("name,logw", LOGW_CASES, ids=[c[0] for c in LOGW_CASES])
def test_log_normalize_ess_entropy(name, logw):
    jn, jz = jw.log_normalize(jnp.asarray(logw))
    tn, tz = tw.log_normalize(torch.from_numpy(logw))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tz), float(jz), rtol=RTOL, atol=ATOL)
    for jf, tf in ((jw.ess_from_logw, tw.ess_from_logw),
                   (jw.weight_entropy, tw.weight_entropy)):
        np.testing.assert_allclose(
            float(tf(torch.from_numpy(logw))), float(jf(jnp.asarray(logw))),
            rtol=RTOL, atol=ATOL,
        )


def test_all_neg_inf_stays_finite():
    _, log_z = tw.log_normalize(torch.full((8,), -float("inf")))
    assert torch.isfinite(log_z)


def test_effective_sample_size_and_uniform():
    w = np.random.default_rng(1).random(100).astype(np.float32)
    np.testing.assert_allclose(
        float(tw.effective_sample_size(torch.from_numpy(w))),
        float(jw.effective_sample_size(jnp.asarray(w))), rtol=RTOL,
    )
    np.testing.assert_allclose(
        tw.uniform_logw(1000).numpy(), np.asarray(jw.uniform_logw(1000)),
        rtol=RTOL, atol=ATOL,
    )


@pytest.mark.parametrize("d", [1, 3])
def test_weighted_mean_cov(d):
    rng = np.random.default_rng(2 + d)
    p = rng.standard_normal((500, d)).astype(np.float32)
    logw = rng.standard_normal(500).astype(np.float32)
    jm, jc = jw.weighted_mean_cov(jnp.asarray(p), jnp.asarray(logw))
    tm, tc = tw.weighted_mean_cov(torch.from_numpy(p), torch.from_numpy(logw))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tw.weighted_mean(torch.from_numpy(p), torch.from_numpy(logw)).numpy(),
        np.asarray(jw.weighted_mean(jnp.asarray(p), jnp.asarray(logw))),
        rtol=RTOL, atol=ATOL,
    )


def _spd(n, seed, cond_eps=0.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    m = a @ a.T / n + np.eye(n)
    if cond_eps:  # rank-1 dominated: near-singular in f32
        v = rng.standard_normal(n)
        m = np.outer(v, v) + cond_eps * np.eye(n)
    return m.astype(np.float32)


@pytest.mark.parametrize(
    "a,singular",
    [(_spd(1, 0), False), (_spd(4, 1), False), (_spd(6, 2, cond_eps=1e-9), True),
     (np.array([[1.0, 1.0], [1.0, 1.0]], np.float32), True)],
    ids=["spd1", "spd4", "near-singular6", "singular2"],
)
def test_chol_with_jitter(a, singular):
    """SPD: the factors agree. Near-singular: the rung's factor is fixed
    only to ~sqrt(eps) by LAPACK's rounding, so the reconstruction L Lᵀ —
    which shows the jitter rung chosen — is what agrees."""
    jl = np.asarray(jlin.chol_with_jitter(jnp.asarray(a)))
    tl = tlin.chol_with_jitter(torch.from_numpy(a)).numpy()
    assert np.all(np.isfinite(tl))
    if singular:
        np.testing.assert_allclose(tl @ tl.T, jl @ jl.T, atol=1e-6)
    else:
        np.testing.assert_allclose(tl, jl, atol=1e-6)


def test_chol_with_jitter_all_rungs_fail_is_nan():
    a = torch.tensor([[-1.0, 0.0], [0.0, -1.0]])
    assert torch.isnan(tlin.chol_with_jitter(a)).any()


def test_symmetrize():
    a = np.random.default_rng(3).standard_normal((2, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tlin.symmetrize(torch.from_numpy(a)).numpy(),
        np.asarray(jlin.symmetrize(jnp.asarray(a))),
    )


@pytest.mark.parametrize("n", [100, 1 << 15])
def test_cumsum_matches_blocked_cumsum(n):
    """The port's blocked_cumsum (the resample cdf's scan) against the JAX
    package's: integers equal, floats to f32 rounding of a sum of n positive
    terms (the port sums in f64 and rounds once, the JAX package in f32 in
    another order)."""
    rng = np.random.default_rng(n)
    ints = rng.integers(0, 5, n).astype(np.int32)
    np.testing.assert_array_equal(
        tbc.blocked_cumsum(torch.from_numpy(ints)).numpy(),
        np.asarray(blocked_cumsum(jnp.asarray(ints))),
    )
    w = rng.random(n).astype(np.float32)
    w /= w.sum()
    np.testing.assert_allclose(
        tbc.blocked_cumsum(torch.from_numpy(w)).numpy(),
        np.asarray(blocked_cumsum(jnp.asarray(w))),
        rtol=0, atol=16 * np.finfo(np.float32).eps,
    )


@pytest.mark.parametrize("shape", [(1,), (127,), (129,), (3, 1000), (2, 1 << 15)])
def test_blocked_cumsum_along_the_last_axis(shape):
    """Any length and leading axes, row by row: f64 to 1e-12 of numpy's
    cumsum, f32 to one rounding of the exact sum, integers exact, and the
    same bits on a second call."""
    x = torch.rand(shape, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(tbc.blocked_cumsum(x).numpy(), np.cumsum(x.numpy(), -1),
                               rtol=1e-12)
    xi = torch.randint(0, 9, shape, dtype=torch.int32)
    assert torch.equal(tbc.blocked_cumsum(xi), torch.cumsum(xi, -1, dtype=torch.int32))
    xf = x.float()
    exact = np.cumsum(xf.double().numpy(), -1)
    np.testing.assert_allclose(tbc.blocked_cumsum(xf).numpy(), exact, rtol=2 ** -23, atol=0)
    assert torch.equal(tbc.blocked_cumsum(xf), tbc.blocked_cumsum(xf.clone()))
