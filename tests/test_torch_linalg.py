"""Port parity: core/linalg against the JAX package.

The JAX module routes 32 ≤ n ≤ 160 (and smaller dims at large batch)
through its unrolled blocked Cholesky and TRSM; the port uses
``torch.linalg`` throughout, so the cases cross that window. Tolerances:
rtol/atol 1e-5 on well-conditioned SPD inputs at d ≤ 16 (f32 rounding of a
factorization), 1e-4 at d = 40, and rtol 1e-3 for the power-iteration
condition number (24 iterations from the same start; the estimate itself is
within 2 % of the true value, so the two packages agree far closer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu.core import linalg as jlin
from particle_filters_tpu_torch.core import linalg as tlin

torch.set_num_threads(1)


def _spd(shape, n, seed, ridge=1.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape + (n, n))
    return (a @ np.swapaxes(a, -1, -2) / n + ridge * np.eye(n)).astype(np.float32)


def _tol(n):
    return dict(rtol=1e-5, atol=1e-5) if n <= 16 else dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


SHAPES = [((), 1), ((), 4), ((), 16), ((3,), 8), ((2, 5), 6), ((), 40), ((4,), 40)]
IDS = [f"batch{s}-n{n}" for s, n in SHAPES]


@pytest.mark.parametrize("shape,n", SHAPES, ids=IDS)
def test_chol_nojitter_and_with_jitter(shape, n):
    a = _spd(shape, n, n)
    np.testing.assert_allclose(tlin.chol_nojitter(_t(a)).numpy(),
                               np.asarray(jlin.chol_nojitter(jnp.asarray(a))), **_tol(n))
    np.testing.assert_allclose(tlin.chol_with_jitter(_t(a)).numpy(),
                               np.asarray(jlin.chol_with_jitter(jnp.asarray(a))), **_tol(n))


def test_chol_nojitter_non_spd_is_nan():
    a = np.array([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 3.0]]], np.float32)
    L = tlin.chol_nojitter(_t(a))
    assert torch.isnan(L[0]).any() and torch.isfinite(L[1]).all()


@pytest.mark.parametrize("shape,n", SHAPES, ids=IDS)
@pytest.mark.parametrize("rhs", ["vec", "mat"])
def test_triangular_solves_and_chol_solve(shape, n, rhs):
    rng = np.random.default_rng(n + 7)
    L = np.asarray(jlin.chol_nojitter(jnp.asarray(_spd(shape, n, n))))
    b = rng.standard_normal(shape + ((n,) if rhs == "vec" else (n, 3))).astype(np.float32)
    for jf, tf in ((jlin.tri_solve_lower, tlin.tri_solve_lower),
                   (jlin.tri_solve_lower_t, tlin.tri_solve_lower_t),
                   (jlin.chol_solve, tlin.chol_solve)):
        np.testing.assert_allclose(tf(_t(L), _t(b)).numpy(),
                                   np.asarray(jf(jnp.asarray(L), jnp.asarray(b))), **_tol(n))


@pytest.mark.parametrize("n", [3, 16])
def test_solve_psd_inv_psd(n):
    a = _spd((), n, 30 + n)
    b = np.random.default_rng(n).standard_normal((n, 2)).astype(np.float32)
    np.testing.assert_allclose(tlin.solve_psd(_t(a), _t(b)).numpy(),
                               np.asarray(jlin.solve_psd(jnp.asarray(a), jnp.asarray(b))),
                               **_tol(n))
    np.testing.assert_allclose(tlin.inv_psd(_t(a)).numpy(),
                               np.asarray(jlin.inv_psd(jnp.asarray(a))), **_tol(n))


@pytest.mark.parametrize("xshape", [(5,), (7, 5)])
def test_mvn_logpdf_chol_and_mvn_logpdf(xshape):
    rng = np.random.default_rng(len(xshape))
    cov = _spd((), 5, 11, ridge=0.5)
    L = np.asarray(jlin.chol_with_jitter(jnp.asarray(cov)))
    x = rng.standard_normal(xshape).astype(np.float32)
    mean = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(
        tlin.mvn_logpdf_chol(_t(x), _t(mean), _t(L)).numpy(),
        np.asarray(jlin.mvn_logpdf_chol(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(L))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tlin.mvn_logpdf(_t(x), _t(mean), _t(cov)).numpy(),
        np.asarray(jlin.mvn_logpdf(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(cov))),
        rtol=1e-5, atol=1e-5)
    assert tlin._LOG_2PI == jlin._LOG_2PI


def test_mvn_logpdf_chol_over_more_leading_axes():
    """(B, N, d) points against one factor (the JAX function takes at most
    (N, d)): each slice as the (N, d) call."""
    rng = np.random.default_rng(9)
    L = torch.linalg.cholesky(_t(_spd((), 5, 12)))
    x = _t(rng.standard_normal((2, 7, 5)).astype(np.float32))
    mean = _t(rng.standard_normal(5).astype(np.float32))
    out = tlin.mvn_logpdf_chol(x, mean, L)
    for b in range(2):
        torch.testing.assert_close(out[b], tlin.mvn_logpdf_chol(x[b], mean, L))


def test_diag_gaussian_logpdf():
    rng = np.random.default_rng(0)
    x, m = rng.standard_normal((2, 6, 4)).astype(np.float32)
    var = (0.1 + np.abs(rng.standard_normal(4))).astype(np.float32)
    np.testing.assert_allclose(
        tlin.diag_gaussian_logpdf(_t(x), _t(m), _t(var)).numpy(),
        np.asarray(jlin.diag_gaussian_logpdf(jnp.asarray(x), jnp.asarray(m), jnp.asarray(var))),
        rtol=1e-5)


@pytest.mark.parametrize("n", [4, 16])
def test_condition_numbers(n):
    a = _spd((), n, 50 + n, ridge=0.05)
    exact = np.asarray(jlin.cond_spd(jnp.asarray(a)))
    np.testing.assert_allclose(float(tlin.cond_spd(_t(a))), exact, rtol=1e-3)
    L = np.asarray(jlin.chol_nojitter(jnp.asarray(a)))
    for chol in (None, L):
        jc = jlin.cond_spd_power(jnp.asarray(a), None if chol is None else jnp.asarray(chol))
        tc = tlin.cond_spd_power(_t(a), None if chol is None else _t(chol))
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-3)


def test_jitter_ladder_is_chosen_per_trial_under_vmap():
    """One matrix of the batch needs jitter, the others do not. Under vmap
    each picks its own rung, as under jax.vmap; one call on the whole
    (B, d, d) batch would give all of them the jittered rung."""
    good = _spd((2,), 6, 3)
    bad = np.ones((6, 6), np.float32)  # rank one: the base rung fails
    batch = np.stack([good[0], bad, good[1]])
    t_vm = torch.func.vmap(tlin.chol_with_jitter)(_t(batch)).numpy()
    j_vm = np.asarray(jax.vmap(jlin.chol_with_jitter)(jnp.asarray(batch)))
    assert np.isfinite(t_vm).all()
    for k in (0, 2):  # unjittered: the plain factor of each good matrix
        np.testing.assert_allclose(t_vm[k], j_vm[k], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t_vm[k], np.linalg.cholesky(batch[k]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_vm[1] @ t_vm[1].T, j_vm[1] @ j_vm[1].T, atol=1e-5)
    whole = tlin.chol_with_jitter(_t(batch)).numpy()
    assert not np.allclose(whole[0], t_vm[0], rtol=0, atol=0)


def test_log_density_solve_under_vmap_and_derivatives():
    """Under vmap a constant factor serves all the batched points at once,
    with the values of unbatched calls, also where both are batched; grad
    and jacfwd of the log-density equal those of the same density through
    torch's own triangular solve."""
    L = torch.linalg.cholesky(_t(_spd((), 5, 1)))
    xs = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(0))
    mean = torch.randn(5, generator=torch.Generator().manual_seed(2))
    got = torch.func.vmap(torch.func.vmap(lambda v: tlin.mvn_logpdf_chol(v, mean, L)))(xs)
    torch.testing.assert_close(got, tlin.mvn_logpdf_chol(xs, mean, L))
    Ls = torch.linalg.cholesky(_t(_spd((4,), 5, 2)))
    got = torch.func.vmap(lambda l, v: tlin.mvn_logpdf_chol(v, mean, l))(Ls, xs)
    for b in range(4):
        torch.testing.assert_close(got[b], tlin.mvn_logpdf_chol(xs[b], mean, Ls[b]))
    got = torch.func.vmap(lambda l: tlin.mvn_logpdf_chol(xs[0], mean, l))(Ls)
    torch.testing.assert_close(got[1], tlin.mvn_logpdf_chol(xs[0], mean, Ls[1]))

    def ref(l, x):
        sol = torch.linalg.solve_triangular(l.tril(), (x - mean).T, upper=False)
        logdet = 2.0 * torch.log(torch.diagonal(l)).sum()
        return (-0.5 * (sol.square().sum(0) + logdet + 5 * tlin._LOG_2PI)).sum()

    def port(l, x):
        return tlin.mvn_logpdf_chol(x, mean, l.tril()).sum()

    x = xs[0]
    for f_port, f_ref in ((torch.func.grad(port, argnums=(0, 1)), torch.func.grad(ref, argnums=(0, 1))),
                          (torch.func.jacfwd(port, argnums=(0, 1)), torch.func.jacfwd(ref, argnums=(0, 1)))):
        for g_port, g_ref in zip(f_port(L, x), f_ref(L, x)):
            torch.testing.assert_close(g_port, g_ref, rtol=1e-4, atol=1e-5)


def test_chol_with_jitter_reports_its_rung():
    """``return_jitter`` gives the jitter of the rung taken: 0 for an SPD
    matrix, the first rung that factorizes a singular one (whose factor
    reproduces the matrix plus that jitter), and the one rung asked for
    with ``max_tries=0``."""
    good = _spd((), 5, 4)
    L, j = tlin.chol_with_jitter(_t(good), return_jitter=True)
    assert float(j) == 0.0 and torch.equal(L, tlin.chol_with_jitter(_t(good)))
    bad = np.ones((5, 5), np.float32)
    L, j = tlin.chol_with_jitter(_t(bad), return_jitter=True)
    assert float(j) > 0.0 and bool(torch.isfinite(L).all())
    np.testing.assert_allclose((L @ L.T).numpy(), bad + float(j) * np.eye(5), atol=1e-5)
    L, j = tlin.chol_with_jitter(_t(bad), jitter=1e-2, max_tries=0, return_jitter=True)
    assert float(j) == pytest.approx(1e-2) and bool(torch.isfinite(L).all())

