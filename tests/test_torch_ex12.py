"""Port parity: ``examples/12_kernel_pf_experiments.py`` and its twin
``particle_filters_tpu_torch/examples/ex12_kernel_pf_experiments.py``, on
the committed ``kpf_l96_nx1000.npz`` (the JAX package's prior ensemble,
observation, ``H_idx``, ``R_diag`` and KPF posteriors).

- The perturbed-observation EnKF from the JAX package's perturbations
  (``PRNGKey(999)``): posterior ensemble and analytic covariance within
  5e-5 (f32 rounding of a 250 × 250 solve: members' entries of order 1-10
  differ by up to 2.3e-5).
- Both tables' functions on the same ensembles (the JAX package's EnKF and
  its committed KPF posteriors): the 2-D marginal's trace and the observed
  and unobserved variances within 1e-5 relative.
- The whole example on the CPU with the JAX package's perturbations: its
  EnKF numbers within 1e-4 relative of the JAX package's, its KPF rows
  within ``benchmarks/kpf.py``'s tolerance of the committed posteriors
  (the ladder takes the JAX package's rung on the CPU), the module's gates.
- The rung of the unlocalized diagonal case: in float32 the CPU's factor
  pinned at 1e-5 is not finite and the one at 1e-4 passes the ladder's
  residual bound; in float64 the posterior's variance reductions at 1e-5
  and 1e-4 agree within 0.5 points (>= 0.85); a finite but inaccurate
  factor at 1e-5 (float64's, rounded to float32) is rejected by the
  ladder, which takes 1e-4 and gives the JAX package's reductions within
  ``DIAG_USER_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu_torch.benchmarks import kpf
from particle_filters_tpu_torch.examples import ex12_kernel_pf_experiments as ex
from particle_filters_tpu_torch.models import kernel_particle_filter as tkpf
from particle_filters_tpu_torch.models.kernel_particle_filter import KernelParticleFilter

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    return kpf.load_data(CPU)


def jax_enkf(d):
    """The JAX script's ``enkf_update`` and its standard normals."""
    X, y = jnp.asarray(d["prior1"].numpy()), jnp.asarray(d["y1"].numpy())
    H_idx, R = jnp.asarray(d["H_idx"].numpy()), jnp.diag(jnp.asarray(d["R_diag"].numpy()))
    Np, _ = X.shape
    A = X - jnp.mean(X, axis=0)
    P = (A.T @ A) / (Np - 1)
    HP = jnp.take(P, H_idx, axis=0)
    S = jnp.take(HP, H_idx, axis=1) + R
    K = jnp.linalg.solve(S, HP).T
    normals = jax.random.normal(jax.random.PRNGKey(ex.ENKF_SEED), (Np, H_idx.shape[0]))
    pert = normals @ jnp.linalg.cholesky(R).T
    X_post = jax.vmap(lambda x, e: x + K @ (y + e - jnp.take(x, H_idx)))(X, pert)
    return np.asarray(X_post), np.asarray(P - K @ HP), np.asarray(normals)


def jax_tables(X, H_idx, idx=ex.VARS):
    A = X - jnp.mean(X, axis=0)
    P = (A.T @ A) / (X.shape[0] - 1)
    tr = float(jnp.trace(P[jnp.ix_(jnp.array(idx), jnp.array(idx))]))
    v = jnp.var(X, axis=0)
    unobs = np.setdiff1d(np.arange(X.shape[1]), np.asarray(H_idx))
    return tr, (float(jnp.mean(v[H_idx])), float(jnp.mean(v[unobs])))


def test_enkf_from_jax_perturbations(data):
    X_post, P_an, normals = jax_enkf(data)
    got, got_p = ex.enkf_update(data["prior1"], data["y1"], data["H_idx"].long(),
                                torch.diag(data["R_diag"]), torch.tensor(normals))
    np.testing.assert_allclose(got.numpy(), X_post, rtol=0, atol=5e-5)
    np.testing.assert_allclose(got_p.numpy(), P_an, rtol=0, atol=5e-5)


@pytest.mark.parametrize("name", ["enkf", "post_scalar", "post_diagonal", "prior1"])
def test_tables_on_the_same_ensembles(data, name):
    X = jax_enkf(data)[0] if name == "enkf" else data[name].numpy()
    H_idx = data["H_idx"].numpy()
    tr, (o, u) = jax_tables(jnp.asarray(X), jnp.asarray(H_idx))
    Xt = torch.tensor(X)
    np.testing.assert_allclose(torch.trace(ex.ens_cov_2d(Xt)).item(), tr, rtol=1e-5)
    np.testing.assert_allclose(ex.variances(Xt, data["H_idx"].long()), (o, u), rtol=1e-5)


def test_example_on_the_cpu(data):
    X_post, P_an, normals = jax_enkf(data)
    res = ex.run_all(CPU, data, perturbations=torch.tensor(normals))
    H_idx = jnp.asarray(data["H_idx"].numpy())
    tr, var = jax_tables(jnp.asarray(X_post), H_idx)
    np.testing.assert_allclose(res["trace"]["EnKF"], tr, rtol=1e-4)
    np.testing.assert_allclose(res["variance"]["EnKF"], var, rtol=1e-4)
    np.testing.assert_allclose(res["enkf_var_mean"], float(np.var(X_post, axis=0).mean()),
                               rtol=1e-4)
    np.testing.assert_allclose(res["analytic_var_mean"], float(np.diagonal(P_an).mean()),
                               rtol=1e-4)
    for name in ex.KERNELS:
        r = res["kpf"][name]
        kind, bound = kpf.tolerance(name)
        assert np.float32(r["rung"]) == np.float32(kpf.JAX_RUNG[name]) and r[kind] <= bound
    gates = ex.gates(res)
    assert all(held for _, held in gates.values()), gates


def test_f32_factor_at_the_cards_rung_is_not_finite_on_the_cpu(data):
    """The unlocalized diagonal case's B + reg·I in float32: the ladder takes
    1e-4 (the JAX package's rung), and LAPACK's factor pinned at 1e-5 (the
    rung the card's cuSOLVER takes) is not finite, so the card's float32
    run cannot be replayed on the CPU."""
    cfg, idx = kpf.CASES["diagonal"]
    f = KernelParticleFilter(kpf.obs_model(data), cfg)
    B = f._prior_stats(data[f"prior{idx}"])[1]
    L, rung = f.prior_factor(B)
    assert np.float32(float(rung)) == np.float32(1e-4) and bool(torch.isfinite(L).all())
    L5, _ = f.prior_factor(B, 1e-5)
    assert not bool(torch.isfinite(L5).all())


def test_f64_diagonal_posterior_does_not_depend_on_the_rung(data):
    """In float64 the diagonal kernel's variance reductions at jitter 1e-5
    and 1e-4 agree within 0.5 points and both are >= ``F64_MIN_RED``: the
    rung moves the posterior only through float32 rounding."""
    r5 = ex.diagonal_f64(CPU, data, 1e-5)
    r4 = ex.diagonal_f64(CPU, data, 1e-4)
    assert min(r5 + r4) >= ex.F64_MIN_RED, (r5, r4)
    np.testing.assert_allclose(r5, r4, rtol=0, atol=0.005)


def test_f32_factor_residuals_on_the_cpu(data):
    """The residual bound passes LAPACK's factor at the JAX package's rung;
    LAPACK has no factor at 1e-5."""
    resid = ex.diagonal_factor_residuals(CPU, data)
    assert resid[1e-5] == float("inf")
    assert resid[1e-4] <= tkpf.FACTOR_RESID_MAX, resid


def test_ladder_rejects_a_finite_inaccurate_factor(data, monkeypatch):
    """The ladder handed a finite factor at 1e-5 that is too far from
    B + reg·I (float64's factor rounded to float32, residual ~0.85, whose
    posterior loses ~8 points of variance reduction) restarts above it,
    takes 1e-4 and gives the JAX package's reductions within
    ``DIAG_USER_TOL``."""
    cfg, idx = kpf.CASES["diagonal"]
    f = KernelParticleFilter(kpf.obs_model(data), cfg)
    X, H_idx = data[f"prior{idx}"], data["H_idx"].long()
    n = X.shape[1]
    real = tkpf.chol_with_jitter

    def ladder(a, jitter=0.0, **kw):
        if a.shape[-1] == n and jitter == 0.0 and not kw.get("max_tries", 1) == 0:
            eye = torch.eye(n, dtype=torch.float64)
            return (torch.linalg.cholesky(a.double() + 1e-5 * eye).float(),
                    torch.tensor(1e-5, dtype=a.dtype))
        return real(a, jitter=jitter, **kw)

    monkeypatch.setattr(tkpf, "chol_with_jitter", ladder)
    B = f._prior_stats(X)[1]
    L5, rung5 = ladder(B + cfg.reg * torch.eye(n))
    assert tkpf.factor_residual(L5, B + (cfg.reg + 1e-5) * torch.eye(n)) > tkpf.FACTOR_RESID_MAX
    L, rung = f.prior_factor(B)
    assert np.float32(float(rung)) == np.float32(1e-4) and bool(torch.isfinite(L).all())
    post = f.analyze(X, data[f"y{idx}"]).particles
    red = [1 - a / b for a, b in zip(ex.variances(post, H_idx), ex.variances(X, H_idx))]
    want = [1 - a / b for a, b in zip(ex.variances(data["post_diagonal"], H_idx),
                                      ex.variances(X, H_idx))]
    np.testing.assert_allclose(red, want, rtol=0, atol=ex.DIAG_USER_TOL)
