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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu_torch.benchmarks import kpf
from particle_filters_tpu_torch.examples import ex12_kernel_pf_experiments as ex

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
