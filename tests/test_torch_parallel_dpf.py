"""Port parity: sharded differentiable-PF training and the whole slice on
spawned gloo ranks.

- ``make_sharded_dpf_train_step`` (``tests/unit/test_sharding.py:118-213``)
  on a 2×2 and a 1×2 mesh against a 1×1 mesh (a world of one in this
  process): the loss, the gradients and the updated parameters equal to f32
  rounding (rtol 1e-5, atol 1e-6), the noise being drawn at the global
  shape; the loss finite and α moved as the JAX package's step moves it
  (over 8 keys each, the mean change equal by a Welch test, p ≥ 1e-3: the
  draws differ); ``sharded_soft_resample`` giving every rank distinct rows;
  the particle count validated.
- The whole slice: the port's run of ``dryrun_multichip``'s four phases
  (``__graft_entry__.py:162``) at their sizes on a 2×2 mesh and on a world
  of one: finite, the forced resamples on every step, the neighbour pool
  sufficient; the DPF loss, the fused all-gather run and the EDH run (no
  process noise) equal to the one-rank run to f32 rounding.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_rank_programs as progs
from particle_filters_tpu.parallel.dpf_sharded import make_sharded_dpf_train_step as jstep
from particle_filters_tpu_torch.benchmarks._stats import P_MIN, summary, welch_z
from particle_filters_tpu_torch.parallel import make_sharded_dpf_train_step
from particle_filters_tpu_torch.parallel.launch import process_group, run_ranks, to_numpy

torch.set_num_threads(1)

B, N, T = 4, 32, 5
SEED, DRY_SEED = 3, 0
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(SEED)
    xs = rng.standard_normal((B, T, 1)).astype(np.float32)
    ys = (np.exp(0.5 * xs) * rng.standard_normal((B, T, 1))).astype(np.float32)
    return xs, ys


def _args(n_batch, data):
    return (n_batch, N, *data, SEED, n_batch, DRY_SEED)


@pytest.fixture(scope="module")
def one(data, tmp_path_factory):
    with process_group("gloo", store_dir=str(tmp_path_factory.mktemp("store"))):
        return to_numpy(progs.dpf_suite(*_args(1, data)))


@pytest.fixture(scope="module")
def two_by_two(data, tmp_path_factory):
    return run_ranks(progs.dpf_suite, 4, args=_args(2, data), timeout_s=120.0,
                     store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.fixture(scope="module")
def one_by_two(data, tmp_path_factory):
    return run_ranks(progs.dpf_train, 2, args=(1, N, *data, SEED), timeout_s=120.0,
                     store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_dpf_train_step_equals_unsharded(one, two_by_two, one_by_two, mesh):
    ranks = [r["dpf"] for r in two_by_two] if mesh == "2x2" else one_by_two
    want = one["dpf"]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], **TOL)
        for k in want["grads"]:
            np.testing.assert_allclose(r["grads"][k], want["grads"][k], **TOL, err_msg=k)
            np.testing.assert_allclose(r["new"][k], want["new"][k], **TOL, err_msg=k)


def test_dpf_train_step_moves_alpha_as_jax(tmp_path, data):
    """The step's change of α over 8 keys (the JAX package's on its 2×2
    mesh, the port's on a world of one): finite, non-zero, and the two
    samples' means equal by the Welch test of ``benchmarks/_stats.py``
    (p ≥ 1e-3), the draws of the two packages being different."""
    xs, ys = data
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("batch", "particles"))

    def transition_fn(p, k, particles):
        return p["alpha"] * particles + jnp.exp(p["log_sigma"]) * jax.random.normal(
            k, particles.shape)

    def obs_loglik_fn(p, particles, y):
        var = jnp.exp(particles[:, 0])
        return -0.5 * (y[0] ** 2 / var + jnp.log(var))

    step = jstep(mesh, n_particles=N, transition_fn=transition_fn, obs_loglik_fn=obs_loglik_fn,
                 init_fn=lambda p, k, m: jnp.exp(p["log_sigma"]) * jax.random.normal(k, (m, 1)),
                 loss_fn=lambda m, x: jnp.mean((m - x) ** 2))
    params = {"alpha": jnp.asarray(progs.ALPHA0),
              "log_sigma": jnp.asarray(math.log(progs.SIGMA0))}
    d_jax, d_port = [], []
    with process_group("gloo", store_dir=str(tmp_path)):
        for k in range(8):
            loss, new = step(params, jax.random.PRNGKey(k), jnp.asarray(ys), jnp.asarray(xs))
            port = to_numpy(progs.dpf_train(1, N, xs, ys, 100 + k))
            assert np.isfinite(float(loss)) and np.isfinite(port["loss"])
            d_jax.append(float(new["alpha"]) - progs.ALPHA0)
            d_port.append(float(port["new"]["alpha"]) - progs.ALPHA0)
    assert all(d != 0.0 for d in d_jax + d_port)
    _, p = welch_z(d_port, *summary(d_jax))
    assert p >= P_MIN, (p, d_port, d_jax)


def test_soft_resample_differs_across_ranks(two_by_two):
    for r in two_by_two:
        assert np.all(np.isfinite(r["dpf"]["soft"]))
    # the 2x2 mesh: ranks (b, 0) and (b, 1) hold different rows of one cloud
    assert not np.allclose(two_by_two[0]["dpf"]["soft"], two_by_two[1]["dpf"]["soft"])
    assert "divide" in two_by_two[0]["dpf"]["bad"]


def test_whole_slice_dry_run(one, two_by_two):
    for r in two_by_two:
        d = r["dry"]
        assert np.isfinite(d["loss"]) and float(d["alpha"]) != progs.ALPHA0
        assert np.all(np.isfinite(d["pf"]["mean"])) and d["pf"]["exchange_ok"].all()
        assert d["pf"]["resampled"].all()
        assert np.all(np.isfinite(d["fused"]["mean"])) and d["fused"]["resampled"].all()
        assert np.all(np.isfinite(d["edh"]["mean"]))
        np.testing.assert_allclose(d["loss"], two_by_two[0]["dry"]["loss"], rtol=0, atol=0)
    d, d1 = two_by_two[0]["dry"], one["dry"]
    np.testing.assert_allclose(d["loss"], d1["loss"], **TOL)
    np.testing.assert_allclose(d["alpha"], d1["alpha"], **TOL)
    for k in ("mean", "ess", "log_evidence"):
        np.testing.assert_allclose(d["fused"][k], d1["fused"][k], **TOL, err_msg=k)
    for k in ("mean", "cov", "ess"):
        np.testing.assert_allclose(d["edh"][k], d1["edh"][k], **TOL, err_msg=k)


def test_unsharded_dpf_step_equals_one_rank(one, data):
    """``mesh=None``: the same step on one device without collectives,
    equal to the one-rank mesh's bit for bit (its sums are of one rank)."""
    tr, ll, init, loss_fn = progs.dpf_parts()
    step = make_sharded_dpf_train_step(None, n_particles=N, dim=1, transition_fn=tr,
                                       obs_loglik_fn=ll, init_fn=init, loss_fn=loss_fn)
    params = {"alpha": torch.tensor(progs.ALPHA0),
              "log_sigma": torch.tensor(math.log(progs.SIGMA0))}
    xs, ys = data
    loss, new = step(params, torch.Generator().manual_seed(SEED), torch.from_numpy(ys),
                     torch.from_numpy(xs))
    np.testing.assert_array_equal(loss.numpy(), one["dpf"]["loss"])
    for k, v in new.items():
        np.testing.assert_array_equal(v.numpy(), one["dpf"]["new"][k])
