"""Port parity: the multi-device layer's resampling, weights and mesh, on
4 spawned gloo ranks, against the JAX package's 4-device mesh (the
conftest's virtual devices) on the same numpy inputs.

- ``neighbor_exchange_systematic_resample`` with u from the JAX key
  (``tests/unit/test_distributed_resample.py``'s cases at S = 4: balanced
  weights at radius 1 and 2, a shard-blocked skew, all mass on the last
  shard at radius 1 (the rescue), mass on a middle shard, radius S − 1 at
  that skew): the ``ok`` flags equal to JAX's, the ancestry (column 0
  holds the particle's index) equal to JAX's and to the all-gather
  path's, the values within 1e-5 of JAX's (its telescoping sums round;
  the port's values are copies, equal to the particles they copy).
- The exact mode forced at N = 256 (as ``tests/unit/test_sharding.py``
  forces it): every rank's pooled run ends bit-identical to the one-device
  ``exact_child_run_ends_u`` on the gathered weights and to JAX's
  ``exact_child_run_ends`` for the same u.
- ``core.weights`` with a group: equal to the ungrouped call on the
  gathered vector to f32 rounding (rtol 1e-6, atol 1e-7: sums in another
  order), ESS over the global N.
- ``make_mesh``: shapes and validation (``test_sharding.py:45-56``); the
  point-to-point shift; B2's M→n form (plain version) equal to the slice of
  the whole resample; ``interop.sharded_state_from_jax``; ``run_ranks``
  failing on a rank that raises and on a timeout instead of hanging.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_rank_programs as progs
from particle_filters_tpu.models.particle_filter import PFState as JPFState
from particle_filters_tpu.ops import fused_pf as jfused
from particle_filters_tpu.parallel import neighbor_exchange_systematic_resample as jneighbor
from particle_filters_tpu.resampling import exact as jexact
from particle_filters_tpu_torch import interop
from particle_filters_tpu_torch.core import weights as tw
from particle_filters_tpu_torch.ops.resample import resample_by_starts
from particle_filters_tpu_torch.parallel.launch import run_ranks
from particle_filters_tpu_torch.resampling import exact as texact

torch.set_num_threads(1)

S = 4
TIMEOUT = 120.0


def _cloud(n, d, seed):
    p = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    p[:, 0] = np.arange(n)  # the values carry their ancestor's index
    return p


def _normalized(lw):
    lw = np.asarray(lw, np.float32)
    return (lw - np.float32(jax.scipy.special.logsumexp(jnp.asarray(lw)))).astype(np.float32)


def _point_mass(n, lo, hi):
    lw = np.full(n, -1e6, np.float32)
    lw[lo:hi] = 0.0
    return _normalized(lw)


def _cases():
    """(name, particles, logw, key, radius, exact)."""
    n = 256
    bal = _normalized(0.1 * np.random.default_rng(1).standard_normal(n))
    skew = _normalized(np.log(np.repeat(np.array([1.0, 3.0, 2.0, 1.0]), n // S)))
    last = _point_mass(128, 128 - 128 // S, 128)
    mid = _point_mass(128, 128 // S, 2 * (128 // S))
    return [
        ("balanced-r1", _cloud(n, 3, 0), bal, 2, 1, False),
        ("balanced-r2", _cloud(n, 3, 0), bal, 2, 2, False),
        ("skewed-r1", _cloud(n, 2, 1), skew, 3, 1, False),
        ("last-shard-r1", _cloud(128, 2, 2), last, 6, 1, False),
        ("middle-shard-r1", _cloud(128, 1, 3), mid, 7, 1, False),
        ("last-shard-wide", _cloud(128, 1, 4), last, 5, S - 1, False),
        ("exact-skewed-r1", _cloud(n, 2, 1), skew, 3, 1, True),
        ("exact-last-shard-r1", _cloud(128, 2, 2), last, 6, 1, True),
    ]


CASES = _cases()
IDS = [c[0] for c in CASES]


def _jax_neighbor(key, p, lw, radius, exact):
    mesh = Mesh(np.asarray(jax.devices()[:S]).reshape(1, S), ("batch", "particles"))

    @partial(shard_map, mesh=mesh, in_specs=(P(), P("particles", None), P("particles")),
             out_specs=(P("particles", None), P()), check_vma=False)
    def f(k, pp, ll):
        return jneighbor(k, pp, ll, axis_name="particles", radius=radius, exact=exact)

    vals, ok = f(key, jnp.asarray(p), jnp.asarray(lw))
    return np.asarray(vals), bool(ok)


@pytest.fixture(scope="module")
def weight_inputs():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((256, 3)).astype(np.float32),
            (2.0 * rng.standard_normal(256)).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(weight_inputs, tmp_path_factory):
    cases = [(p, lw, float(jax.random.uniform(jax.random.PRNGKey(k), (), jnp.float32)), r, e)
             for _, p, lw, k, r, e in CASES]
    return run_ranks(progs.resample_suite, S, args=(cases, *weight_inputs),
                     timeout_s=TIMEOUT, store_dir=str(tmp_path_factory.mktemp("store")))


def _jax_exact_values(key, p, lw):
    """The JAX package's exact systematic resample of ``p`` (its run ends,
    then the copies): its sharded exact mode equals these by its own tests,
    and compiling that mode here would take minutes."""
    w = torch.exp(torch.from_numpy(lw)).numpy()  # as the ranks take them
    t = np.asarray(jexact.exact_child_run_ends(key, jnp.asarray(w), w.shape[0]))
    starts = np.concatenate([[0], t[:-1]])
    return p[np.searchsorted(starts, np.arange(p.shape[0]), side="right") - 1]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_neighbor_exchange_matches_jax(ranks, i):
    name, p, lw, k, radius, exact = CASES[i]
    key = jax.random.PRNGKey(k)
    # The exact cases' flags are the f32 mode's on the same weights (no
    # ancestor lies near a pool's edge in them).
    want, want_ok = _jax_neighbor(key, p, lw, radius, False)
    if exact:
        want = _jax_exact_values(key, p, lw)
    got = np.concatenate([r["cases"][i]["neighbor"] for r in ranks])
    agp = np.concatenate([r["cases"][i]["all_gather"] for r in ranks])
    oks = [r["cases"][i]["ok"] for r in ranks]
    assert oks == [want_ok] * S, (name, oks, want_ok)
    np.testing.assert_array_equal(got[:, 0], want[:, 0].round())  # the ancestry
    np.testing.assert_array_equal(got, agp)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert set(map(tuple, got)) <= set(map(tuple, p))  # copies of particles


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES) if c[5]],
                         ids=[c[0] for c in CASES if c[5]])
def test_exact_pooled_starts_bit_identical(ranks, i):
    name, p, lw, k, radius, _ = CASES[i]
    key = jax.random.PRNGKey(k)
    u = jax.random.uniform(key, (), jnp.float32)
    w = torch.exp(torch.from_numpy(lw)).numpy()
    t_port = texact.exact_child_run_ends_u(torch.from_numpy(w), w.shape[0],
                                           torch.tensor(float(u))).numpy()
    t_jax = np.asarray(jexact.exact_child_run_ends(key, jnp.asarray(w), w.shape[0]))
    got = np.concatenate([r["cases"][i]["t_local"] for r in ranks])
    np.testing.assert_array_equal(got, t_port)
    np.testing.assert_array_equal(got, t_jax)
    starts = ranks[0]["cases"][i]["starts"]
    np.testing.assert_array_equal(starts[1:], t_port[:-1])
    for r, res in enumerate(ranks):
        n = w.shape[0] // S
        lo = max(0, r - radius)
        before = 0 if lo == 0 else t_port[lo * n - 1]
        assert int(res["cases"][i]["t_before"].reshape(-1)[0]) == before


def test_weights_with_group_equal_gathered(ranks, weight_inputs):
    p, lw = (torch.from_numpy(a) for a in weight_inputs)
    got = [r["weights"] for r in ranks]
    logw_n, log_z = tw.log_normalize(lw)
    mean, cov = tw.weighted_mean_cov(p, lw)
    tol = dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.concatenate([g["logw_n"] for g in got]), logw_n, rtol=1e-6,
                               atol=1e-6)
    for g in got:
        np.testing.assert_allclose(g["log_z"], log_z, **tol)
        np.testing.assert_allclose(g["ess"], tw.ess_from_logw(lw), rtol=1e-5)
        np.testing.assert_allclose(g["mean"], mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["cov"], cov, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["wmean"], mean, rtol=1e-5, atol=1e-6)
        # ESS is over the global N = 256, not a rank's 64.
        np.testing.assert_allclose(g["ess_uniform"], 256.0, rtol=1e-6)
        for k in g:  # the same bits on every rank
            if k != "logw_n":
                np.testing.assert_array_equal(g[k], got[0][k])


def test_make_mesh_shapes_and_validation(ranks):
    m = ranks[0]["mesh"]
    assert m["names"] == ["batch", "particles"]
    assert m["shape1"] == (1, S) and m["shape2"] == (2, 2) and m["particles_size2"] == 2
    assert "divisible" in m["bad"][0]
    assert "more than" in m["bad"][1]
    assert "leaves out" in m["bad"][2]


def test_shift_is_a_ring_without_wraparound(ranks):
    for r, res in enumerate(ranks):
        for off, got in zip((-2, -1, 1, 2), res["mesh"]["shift"]):
            if 0 <= r + off < S:
                assert float(got[0]) == r + off
            else:
                assert got is None


@pytest.mark.parametrize("n_out,offset,d", [(64, 0, 1), (64, 192, 3), (10, 5, 2)])
def test_resample_by_starts_m_to_n(n_out, offset, d):
    rng = np.random.default_rng(n_out + offset)
    m = 256
    p = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    starts = torch.from_numpy(np.sort(rng.integers(0, m + 1, m)).astype(np.int32))
    starts[0] = 0
    whole = resample_by_starts(p, starts)
    got = resample_by_starts(p, starts, n_out=n_out, offset=offset)
    assert torch.equal(got, whole[offset:offset + n_out])


def test_resample_by_starts_neighbor_pool():
    """A rank's pool: its neighbours' starts, led by a start at or before
    its first slot, give the whole resample's slice."""
    rng = np.random.default_rng(5)
    n, ranks_, r = 64, 4, 2
    w = rng.random(n * ranks_).astype(np.float32)
    t = np.ceil(n * ranks_ * np.cumsum(w) / w.sum() - 0.3).clip(0, n * ranks_).astype(np.int32)
    starts = torch.from_numpy(np.concatenate([[0], t[:-1]]).astype(np.int32))
    p = torch.from_numpy(rng.standard_normal((n * ranks_, 2)).astype(np.float32))
    lo, hi = (r - 1) * n, (r + 2) * n
    got = resample_by_starts(p[lo:hi], starts[lo:hi].contiguous(), n_out=n, offset=r * n)
    assert torch.equal(got, resample_by_starts(p, starts)[r * n:(r + 1) * n])


def test_sharded_state_from_jax():
    n = 64
    rng = np.random.default_rng(0)
    st = JPFState(particles=jnp.asarray(rng.standard_normal((n, 2)), jnp.float32),
                  log_weights=jnp.full((n,), -np.log(n), jnp.float32),
                  mean=jnp.zeros(2), cov=jnp.eye(2), t=jnp.asarray(3, jnp.int32))
    for r in range(S):
        cut = interop.sharded_state_from_jax(st, r, S, device="cpu")
        np.testing.assert_array_equal(cut.particles, np.asarray(st.particles)[r * 16:(r + 1) * 16])
        np.testing.assert_array_equal(cut.mean, np.zeros(2))
    f = jfused.FusedSIRFilter(lambda x: x, lambda x, z: -x * x, np.eye(2, dtype=np.float32),
                              Np=n, block=n)
    carry = f.initialize(jax.random.PRNGKey(0), jnp.zeros(2), jnp.eye(2))
    whole = interop.state_from_jax(carry, device="cpu")
    for r in range(S):
        x, lw, off = interop.sharded_state_from_jax(carry, r, S, device="cpu")
        assert torch.equal(x, whole[0][:, r * 16:(r + 1) * 16])
        assert torch.equal(lw, whole[1][r * 16:(r + 1) * 16]) and torch.equal(off, whole[2])


def test_run_ranks_fails_instead_of_hanging(tmp_path):
    with pytest.raises(RuntimeError, match="failed on purpose"):
        run_ranks(progs.fail_on_rank, 2, args=(1,), timeout_s=TIMEOUT,
                  store_dir=str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="timed out"):
        run_ranks(progs.sleep_past, 1, args=(120,), timeout_s=6.0,
                  store_dir=str(tmp_path / "b"))
