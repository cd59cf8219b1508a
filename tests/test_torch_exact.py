"""Port parity: the exact (quantized-integer) systematic run ends against the
JAX package, bit for bit.

The port computes the convention in int64 where the JAX package uses 15-bit
int32 limbs; for the same weights, M and u the run ends must be equal. The
cases are those of the JAX package's own exact-path tests (lognormal,
uniform, spiky, point masses, M ≠ N) plus σ = 2, unnormalized and
non-finite weights, and the dispatch past 2²⁴.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu.resampling import exact as jexact
from particle_filters_tpu.resampling import hard as jhard
from particle_filters_tpu_torch.resampling import exact as texact
from particle_filters_tpu_torch.resampling import hard as thard

torch.set_num_threads(1)

_exact_jit = jax.jit(jexact.exact_child_run_ends, static_argnums=2)
_quant_jit = jax.jit(jexact.quantize_weights_limbs)


def _point_masses(n, *where):
    w = np.zeros(n, np.float32)
    w[list(where)] = 1.0
    return w


def _weights(kind, n, rng):
    if kind == "lognormal-1":
        return rng.lognormal(0, 1, n).astype(np.float32)
    if kind == "lognormal-2":
        return rng.lognormal(0, 2, n).astype(np.float32)
    if kind == "uniform":
        return rng.uniform(0.5, 1.5, n).astype(np.float32)
    if kind == "spiky":
        w = rng.uniform(1e-8, 1e-6, n).astype(np.float32)
        w[rng.choice(n, 50, replace=False)] = 1.0
        return w
    if kind == "point-mass-0":
        return _point_masses(n, 0)
    if kind == "point-mass-mid":
        return _point_masses(n, 137)
    if kind == "point-mass-last":
        return _point_masses(n, n - 1)
    if kind == "two-point-masses":
        return _point_masses(n, n // 4, (3 * n) // 4)
    if kind == "non-finite":
        w = rng.lognormal(0, 1, n).astype(np.float32)
        w[::97] = np.nan
        w[5::101] = np.inf
        w[7::103] = -1.0
        return w
    raise ValueError(kind)


CASES = [
    # (kind, N, M, normalize)
    ("lognormal-2", 1 << 16, 1 << 16, True),
    ("lognormal-1", 1 << 14, 1 << 14, True),
    ("uniform", 1 << 14, 1 << 14, True),
    ("spiky", 1 << 14, 1 << 14, True),
    ("point-mass-0", 1 << 10, 1 << 10, True),
    ("point-mass-mid", 1 << 10, 1 << 10, True),
    ("point-mass-last", 1 << 10, 1 << 10, True),
    ("two-point-masses", 1 << 12, 1 << 12, True),
    ("lognormal-1", 1 << 12, 3 * (1 << 12) + 17, True),  # M > N
    ("lognormal-2", 1 << 14, 5000, True),  # M < N
    ("lognormal-2", 7, 1 << 27, True),  # the largest M
    ("lognormal-2", 1, 1 << 10, True),
    ("lognormal-1", 1 << 12, 1 << 12, False),  # unnormalized
    ("non-finite", 1 << 12, 1 << 12, False),
]


@pytest.mark.parametrize("kind,n,m,normalize", CASES,
                         ids=[f"{c[0]}-N{c[1]}-M{c[2]}-{'norm' if c[3] else 'raw'}" for c in CASES])
def test_run_ends_bit_equal_to_jax(kind, n, m, normalize):
    rng = np.random.default_rng(CASES.index((kind, n, m, normalize)))
    w = _weights(kind, n, rng)
    if normalize:
        w = (w / w.sum()).astype(np.float32)
    key = jax.random.PRNGKey(5)
    t_jax = np.asarray(_exact_jit(key, jnp.asarray(w), m))
    u = torch.tensor(float(jax.random.uniform(key, (), jnp.float32)))
    t_port = thard._child_run_ends_u(torch.from_numpy(w), m, u, exact=True)
    assert t_port.dtype == torch.int32
    np.testing.assert_array_equal(t_port.numpy(), t_jax)
    assert int(t_port[-1]) == m and bool((t_port[1:] >= t_port[:-1]).all())


@pytest.mark.parametrize("kind", ["lognormal-2", "spiky", "point-mass-mid", "non-finite"])
def test_quantized_weights_equal_jax_limbs(kind):
    w = _weights(kind, 1 << 12, np.random.default_rng(3))
    q = _quant_jit(jnp.asarray(w))
    q_jax = sum(np.asarray(l).astype(np.int64) << (15 * i) for i, l in enumerate(q))
    np.testing.assert_array_equal(texact.quantize_weights(torch.from_numpy(w)).numpy(), q_jax)


def test_rows_equal_one_dimensional_calls():
    """Weights (B, N) with one u per row: each row's run ends are those of
    the 1-D call (the batched resample of the flows uses rows)."""
    rng = np.random.default_rng(8)
    w = rng.lognormal(0, 2, (3, 512)).astype(np.float32)
    u = torch.tensor([0.1, 0.5, 0.97])
    rows = texact.exact_child_run_ends_u(torch.from_numpy(w), 512, u)
    for b in range(3):
        one = texact.exact_child_run_ends_u(torch.from_numpy(w[b]), 512, u[b])
        assert torch.equal(rows[b], one)


def test_u_on_the_grid_matches_big_integers():
    """U = min(⌊round(u·2²⁴)·Q_total/2²⁴⌋, Q_total − 1) for Q_total past 2⁴²,
    where the product passes 2⁶⁴."""
    q_total = torch.tensor([(1 << 43) + 12345, (1 << 40) - 1, 3])
    for u in (0.0, 0.3, 0.999999940395, 0.5):
        got = texact.exact_u(torch.tensor(u), q_total).tolist()
        n_u = int(np.round(np.float32(u) * np.float32(2.0**24)))
        want = [min((n_u * q) >> 24, q - 1) for q in q_total.tolist()]
        assert got == want


def test_dispatch_past_2_24_for_m():
    """max(N, M) > 2²⁴ takes the exact path by itself, as in the JAX package."""
    w = np.random.default_rng(4).lognormal(0, 1, 64).astype(np.float32)
    w /= w.sum()
    m = (1 << 24) + 8
    key = jax.random.PRNGKey(0)
    t_jax = np.asarray(jhard._child_run_ends(key, jnp.asarray(w), m))
    u = torch.tensor(float(jax.random.uniform(key, (), jnp.float32)))
    t_port = thard._child_run_ends_u(torch.from_numpy(w), m, u)
    np.testing.assert_array_equal(t_port.numpy(), t_jax)
    t_exact = thard._child_run_ends_u(torch.from_numpy(w), m, u, exact=True)
    assert torch.equal(t_port, t_exact)


def test_dispatch_past_2_24_for_n():
    """N = 2²⁴ + 1 particles: the automatic dispatch of both packages, bit
    for bit (the f32 path would quantize here)."""
    n = (1 << 24) + 1
    w = (1.0 + (np.arange(n) % 7)).astype(np.float32)
    w /= w.sum()
    key = jax.random.PRNGKey(3)
    t_jax = np.asarray(jax.jit(lambda w: jhard._child_run_ends(key, w, n))(jnp.asarray(w)))
    u = torch.tensor(float(jax.random.uniform(key, (), jnp.float32)))
    t_port = thard._child_run_ends_u(torch.from_numpy(w), n, u)
    np.testing.assert_array_equal(t_port.numpy(), t_jax)


def test_agrees_with_f32_path_below_ceiling():
    """Below 2²⁴ the exact and f32 run ends differ by at most one slot, at
    the few positions where M·cdf sits within f32 rounding of an integer."""
    w = np.random.default_rng(13).lognormal(0, 1, 1 << 14).astype(np.float32)
    w = torch.from_numpy(w / w.sum())
    u = torch.tensor(0.37)
    t_exact = thard._child_run_ends_u(w, 1 << 14, u, exact=True).long()
    t_f32 = thard._child_run_ends_u(w, 1 << 14, u, exact=False).long()
    d = t_exact - t_f32
    assert int(d.abs().max()) <= 1 and float((d != 0).float().mean()) < 0.05


def test_m_past_2_27_raises():
    with pytest.raises(ValueError, match="M <= 2\\^27"):
        texact.exact_child_run_ends_u(torch.ones(4) / 4, (1 << 27) + 1, torch.tensor(0.5))


def test_systematic_values_past_2_24_use_the_exact_path():
    """The value path past 2²⁴ outputs: counts from the exact run ends, and
    ``systematic_counts`` equals their differences."""
    w = torch.softmax(torch.from_numpy(np.random.default_rng(2).standard_normal(64)
                                       .astype(np.float32)), 0)
    m = (1 << 24) + 3
    idx = thard.systematic_resample(torch.Generator().manual_seed(1), w, num_samples=m)
    t = thard._child_run_ends(torch.Generator().manual_seed(1), w, m)
    counts = torch.bincount(idx.long(), minlength=64)
    assert torch.equal(counts, torch.diff(t, prepend=t.new_zeros(1)).long())
