"""Port parity: hard resampling and kernel B2's plain version against the
JAX package (its Pallas resample kernel in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from particle_filters_tpu.ops.resample_pallas import systematic_resample_values_blocked
from particle_filters_tpu.resampling import hard as jhard
from particle_filters_tpu_torch.ops.resample import (
    resample_by_starts,
    resample_by_starts_reference,
)
from particle_filters_tpu_torch.ops.systematic_starts import running_max
from particle_filters_tpu_torch.resampling import hard as thard

torch.set_num_threads(1)


def _softmax(z):
    e = np.exp(z - z.max())
    return (e / e.sum()).astype(np.float32)


def _jax_u(key):
    """The u that the JAX package's _child_run_ends draws from ``key``."""
    return float(jax.random.uniform(key, (), jnp.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_child_run_ends_integer_equal_on_shared_cdf(seed):
    """Weights c_j / 2^20 with integer c_j: every partial sum is exact in
    f32, so both packages see one cdf whatever their summation order."""
    n = 1 << 15
    counts = np.random.default_rng(seed).integers(0, 64, n).astype(np.float64)
    counts[-1] += (1 << 20) - counts.sum() if counts.sum() < (1 << 20) else 0
    w = (counts / counts.sum()).astype(np.float32)
    assert np.cumsum(w.astype(np.float64))[-1] == 1.0
    key = jax.random.PRNGKey(seed)
    t_jax = np.asarray(jhard._child_run_ends(key, jnp.asarray(w), n))
    t_port = thard._child_run_ends_u(torch.from_numpy(w), n, torch.tensor(_jax_u(key)))
    np.testing.assert_array_equal(t_port.numpy(), t_jax)


def test_child_run_ends_end_to_end_rare_shifts():
    """Generic weights at N = 2^15: JAX's blocked cumsum and torch.cumsum
    differ in order, so ≤ 1e-3 of the run ends may move by ±1."""
    n = 1 << 15
    w = _softmax(1.5 * np.random.default_rng(7).standard_normal(n))
    key = jax.random.PRNGKey(11)
    t_jax = np.asarray(jhard._child_run_ends(key, jnp.asarray(w), n))
    t_port = thard._child_run_ends_u(torch.from_numpy(w), n, torch.tensor(_jax_u(key))).numpy()
    diff = np.abs(t_port.astype(np.int64) - t_jax)
    assert diff.max() <= 1
    assert np.mean(diff > 0) <= 1e-3


@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 3000, (1 << 20) + 3])
def test_running_max_equals_cummax(n):
    """The two-level running maximum that keeps the cdf nondecreasing (the
    card's parallel cumsum can round a partial sum down) is torch.cummax."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(np.float32))
    assert torch.equal(running_max(x), torch.cummax(x, 0).values)
    t = x.to(torch.int32)
    assert torch.equal(running_max(t), torch.cummax(t, 0).values)


def test_inexact_sizes_raise():
    """Past 2²⁴ the exact path takes over (no longer an error); past its
    M = 2²⁷ limit the run ends raise, as in the JAX package."""
    t = thard._child_run_ends_u(torch.ones(4) / 4, (1 << 24) + 1, torch.tensor(0.5))
    assert int(t[-1]) == (1 << 24) + 1
    with pytest.raises(ValueError):
        thard._child_run_ends_u(torch.ones(4) / 4, (1 << 27) + 1, torch.tensor(0.5))


@pytest.mark.parametrize("d", [1, 3])
def test_b2_plain_equals_gather_of_indices(d):
    n = 5000
    rng = np.random.default_rng(d)
    w = torch.from_numpy(_softmax(3.0 * rng.standard_normal(n)))
    p = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    vals = thard.systematic_resample_values(torch.Generator().manual_seed(4), p, w=w)
    idx = thard.systematic_resample(torch.Generator().manual_seed(4), w)
    assert torch.equal(vals, p[idx.long()])
    starts = thard._systematic_starts(torch.Generator().manual_seed(4), w, n)
    assert torch.equal(resample_by_starts_reference(p, starts), vals)
    assert torch.equal(resample_by_starts(p, starts), vals)  # CPU tensor: plain


def _mid_tier_weights(n):
    w = np.ones(n, np.float32)
    w[64:704] = 1e-6
    return (w / w.sum()).astype(np.float32)


B2_CASES = {
    # name: (n, d, weights) — the cases of the JAX kernel's interpret tests
    "smooth": (4096, 1, lambda n, rng: _softmax(1.0 * rng.standard_normal(n))),
    "near-uniform": (4096, 1, lambda n, rng: _softmax(0.05 * rng.standard_normal(n))),
    "heavy-multi-d": (4096, 2, lambda n, rng: _softmax(3.0 * rng.standard_normal(n))),
    "tail-block": (3000, 1, lambda n, rng: _softmax(2.0 * rng.standard_normal(n))),
    "mid-tier": (4096, 2, lambda n, rng: _mid_tier_weights(n)),
}


@pytest.mark.parametrize("case", list(B2_CASES))
def test_b2_plain_matches_jax_blocked_kernel(case):
    n, d, make_w = B2_CASES[case]
    rng = np.random.default_rng(list(B2_CASES).index(case))
    w = make_w(n, rng)
    p = rng.standard_normal((n, d)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    with pltpu.force_tpu_interpret_mode():
        v_jax = np.asarray(
            systematic_resample_values_blocked(key, jnp.asarray(p), w=jnp.asarray(w))
        )
    # B2 maps starts to values; the starts are held against JAX's above, so
    # here both sides take the JAX kernel's own starts (its w / Σw first).
    wn = jnp.asarray(w) / jnp.sum(jnp.asarray(w))
    starts = torch.from_numpy(np.array(jhard._systematic_starts(key, wn, n)))
    v_port = resample_by_starts_reference(torch.from_numpy(p), starts).numpy()
    np.testing.assert_allclose(v_port, v_jax, atol=1e-4)


def _counts(idx, n):
    return np.bincount(idx.numpy().astype(np.int64), minlength=n)


def test_systematic_counts_within_one_of_expected():
    n = 2000
    w = torch.from_numpy(_softmax(np.random.default_rng(5).standard_normal(n)))
    gen = torch.Generator().manual_seed(0)
    c = thard.systematic_counts(gen, w).numpy()
    assert c.sum() == n and np.all(np.abs(c - n * w.numpy()) < 1.0 + 1e-3)
    c2 = _counts(thard.systematic_resample(torch.Generator().manual_seed(0), w), n)
    np.testing.assert_array_equal(c, c2)


@pytest.mark.parametrize("method", ["multinomial", "stratified", "residual"])
def test_other_methods_statistically(method):
    """Valid int32 indices; average child counts match N·w; residual keeps
    its ⌊N w⌋ deterministic copies and stratified stays within ±1 of N·w."""
    n, reps = 500, 200
    w_np = _softmax(1.0 * np.random.default_rng(9).standard_normal(n))
    w = torch.from_numpy(w_np)
    gen = torch.Generator().manual_seed(1)
    total = np.zeros(n)
    for _ in range(reps):
        idx = thard.resample_indices(method, gen, w)
        assert idx.dtype == torch.int32 and idx.shape == (n,)
        assert int(idx.min()) >= 0 and int(idx.max()) < n
        c = _counts(idx, n)
        if method == "residual":
            assert np.all(c >= np.floor(n * w_np) - 1e-9)
        if method == "stratified":
            assert np.all(np.abs(c - n * w_np) < 2.0)
        total += c
    mean = total / reps
    # multinomial: Var(c_j) ≤ N w_j, so the mean of reps draws is within
    # 5 sd of N·w (plus a floor for the smallest weights)
    sd = np.sqrt(n * w_np / reps)
    assert np.all(np.abs(mean - n * w_np) < 5 * sd + 0.05)


def test_log_weights_and_argument_errors():
    w = _softmax(np.random.default_rng(2).standard_normal(100))
    a = thard.systematic_resample(torch.Generator().manual_seed(3), torch.from_numpy(w))
    b = thard.systematic_resample(
        torch.Generator().manual_seed(3), logw=torch.from_numpy(np.log(w) + 4.0)
    )
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="exactly one"):
        thard.systematic_resample(torch.Generator())
    with pytest.raises(ValueError, match="Unknown resample method"):
        thard.resample_indices("bogus", torch.Generator(), torch.from_numpy(w))
    with pytest.raises(TypeError):
        resample_by_starts(torch.zeros(4, 1, dtype=torch.float64), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        resample_by_starts(torch.zeros(4, 1), torch.zeros(3, dtype=torch.int32))
