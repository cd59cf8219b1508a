"""Port parity: soft (Gumbel-mixture) resampling and Sinkhorn-OT resampling,
dense and blockwise, against the JAX package.

- Soft: the batched log-normalize to 1e-6; the Gumbel draws' interval (no
  −inf at u = 0); ``soft_resample`` fed the JAX package's own Gumbel draws
  (``sample_gumbel`` on the key its ``gumbel_softmax`` splits off) gives its
  assignment and particles to 2e-6 and its aux diagnostics to 1e-5.
- Dense OT: deterministic given the cloud, so the resampled particles, the
  diagnostics and the autograd gradients (with respect to the particles
  and the log-weights, of a fixed functional of the output) equal the JAX
  package's ``jax.grad`` to f32 rounding: rtol 2e-4, atol 2e-5 at ε = 0.1
  (the dual iteration is unrolled 50 times; each step re-rounds a
  logsumexp of terms divided by ε), and at ε = 0.01 with TF32-free
  products, rtol 1e-3 / atol 1e-4 (rounding in C is multiplied by 100).
- Blockwise OT against dense, with N not a multiple of the block (N = 37,
  block 16: the last block holds 11 padded columns of −inf log-mass):
  values to 2e-5 and autograd gradients finite and to 1e-4; and against
  the JAX package's blockwise to the same tolerance.

Run as a script, this file prints the JAX package's ``ot_large`` mean
errors on the CPU (``JAX_MEAN_ERR`` of ``benchmarks/ot_large.py``):

    JAX_PLATFORMS=cpu python tests/test_torch_soft_ot.py
"""

import os
import sys

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from particle_filters_tpu.resampling import ot as jot  # noqa: E402
from particle_filters_tpu.resampling import ot_blockwise as jotb  # noqa: E402
from particle_filters_tpu.resampling import soft as jsoft  # noqa: E402
from particle_filters_tpu_torch.resampling import ot as tot  # noqa: E402
from particle_filters_tpu_torch.resampling import ot_blockwise as totb  # noqa: E402
from particle_filters_tpu_torch.resampling import soft as tsoft  # noqa: E402

torch.set_num_threads(1)


def _cloud(seed, n, d=2, spread=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    lw = (spread * rng.standard_normal(n)).astype(np.float32)
    return x, lw


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# --------------------------------- soft ------------------------------------


def test_log_normalize_lastaxis_matches_jax():
    _, lw = _cloud(0, 24)
    lw = np.stack([lw, lw * 3.0, np.full_like(lw, -np.inf)])
    jn, jz = jsoft.log_normalize_lastaxis(jnp.asarray(lw))
    tn, tz = tsoft.log_normalize_lastaxis(_t(lw))
    np.testing.assert_allclose(tn.numpy()[:2], np.asarray(jn)[:2], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)


def test_gumbel_draws_are_finite_at_the_interval_ends(monkeypatch):
    g = torch.Generator().manual_seed(0)
    assert torch.isfinite(tsoft.sample_gumbel(g, (64, 64))).all()
    # torch.rand can return 0 (and at most 1 − 2⁻²⁴): both ends stay finite,
    # at the JAX package's values for its interval [eps, 1 − eps).
    ends = torch.tensor([0.0, 1.0 - 2.0**-24])
    monkeypatch.setattr(tsoft.torch, "rand", lambda *a, **k: ends.clone())
    for eps in (1e-20, 1e-10):
        t = tsoft.sample_gumbel(g, (2,), eps=eps)
        j = -jnp.log(-jnp.log(jnp.array([eps, 1.0 - 2.0**-24], jnp.float32)))
        assert torch.isfinite(t).all()
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    monkeypatch.undo()
    # A different generator state gives different draws; one state, the same.
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(tsoft.sample_gumbel(g1, (5,)), tsoft.sample_gumbel(g2, (5,)))


@pytest.mark.parametrize("alpha,temperature", [(0.5, 0.5), (0.1, 0.2), (0.0, 1.0)])
def test_soft_resample_with_jax_gumbel_draws(alpha, temperature):
    x, lw = _cloud(1, 20, d=3)
    key = jax.random.PRNGKey(7)
    jp, jlw, jaux = jsoft.soft_resample(key, jnp.asarray(x), jnp.asarray(lw), alpha=alpha,
                                        temperature=temperature, return_aux=True)
    gumbel = np.asarray(jsoft.sample_gumbel(key, (20, 20), jnp.float32))
    tp, tlw, taux = tsoft.soft_resample(None, _t(x), _t(lw), alpha=alpha,
                                        temperature=temperature, return_aux=True,
                                        gumbel=_t(gumbel))
    np.testing.assert_allclose(taux["assignment"].numpy(), np.asarray(jaux["assignment"]),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(tlw.numpy(), np.asarray(jlw), rtol=1e-6)
    for k in ("assignment_entropy_mean", "assignment_entropy_std", "max_weight_before"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), rtol=1e-5, atol=1e-6)


def test_soft_resample_batched_equals_per_cloud():
    x, lw = _cloud(2, 16)
    xb, lwb = np.stack([x, x[::-1]]), np.stack([lw, -lw])
    g = torch.Generator().manual_seed(0)
    gumbel = tsoft.sample_gumbel(g, (2, 16, 16))
    pb, _ = tsoft.soft_resample(None, _t(xb), _t(lwb), gumbel=gumbel)
    for b in range(2):
        p1, _ = tsoft.soft_resample(None, _t(xb[b]), _t(lwb[b]), gumbel=gumbel[b])
        np.testing.assert_allclose(pb[b].numpy(), p1.numpy(), rtol=1e-6, atol=1e-6)


# ------------------------------- dense OT ----------------------------------


def _functional(lib, new_p):
    c = lib.arange(new_p.shape[0] * new_p.shape[1]).reshape(new_p.shape) % 3 - 1.0
    return lib.sum(lib.tanh(new_p) * c)


@pytest.mark.parametrize("epsilon,damping,n_iters,tol", [
    (0.1, 0.5, 50, dict(rtol=2e-4, atol=2e-5)),
    (0.3, 1.0, 30, dict(rtol=2e-4, atol=2e-5)),
    (0.01, 1.0, 50, dict(rtol=1e-3, atol=1e-4)),
])
def test_sinkhorn_values_and_gradients_match_jax(epsilon, damping, n_iters, tol):
    x, lw = _cloud(3, 24, spread=0.5)
    kw = dict(epsilon=epsilon, n_iters=n_iters, damping=damping)

    def jloss(xx, ll):
        new_p, _ = jot.ot_resample(None, xx, ll, **kw)
        return _functional(jnp, new_p)

    jval, (jgx, jgl) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(lw))
    tx, tl = _t(x, True), _t(lw, True)
    new_p, new_lw = tot.ot_resample(None, tx, tl, **kw)
    tval = _functional(torch, new_p)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **tol)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgl), **tol)
    np.testing.assert_allclose(new_lw.detach().numpy(), np.full(24, -np.log(24)), rtol=1e-6)


def test_sinkhorn_diagnostics_match_jax():
    x, lw = _cloud(4, 30)
    w = np.exp(lw - lw.max())
    w = (w / w.sum()).astype(np.float32)
    _, jw, jd = jot.sinkhorn_ot_resample(jnp.asarray(x), jnp.asarray(w), epsilon=0.2,
                                         n_iters=40, return_diagnostics=True)
    _, tw, td = tot.sinkhorn_ot_resample(_t(x), _t(w), epsilon=0.2, n_iters=40,
                                         return_diagnostics=True)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    for k in ("final_delta", "ot_distance", "transport_plan_sparsity"):
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(td["convergence_history"].numpy(),
                               np.asarray(jd["convergence_history"]), rtol=1e-3, atol=1e-6)
    assert bool(td["converged"]) == bool(jd["converged"])
    for k in ("f_mean", "f_std", "g_mean", "g_std"):
        np.testing.assert_allclose(float(td["dual_variables"][k]),
                                   float(jd["dual_variables"][k]), rtol=1e-4, atol=1e-5)
    c_j = jot.pairwise_squared_distances(jnp.asarray(x), jnp.asarray(x[:7]))
    c_t = tot.pairwise_squared_distances(_t(x), _t(x[:7]))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6, atol=1e-6)


def test_sinkhorn_preserves_the_weighted_mean_when_converged():
    x, lw = _cloud(5, 40)
    w = torch.softmax(_t(lw), 0)
    new_p, _, d = tot.sinkhorn_ot_resample(_t(x), w, epsilon=0.5, n_iters=200,
                                           damping=1.0, return_diagnostics=True)
    assert bool(d["converged"])
    np.testing.assert_allclose(new_p.mean(0).numpy(), (w @ _t(x)).numpy(), atol=1e-4)


# ----------------------------- blockwise OT --------------------------------


@pytest.mark.parametrize("n,block", [(37, 16), (32, 16), (5, 8)])
def test_blockwise_matches_dense_values_and_gradients(n, block):
    x, lw = _cloud(6, n, spread=0.7)
    kw = dict(epsilon=0.1, n_iters=20, damping=0.5)
    xd, ld = _t(x, True), _t(lw, True)
    pd, _ = tot.ot_resample(None, xd, ld, **kw)
    _functional(torch, pd).backward()
    xb, lb = _t(x, True), _t(lw, True)
    pb, lwb = totb.ot_resample_blockwise(None, xb, lb, block=block, **kw)
    _functional(torch, pb).backward()
    np.testing.assert_allclose(pb.detach().numpy(), pd.detach().numpy(), rtol=2e-5, atol=2e-5)
    assert torch.isfinite(xb.grad).all() and torch.isfinite(lb.grad).all()
    np.testing.assert_allclose(xb.grad.numpy(), xd.grad.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lb.grad.numpy(), ld.grad.numpy(), rtol=1e-4, atol=1e-4)
    assert lwb.shape == (n,)


def test_blockwise_matches_jax_blockwise():
    x, lw = _cloud(7, 45)
    w = np.asarray(jax.nn.softmax(jnp.asarray(lw)))
    jp, jw = jotb.sinkhorn_ot_resample_blockwise(jnp.asarray(x), jnp.asarray(w), epsilon=0.1,
                                                 n_iters=10, block=16)
    tp, tw = totb.sinkhorn_ot_resample_blockwise(_t(x), _t(w), epsilon=0.1, n_iters=10,
                                                 block=16)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)


def test_pad_to_blocks():
    x = torch.arange(10.0).reshape(5, 2)
    padded, n = totb._pad_to_blocks(x, 4, -1.0)
    assert n == 5 and padded.shape == (8, 2) and bool((padded[5:] == -1.0).all())
    same, n = totb._pad_to_blocks(x, 5, 0.0)
    assert same is x and n == 5


def test_ot_large_at_a_toy_size():
    """The ``ot_large`` column's code on the CPU at small N: finite, the
    weighted mean kept to 0.2 (10 iterations leave small clouds
    unconverged: 0.07 at N = 300), dense equal to blockwise."""
    from particle_filters_tpu_torch.benchmarks import ot_large

    res = ot_large.run("cpu", sizes=(300, 700))
    for r in res.values():
        assert r["finite"] and r["mean_err"] < 0.2
    assert ot_large.dense_vs_blockwise("cpu", n=600)["max_abs_diff"] < 1e-4


def _jax_references():  # pragma: no cover - run by hand
    from particle_filters_tpu_torch.benchmarks import ot_large

    key = jax.random.PRNGKey(0)
    out = {}
    for n in ot_large.SIZES:
        p = jax.random.normal(key, (n, 2), jnp.float32)
        w = jax.nn.softmax(jax.random.normal(jax.random.fold_in(key, 1), (n,)) * 0.5)
        new_p = jax.jit(lambda pp, ww: jotb.sinkhorn_ot_resample_blockwise(
            pp, ww, epsilon=ot_large.EPSILON, n_iters=ot_large.N_ITERS,
            block=ot_large.BLOCK)[0])(p, w)
        out[n] = float(jnp.linalg.norm(jnp.mean(new_p, 0) - (w @ p)))
        print(n, out[n], flush=True)
    print(f"JAX_MEAN_ERR = {out!r}")


if __name__ == "__main__":
    _jax_references()
