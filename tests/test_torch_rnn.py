"""Port parity: the RNN resampler against the JAX package.

Parameters are carried across by ``interop.rnn_params_from_jax`` (read by
name from the JAX pytree, or in ``tree_flatten`` order from an ``.npz``).
Tolerances: the cells to 1e-6, the assignments and resampled particles to
2e-6 and the logits to 1e-5 (f32; the port forms the first layer's x·W as
the shared part plus the one-hot row, the JAX package as one product over
the whole input, so sums round in another order), baseline mode fed the
JAX package's Gumbel draws to 2e-6. The committed
``examples/rnn_resampler_params.npz`` is checked against a pytree the JAX
package rebuilds from its own ``init`` tree structure and the file's
leaves, so the leaf order is tested, not assumed.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu.resampling import rnn as jr
from particle_filters_tpu.resampling import soft as jsoft
from particle_filters_tpu_torch import interop
from particle_filters_tpu_torch.resampling import rnn as tr

torch.set_num_threads(1)

CPU = "cpu"
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "examples", "rnn_resampler_params.npz")


def _pair(n, d, **kw):
    kw.setdefault("hidden_dim", 8)
    kw.setdefault("output_init_scale", 0.5)  # a head that moves the logits
    J = jr.RNNResampler(n, d, **kw)
    params = J.init(jax.random.PRNGKey(1))
    T = interop.rnn_params_from_jax(tr.RNNResampler(n, d, device=CPU, **kw), params)
    return J, params, T


def _clouds(seed, b, n, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, d)).astype(np.float32),
            (2.0 * rng.standard_normal((b, n))).astype(np.float32))


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_cells_match_jax(rnn_type):
    init = jr.gru_cell_init if rnn_type == "gru" else jr.lstm_cell_init
    p = init(jax.random.PRNGKey(2), 5, 6)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    rng = np.random.default_rng(0)
    x, h, c = (rng.standard_normal((4, k)).astype(np.float32) for k in (5, 6, 6))
    if rnn_type == "gru":
        jh, _ = jr.gru_cell_apply(p, jnp.asarray(x), jnp.asarray(h))
        th, _ = tr.gru_cell_apply(tp, torch.tensor(x), torch.tensor(h))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-6)
    else:
        (jh, jc), _ = jr.lstm_cell_apply(p, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
        (th, tc), _ = tr.lstm_cell_apply(tp, torch.tensor(x), (torch.tensor(h), torch.tensor(c)))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("use_weight_prior", [False, True])
def test_resampler_matches_jax(rnn_type, num_layers, use_weight_prior):
    n, d = 10, 2
    J, params, T = _pair(n, d, rnn_type=rnn_type, num_layers=num_layers,
                         use_weight_prior=use_weight_prior, temperature=0.7)
    x, lw = _clouds(3, 3, n, d)

    def jax_logits(xx, ll):
        return jax.vmap(lambda i: J._run_cells(params, J._features(xx, ll, i))
                        @ params["out_kernel"] + params["out_bias"])(jnp.arange(n))

    jl = jax.vmap(jax_logits)(jnp.asarray(x), jnp.asarray(lw))
    tl = T.logits(None, torch.tensor(x), torch.tensor(lw))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    jp, jlw, jaux = jax.vmap(lambda xx, ll: J.apply(params, None, xx, ll, True))(
        jnp.asarray(x), jnp.asarray(lw))
    tp, tlw, taux = T.apply(None, None, torch.tensor(x), torch.tensor(lw), True)
    np.testing.assert_allclose(taux["assignment"].detach().numpy(),
                               np.asarray(jaux["assignment"]), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(tlw.numpy(), np.asarray(jlw), rtol=1e-6)
    np.testing.assert_allclose(taux["assignment_entropy_mean"].detach().numpy(),
                               np.asarray(jaux["assignment_entropy_mean"]), rtol=1e-5)


def test_pytree_params_and_unbatched_cloud():
    """``apply`` takes the module, None or the pytree; an (N, d) cloud is
    the B = 1 case."""
    n, d = 8, 1
    _, params, T = _pair(n, d)
    x, lw = _clouds(4, 1, n, d)
    ref, _ = T.apply(T, None, torch.tensor(x), torch.tensor(lw))
    tree = {"cells": [{k: torch.tensor(v) for k, v in c.items()} for c in
                      interop.rnn_params_to_jax(T)["cells"]],
            "out_kernel": torch.tensor(np.asarray(params["out_kernel"])),
            "out_bias": torch.tensor(np.asarray(params["out_bias"]))}
    via_tree, _ = T.apply(tree, None, torch.tensor(x), torch.tensor(lw))
    single, _ = T.apply(None, None, torch.tensor(x[0]), torch.tensor(lw[0]))
    assert torch.equal(via_tree, ref)
    np.testing.assert_allclose(single.detach().numpy(), ref[0].detach().numpy(), rtol=1e-6,
                               atol=1e-6)


def test_baseline_mode_with_jax_gumbel_draws():
    n = 12
    J = jr.RNNResampler(n, 1, use_baseline_resampling=True, temperature=0.5)
    T = tr.RNNResampler(n, 1, use_baseline_resampling=True, temperature=0.5, device=CPU)
    x, lw = _clouds(5, 1, n, 1)
    key = jax.random.PRNGKey(9)
    jp, _, jaux = J.apply(None, key, jnp.asarray(x[0]), jnp.asarray(lw[0]), True)
    g = np.asarray(jsoft.sample_gumbel(key, (n, n), jnp.float32, eps=1e-10))
    tp, _, taux = T.apply(None, None, torch.tensor(x[0]), torch.tensor(lw[0]), True,
                          gumbel=torch.tensor(g))
    np.testing.assert_allclose(taux["assignment"].numpy(), np.asarray(jaux["assignment"]),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-6, atol=2e-6)


def test_committed_npz_leaf_order():
    """The example's trained GRU (hidden 16, N = 16, input 1 + 1 + 16):
    the JAX package's pytree rebuilt from its ``init`` treedef and the
    file's leaves, and the port loaded from the file, give the same logits
    and resampled cloud."""
    kw = dict(hidden_dim=16, rnn_type="gru", temperature=0.5, use_weight_prior=True)
    J = jr.RNNResampler(16, 1, **kw)
    treedef = jax.tree_util.tree_structure(J.init(jax.random.PRNGKey(0)))
    with np.load(NPZ) as z:
        leaves = [jnp.asarray(z[f"arr_{i}"]) for i in range(len(z.files))]
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    assert params["cells"][0]["Wz"].shape == (18, 16) and params["out_kernel"].shape == (16, 16)
    T = interop.rnn_params_from_jax(tr.RNNResampler(16, 1, device=CPU, **kw), NPZ)
    T2 = interop.rnn_params_from_jax(tr.RNNResampler(16, 1, device=CPU, **kw), params)
    for a, b in zip(T.parameters(), T2.parameters()):
        assert torch.equal(a, b)
    x, lw = _clouds(6, 2, 16, 1)
    jp, _, jaux = jax.vmap(lambda xx, ll: J.apply(params, None, xx, ll, True))(
        jnp.asarray(x), jnp.asarray(lw))
    tp, _, taux = T.apply(None, None, torch.tensor(x), torch.tensor(lw), True)
    np.testing.assert_allclose(taux["assignment"].detach().numpy(),
                               np.asarray(jaux["assignment"]), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=2e-6, atol=2e-6)
    back = interop.rnn_params_to_jax(T)
    for name, leaf in zip(T.leaf_names(), jax.tree_util.tree_leaves(params)):
        node = back
        for part in name.split("."):
            node = node[int(part)] if part.isdigit() else node[part]
        np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_init_layout(rnn_type):
    T = tr.RNNResampler(6, 2, hidden_dim=4, num_layers=2, rnn_type=rnn_type, device=CPU)
    T.init(torch.Generator().manual_seed(3))
    J = jr.RNNResampler(6, 2, hidden_dim=4, num_layers=2, rnn_type=rnn_type)
    jp = J.init(jax.random.PRNGKey(0))
    tp = T.params()
    for jc, tc in zip(jp["cells"], tp["cells"]):
        assert sorted(jc) == sorted(tc)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape
            if k[0] in "WU":  # glorot-uniform bound
                lim = np.sqrt(6.0 / sum(jc[k].shape))
                assert float(tc[k].detach().abs().max()) <= lim
    if rnn_type == "lstm":
        np.testing.assert_array_equal(tp["cells"][0]["b"].detach().numpy(),
                                      np.asarray(jp["cells"][0]["b"]))
    assert float(tp["out_kernel"].detach().abs().max()) < 0.01
    assert float(tp["out_bias"].detach().abs().max()) == 0
    with pytest.raises(ValueError, match="Unknown RNN type"):
        tr.RNNResampler(4, 1, rnn_type="rnn", device=CPU)
    with pytest.raises(ValueError, match="at least one"):
        tr.RNNResampler(4, 1, use_weight_features=False, use_particle_features=False,
                        device=CPU)


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_cells_are_hand_written(rnn_type):
    """No ``torch.nn`` recurrent module is built or called."""
    T = tr.RNNResampler(4, 1, rnn_type=rnn_type, device=CPU)
    assert not any(isinstance(m, torch.nn.RNNBase) for m in T.modules())
    src = inspect.getsource(tr)
    assert "nn.GRU(" not in src and "nn.LSTM(" not in src and "RNNBase" not in src
