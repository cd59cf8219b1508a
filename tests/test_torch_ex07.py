"""Port parity: ``examples/07_train_dpf.py`` and its twin
``particle_filters_tpu_torch/examples/ex07_train_dpf.py``.

- The loss and ∂loss/∂a of one filter run from the JAX package's data and
  draws (the initial normals, the transition's normals and the Gumbel
  draws of every step, split from the key as ``DifferentiableParticleFilter.
  filter`` splits it): within 2e-5 relative (f32 sums over 30 steps of
  8 × 64 particles, and a gradient through 30 soft resamples).
- Three SGD steps from a = 0.3 tracking the JAX script's (a after each step
  within 1e-5, the losses within 2e-5 relative).
- The whole training at the example's size on the CPU from the port's own
  draws: the module's gates (loss decreasing, the final a inside the band
  about the JAX package's 8 keys).

Run this file as a script to print the JAX package's final a for keys 0-7
(``ex07_train_dpf.JAX_FINAL_A``; about a minute):

    JAX_PLATFORMS=cpu python tests/test_torch_ex07.py
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
import torch  # noqa: E402

from particle_filters_tpu.models import DifferentiableParticleFilter  # noqa: E402
from particle_filters_tpu.resampling.soft import sample_gumbel  # noqa: E402
from particle_filters_tpu_torch.examples import ex07_train_dpf as ex  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def jax_data(key):
    """The JAX script's training data for ``key``: (X, Y, truth)."""
    x = jnp.zeros((ex.B, 1))
    xs, ys = [], []
    for t in range(ex.T):
        k1, k2 = jax.random.split(jax.random.fold_in(key, t))
        x = ex.TRUE_A * x + ex.SQ * jax.random.normal(k1, x.shape)
        xs.append(x)
        ys.append(x + ex.SR * jax.random.normal(k2, x.shape))
    X, Y = jnp.stack(xs, 1), jnp.stack(ys, 1)
    return X, Y, jnp.concatenate([jnp.zeros((ex.B, 1, 1)), X], 1)


def jax_dpf():
    def transition(k, p, params):
        return params["a"] * p + ex.SQ * jax.random.normal(k, p.shape, p.dtype)

    def loglik(p, y, params):
        return jnp.sum(-0.5 * (y[:, None, :] - p) ** 2 / ex.SR**2, axis=-1)

    return DifferentiableParticleFilter(ex.N, 1, transition, loglik, soft_alpha=ex.SOFT_ALPHA,
                                        gumbel_temperature=ex.GUMBEL_TEMPERATURE)


def jax_value_and_grad(dpf, Y, truth):
    def loss_fn(a, k):
        ps, lws = dpf.filter(k, Y, jnp.zeros(1), jnp.eye(1), params={"a": a})
        w = jax.nn.softmax(lws, axis=-1)
        means = jnp.einsum("btn,btnd->btd", w, ps)
        return jnp.mean((means[:, 1:] - truth[:, 1:]) ** 2)

    return jax.jit(jax.value_and_grad(loss_fn))


def jax_draws(k):
    """The draws ``dpf.filter(k, ...)`` takes, as the port's ``draws=``."""
    k_init, k_scan = jax.random.split(k)
    init = jax.random.normal(k_init, (ex.B, ex.N, 1))
    noise, gumbel = [], []
    for kt in jax.random.split(k_scan, ex.T):
        k_trans, k_gumbel = jax.random.split(kt)
        noise.append(jax.random.normal(k_trans, (ex.B, ex.N, 1)))
        gumbel.append(sample_gumbel(k_gumbel, (ex.B, ex.N, ex.N)))
    return {"init_eps": torch.tensor(np.asarray(init)),
            "noise": torch.tensor(np.asarray(jnp.stack(noise))),
            "gumbel": torch.tensor(np.asarray(jnp.stack(gumbel)))}


def jax_train(key, steps=ex.STEPS):
    """The JAX script's SGD for ``key``: a after each step and the losses."""
    _, Y, truth = jax_data(key)
    grad_fn = jax_value_and_grad(jax_dpf(), Y, truth)
    a, out_a, out_l = jnp.asarray(ex.A0), [], []
    for step in range(steps):
        loss, g = grad_fn(a, jax.random.fold_in(key, 1000 + step))
        a = a - ex.LR * g
        out_a.append(float(a))
        out_l.append(float(loss))
    return out_a, out_l


def _port_data(key):
    return tuple(torch.tensor(np.asarray(v)) for v in jax_data(key))


# --- tests -------------------------------------------------------------------
def test_loss_and_grad_from_jax_draws():
    key = jax.random.PRNGKey(0)
    _, Y, truth = jax_data(key)
    k = jax.random.fold_in(key, 1000)
    for a in (0.3, 0.85):
        want_l, want_g = jax_value_and_grad(jax_dpf(), Y, truth)(jnp.float32(a), k)
        _, tY, ttruth = _port_data(key)
        got_l, got_g = ex.value_and_grad(ex.make_dpf(CPU), a, None, tY, ttruth, jax_draws(k))
        np.testing.assert_allclose(got_l, float(want_l), rtol=2e-5)
        np.testing.assert_allclose(got_g, float(want_g), rtol=2e-5, atol=1e-7)


def test_three_sgd_steps_track_jax():
    key = jax.random.PRNGKey(0)
    want_a, want_l = jax_train(key, steps=3)
    res = ex.train(CPU, steps=3, data=_port_data(key),
                   draws_for=lambda s: jax_draws(jax.random.fold_in(key, 1000 + s)))
    np.testing.assert_allclose(res["a"], want_a, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["loss"], want_l, rtol=2e-5)


def test_training_meets_the_gates():
    res = ex.train(CPU)
    assert len(res["a"]) == ex.STEPS and all(np.isfinite(res["loss"]))
    gates = ex.gates(res)
    assert all(held for _, held in gates.values()), gates


if __name__ == "__main__":
    finals = [jax_train(jax.random.PRNGKey(k))[0][-1] for k in range(8)]
    print("JAX_FINAL_A", tuple(finals))
    print("mean", float(np.mean(finals)), "sd", float(np.std(finals, ddof=1)))
