"""Port parity: the differentiable particle filters (soft, Sinkhorn-OT and
RNN resampling) against the JAX package, and the committed DPF data.

Both packages start from the JAX package's draws: the initial normals
(``init_eps``), the transition noise (a transition that returns the step's
JAX normals) and the Gumbel draws (``gumbel=``). Tolerances (f32):
- the diagnostics to 1e-5 relative;
- the soft and RNN filters step by step over T = 6 steps, particles and
  log-weights to 2e-5 (softmax assignments of order-one clouds);
- ``DPF_OT.run_filter`` over T = 8 steps, particles and weights to 5e-5 at
  ε = 0.1 (50 unrolled Sinkhorn iterations a step; each step's rounding
  feeds the next), its diagnostics to 1e-3 relative; the autograd gradient
  of a loss through the whole filter against ``jax.grad`` to 2e-3;
- the ``dpf_linear`` sequence and examples/09's held-out sequences in
  ``benchmarks/data/dpf.npz`` equal to what the JAX package draws; the
  ``dpf_nonlinear`` data equal to the reference's numpy draws.

Run as a script, this file writes ``dpf.npz`` again and prints the JAX
package's reference values on the CPU (``JAX_STATS`` over 64 keys,
``JAX_TRAINED``, ``JAX_HELDOUT`` of ``benchmarks/dpf.py``; ~10 min on 8
cores):

    JAX_PLATFORMS=cpu python tests/test_torch_dpf.py
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

from particle_filters_tpu.models import dpf as jd  # noqa: E402
from particle_filters_tpu.resampling import soft as jsoft  # noqa: E402
from particle_filters_tpu_torch import interop  # noqa: E402
from particle_filters_tpu_torch.benchmarks import dpf as tbench  # noqa: E402
from particle_filters_tpu_torch.benchmarks._stats import summary  # noqa: E402
from particle_filters_tpu_torch.models import dpf as td  # noqa: E402

torch.set_num_threads(1)

CPU = "cpu"
A, SQ, SR = 0.9, 0.3, 0.5


# ------------------------------- JAX side ------------------------------------


def jax_linear_data():
    """``bench_dpf_linear``'s sequence (key 0): X, Y (1, 20, 1)."""
    key = jax.random.PRNGKey(0)
    T = tbench.LIN["T"]
    ks = jax.random.split(key, T + 1)
    x = jnp.zeros((1, 1))
    xs, ys = [], []
    for t in range(T):
        k1, k2 = jax.random.split(ks[t])
        x = A * x + SQ * jax.random.normal(k1, x.shape)
        ys.append(x + SR * jax.random.normal(k2, x.shape))
        xs.append(x)
    return np.asarray(jnp.stack(xs, 1)), np.asarray(jnp.stack(ys, 1))


def jax_sim_batch(key, batch, t_steps, a, sq, sr, x0_normal):
    """examples/09's ``simulate_batch`` (x0 ~ N(0, 1)) and the suite's
    ``sim_batch`` (x0 = 0)."""
    k0, ks = jax.random.split(key)
    x0 = jax.random.normal(k0, (batch, 1)) if x0_normal else jnp.zeros((batch, 1))

    def body(x, k):
        k1, k2 = jax.random.split(k)
        x = a * x + sq * jax.random.normal(k1, x.shape)
        return x, (x, x + sr * jax.random.normal(k2, x.shape))

    _, (xs, ys) = jax.lax.scan(body, x0, jax.random.split(ks, t_steps))
    return xs.swapaxes(0, 1), ys.swapaxes(0, 1)


def jax_heldout_data():
    h = tbench.HELD
    xs, ys = jax_sim_batch(jax.random.PRNGKey(777), 32, h["T"], h["a"], h["sq"], h["sr"], True)
    return np.asarray(xs), np.asarray(ys)


def nonlinear_reference_data():
    """``bench_dpf_nonlinear``'s numpy draws, as written there."""
    alpha, sigma, beta, T = 0.95, 0.2, 0.6, 100
    rng = np.random.default_rng(42)
    var0 = sigma**2 / (1 - alpha**2)
    Xr = np.empty(T)
    Xr[0] = rng.normal(0.0, np.sqrt(var0))
    V = rng.standard_normal(T - 1)
    for t in range(1, T):
        Xr[t] = alpha * Xr[t - 1] + sigma * V[t - 1]
    W = rng.standard_normal(T)
    return Xr, beta * np.exp(0.5 * Xr) * W, var0


# ------------------------------ shared models --------------------------------


def jtrans(k, p, params):
    return A * p + SQ * jax.random.normal(k, p.shape, p.dtype)


def jloglik(p, y, params):
    return jnp.sum(-0.5 * (y[:, None, :] - p) ** 2 / SR**2, axis=-1)


def tloglik(p, y, params):
    return torch.sum(-0.5 * (y[:, None, :] - p) ** 2 / SR**2, dim=-1)


def injected(noises, scale=SQ, a=A):
    """A port transition that returns the step's given normals."""
    it = iter(noises)
    return lambda g, p, params: a * p + scale * torch.tensor(next(it))


def _data(seed, B, T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 1)) * 0.7).astype(np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(a, torch.Tensor) else a),
                               np.asarray(b), rtol=tol, atol=tol)


# ---------------------------------- tests ------------------------------------


def test_committed_data_is_the_jax_packages():
    d = np.load(tbench.DATA)
    X, Y = jax_linear_data()
    np.testing.assert_array_equal(d["linear_X"], X)
    np.testing.assert_array_equal(d["linear_Y"], Y)
    hx, hy = jax_heldout_data()
    np.testing.assert_array_equal(d["heldout_X"], hx)
    np.testing.assert_array_equal(d["heldout_Y"], hy)


def test_nonlinear_data_is_the_references():
    Xr, Yr, var0 = nonlinear_reference_data()
    d = tbench.nonlinear_data(CPU)
    np.testing.assert_array_equal(d["X"].numpy()[:, 0], Xr.astype(np.float32))
    np.testing.assert_array_equal(d["Y"].numpy()[0, :, 0], Yr.astype(np.float32))
    assert d["truth"].shape == (1, 101, 1) and float(d["truth"][0, 0, 0]) == 0.0
    np.testing.assert_allclose(float(d["chol"]), np.sqrt(var0), rtol=1e-7)


def test_diagnostics_match_jax():
    rng = np.random.default_rng(0)
    p = rng.standard_normal((3, 12, 2)).astype(np.float32)
    lw = (2 * rng.standard_normal((3, 12))).astype(np.float32)
    for name in ("compute_ess", "compute_weight_entropy"):
        _close(getattr(td, name)(torch.tensor(lw)), getattr(jd, name)(jnp.asarray(lw)), 1e-5)
    jdiv, tdiv = jd.compute_particle_diversity(jnp.asarray(p)), td.compute_particle_diversity(
        torch.tensor(p))
    for k in jdiv:
        _close(tdiv[k], jdiv[k], 1e-5)
    stacked = {"a": rng.standard_normal(7).astype(np.float32)}
    ja, ta = jd.aggregate_diagnostics(stacked), td.aggregate_diagnostics(
        {"a": torch.tensor(stacked["a"])})
    for k in ja:
        _close(ta[k], ja[k], 1e-6)
    ps = rng.standard_normal((2, 5, 12, 2)).astype(np.float32)
    lws = rng.standard_normal((2, 5, 12)).astype(np.float32)
    gt = rng.standard_normal((2, 5, 2)).astype(np.float32)
    _close(td.rmse_sequence(torch.tensor(ps), torch.tensor(lws), torch.tensor(gt)),
           jd.rmse_sequence(jnp.asarray(ps), jnp.asarray(lws), jnp.asarray(gt)), 1e-5)


def test_init_particles_from_given_normals():
    key = jax.random.PRNGKey(4)
    mean, chol = np.array([0.5, -1.0], np.float32), np.array([[1.0, 0], [0.3, 0.5]], np.float32)
    jp, jlw = jd._init_particles(key, 3, 7, 2, mean, chol, jnp.float32)
    eps = np.asarray(jax.random.normal(key, (3, 7, 2), jnp.float32))
    tp, tlw = td._init_particles(None, 3, 7, 2, mean, chol, CPU, eps)
    _close(tp, jp, 1e-6)
    _close(tlw, jlw, 1e-6)


@pytest.mark.parametrize("diagnostics", [False, True])
def test_soft_filter_steps_match_jax(diagnostics):
    B, N, T = 2, 16, 6
    Y = _data(1, B, T)
    jf = jd.DifferentiableParticleFilter(N, 1, jtrans, jloglik, soft_alpha=0.2,
                                         gumbel_temperature=0.4)
    key = jax.random.PRNGKey(5)
    jp, jlw = jf.init_particles(key, B, jnp.zeros(1), jnp.eye(1))
    tp, tlw = torch.tensor(np.asarray(jp)), torch.tensor(np.asarray(jlw))
    for t in range(T):
        k = jax.random.fold_in(key, t)
        k_trans, k_gumbel = jax.random.split(k)
        noise = np.asarray(jax.random.normal(k_trans, (B, N, 1), jnp.float32))
        gumbel = np.asarray(jsoft.sample_gumbel(k_gumbel, (B, N, N), jnp.float32))
        tf = td.DifferentiableParticleFilter(N, 1, injected([noise]), tloglik, soft_alpha=0.2,
                                             gumbel_temperature=0.4, device=CPU)
        jout = jf.step(k, jp, jlw, jnp.asarray(Y[:, t]), None, diagnostics)
        tout = tf.step(None, tp, tlw, torch.tensor(Y[:, t]), None, diagnostics,
                       gumbel=torch.tensor(gumbel))
        _close(tout[0], jout[0], 2e-5)
        _close(tout[1], jout[1], 2e-5)
        if diagnostics:
            assert sorted(tout[2]) == sorted(jout[2])
            for name in jout[2]:
                _close(tout[2][name], jout[2][name], 1e-4)
        jp, jlw = jout[0], jout[1]
        tp, tlw = tout[0], tout[1]


def test_soft_filter_outputs_and_gradient():
    """``filter`` keeps the JAX shapes, and autograd reaches the transition
    parameter through the soft resampling."""
    B, N, T = 2, 10, 5
    Y = torch.tensor(_data(2, B, T))
    a = torch.tensor(0.8, requires_grad=True)

    def trans(g, p, params):
        return params["a"] * p + SQ * torch.randn(p.shape, generator=g)

    f = td.DifferentiableParticleFilter(N, 1, trans, tloglik, device=CPU)
    ps, lws, diag = f.filter(torch.Generator().manual_seed(0), Y, torch.zeros(1),
                             torch.eye(1), {"a": a}, return_diagnostics=True,
                             ground_truth=torch.zeros(B, T + 1, 1))
    assert ps.shape == (B, T + 1, N, 1) and lws.shape == (B, T + 1, N)
    assert {"mean_rmse", "final_rmse", "ess_before_mean", "assignment_entropy_mean_max"} <= set(diag)
    diag["mean_rmse"].backward()
    assert torch.isfinite(a.grad) and float(a.grad.abs()) > 0


def _jax_ot_run(key, Y, N, eps, iters, alpha=A):
    f = jd.DPF_OT(N, 1, lambda k, p, t: alpha * p + SQ * jax.random.normal(k, p.shape, p.dtype),
                  lambda p, y, t: jnp.sum(-0.5 * (y - p) ** 2 / SR**2, axis=-1),
                  epsilon=eps, n_sinkhorn_iters=iters)
    return f.run_filter(key, Y, jnp.zeros(1), jnp.eye(1), return_diagnostics=True)


def _jax_ot_draws(key, T, N):
    """The normals ``DPF_OT.run_filter`` draws: initial cloud, then a step's."""
    k_init, k_scan = jax.random.split(key)
    keys = jax.random.split(k_scan, T)
    return (np.asarray(jax.random.normal(k_init, (N, 1), jnp.float32)),
            [np.asarray(jax.random.normal(k, (N, 1), jnp.float32)) for k in keys])


def _port_ot(noises, N, eps, iters, alpha=A):
    it = iter(noises)
    return td.DPF_OT(N, 1, lambda g, p, t: alpha * p + SQ * torch.tensor(next(it)),
                     lambda p, y, t: torch.sum(-0.5 * (y - p) ** 2 / SR**2, dim=-1),
                     epsilon=eps, n_sinkhorn_iters=iters, device=CPU)


def test_ot_run_filter_matches_jax():
    N, T = 20, 8
    Y = _data(3, 1, T)[0]
    key = jax.random.PRNGKey(6)
    jps, jws, jdiag = _jax_ot_run(key, jnp.asarray(Y), N, 0.1, 50)
    eps0, noises = _jax_ot_draws(key, T, N)
    tf = _port_ot(noises, N, 0.1, 50)
    tps, tws, tdiag = tf.run_filter(None, torch.tensor(Y), torch.zeros(1), torch.eye(1),
                                    return_diagnostics=True, init_eps=eps0)
    assert tps.shape == (T + 1, N, 1) and tws.shape == (T + 1, N)
    _close(tps, jps, 5e-5)
    _close(tws, jws, 5e-5)
    assert sorted(tdiag) == sorted(jdiag)
    for k in jdiag:
        np.testing.assert_allclose(float(tdiag[k]), float(jdiag[k]), rtol=1e-3, atol=1e-6)


def test_ot_filter_gradient_matches_jax_grad():
    """d loss / d alpha through the whole OT filter (test_grad_checks'
    case, in f32): autograd against ``jax.grad``."""
    N, T = 16, 5
    rng = np.random.default_rng(9)
    xs = np.cumsum(0.2 * rng.standard_normal((T, 1)), axis=0).astype(np.float32)
    ys = (xs + 0.2 * rng.standard_normal((T, 1))).astype(np.float32)
    key = jax.random.PRNGKey(8)
    eps0, noises = _jax_ot_draws(key, T, N)

    def jloss(alpha):
        ps, ws, _ = _jax_ot_run(key, jnp.asarray(ys), N, 0.3, 30, alpha)
        means = jnp.einsum("tn,tnd->td", ws, ps)
        return jnp.mean((means[1:] - xs) ** 2)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.float32(0.9))
    alpha = torch.tensor(0.9, requires_grad=True)
    ps, ws = _port_ot(noises, N, 0.3, 30, alpha).run_filter(
        None, torch.tensor(ys), torch.zeros(1), torch.eye(1), init_eps=eps0)
    means = torch.einsum("tn,tnd->td", ws, ps)
    loss = torch.mean((means[1:] - torch.tensor(xs)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-4)
    assert abs(float(jgrad)) > 1e-6
    np.testing.assert_allclose(float(alpha.grad), float(jgrad), rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("rnn_type,baseline", [("gru", False), ("lstm", False), ("gru", True)])
def test_rnn_filter_steps_match_jax(rnn_type, baseline):
    B, N, T = 2, 8, 6
    Y = _data(4, B, T)
    kw = dict(rnn_hidden_dim=8, rnn_type=rnn_type, temperature=0.6,
              use_baseline_resampling=baseline, use_weight_prior=True)
    jf = jd.DifferentiableParticleFilterRNN(N, 1, jtrans, jloglik, **kw)
    params = jf.init_resampler(jax.random.PRNGKey(2))
    params["out_kernel"] = params["out_kernel"] * 300.0  # a head that moves the logits
    noises = []
    tf = td.DifferentiableParticleFilterRNN(N, 1, injected(noises), tloglik, device=CPU, **kw)
    interop.rnn_params_from_jax(tf.resampler, params)
    key = jax.random.PRNGKey(3)
    jp, jlw = jf.init_particles(key, B, jnp.zeros(1), jnp.eye(1))
    tp, tlw = torch.tensor(np.asarray(jp)), torch.tensor(np.asarray(jlw))
    for t in range(T):
        k = jax.random.fold_in(key, t)
        k_trans, k_res = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(k_trans, (B, N, 1), jnp.float32)))
        gumbel = np.stack([np.asarray(jsoft.sample_gumbel(kb, (N, N), jnp.float32, eps=1e-10))
                           for kb in jax.random.split(k_res, B)])
        tf.transition_fn = injected(noises[-1:])
        jout = jf.step(params, k, jp, jlw, jnp.asarray(Y[:, t]), None, True)
        tout = tf.step(None, None, tp, tlw, torch.tensor(Y[:, t]), None, True,
                       gumbel=torch.tensor(gumbel))
        _close(tout[0], jout[0], 2e-5)
        _close(tout[1], jout[1], 2e-5)
        for name in jout[2]:
            _close(tout[2][name], jout[2][name], 1e-4)
        jp, jlw, tp, tlw = jout[0], jout[1], tout[0], tout[1]


def test_rnn_filter_trains():
    """One Adam step on the NLL moves every resampler parameter; the
    gradients are finite; ``filter`` takes the module or its pytree."""
    N, T = 8, 4
    trans, loglik, _ = tbench.lgssm(A, SQ, SR)
    f = td.DifferentiableParticleFilterRNN(N, 1, trans, loglik, rnn_hidden_dim=6,
                                           temperature=0.5, use_weight_prior=True, device=CPU)
    g = torch.Generator().manual_seed(0)
    xs, ys = tbench.simulate_lgssm(g, 3, T, A, SQ, SR, CPU)
    loss = tbench.nll(f, None, torch.Generator().manual_seed(1), ys, xs)
    loss.backward()
    grads = [p.grad for p in f.resampler.parameters()]
    assert all(gr is not None and torch.isfinite(gr).all() for gr in grads)
    via_tree = tbench.nll(f, f.resampler.params(), torch.Generator().manual_seed(1), ys, xs)
    assert float(via_tree.detach()) == float(loss.detach())
    before = [p.detach().clone() for p in f.resampler.parameters()]
    torch.optim.Adam(f.resampler.parameters(), lr=1e-3).step()
    assert all(not torch.equal(b, p) for b, p in zip(before, f.resampler.parameters()))


def test_columns_at_a_toy_size():
    """The benchmark's columns on the CPU with 2 seeds and 2 training
    steps: finite rows in the JAX package's shapes."""
    lin = tbench.run_linear(CPU, seeds=2, train_steps=2)
    assert set(lin) == {"soft", "ot", "rnn", "train", "rnn_trained"}
    for tag in ("soft", "ot", "rnn", "rnn_trained"):
        assert np.isfinite(lin[tag]["rmse"]) and 0.05 < lin[tag]["rmse"] < 2.0
    assert np.isfinite(lin["rnn_trained"]["nll"]) and np.isfinite(lin["train"]["last_loss"])
    held = tbench.run_heldout(CPU, seeds=1)
    assert held["ratio"] > tbench.NLL_RATIO, held


# ------------------------------ the script -----------------------------------


def _jax_references():  # pragma: no cover - run by hand
    from particle_filters_tpu.models import (
        DPF_OT,
        DifferentiableParticleFilter,
        DifferentiableParticleFilterRNN,
    )
    import optax

    X, Y = jax_linear_data()
    hx, hy = jax_heldout_data()
    np.savez(tbench.DATA, linear_X=X, linear_Y=Y, heldout_X=hx, heldout_Y=hy)
    print(f"wrote {tbench.DATA}")
    X, Y = jnp.asarray(X), jnp.asarray(Y)
    truth = jnp.concatenate([jnp.zeros((1, 1, 1)), X], axis=1)
    keys = [jax.random.PRNGKey(i) for i in range(64)]
    bands = {"dpf_linear": {}, "dpf_nonlinear": {}}

    def band(vals):
        """(mean, sd, size) over the 64 keys, and key 0's value."""
        return summary(vals) + (vals[0],)

    soft = DifferentiableParticleFilter(50, 1, jtrans, jloglik)
    f = jax.jit(lambda k: soft.filter(k, Y, jnp.zeros(1), jnp.eye(1), return_diagnostics=True,
                                      ground_truth=truth)[2]["mean_rmse"])
    bands["dpf_linear"]["soft"] = band([float(f(k)) for k in keys])
    ot = DPF_OT(50, 1, lambda k, p, t: A * p + SQ * jax.random.normal(k, p.shape, p.dtype),
                lambda p, y, t: jnp.sum(-0.5 * (y - p) ** 2 / SR**2, axis=-1),
                epsilon=0.01, n_sinkhorn_iters=50, damping=1.0)

    def ot_rmse(k, X=X, Y=Y, f=ot):
        ps, ws = f.run_filter(k, Y[0], jnp.zeros(1), jnp.eye(1))
        means = jnp.einsum("tn,tnd->td", ws, ps)
        return jnp.sqrt(jnp.mean((means[1:] - X[0]) ** 2))

    g = jax.jit(ot_rmse)
    bands["dpf_linear"]["ot"] = band([float(g(k)) for k in keys])
    rnn = DifferentiableParticleFilterRNN(50, 1, jtrans, jloglik, use_baseline_resampling=True,
                                          temperature=0.5)
    p0 = rnn.init_resampler(keys[0])
    f = jax.jit(lambda k: rnn.filter(p0, k, Y, jnp.zeros(1), jnp.eye(1), return_diagnostics=True,
                                     ground_truth=truth)[2]["mean_rmse"])
    bands["dpf_linear"]["rnn"] = band([float(f(k)) for k in keys])

    # The trained row, as bench_dpf_linear runs it (300 optax steps from key 0).
    key = keys[0]
    tr = DifferentiableParticleFilterRNN(50, 1, jtrans, jloglik, rnn_hidden_dim=16,
                                         temperature=0.5, use_weight_prior=True)
    base = DifferentiableParticleFilterRNN(50, 1, jtrans, jloglik, rnn_hidden_dim=16,
                                           temperature=0.5, use_weight_prior=True,
                                           use_baseline_resampling=True)

    def jmoments(dpf_obj, p, k, ys):
        ps_, lws_ = dpf_obj.filter(p, k, ys, jnp.zeros(1), jnp.eye(1))
        w_ = jax.nn.softmax(lws_, axis=-1)
        m_ = jnp.einsum("btn,btnd->btd", w_, ps_)
        return m_[:, 1:], jnp.sum(w_ * (ps_[..., 0] - m_[..., 0][..., None]) ** 2, axis=-1)[:, 1:]

    def jnll(dpf_obj, p, k, ys, xs):
        m_, v_ = jmoments(dpf_obj, p, k, ys)
        v_ = v_ + 1e-4
        return jnp.mean(0.5 * jnp.log(v_) + 0.5 * (m_[..., 0] - xs[..., 0]) ** 2 / v_)

    p_tr = tr.init_resampler(key)
    opt = optax.adam(3e-3)
    st = opt.init(p_tr)

    @jax.jit
    def tstep(p, s, k):
        kd, kf = jax.random.split(k)
        xs_b, ys_b = jax_sim_batch(kd, 8, 20, A, SQ, SR, False)
        loss, gr = jax.value_and_grad(lambda q: jnll(tr, q, kf, ys_b, xs_b))(p)
        u, s = opt.update(gr, s)
        return optax.apply_updates(p, u), s, loss

    for i in range(300):
        p_tr, st, _ = tstep(p_tr, st, jax.random.fold_in(key, i))
    eval_keys = [jax.random.fold_in(key, 990 + i) for i in range(8)]  # the suite's 8
    f = jax.jit(lambda k: tr.filter(p_tr, k, Y, jnp.zeros(1), jnp.eye(1), return_diagnostics=True,
                                    ground_truth=truth)[2]["mean_rmse"])
    rm = [float(f(k)) for k in eval_keys]
    trained = {"rmse": float(np.mean(rm)), "rmses": rm,
               "nll": float(np.mean([float(jnll(tr, p_tr, k, Y, X)) for k in eval_keys])),
               "baseline_nll": float(np.mean([float(jnll(base, p_tr, k, Y, X))
                                              for k in eval_keys]))}

    Xr, Yr, var0 = nonlinear_reference_data()
    Xn = jnp.asarray(Xr[:, None], jnp.float32)
    Yn = jnp.asarray(Yr[None, :, None], jnp.float32)
    truth_n = jnp.concatenate([jnp.zeros((1, 1, 1)), Xn[None]], axis=1)
    chol = jnp.float32(np.sqrt(var0)) * jnp.eye(1)

    def sv_trans(k, p, params):
        return 0.95 * p + 0.2 * jax.random.normal(k, p.shape, p.dtype)

    def sv_ll(p, y, params):
        var = 0.36 * jnp.exp(p[..., 0])
        return -0.5 * (y[:, None, 0] ** 2 / var + jnp.log(var))

    soft = DifferentiableParticleFilter(100, 1, sv_trans, sv_ll, soft_alpha=0.1,
                                        gumbel_temperature=0.5)
    f = jax.jit(lambda k: soft.filter(k, Yn, jnp.zeros(1), chol, return_diagnostics=True,
                                      ground_truth=truth_n)[2]["mean_rmse"])
    bands["dpf_nonlinear"]["soft"] = band([float(f(k)) for k in keys])
    ot_n = DPF_OT(100, 1, lambda k, p, t: sv_trans(k, p, None),
                  lambda p, y, t: -0.5 * (y[0] ** 2 / (0.36 * jnp.exp(p[:, 0]))
                                          + jnp.log(0.36 * jnp.exp(p[:, 0]))),
                  epsilon=0.02, n_sinkhorn_iters=50, damping=1.0)

    def ot_rmse_n(k):
        ps, ws = ot_n.run_filter(k, Yn[0], jnp.zeros(1), chol)
        means = jnp.einsum("tn,tnd->td", ws, ps)
        return jnp.sqrt(jnp.mean((means[1:] - Xn) ** 2))

    g = jax.jit(ot_rmse_n)
    bands["dpf_nonlinear"]["ot"] = band([float(g(k)) for k in keys])
    rnn_n = DifferentiableParticleFilterRNN(100, 1, sv_trans, sv_ll, rnn_type="lstm",
                                            rnn_hidden_dim=32, use_baseline_resampling=True,
                                            temperature=0.5)
    pn = rnn_n.init_resampler(keys[0])
    f = jax.jit(lambda k: rnn_n.filter(pn, k, Yn, jnp.zeros(1), chol, return_diagnostics=True,
                                       ground_truth=truth_n)[2]["mean_rmse"])
    bands["dpf_nonlinear"]["rnn"] = band([float(f(k)) for k in keys])

    # The committed trained parameters on examples/09's held-out sequences.
    h = tbench.HELD

    def htrans(k, p, params):
        return h["a"] * p + h["sq"] * jax.random.normal(k, p.shape, p.dtype)

    def hll(p, y, params):
        return -0.5 * jnp.sum((y[:, None, :] - p) ** 2, axis=-1) / h["sr"] ** 2

    kw = dict(rnn_type="gru", rnn_hidden_dim=16, temperature=0.5, use_weight_prior=True)
    ht = DifferentiableParticleFilterRNN(16, 1, htrans, hll, **kw)
    hb = DifferentiableParticleFilterRNN(16, 1, htrans, hll, use_baseline_resampling=True, **kw)
    treedef = jax.tree_util.tree_structure(ht.init_resampler(keys[0]))
    with np.load(tbench.PARAMS) as z:
        hp = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(z[f"arr_{i}"])
                                                    for i in range(len(z.files))])
    ev = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(777), 1), 8)
    held = {tag: float(np.mean([float(jnll(dpf_obj, hp, k, jnp.asarray(hy), jnp.asarray(hx)))
                                for k in ev])) for tag, dpf_obj in (("trained", ht),
                                                                    ("baseline", hb))}
    print(f"JAX_STATS = {bands!r}")
    print(f"JAX_TRAINED = {trained!r}")
    print(f"JAX_HELDOUT = {held!r}")


if __name__ == "__main__":
    _jax_references()
