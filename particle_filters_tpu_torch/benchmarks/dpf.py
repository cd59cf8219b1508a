"""The differentiable-PF columns ``dpf_linear`` and ``dpf_nonlinear`` — the
port's twins of ``bench_dpf_linear`` and ``bench_dpf_nonlinear`` in
``benchmarks/run_benchmarks.py`` — and the held-out check of the trained
RNN resampler.

    python -m particle_filters_tpu_torch.benchmarks.dpf [train_steps]

- ``dpf_linear``: the 1-D LGSSM x' = 0.9x + 0.3w, y = x + 0.5v, N = 50,
  T = 20, on the JAX package's sequence (``data/dpf.npz``, drawn with
  ``jax.random`` key 0 as the suite draws it): soft (α 0.1, τ 0.2), OT
  (ε 0.01, damping 1, 50 iterations), the RNN in baseline mode (τ 0.5),
  and a GRU (hidden 16, τ 0.5, weight prior) trained ``train_steps``
  (300) ``torch.optim.Adam`` steps at lr 3e-3 on the NLL of fresh batches
  of 8 simulated sequences, evaluated on the column's sequence.
- ``dpf_nonlinear``: the SV model (α 0.95, σ 0.2, β 0.6), N = 100, T = 100,
  on the reference's numpy PCG64 seed-42 realization (regenerated here):
  soft (α 0.1, τ 0.5), OT (ε 0.02, damping 1, 50 iterations), the LSTM
  (hidden 32) in baseline mode (τ 0.5).
- ``heldout``: ``examples/rnn_resampler_params.npz`` (the JAX package's
  trained GRU, N = 16, on ``examples/09_train_rnn_resampler.py``'s system)
  against baseline mode, Gaussian NLL of the truth on that example's 32
  held-out sequences (``data/dpf.npz``) over 8 filter seeds; the JAX
  package claims a ≥ 10× lower NLL.

Every row runs over 8 generator seeds (the held-out seeds 990–997 for the
trained resampler, as the suite's 8 keys). The sampled RMSEs are held to
the JAX package's distribution of the same row over 64 ``jax.random`` keys
on the CPU (``JAX_STATS``, printed by ``python tests/test_torch_dpf.py``)
by a two-sample test (``_stats.welch_z``, p ≥ 1e-3): 8 keys alone give a
band too narrow for a mean of 8 (the JAX package's own first 8 keys sit
0.009 below its 64-key mean of the soft row). Seconds are wall clock to a sync of one
filter call (seed 0) after a warm-up call. Products run with TF32 off
(``main`` sets it; a caller sets its own).
"""

from __future__ import annotations

import pathlib
import statistics
import sys
import time

import numpy as np
import torch

from particle_filters_tpu_torch.benchmarks._stats import welch_z
from particle_filters_tpu_torch.benchmarks.snlg import _timed, card_line, print_profile
from particle_filters_tpu_torch.models.dpf import (
    DPF_OT,
    DifferentiableParticleFilter,
    DifferentiableParticleFilterRNN,
)

DATA = pathlib.Path(__file__).resolve().parent / "data" / "dpf.npz"
PARAMS = pathlib.Path(__file__).resolve().parents[2] / "examples" / "rnn_resampler_params.npz"
LIN = dict(a=0.9, sq=0.3, sr=0.5, N=50, T=20)
NL = dict(alpha=0.95, sigma=0.2, beta=0.6, N=100, T=100)
HELD = dict(a=0.9, sq=0.5, sr=0.7, N=16, T=25)  # examples/09's system
SEEDS = 8
TRAIN_STEPS, TRAIN_LR, TRAIN_BATCH = 300, 3e-3, 8
EVAL_SEEDS = tuple(990 + i for i in range(SEEDS))
NLL_RATIO = 10.0  # the trained resampler's held-out NLL below baseline's by this
# The JAX package on the CPU over jax.random keys 0-63 (``python
# tests/test_torch_dpf.py``): (mean, sd, 64, key 0's value) of each row's RMSE.
JAX_STATS = {
    "dpf_linear": {
        "soft": (0.29367965273559093, 0.02115957649855466, 64, 0.2953740954399109),
        "ot": (0.33029203955084085, 0.01478192970460052, 64, 0.33283811807632446),
        "rnn": (0.3100838456302881, 0.018915737570491403, 64, 0.3187685012817383)},
    "dpf_nonlinear": {
        "soft": (0.24939048499800265, 0.015401089104393938, 64, 0.24263757467269897),
        "ot": (0.3067549401894212, 0.00944992968038577, 64, 0.31112438440322876),
        "rnn": (0.25130712194368243, 0.013087280341685445, 64, 0.2452092319726944)}}
# The JAX package's trained-RNN row (300 optax steps from key 0, evaluated
# over its 8 held-out keys: mean RMSE, its band, mean NLL and baseline
# mode's), and the held-out NLLs of the committed parameters on examples/09's
# sequences over that example's 8 keys.
JAX_TRAINED = {"rmse": 0.2889435440301895,
               "rmses": [0.29116714000701904, 0.34249332547187805, 0.3157729506492615,
                         0.2942149341106415, 0.21199697256088257, 0.33595097064971924,
                         0.2955222427845001, 0.22442981600761414],
               "nll": 2.436808334197849, "baseline_nll": 486.3274040222168}
JAX_HELDOUT = {"trained": 10.09466141462326, "baseline": 638.1267013549805}


def load_data(device, path=DATA):
    with np.load(str(path)) as f:
        return {k: torch.as_tensor(f[k], device=device) for k in f.files}


def nonlinear_data(device):
    """The reference's seed-42 SV realization (numpy PCG64, its draw order):
    X (T, 1), Y (1, T, 1), truth (1, T+1, 1), the prior's Cholesky factor."""
    a, s, b, T = NL["alpha"], NL["sigma"], NL["beta"], NL["T"]
    rng = np.random.default_rng(42)
    var0 = s**2 / (1 - a**2)
    X = np.empty(T)
    X[0] = rng.normal(0.0, np.sqrt(var0))
    V = rng.standard_normal(T - 1)
    for t in range(1, T):
        X[t] = a * X[t - 1] + s * V[t - 1]
    W = rng.standard_normal(T)
    Y = b * np.exp(0.5 * X) * W
    X = torch.as_tensor(X[:, None], dtype=torch.float32, device=device)
    return {"X": X, "Y": torch.as_tensor(Y[None, :, None], dtype=torch.float32, device=device),
            "truth": torch.cat([X.new_zeros((1, 1, 1)), X[None]], dim=1),
            "chol": torch.tensor([[np.float32(np.sqrt(var0))]], device=device)}


# ----------------------------- the models -----------------------------------


def lgssm(a, sq, sr):
    """Batched (transition, log-likelihood) and the OT filter's pair."""
    def trans(g, p, params):
        return a * p + sq * torch.randn(p.shape, generator=g, device=p.device)

    def loglik(p, y, params):
        return torch.sum(-0.5 * (y[:, None, :] - p) ** 2 / sr**2, dim=-1)

    def obsll(p, y, t):
        return torch.sum(-0.5 * (y - p) ** 2 / sr**2, dim=-1)

    return trans, loglik, obsll


def sv_model():
    a, s, b = NL["alpha"], NL["sigma"], NL["beta"]

    def trans(g, p, params):
        return a * p + s * torch.randn(p.shape, generator=g, device=p.device)

    def loglik(p, y, params):
        var = b**2 * torch.exp(p[..., 0])
        return -0.5 * (y[:, None, 0] ** 2 / var + torch.log(var))

    def obsll(p, y, t):
        var = b**2 * torch.exp(p[:, 0])
        return -0.5 * (y[0] ** 2 / var + torch.log(var))

    return trans, loglik, obsll


def simulate_lgssm(gen, batch, T, a, sq, sr, device, x0_std=0.0):
    """(B, T, 1) states and observations of x' = a·x + sq·w, y = x + sr·v."""
    x = x0_std * torch.randn((batch, 1), generator=gen, device=device)
    xs, ys = [], []
    for _ in range(T):
        x = a * x + sq * torch.randn(x.shape, generator=gen, device=device)
        ys.append(x + sr * torch.randn(x.shape, generator=gen, device=device))
        xs.append(x)
    return torch.stack(xs, 1), torch.stack(ys, 1)


def moments(dpf, params, gen, ys):
    """Posterior means (B, T, 1) and variances (B, T) at t = 1..T."""
    ps, lws = dpf.filter(params, gen, ys, torch.zeros(1), torch.eye(1))
    w = torch.softmax(lws, dim=-1)
    m = torch.einsum("btn,btnd->btd", w, ps)
    v = torch.sum(w * (ps[..., 0] - m[..., 0][..., None]) ** 2, dim=-1)
    return m[:, 1:], v[:, 1:]


def nll(dpf, params, gen, ys, xs):
    """Gaussian NLL of the truth under the per-step posterior mean and
    variance (+1e-4), averaged."""
    m, v = moments(dpf, params, gen, ys)
    v = v + 1e-4
    return torch.mean(0.5 * torch.log(v) + 0.5 * (m[..., 0] - xs[..., 0]) ** 2 / v)


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _row(T, run, device, seeds=SEEDS):
    """A row: ``run(seed)`` → RMSE, over ``seeds``; seconds of seed 0."""
    secs, _ = _timed(lambda: run(0), lambda: run(0), device)
    rmses = [float(run(s)) for s in range(seeds)]
    return {"s": secs, "ms_per_step": secs / T * 1e3, "rmse": statistics.fmean(rmses),
            "rmse_seed0": rmses[0], "rmses": rmses}


# ------------------------------- the columns ---------------------------------


def run_linear(device, seeds=SEEDS, train_steps=TRAIN_STEPS):
    """The ``dpf_linear`` column: soft, OT, RNN baseline and trained rows."""
    device = torch.device(device)
    data = load_data(device)
    X, Y = data["linear_X"], data["linear_Y"]
    truth = torch.cat([X.new_zeros((1, 1, 1)), X], dim=1)
    N, T = LIN["N"], LIN["T"]
    trans, loglik, obsll = lgssm(LIN["a"], LIN["sq"], LIN["sr"])
    zero, eye = torch.zeros(1), torch.eye(1)
    out = {}

    soft = DifferentiableParticleFilter(N, 1, trans, loglik, device=device)
    out["soft"] = _row(T, lambda s: soft.filter(
        _gen(device, s), Y, zero, eye, return_diagnostics=True,
        ground_truth=truth)[2]["mean_rmse"], device, seeds)

    ot = DPF_OT(N, 1, lambda g, p, t: trans(g, p, None), obsll, epsilon=0.01,
                n_sinkhorn_iters=50, damping=1.0, device=device)

    def ot_rmse(s):
        ps, ws = ot.run_filter(_gen(device, s), Y[0], zero, eye)
        means = torch.einsum("tn,tnd->td", ws, ps)
        return torch.sqrt(torch.mean((means[1:] - X[0]) ** 2))

    out["ot"] = _row(T, ot_rmse, device, seeds)

    rnn = DifferentiableParticleFilterRNN(N, 1, trans, loglik, use_baseline_resampling=True,
                                          temperature=0.5, device=device)
    out["rnn"] = _row(T, lambda s: rnn.filter(
        None, _gen(device, s), Y, zero, eye, return_diagnostics=True,
        ground_truth=truth)[2]["mean_rmse"], device, seeds)

    tr = DifferentiableParticleFilterRNN(N, 1, trans, loglik, rnn_hidden_dim=16,
                                         temperature=0.5, use_weight_prior=True, device=device)
    out["train"] = train_rnn(tr, train_steps, device)
    base = DifferentiableParticleFilterRNN(N, 1, trans, loglik, rnn_hidden_dim=16,
                                           temperature=0.5, use_weight_prior=True,
                                           use_baseline_resampling=True, device=device)
    with torch.no_grad():
        def first():
            return tr.filter(None, _gen(device, EVAL_SEEDS[0]), Y, zero, eye)

        secs, _ = _timed(first, first, device)
        rm = [float(tr.filter(None, _gen(device, s), Y, zero, eye, return_diagnostics=True,
                              ground_truth=truth)[2]["mean_rmse"]) for s in EVAL_SEEDS[:seeds]]
        out["rnn_trained"] = {
            "s": secs, "ms_per_step": secs / T * 1e3, "rmse": statistics.fmean(rm),
            "rmse_seed0": rm[0], "rmses": rm,
            "nll": statistics.fmean(float(nll(tr, None, _gen(device, s), Y, X))
                                    for s in EVAL_SEEDS[:seeds]),
            "baseline_nll": statistics.fmean(float(nll(base, None, _gen(device, s), Y, X))
                                             for s in EVAL_SEEDS[:seeds])}
    return out


def train_rnn(dpf, steps, device):
    """``steps`` Adam steps on the NLL of fresh simulated batches of the
    column's system; the resampler is trained in place. Returns the
    per-step seconds (to a sync) and the losses."""
    opt = torch.optim.Adam(dpf.resampler.parameters(), lr=TRAIN_LR)
    gen = _gen(device, 0)
    secs, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        xs, ys = simulate_lgssm(gen, TRAIN_BATCH, LIN["T"], LIN["a"], LIN["sq"], LIN["sr"],
                                device)
        loss = nll(dpf, None, gen, ys, xs)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))  # a sync
        secs.append(time.perf_counter() - t0)
    return {"steps": steps, "step_s": statistics.median(secs) if secs else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "last_loss": losses[-1] if losses else float("nan")}


def run_nonlinear(device, seeds=SEEDS):
    """The ``dpf_nonlinear`` column: soft, OT and the LSTM baseline rows."""
    device = torch.device(device)
    d = nonlinear_data(device)
    N, T = NL["N"], NL["T"]
    trans, loglik, obsll = sv_model()
    zero = torch.zeros(1)
    out = {}
    soft = DifferentiableParticleFilter(N, 1, trans, loglik, soft_alpha=0.1,
                                        gumbel_temperature=0.5, device=device)
    out["soft"] = _row(T, lambda s: soft.filter(
        _gen(device, s), d["Y"], zero, d["chol"], return_diagnostics=True,
        ground_truth=d["truth"])[2]["mean_rmse"], device, seeds)
    ot = DPF_OT(N, 1, lambda g, p, t: trans(g, p, None), obsll, epsilon=0.02,
                n_sinkhorn_iters=50, damping=1.0, device=device)

    def ot_rmse(s):
        ps, ws = ot.run_filter(_gen(device, s), d["Y"][0], zero, d["chol"])
        means = torch.einsum("tn,tnd->td", ws, ps)
        return torch.sqrt(torch.mean((means[1:] - d["X"]) ** 2))

    out["ot"] = _row(T, ot_rmse, device, seeds)
    rnn = DifferentiableParticleFilterRNN(N, 1, trans, loglik, rnn_type="lstm",
                                          rnn_hidden_dim=32, use_baseline_resampling=True,
                                          temperature=0.5, device=device)
    out["rnn"] = _row(T, lambda s: rnn.filter(
        None, _gen(device, s), d["Y"], zero, d["chol"], return_diagnostics=True,
        ground_truth=d["truth"])[2]["mean_rmse"], device, seeds)
    return out


def heldout_filters(device, params=PARAMS):
    """Example 09's filter with the committed trained parameters, and its
    baseline mode."""
    from particle_filters_tpu_torch.interop import rnn_params_from_jax

    trans, loglik, _ = lgssm(HELD["a"], HELD["sq"], HELD["sr"])
    kw = dict(rnn_type="gru", rnn_hidden_dim=16, temperature=0.5, use_weight_prior=True,
              device=device)
    trained = DifferentiableParticleFilterRNN(HELD["N"], 1, trans, loglik, **kw)
    rnn_params_from_jax(trained.resampler, params)
    base = DifferentiableParticleFilterRNN(HELD["N"], 1, trans, loglik,
                                           use_baseline_resampling=True, **kw)
    return trained, base


def run_heldout(device, seeds=SEEDS):
    """NLL and RMSE of the committed trained resampler and of baseline mode
    on example 09's 32 held-out sequences, averaged over ``seeds``."""
    device = torch.device(device)
    data = load_data(device)
    xs, ys = data["heldout_X"], data["heldout_Y"]
    trained, base = heldout_filters(device)
    out = {}
    with torch.no_grad():
        for tag, dpf in (("trained", trained), ("baseline", base)):
            nl, rm = [], []
            for s in range(seeds):
                m, v = moments(dpf, None, _gen(device, s), ys)
                v = v + 1e-4
                nl.append(float(torch.mean(0.5 * torch.log(v)
                                           + 0.5 * (m[..., 0] - xs[..., 0]) ** 2 / v)))
                rm.append(float(torch.sqrt(torch.mean((m - xs) ** 2))))
            out[tag] = {"nll": statistics.fmean(nl), "rmse": statistics.fmean(rm)}
    out["ratio"] = out["baseline"]["nll"] / out["trained"]["nll"]
    return out


def against_jax(column, tag, rmses):
    """(z, p) of a row's RMSEs against the JAX package's 64 keys."""
    mean, sd, n, _ = JAX_STATS[column][tag]
    return welch_z(rmses, mean, sd, n)


def print_columns(lin, nl, held, card=""):
    for column, res in (("dpf_linear", lin), ("dpf_nonlinear", nl)):
        for tag, r in res.items():
            if tag == "train":
                continue
            if "nll" in r:
                ref = (f"JAX CPU {JAX_TRAINED['rmse']:.4f} over its 8 keys, NLL {r['nll']:.4f} "
                       f"(baseline {r['baseline_nll']:.4f}; JAX {JAX_TRAINED['nll']:.4f}, "
                       f"{JAX_TRAINED['baseline_nll']:.4f})")
            else:
                mean, sd, n, key0 = JAX_STATS[column][tag]
                z, p = against_jax(column, tag, r["rmses"])
                ref = (f"JAX CPU {mean:.4f} ± {sd:.4f} over {n} keys (key 0 {key0:.4f}), "
                       f"z {z:.2f}, p {p:.4f}")
            print(f"{column} {tag}: {r['s']:.4f} s ({r['ms_per_step']:.3f} ms/step), RMSE mean "
                  f"over {len(r['rmses'])} seeds {r['rmse']:.4f} (seed 0 {r['rmse_seed0']:.4f}); "
                  f"{ref}  [{card}]")
    if lin and "train" in lin:
        t = lin["train"]
        print(f"dpf_linear RNN training: {t['steps']} Adam steps, {t['step_s']:.4f} s a step "
              f"(median), loss {t['first_loss']:.4f} -> {t['last_loss']:.4f}  [{card}]")
    if held:
        print(f"held-out (examples/09, N = 16): trained NLL {held['trained']['nll']:.4f}, "
              f"baseline {held['baseline']['nll']:.4f}, ratio {held['ratio']:.2f} (JAX "
              f"{JAX_HELDOUT})  [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("dpf: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else TRAIN_STEPS
    card = card_line()
    lin = run_linear("cuda", train_steps=steps)
    nl = run_nonlinear("cuda")
    held = run_heldout("cuda")
    print_columns(lin, nl, held, card)
    trans, loglik, _ = lgssm(LIN["a"], LIN["sq"], LIN["sr"])
    tr = DifferentiableParticleFilterRNN(LIN["N"], 1, trans, loglik, rnn_hidden_dim=16,
                                         temperature=0.5, use_weight_prior=True, device="cuda")
    print_profile("dpf_linear trained-GRU Adam step", lambda: train_rnn(tr, 1, "cuda"), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
