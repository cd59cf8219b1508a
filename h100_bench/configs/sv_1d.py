"""Plain reference of the ``sv_1d`` configuration, in plain PyTorch (no code
of the program): its simulator, a plain SIR filter, and the numbers that
compare a run of the program with a run of this filter on the same
observations.

    X_t = α X_{t−1} + σ V_t,   Y_t = β exp(X_t / 2) W_t,   X_{−1} ~ N(0, σ²/(1 − α²))

The filter propagates, weights by log p(y | x) = −½(y²/β²·e⁻ˣ + x + 2 log β)
(the −½ log 2π constant left out, as the program's SV model leaves it out),
records the step's log-normalizer, ESS and weighted mean before any
resample, and resamples systematically (positions (u + i)/N, one u) when
ESS < ratio·N. The program draws its own normals on the card, so the two
filters share observations and never random numbers: the comparison is of
Monte Carlo estimates of one posterior.
"""

from __future__ import annotations

import math

import torch


def simulate(cfg: dict, sequences: int, generator, device):
    """``sequences`` independent (X, Y) paths of ``cfg["steps"]`` steps, each
    (sequences, T) f32, drawn on ``device`` from ``generator``."""
    a, s, b, T = cfg["alpha"], cfg["sigma"], cfg["beta"], cfg["steps"]
    x = s / math.sqrt(1 - a * a) * torch.randn(sequences, generator=generator, device=device)
    V = torch.randn((T, sequences), generator=generator, device=device)
    W = torch.randn((T, sequences), generator=generator, device=device)
    xs = []
    for t in range(T):
        x = a * x + s * V[t]
        xs.append(x)
    X = torch.stack(xs, dim=1)
    return X, b * torch.exp(X / 2) * W.T


def sir(cfg: dict, y, n: int, generator, dtype=torch.float32) -> dict:
    """The plain SIR filter on one observation sequence ``y`` (T,) with
    ``n`` particles, computed in ``dtype``: per step ``log_z``, ``ess``,
    ``mean`` (before any resample) and ``resampled``, each (T,) f64."""
    a, s, b = cfg["alpha"], cfg["sigma"], cfg["beta"]
    dev = y.device
    acc = torch.float64 if dtype == torch.float32 else dtype  # the cdf's precision
    x = (s / math.sqrt(1 - a * a) * torch.randn(n, generator=generator, device=dev)).to(dtype)
    logw = torch.full((n,), -math.log(n), dtype=dtype, device=dev)
    slots = torch.arange(n, device=dev, dtype=acc)
    y = y.to(dtype)
    rows = []
    for t in range(y.shape[0]):
        eps = torch.randn(n, generator=generator, device=dev).to(dtype)
        x = a * x + s * eps
        logw = logw - 0.5 * (y[t] * y[t] / (b * b) * torch.exp(-x) + x + 2 * math.log(b))
        log_z = torch.logsumexp(logw, 0)
        logw = logw - log_z
        w = torch.exp(logw)
        ess = 1.0 / torch.sum(w * w)
        resample = bool(ess < cfg["resample_ess_ratio"] * n)
        rows.append(torch.stack([log_z.double(), ess.double(), torch.sum(w * x).double(),
                                 torch.tensor(float(resample), dtype=torch.float64,
                                              device=dev)]))
        if resample:
            cdf = torch.cumsum(w.to(acc), 0)
            u = torch.rand((), generator=generator, device=dev, dtype=acc)
            idx = torch.searchsorted(cdf / cdf[-1], (u + slots) / n, right=True)
            x = x[idx.clamp_(max=n - 1)]
            logw = torch.full_like(logw, -math.log(n))
    out = torch.stack(rows).cpu()
    return {"log_z": out[:, 0], "ess": out[:, 1], "mean": out[:, 2],
            "resampled": out[:, 3] > 0.5}


def compare(prog: dict, ref: dict, n: int) -> dict:
    """The numbers that compare one run of the program with one of the plain
    filter on the same observations (both dicts of (T,) tensors):

    - ``logz_gap``: |Σ_t log_z| apart, the log-evidence in nats;
    - ``mean_gap``: the RMS over steps of the posterior means' gap;
    - ``ess_gap``: the largest gap of ESS/N over the steps up to the first
      resample of either filter (after it, their resample steps may fall
      apart by one, and the ESS with them).
    """
    p = {k: v.double().cpu() for k, v in prog.items()}
    r = {k: v.double().cpu() for k, v in ref.items()}
    either = (p["resampled"] > 0.5) | (r["resampled"] > 0.5)
    first = int(torch.nonzero(either)[0, 0]) if bool(either.any()) else either.shape[0] - 1
    return {
        "logz_gap": abs(float(p["log_z"].sum() - r["log_z"].sum())),
        "mean_gap": float(torch.sqrt(torch.mean((p["mean"] - r["mean"]) ** 2))),
        "ess_gap": float(torch.max(torch.abs(p["ess"] - r["ess"])[: first + 1])) / n,
    }


def control(cfg: dict, y, n: int, generator) -> dict:
    """The control: this filter in bfloat16, the precision below float32
    (the configuration has no matrix products, so TF32 would change
    nothing)."""
    return sir(cfg, y, n, generator, dtype=torch.bfloat16)
