"""Plain reference of the ``sv_dpf_ot`` configuration, in plain PyTorch (no
code of the program): the SV simulator (``sv_1d``'s), one step of the
Sinkhorn-OT differentiable particle filter (Corenflos et al., "Differentiable
Particle Filtering via Entropy-Regularized Optimal Transport",
arXiv:2102.07850, as the source's ``models/DPF_OT_resampling.py`` runs it),
the numbers that compare a run of the program with it, and the control.

One step from a cloud x (N,) with weights w (N,), on the step's transition
noise v (N,) and observation y:

    x⁺ = α x + σ v,   ℓ = −½(y²/β²·e^(−x⁺) + x⁺ + 2 log β)
    log-evidence increment  log Σᵢ wᵢ exp ℓᵢ
    a ∝ max(w · exp(ℓ − max ℓ), 1e-12)   (linear domain),  b = 1/N
    C_ij = (x⁺ᵢ − x⁺ⱼ)²
    n_iters × { f ← (1−δ) f + δ τ_f(g),  g ← (1−δ) g + δ τ_g(f) }   (f = g = 0 first)
        τ_f(g)ᵢ = −ε logsumexp_j (log bⱼ + (gⱼ − C_ij)/ε)
        τ_g(f)ⱼ = −ε logsumexp_i (log aᵢ + (fᵢ − C_ij)/ε)
    P_ij = aᵢ bⱼ exp((fᵢ + gⱼ − C_ij)/ε),   x'ⱼ = Σᵢ P_ij x⁺ᵢ / bⱼ,   w' = 1/N

The cost is formed from differences, (x⁺ᵢ − x⁺ⱼ)², where the program expands
x² − 2xy + y²; the −½ log 2π of the observation density is left out, as the
program's SV model leaves it out. C is formed a block of rows at a time
(``ROW_CELLS`` cells), never whole, and every reduction over its rows is a
logsumexp of the blocks' logsumexps. float32 throughout, TF32 off; the
control runs the same arithmetic in bfloat16 throughout.
"""

from __future__ import annotations

import math

import torch

from h100_bench import harness

ROW_CELLS = 1 << 25  # cells of C in one block of rows: 128 MB of float32


def simulate(cfg: dict, sequences: int, generator, device):
    """``sv_1d``'s simulator: ``sequences`` (X, Y) paths of ``cfg["steps"]``."""
    return harness.load_module("configs", "sv_1d").simulate(cfg, sequences, generator, device)


def loglik(cfg: dict, x, y):
    b = cfg["beta"]
    return -0.5 * (y * y / (b * b) * torch.exp(-x) + x + 2 * math.log(b))


def _cost(xr, x):
    """The rows ``xr`` of C against every x."""
    d = xr[:, None] - x[None, :]
    return d * d


def step(cfg: dict, x, w, y, v, dtype=torch.float32) -> dict:
    """One DPF-OT step (module docstring) from the cloud ``x`` (N,) with
    weights ``w`` (N,) on the noise ``v`` (N,) and the observation ``y``:
    ``{"x": x' (N,), "log_z": the increment (0-d), "mean": the mean of
    x'}``, every number of it computed in ``dtype``."""
    x, w, y, v = (t.to(dtype) for t in (x, w, y, v))
    eps, damp, n = cfg["epsilon"], cfg["damping"], x.shape[0]
    x = cfg["alpha"] * x + cfg["sigma"] * v
    ll = loglik(cfg, x, y)
    log_z = torch.logsumexp(torch.log(w) + ll, 0)
    lin = torch.clamp(w * torch.exp(ll - torch.amax(ll)), min=1e-12)
    log_a = torch.log(lin / torch.sum(lin))
    log_b = torch.full_like(x, -math.log(n))
    rows = max(1, ROW_CELLS // n)
    blocks = [slice(i, min(i + rows, n)) for i in range(0, n, rows)]

    def tau_f(g):
        return torch.cat([-eps * torch.logsumexp(log_b + (g - _cost(x[r], x)) / eps, dim=1)
                          for r in blocks])

    def tau_g(f):
        parts = [torch.logsumexp(log_a[r, None] + (f[r, None] - _cost(x[r], x)) / eps, dim=0)
                 for r in blocks]
        return -eps * torch.logsumexp(torch.stack(parts), dim=0)

    f = torch.zeros_like(x)
    g = torch.zeros_like(x)
    for _ in range(int(cfg["sinkhorn_iters"])):
        f = (1 - damp) * f + damp * tau_f(g)
        g = (1 - damp) * g + damp * tau_g(f)
    x_new = torch.zeros_like(x)
    for r in blocks:
        log_p = log_a[r, None] + log_b + (f[r, None] + g - _cost(x[r], x)) / eps
        x_new = x_new + torch.sum(torch.exp(log_p) * x[r, None], dim=0)
    x_new = x_new * n
    return {"x": x_new, "log_z": log_z, "mean": torch.mean(x_new)}


def run(cfg: dict, x0, ys, vs, dtype=torch.float32) -> dict:
    """The filter run on its own from the cloud ``x0`` (N,) over the
    observations ``ys`` (T,), step t on the noise ``vs[t]`` (N,), computed
    in ``dtype`` (the log-evidence's sum too): the program's outputs,
    ``{"particles": (T+1, N, 1), "weights": (T+1, N), "log_evidence":
    0-d}``, as float32."""
    n = x0.shape[0]
    xs, log_z = [x0.to(dtype)], torch.zeros((), dtype=dtype, device=x0.device)
    w = torch.full_like(xs[0], 1.0 / n)
    for t in range(ys.shape[0]):
        out = step(cfg, xs[-1], w, ys[t], vs[t], dtype)
        xs.append(out["x"])
        log_z = log_z + out["log_z"]
    return {"particles": torch.stack(xs).float()[..., None],
            "weights": w.float().expand(len(xs), n), "log_evidence": log_z.float()}


def compare(cfg: dict, prog: dict, ys, vs) -> dict:
    """The numbers that compare one run of the program (its ``particles``
    (T+1, N, 1), ``weights`` (T+1, N) and ``log_evidence``) with this
    filter stepped from each of the program's states on the program's own
    transition noise ``vs`` (T, N) and observations ``ys`` (T,):

    - ``particle_gap_p50``, ``particle_gap_p90``: the quantiles, over every
      particle of every step, of |x' − x'_ref| over the std of x'_ref;
    - ``mean_gap``: the same steps' largest gap of the filtered mean, over
      the std of x'_ref;
    - ``logz_gap``: |the program's log-evidence − Σ_t the increments of
      the same steps| in nats.
    """
    ps, ws = prog["particles"][..., 0], prog["weights"]
    gaps, mean_gap, log_z = [], 0.0, 0.0
    for t in range(ys.shape[0]):
        ref = step(cfg, ps[t], ws[t], ys[t], vs[t])
        std = torch.std(ref["x"].double())
        gaps.append((torch.abs(ps[t + 1].double() - ref["x"].double()) / std).cpu())
        mean_gap = max(mean_gap, float(abs(torch.mean(ps[t + 1].double()) - ref["mean"]) / std))
        log_z += float(ref["log_z"])
    q = torch.quantile(torch.cat(gaps), torch.tensor([0.5, 0.9], dtype=torch.float64))
    return {"particle_gap_p50": float(q[0]), "particle_gap_p90": float(q[1]),
            "mean_gap": mean_gap, "logz_gap": abs(float(prog["log_evidence"]) - log_z)}


def control(cfg: dict, x0, ys, vs) -> dict:
    """The control: this filter run on its own in bfloat16, the precision
    below float32, throughout: the cloud, the weights, the cost, the duals,
    the projection and the log-evidence's sum (TF32 would reach none of it:
    the cost is formed here from differences, and by the program from a
    product with K = 1)."""
    return run(cfg, x0, ys, vs, dtype=torch.bfloat16)
