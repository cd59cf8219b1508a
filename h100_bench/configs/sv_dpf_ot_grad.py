"""Plain reference of the ``sv_dpf_ot_grad`` configuration, in plain PyTorch (no
code of the program, no JAX, no kernel): ``sv_dpf_ot``'s Sinkhorn-OT
differentiable particle filter as a function of (α, σ, β), its log-evidence,
and the gradient of that log-evidence by reverse mode through the whole run,
what a fitting step computes (Corenflos et al., arXiv:2102.07850; the
source's ``models/DPF_OT_resampling.py`` under ``tf.GradientTape``).

One run from the initial normals e (N,) and the transition noise v (T, N):

    x₀ = σ/√(1−α²) · e                                  (differentiated)
    step t:  x⁺ = α x + σ vₜ,   ℓ = −½(yₜ²/β²·e^(−x⁺) + x⁺ + 2 log β)
             log Z += log Σᵢ wᵢ exp ℓᵢ                   (w = 1/N after every resample)
             a ∝ max(w · exp(ℓ − max ℓ), 1e-12)          (the max outside the gradient)
             n_iters damped dual iterations and the barycentric projection,
             as ``sv_dpf_ot.py``'s step; x ← x', w ← 1/N

The gradient is plain autograd through all of it: every propagation, the
weights, all ``sinkhorn_iters`` half-updates of every resample unrolled, and
the projection. Each half-update and each projection runs under
``torch.utils.checkpoint``, so only one of their graphs is alive at a time:
the backward keeps the N-long vectors between them and forms C again, a
block of rows at a time (``ROW_CELLS`` cells), as the forward does. This
module's own step takes α, σ and β as tensors; ``sv_dpf_ot.py``'s step takes
them as Python numbers, and its ``math.log(b)`` would drop β's gradient from
the −log β term. float32 throughout, TF32 off; the control is the same run,
gradient included, in bfloat16 throughout.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from h100_bench import harness

ROW_CELLS = 1 << 25  # cells of C in one block of rows: 128 MB of float32


def _forward():
    """``sv_dpf_ot``'s reference: its simulator and its step-by-step ``compare``."""
    return harness.load_module("configs", "sv_dpf_ot")


def simulate(cfg: dict, sequences: int, generator, device):
    """``sv_1d``'s simulator, through ``sv_dpf_ot``'s."""
    return _forward().simulate(cfg, sequences, generator, device)


def _blocks(n: int) -> list:
    rows = max(1, ROW_CELLS // n)
    return [slice(i, min(i + rows, n)) for i in range(0, n, rows)]


def _cost(xr, x):
    """The rows ``xr`` of C against every x."""
    d = xr[:, None] - x[None, :]
    return d * d


def _half_f(f, g, x, log_b, eps: float, damp: float):
    """f ← (1−δ) f + δ τ_f(g), τ_f(g)ᵢ = −ε logsumexp_j (log bⱼ + (gⱼ − C_ij)/ε)."""
    tau = torch.cat([-eps * torch.logsumexp(log_b + (g - _cost(x[r], x)) / eps, dim=1)
                     for r in _blocks(x.shape[0])])
    return (1 - damp) * f + damp * tau


def _half_g(g, f, x, log_a, eps: float, damp: float):
    """g ← (1−δ) g + δ τ_g(f), τ_g(f)ⱼ = −ε logsumexp_i (log aᵢ + (fᵢ − C_ij)/ε)."""
    parts = [torch.logsumexp(log_a[r, None] + (f[r, None] - _cost(x[r], x)) / eps, dim=0)
             for r in _blocks(x.shape[0])]
    return (1 - damp) * g + damp * (-eps * torch.logsumexp(torch.stack(parts), dim=0))


def _project(x, f, g, log_a, log_b, eps: float):
    """x'ⱼ = Σᵢ P_ij xᵢ / bⱼ, P_ij = aᵢ bⱼ exp((fᵢ + gⱼ − C_ij)/ε)."""
    out = torch.zeros_like(x)
    for r in _blocks(x.shape[0]):
        log_p = log_a[r, None] + log_b + (f[r, None] + g - _cost(x[r], x)) / eps
        out = out + torch.sum(torch.exp(log_p) * x[r, None], dim=0)
    return out * x.shape[0]


def step(cfg: dict, params, x, y, v):
    """One step from the cloud ``x`` (N,) with uniform weights, on the noise
    ``v`` (N,) and the observation ``y``, every number in x's dtype:
    ``(x', the log-evidence increment)``, both differentiable in ``params``
    = (α, σ, β) and x."""
    alpha, sigma, beta = params
    eps, damp, n = cfg["epsilon"], cfg["damping"], x.shape[0]
    x = alpha * x + sigma * v
    ll = -0.5 * (y * y / (beta * beta) * torch.exp(-x) + x + 2 * torch.log(beta))
    log_w = torch.full_like(x, -math.log(n))
    increment = torch.logsumexp(log_w + ll, 0)
    lin = torch.clamp(torch.exp(log_w) * torch.exp(ll - torch.amax(ll).detach()), min=1e-12)
    log_a = torch.log(lin / torch.sum(lin))
    f = torch.zeros_like(x)
    g = torch.zeros_like(x)
    for _ in range(int(cfg["sinkhorn_iters"])):
        f = checkpoint(_half_f, f, g, x, log_w, eps, damp, use_reentrant=False)
        g = checkpoint(_half_g, g, f, x, log_a, eps, damp, use_reentrant=False)
    return checkpoint(_project, x, f, g, log_a, log_w, eps, use_reentrant=False), increment


def run(cfg: dict, e0, ys, vs, dtype=torch.float32) -> dict:
    """The whole run from the initial normals ``e0`` (N,) over ``ys`` (T,),
    step t on the noise ``vs[t]`` (N,), in ``dtype``, and the gradient of
    its log-evidence: the program's outputs, ``{"particles": (T+1, N, 1),
    "weights": (T+1, N), "log_evidence": 0-d, "grads": (3,) for (α, σ,
    β)}``, as float32 (as float64 where computed in float64)."""
    dev = e0.device
    params = tuple(torch.tensor(float(cfg[k]), dtype=dtype, device=dev, requires_grad=True)
                   for k in ("alpha", "sigma", "beta"))
    alpha, sigma, _ = params
    x = sigma / torch.sqrt(1 - alpha * alpha) * e0.to(dtype)
    xs, log_z = [x.detach()], torch.zeros((), dtype=dtype, device=dev)
    for t in range(ys.shape[0]):
        x, increment = step(cfg, params, x, ys[t].to(dtype), vs[t].to(dtype))
        xs.append(x.detach())
        log_z = log_z + increment
    grads = torch.autograd.grad(log_z, params)
    n, out = e0.shape[0], torch.float64 if dtype == torch.float64 else torch.float32
    return {"particles": torch.stack(xs).to(out)[..., None],
            "weights": torch.full((len(xs), n), 1.0 / n, dtype=out, device=dev),
            "log_evidence": log_z.detach().to(out),
            "grads": torch.stack(grads).to(out)}


def compare(cfg: dict, prog: dict, ys, vs, e0) -> dict:
    """The numbers that compare one value-and-gradient evaluation of the
    program (its ``particles``, ``weights``, ``log_evidence`` and ``grads``
    for (α, σ, β)) with this module's own whole run from the same initial
    normals ``e0`` (N,) and transition noise ``vs`` (T, N):

    - ``grad_gap``: maxₖ |∇ₖ − ∇ₖ,ref| / ‖∇_ref‖ over (α, σ, β);
    - ``logz_gap``: |log Z − log Z_ref| in nats, the whole run's;
    - ``particle_gap_p50``, ``particle_gap_p90``, ``mean_gap``:
      ``sv_dpf_ot.py``'s ``compare`` of the kept states, the plain filter
      stepped from each of the program's states on the same noise.
    """
    ref = run(cfg, e0, ys, vs)
    grad, grad_ref = prog["grads"].double().cpu(), ref["grads"].double().cpu()
    steps = _forward().compare(cfg, prog, ys, vs)
    return {"grad_gap": float(torch.max(torch.abs(grad - grad_ref)) / torch.linalg.norm(grad_ref)),
            "logz_gap": abs(float(prog["log_evidence"]) - float(ref["log_evidence"])),
            "particle_gap_p50": steps["particle_gap_p50"],
            "particle_gap_p90": steps["particle_gap_p90"],
            "mean_gap": steps["mean_gap"]}


def control(cfg: dict, e0, ys, vs) -> dict:
    """The control: this run in bfloat16, the precision below float32,
    throughout: the cloud, the weights, the cost, the duals, the projection,
    the log-evidence's sum and the whole backward."""
    return run(cfg, e0, ys, vs, dtype=torch.bfloat16)
