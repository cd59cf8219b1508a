"""DPF-OT parameter tuning, the ε × damping × Sinkhorn-iterations sweep:
the port's twin of ``examples/08_dpf_ot_tuning.py``.

    python -m particle_filters_tpu_torch.examples.ex08_dpf_ot_tuning [--device cpu] [--seeds 10]

The linear comparison config (x' = 0.9x + 0.3·v, y = x + 0.5·w, N = 50,
T = 20): a bootstrap PF whose every step resamples by Sinkhorn OT
(``resampling/ot.py``), scored by the posterior-mean RMSE averaged over
seeds, on the grid ε ∈ ``EPS_GRID`` × damping ∈ ``DAMP_GRID`` × iterations
∈ ``ITERS_GRID``. As the JAX script makes ε and damping traced scalars,
``torch.func.vmap`` runs each iteration count's whole (ε × damping) grid
over all seeds at once, ε and damping reaching ``sinkhorn_ot_resample`` as
0-dim tensors: one batched launch a torch op, where a loop over the 120
filters a count would enqueue each op 120 times. The filter's noise (the
initial cloud and each step's) is drawn before the vmap, from the
generator, or given (``noise=``, so a test can pass the JAX package's).

The JAX package's sweep (``examples/ot_tuning_results.json``, 10 seeds):
best ε 0.01, damping 1, 50 iterations, RMSE ``JAX_BEST_RMSE``, the standard
error of its 10 seeds' RMSEs ``JAX_BEST_SE``. The two packages draw other
data and noise, so their best cells are two samples: over 200 seeds the
JAX package's cell reads 0.3090 ± 0.0047 and the port's 0.3220 ± 0.0060
(CPU). Gates: every cell finite, and the best cell's RMSE within ``SE_K``
standard errors of the JAX package's best (the two samples' errors
combined).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from particle_filters_tpu_torch.resampling.ot import sinkhorn_ot_resample
from particle_filters_tpu_torch.utils.timing import card_line, resolve_device, sync

A_C, SQ, SR = 0.9, 0.3, 0.5
N, T = 50, 20
EPS_GRID = (0.01, 0.02, 0.05, 0.1, 0.2, 0.5)
DAMP_GRID = (0.5, 1.0)
ITERS_GRID = (25, 50, 100)
SEEDS = 10
JAX_BEST = {"epsilon": 0.01, "damping": 1.0, "n_iters": 50}
JAX_BEST_RMSE = 0.3335822522640228
JAX_BEST_SE = 0.017821976091618372  # printed by ``python tests/test_torch_ex08.py``
SE_K = 5.0


def simulate(generator, seeds: int, device):
    """(S, T, 1) states and observations of the 1-D LGSSM from x₀ = 0."""
    v = torch.randn((seeds, T, 2), generator=generator, device=device)
    x, xs, ys = torch.zeros(seeds, device=device), [], []
    for t in range(T):
        x = A_C * x + SQ * v[:, t, 0]
        xs.append(x)
        ys.append(x + SR * v[:, t, 1])
    return torch.stack(xs, 1)[..., None], torch.stack(ys, 1)[..., None]


def draw_noise(generator, seeds: int, device):
    """The filters' standard normals: (S, N, 1) initial, (S, T, N, 1) steps."""
    return (torch.randn((seeds, N, 1), generator=generator, device=device),
            torch.randn((seeds, T, N, 1), generator=generator, device=device))


def filter_means(init, steps, ys, eps, damping, n_iters: int):
    """The OT-DPF on one sequence: (T, 1) posterior means. ``eps`` and
    ``damping`` may be 0-dim tensors (vmapped)."""
    p = init
    w = torch.full((N,), 1.0 / N, device=init.device)
    means = []
    for t in range(T):
        p = A_C * p + SQ * steps[t]
        loglik = -0.5 * torch.sum((p - ys[t][None, :]) ** 2, dim=1) / SR**2
        loglik = loglik - torch.max(loglik).detach()
        w = torch.clamp(w * torch.exp(loglik), min=1e-12)
        w = w / torch.sum(w)
        p, w = sinkhorn_ot_resample(p, w, epsilon=eps, n_iters=n_iters, damping=damping)
        means.append(torch.sum(w[:, None] * p, dim=0))
    return torch.stack(means)


def seed_rmses(xs, ys, noise, eps, damping, n_iters: int):
    """The RMSE of each seed's run: (S,)."""
    init, steps = noise

    def one(x, y, i, s):
        return torch.sqrt(torch.mean((filter_means(i, s, y, eps, damping, n_iters) - x) ** 2))

    return torch.func.vmap(one)(xs, ys, init, steps)


def grid_rmses(xs, ys, noise, n_iters: int, eps_grid=EPS_GRID, damp_grid=DAMP_GRID):
    """Every seed's RMSE at every (ε, damping) cell, one vmap over the grid
    and the seeds: (E, D, S)."""
    device = xs.device
    eps = torch.tensor(eps_grid, device=device)
    damp = torch.tensor(damp_grid, device=device)
    cell = lambda e, d: seed_rmses(xs, ys, noise, e, d, n_iters)  # noqa: E731
    return torch.func.vmap(torch.func.vmap(cell, in_dims=(None, 0)), in_dims=(0, None))(eps, damp)


def run_all(device="cuda", generator=None, seeds: int = SEEDS, iters_grid=ITERS_GRID,
            data=None, noise=None) -> dict:
    """The sweep: ``{"grid": [{epsilon, damping, n_iters, rmse, se}], "best",
    "seconds"}`` (``data`` = (xs, ys) and ``noise`` given, or drawn)."""
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    xs, ys = simulate(gen, seeds, device) if data is None else data
    noise = draw_noise(gen, seeds, device) if noise is None else noise
    rows, secs = [], {}
    for n_iters in iters_grid:
        sync(device)
        t0 = time.perf_counter()
        r = grid_rmses(xs, ys, noise, n_iters)
        sync(device)
        secs[n_iters] = time.perf_counter() - t0
        for i, e in enumerate(EPS_GRID):
            for j, d in enumerate(DAMP_GRID):
                s = r[i, j].double()
                rows.append({"epsilon": e, "damping": d, "n_iters": n_iters,
                             "rmse": s.mean().item(),
                             "se": (s.std() / math.sqrt(s.numel())).item()})
    return {"grid": rows, "best": min(rows, key=lambda r: r["rmse"]), "seconds": secs,
            "seeds": xs.shape[0]}


def gates(res) -> dict:
    """``{gate: (value, held)}``: every cell finite; the best cell within
    ``SE_K`` standard errors of the JAX package's best RMSE."""
    b = res["best"]
    z = abs(b["rmse"] - JAX_BEST_RMSE) / math.hypot(b["se"], JAX_BEST_SE)
    return {"every cell finite": (None, all(math.isfinite(r["rmse"]) for r in res["grid"])),
            f"best within {SE_K} SE of {JAX_BEST_RMSE:.5f}": (z, z <= SE_K)}


def print_tables(res, card: str) -> None:
    for n_iters, s in res["seconds"].items():
        print(f"ex08 n_iters={n_iters} ({len(EPS_GRID)}x{len(DAMP_GRID)} cells x "
              f"{res['seeds']} seeds, one vmap, {s:.3f} s)  [{card}]:")
        for e in EPS_GRID:
            row = "  ".join(f"{r['rmse']:.4f}" for r in res["grid"]
                            if r["n_iters"] == n_iters and r["epsilon"] == e)
            print(f"  eps={e:<5}: {row}  (damping {list(DAMP_GRID)})")
    b = res["best"]
    print(f"ex08 best: {json.dumps(b)} (JAX package: {json.dumps(JAX_BEST)}, RMSE "
          f"{JAX_BEST_RMSE:.5f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=SEEDS)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    res = run_all(device, seeds=args.seeds)
    print_tables(res, card_line(device))
    return 0 if all(held for _, held in gates(res).values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
