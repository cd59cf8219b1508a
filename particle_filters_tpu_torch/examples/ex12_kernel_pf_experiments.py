"""Kernel-PF experiments on Lorenz-96: the EnKF reference and the
notebook's two tables, the port's twin of
``examples/12_kernel_pf_experiments.py``.

    python -m particle_filters_tpu_torch.examples.ex12_kernel_pf_experiments [--device cpu]

From the prior ensemble at the first assimilation time (Lorenz-96,
nx = 1000, Np = 20, every 4th variable observed with unit noise; the JAX
package's ensemble, observation, ``H_idx`` and ``R_diag``, committed as
``benchmarks/data/kpf_l96_nx1000.npz``):

- the perturbed-observation (stochastic) EnKF posterior, the reference
  answer, with the analytic (I − KH)P beside it;
- the kernel PF's posteriors with the scalar kernel (fixed lengthscale 1)
  and the diagonal matrix-valued kernel, from ``benchmarks/kpf.py``'s
  ``run_cases``: as a user runs them (the jitter ladder picks the prior
  factor's rung), and with the factor's jitter pinned at the JAX package's
  rung (1e-4; the rows marked "@1e-04"). Without localization B has rank 19
  in 1000 dimensions and the posterior is rounding-bound: the CPU's LAPACK
  refuses 1e-5 and factors at 1e-4, as the JAX package does; the card's
  cuSOLVER returns a finite factor at 1e-5 that is too far from B + reg·I,
  which the ladder's residual check (``KernelParticleFilter.prior_factor``)
  rejects, so the card also takes 1e-4;
- table 1: the trace of the posterior covariance of the (x19 unobserved,
  x20 observed) marginal, against the EnKF's;
- table 2: the mean variance of the observed and the unobserved
  dimensions, and their reduction from the prior.

The EnKF's observation perturbations are standard normals drawn from the
generator unless given (``perturbations=``, so a test can pass the JAX
package's draws). Gates (the notebook's finding, with margin: JAX package
EnKF 97.50 / 97.35 %, diagonal 88.58 / 88.69 %): the EnKF reduces the
observed and the unobserved variance by at least ``ENKF_MIN_RED``, the
diagonal kernel at the JAX package's rung by at least ``DIAG_MIN_RED``,
the diagonal kernel as a user runs it within ``DIAG_USER_TOL`` of the
reductions of the JAX package's committed posterior, every posterior
finite.
"""

from __future__ import annotations

import argparse
import math

import torch

from particle_filters_tpu_torch.benchmarks import kpf
from particle_filters_tpu_torch.models.kernel_particle_filter import (
    KernelParticleFilter,
    factor_residual,
)
from particle_filters_tpu_torch.utils.timing import card_line, resolve_device

VARS = (19, 20)  # [unobserved, observed]: the notebook's marginal
KERNELS = ("scalar", "diagonal")
ENKF_MIN_RED = 0.90
DIAG_MIN_RED = 0.50
ENKF_SEED = 999  # the JAX script's PRNGKey(999)
F64_MIN_RED = 0.85  # the diagonal kernel in float64, any rung (CPU: 88.26 / 88.44 %)
# The diagonal kernel as a user runs it against the JAX package's reductions
# (88.58 / 88.69 %), in fractions. The posterior is rounding-bound: the CPU
# port reads 0.09 / 0.04 points off, float64 0.32 / 0.25, the card 0.74 /
# 0.59 (its ladder's factor at 1e-4) and 0.50 / 0.45 (the pinned one, the
# same rung by another cuSOLVER call); a rejected 1e-5 factor is 8–60 off.
DIAG_USER_TOL = 0.02


def enkf_update(X, y, H_idx, R, perturbations):
    """The perturbed-observation EnKF: the posterior ensemble and the
    analytic (I − KH)P. ``perturbations`` are (Np, ny) standard normals,
    scaled by chol(R)."""
    Np = X.shape[0]
    A = X - X.mean(0)
    P = (A.T @ A) / (Np - 1)
    HP = P[H_idx]  # (ny, nx) = H P
    S = HP[:, H_idx] + R
    K = torch.linalg.solve(S, HP).T  # (nx, ny) = P Hᵀ S⁻¹
    pert = perturbations @ torch.linalg.cholesky(R).T
    X_post = X + (y + pert - X[:, H_idx]) @ K.T
    return X_post, P - K @ HP


def ens_cov_2d(X, idx=VARS):
    """The ensemble covariance of the ``idx`` marginal."""
    A = X - X.mean(0)
    P = (A.T @ A) / (X.shape[0] - 1)
    idx = torch.as_tensor(idx, device=X.device)
    return P[idx][:, idx]


def variances(X, H_idx):
    """(mean variance of the observed dims, of the unobserved ones)."""
    v = torch.var(X, dim=0, unbiased=False)
    observed = torch.zeros(X.shape[1], dtype=torch.bool, device=X.device)
    observed[H_idx] = True
    return v[observed].mean().item(), v[~observed].mean().item()


def run_all(device="cuda", data=None, perturbations=None, generator=None) -> dict:
    """The EnKF and the two kernel PFs from the committed prior; their
    tables' numbers and the KPF's ``run_cases`` rows."""
    device = resolve_device(device)
    data = kpf.load_data(device) if data is None else data
    X, y = data["prior1"], data["y1"]
    H_idx, R = data["H_idx"].long(), torch.diag(data["R_diag"])
    if perturbations is None:
        gen = generator or torch.Generator(device=device).manual_seed(ENKF_SEED)
        perturbations = torch.randn((X.shape[0], H_idx.shape[0]), generator=gen, device=device)
    X_enkf, P_analytic = enkf_update(X, y, H_idx, R,
                                     torch.as_tensor(perturbations, device=device))
    kpfs = kpf.run_cases(device, data, {k: kpf.CASES[k] for k in KERNELS})
    posteriors = {"EnKF": X_enkf, **{k: kpfs[k]["posterior"] for k in KERNELS},
                  **{f"{k}@{kpf.JAX_RUNG[k]:.0e}": kpfs[k]["pinned"]["posterior"]
                     for k in KERNELS}}
    prior = variances(X, H_idx)
    jax_diag = tuple(1 - a / b for a, b in zip(variances(data["post_diagonal"], H_idx), prior))
    return {
        "enkf": X_enkf, "enkf_var_mean": torch.var(X_enkf, dim=0, unbiased=False).mean().item(),
        "analytic_var_mean": torch.diagonal(P_analytic).mean().item(),
        "trace": {k: torch.trace(ens_cov_2d(v)).item() for k, v in posteriors.items()},
        "prior": prior,
        "reduction": {k: tuple(1 - a / b for a, b in zip(variances(v, H_idx), prior))
                      for k, v in posteriors.items()},
        "variance": {k: variances(v, H_idx) for k, v in posteriors.items()},
        "jax_diagonal_reduction": jax_diag,
        "kpf": kpfs,
        "finite": all(bool(torch.isfinite(v).all()) for v in posteriors.values()),
    }


def diagonal_f64(device, data=None, jitter: float = 1e-5):
    """The diagonal kernel's analysis of the committed prior in float64,
    the factor's jitter pinned at ``jitter``: its (observed, unobserved)
    variance reductions. In float64 the ladder takes jitter 0 and the
    reductions at 0, 1e-5 and 1e-4 agree, so a run's dependence on the rung
    in float32 is rounding of B + (reg + jitter)·I, not the method."""
    device = resolve_device(device)
    data = kpf.load_data(device) if data is None else data
    d64 = {k: v.double() if v.is_floating_point() else v for k, v in data.items()}
    H_idx = d64["H_idx"].long()
    X = d64["prior1"]
    post = KernelParticleFilter(kpf.obs_model(d64), kpf.CASES["diagonal"][0]).analyze(
        X, d64["y1"], jitter=jitter).particles
    return tuple(1 - a / b for a, b in zip(variances(post, H_idx), variances(X, H_idx)))


def diagonal_factor_residuals(device, data=None, jitters=(1e-5, 1e-4)) -> dict:
    """``{jitter: factor_residual}`` of the diagonal case's float32 prior
    factor pinned at each jitter (inf where the factor is not finite): what
    ``prior_factor``'s ladder weighs against ``FACTOR_RESID_MAX``."""
    device = resolve_device(device)
    data = kpf.load_data(device) if data is None else data
    f = KernelParticleFilter(kpf.obs_model(data), kpf.CASES["diagonal"][0])
    B = f._prior_stats(data["prior1"])[1]
    eye = torch.eye(B.shape[0], dtype=B.dtype, device=device)
    out = {}
    for j in jitters:
        L, _ = f.prior_factor(B, j)
        finite = bool(torch.isfinite(L).all())
        out[j] = factor_residual(L, B + (f.cfg.reg + j) * eye).item() if finite else math.inf
    return out


def gates(res) -> dict:
    """``{gate: (value, held)}``."""
    red = res["reduction"]
    e, d = red["EnKF"], red["diagonal"]
    dp = red[f"diagonal@{kpf.JAX_RUNG['diagonal']:.0e}"]
    jd = res["jax_diagonal_reduction"]
    return {
        f"EnKF reduces observed and unobserved variance >= {ENKF_MIN_RED}": (
            e, min(e) >= ENKF_MIN_RED),
        f"diagonal kernel at the JAX package's rung reduces both >= {DIAG_MIN_RED}": (
            dp, min(dp) >= DIAG_MIN_RED),
        f"diagonal kernel as a user runs it within {DIAG_USER_TOL} of the JAX package's "
        f"{tuple(round(v, 4) for v in jd)}": (
            d, max(abs(a - b) for a, b in zip(d, jd)) <= DIAG_USER_TOL),
        "finite posteriors": (None, res["finite"] and math.isfinite(res["analytic_var_mean"])),
    }


def print_tables(res, card: str) -> None:
    print(f"ex12 EnKF posterior: ensemble mean diag {res['enkf_var_mean']:.4f}, analytic mean "
          f"diag {res['analytic_var_mean']:.4f}")
    for k in KERNELS:
        r = res["kpf"][k]
        print(f"ex12 {k:9s} kernel: s = {r['s']:.3f} in {r['steps']} steps, {r['ms']:.3f} ms, "
              f"factor at jitter {r['rung']:g}  [{card}]")
    tr = res["trace"]
    print(f"ex12 table 1, trace of the posterior covariance of (x[{VARS[0]}] unobs, "
          f"x[{VARS[1]}] obs):")
    for k, v in tr.items():
        print(f"  {k:15s} {v:8.4f}   ({v / tr['EnKF']:.2f}x EnKF)")
    po, pu = res["prior"]
    print("ex12 table 2, variance (observed = every 4th of 1000 dims):")
    print(f"  {'method':15s} {'obs var':>9s} {'unobs var':>10s} {'obs red%':>9s} "
          f"{'unobs red%':>11s}")
    print(f"  {'prior':15s} {po:9.4f} {pu:10.4f}")
    for k, (o, u) in res["variance"].items():
        ro, ru = res["reduction"][k]
        print(f"  {k:15s} {o:9.4f} {u:10.4f} {100 * ro:8.2f}% {100 * ru:10.2f}%")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    res = run_all(device)
    print_tables(res, card_line(device))
    return 0 if all(held for _, held in gates(res).values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
