"""Filtering metrics: RMSE / MAE / MSE, NEES, coverage, the weight
degeneracy panel, OMAT (PyTorch port of
``particle_filters_tpu/utils/diagnostics.py``).

Same definitions as the JAX module. The weight metrics work from
log-weights along the last axis, so a (T, N) history reduces row by row;
:func:`unique_fraction` counts occupancy with ``index_add_``, not a
gather. :func:`omat` stays a host function (numpy over the C! target
assignments).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def _lognorm(log_weights: torch.Tensor) -> torch.Tensor:
    lw = torch.as_tensor(log_weights)
    return lw - torch.logsumexp(lw, dim=-1, keepdim=True)


def rmse(estimate, truth) -> torch.Tensor:
    """Root mean squared error over all elements."""
    return torch.sqrt(mse(estimate, truth))


def mae(estimate, truth) -> torch.Tensor:
    return torch.mean(torch.abs(torch.as_tensor(estimate) - torch.as_tensor(truth)))


def mse(estimate, truth) -> torch.Tensor:
    return torch.mean((torch.as_tensor(estimate) - torch.as_tensor(truth)) ** 2)


def nees(means, covs, truth) -> torch.Tensor:
    """Normalized estimation error squared per step: eᵀP⁻¹e, e = mean−truth.
    Shapes: (T, nx), (T, nx, nx), (T, nx) → (T,)."""
    diff = means - truth
    sol = torch.linalg.solve(covs, diff[..., None])[..., 0]
    return torch.sum(diff * sol, dim=-1)


def coverage_95(means, covs, truth) -> torch.Tensor:
    """Fraction of steps whose NEES falls inside the 95% chi-square interval
    for nx degrees of freedom."""
    from scipy.stats import chi2

    nx = means.shape[-1]
    lo, hi = chi2.ppf(0.025, df=nx), chi2.ppf(0.975, df=nx)
    n = nees(means, covs, truth)
    return torch.mean(((n >= lo) & (n <= hi)).to(torch.float32))


def weight_entropy(log_weights, normalized: bool = True) -> torch.Tensor:
    """Shannon entropy H = −Σ wᵢ log wᵢ of the normalized weights, from
    log-weights; with ``normalized`` divided by log(N) (uniform → 1, a point
    mass → 0; a single particle counts as uniform)."""
    lw = _lognorm(log_weights)
    w = torch.exp(lw)
    h = -torch.sum(torch.where(w > 0, w * lw, torch.zeros_like(w)), dim=-1)
    if normalized:
        n = lw.shape[-1]
        if n == 1:
            return torch.ones_like(h)
        h = h / np.log(n)
    return h


def weight_gini(log_weights) -> torch.Tensor:
    """Gini coefficient of the weights ∈ [0, 1): (2 Σᵢ i·w₍ᵢ₎)/N − (N+1)/N
    over the sorted normalized weights."""
    w = torch.sort(torch.exp(_lognorm(log_weights)), dim=-1).values
    n = w.shape[-1]
    idx = torch.arange(1, n + 1, dtype=w.dtype, device=w.device)
    return (2.0 * torch.sum(idx * w, dim=-1)) / n - (n + 1.0) / n


def max_weight(log_weights) -> torch.Tensor:
    """Largest normalized weight; → 1 under total degeneracy."""
    return torch.exp(torch.max(_lognorm(log_weights), dim=-1).values)


def unique_fraction(ancestors) -> torch.Tensor:
    """Fraction of distinct ancestor indices after a resample, (N,) → scalar
    in (0, 1]: ones added onto an occupancy vector, nonzeros counted. As in
    the JAX package's scatter, an index in [−N, 0) counts from the end and
    one outside [−N, N) is dropped."""
    a = torch.as_tensor(ancestors).long()
    n = a.shape[-1]
    a = torch.where(a < 0, a + n, a)
    slot = torch.where((a >= 0) & (a < n), a, torch.full_like(a, n))
    occupancy = torch.zeros(n + 1, dtype=torch.int32, device=a.device)
    occupancy.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    return torch.mean((occupancy[:n] > 0).to(torch.float32))


def degeneracy_report(log_weights_history) -> dict:
    """ESS, normalized entropy, Gini and max weight per step of a (T, N)
    log-weight history."""
    lw = torch.as_tensor(log_weights_history)
    ess = torch.exp(-torch.logsumexp(2.0 * _lognorm(lw), dim=-1))
    return {"ess": ess, "entropy": weight_entropy(lw), "gini": weight_gini(lw),
            "max_weight": max_weight(lw)}


def omat(est_positions, true_positions, p: int = 1) -> float:
    """OMAT (optimal mass transfer) for multi-target tracking: the least,
    over target assignments, mean p-norm position error. (C, 2) vs (C, 2);
    host-side, over the C! permutations."""
    if isinstance(est_positions, torch.Tensor):
        est_positions = est_positions.detach().cpu().numpy()
    if isinstance(true_positions, torch.Tensor):
        true_positions = true_positions.detach().cpu().numpy()
    est = np.asarray(est_positions, np.float64)
    tru = np.asarray(true_positions, np.float64)
    best = np.inf
    for perm in itertools.permutations(range(est.shape[0])):
        d = np.linalg.norm(est[list(perm)] - tru, axis=-1) ** p
        best = min(best, float(np.mean(d) ** (1.0 / p)))
    return best
