"""Skew-t dynamics sensor network with Poisson count measurements (PyTorch
port of ``particle_filters_tpu/simulators/sensor_network_skewt.py``).

    W_k ~ InvGamma(ν/2, ν/2)
    x_k = α x_{k−1} + W_k γ + √W_k · L z_k,   z_k ~ N(0, I),  Σ = L Lᵀ spatial SE kernel
    λ_k = m₁ exp(m₂ · clip(x_k)),  counts ~ Poisson(λ_k)

The inverse gamma is 1 / (Gamma(ν/2) / (ν/2)) from ``torch._standard_gamma``,
the counts ``torch.poisson``, both drawn from a ``torch.Generator`` on the
device seeded with ``dyn_cfg.seed`` (other streams than the JAX package's
threefry keys, so samples compare statistically). The T-step recursion is a
Python loop; :func:`simulate_skewt_many` draws every trial's step at once.
``save_npz``/``load_npz`` use the JAX package's keys, so a file written by
either package loads in the other.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from particle_filters_tpu_torch.core.linalg import chol_with_jitter


@dataclass(frozen=True)
class SkewTGridConfig:
    d: int = 144
    alpha0: float = 1.0
    alpha1: float = 1e-3
    beta: float = 8.0


@dataclass(frozen=True)
class SkewTDynConfig:
    alpha: float = 0.9
    nu: float = 8.0
    gamma_scale: float = 0.1
    gamma_vec: Optional[Any] = None
    clip_x: Optional[Tuple[float, float]] = (-10.0, 10.0)
    chol_jitter: float = 1e-8
    seed: Optional[int] = 123


@dataclass(frozen=True)
class SkewTMeasConfig:
    m1: float = 1.0
    m2: float = 1.0 / 3.0


@dataclass(frozen=True)
class SkewTSimConfig:
    T: int = 10
    n_trials: int = 1
    save_lambda: bool = True


def make_lattice(d: int, device="cuda") -> torch.Tensor:
    """(d, 2) sensor lattice, 'xy' meshgrid ordering, f32."""
    s = int(np.sqrt(d))
    if s * s != d:
        raise ValueError(f"d={d} is not a perfect square; got sqrt={s}.")
    xs, ys = torch.meshgrid(torch.arange(s), torch.arange(s), indexing="xy")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1).to(
        device=device, dtype=torch.float32)


def build_spatial_cov(R: torch.Tensor, alpha0: float, alpha1: float,
                      beta: float) -> torch.Tensor:
    """Σ_ij = α₀ exp(−‖Rᵢ−Rⱼ‖²/β) + α₁ δᵢⱼ."""
    diffs = R[:, None, :] - R[None, :, :]
    dist2 = torch.sum(diffs * diffs, dim=-1)
    K = alpha0 * torch.exp(-dist2 / beta)
    return K + alpha1 * torch.eye(R.shape[0], dtype=K.dtype, device=K.device)


def sample_inverse_gamma(generator, shape_p: float, scale_p: float, shape=(),
                         device="cuda") -> torch.Tensor:
    """W ~ InvGamma(shape_p, scale_p) = 1 / (Gamma(shape_p) / scale_p), the
    standard (rate 1) gamma divided by the rate."""
    alpha = torch.full(tuple(shape), float(shape_p), device=device)
    return 1.0 / (torch._standard_gamma(alpha, generator=generator) / scale_p)


def prepare_gamma_vector(generator, d: int, gamma_scale: float, gamma_vec: Optional[Any],
                         device="cuda") -> torch.Tensor:
    """Skew vector γ: explicit, or a random unit vector scaled by γ_scale."""
    if gamma_vec is not None:
        g = torch.as_tensor(np.asarray(gamma_vec, np.float32), device=device).reshape(-1)
        if g.shape[0] != d:
            raise ValueError(f"gamma_vec shape {tuple(g.shape)} incompatible with d={d}")
        return g
    v = torch.randn(d, generator=generator, device=device)
    return gamma_scale * v / (torch.linalg.vector_norm(v) + 1e-12)


@dataclass(frozen=True)
class SkewTTrialResult:
    """One trial (or stacked trials): X latent, Z counts (int32), Λ rates,
    geometry; the keys of the JAX package's result."""

    X: torch.Tensor  # (T, d) or (n_trials, T, d)
    Z: torch.Tensor  # same leading shape, int32 counts
    Lambda: Optional[torch.Tensor]
    Sigma: torch.Tensor
    L: torch.Tensor
    R: torch.Tensor
    gamma: torch.Tensor
    meta: Optional[Dict[str, Any]] = None

    def as_dict(self) -> Dict[str, Any]:
        out = {"X": self.X, "Z": self.Z, "Sigma": self.Sigma, "L": self.L, "R": self.R,
               "gamma": self.gamma, "meta": self.meta}
        if self.Lambda is not None:
            out["Lambda"] = self.Lambda
        return out


def _trials(generator, L, gamma, dyn: SkewTDynConfig, meas: SkewTMeasConfig, T: int,
            n_trials: int):
    """X, Z, Λ (n_trials, T, d): each step draws W (n_trials,), z
    (n_trials, d) and the counts, in that order."""
    d = L.shape[0]
    shape_p = dyn.nu / 2.0
    x = torch.zeros((n_trials, d), dtype=L.dtype, device=L.device)
    xs, zs, lams = [], [], []
    for _ in range(T):
        W = sample_inverse_gamma(generator, shape_p, shape_p, (n_trials, 1), device=L.device)
        z = torch.randn((n_trials, d), generator=generator, device=L.device)
        x = dyn.alpha * x + W * gamma + torch.sqrt(W) * (z @ L.T)
        x_eff = x if dyn.clip_x is None else torch.clamp(x, dyn.clip_x[0], dyn.clip_x[1])
        lam = meas.m1 * torch.exp(meas.m2 * x_eff)
        xs.append(x)
        zs.append(torch.poisson(lam, generator=generator).to(torch.int32))
        lams.append(lam)
    return tuple(torch.stack(a, dim=1) for a in (xs, zs, lams))


def _simulate(grid_cfg, dyn_cfg, meas_cfg, sim_cfg, n_trials, device):
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(
        0 if dyn_cfg.seed is None else int(dyn_cfg.seed))
    R = make_lattice(grid_cfg.d, device=device)
    Sigma = build_spatial_cov(R, grid_cfg.alpha0, grid_cfg.alpha1, grid_cfg.beta)
    L = chol_with_jitter(Sigma, jitter=dyn_cfg.chol_jitter)
    gamma = prepare_gamma_vector(gen, grid_cfg.d, dyn_cfg.gamma_scale, dyn_cfg.gamma_vec,
                                 device=device)
    X, Z, Lam = _trials(gen, L, gamma, dyn_cfg, meas_cfg, sim_cfg.T, n_trials)
    meta = {
        "grid_cfg": asdict(grid_cfg),
        "dyn_cfg": {**{k: v for k, v in asdict(dyn_cfg).items() if k != "gamma_vec"},
                    "gamma_vec": "provided" if dyn_cfg.gamma_vec is not None else None},
        "meas_cfg": asdict(meas_cfg),
        "sim_cfg": asdict(sim_cfg),
    }
    return SkewTTrialResult(X=X, Z=Z, Lambda=Lam if sim_cfg.save_lambda else None,
                            Sigma=Sigma, L=L, R=R, gamma=gamma, meta=meta)


def simulate_skewt_trial(grid_cfg: SkewTGridConfig, dyn_cfg: SkewTDynConfig,
                         meas_cfg: SkewTMeasConfig, sim_cfg: SkewTSimConfig,
                         device="cuda") -> SkewTTrialResult:
    """One trial: X, Z, Λ (T, d), on ``device`` (the card unless ``"cpu"``)."""
    res = _simulate(grid_cfg, dyn_cfg, meas_cfg, sim_cfg, 1, device)
    return replace(res, X=res.X[0], Z=res.Z[0],
                   Lambda=None if res.Lambda is None else res.Lambda[0])


def simulate_skewt_many(grid_cfg: SkewTGridConfig, dyn_cfg: SkewTDynConfig,
                        meas_cfg: SkewTMeasConfig, sim_cfg: SkewTSimConfig,
                        device="cuda") -> SkewTTrialResult:
    """``sim_cfg.n_trials`` trials stacked, (n_trials, T, d), sharing the
    geometry (Σ, L, γ), on ``device`` (the card unless ``"cpu"``)."""
    return _simulate(grid_cfg, dyn_cfg, meas_cfg, sim_cfg, sim_cfg.n_trials, device)


def save_npz(path: str, result: SkewTTrialResult) -> None:
    """Compressed npz of every array of the result (the JAX package's keys)."""
    data = {k: v.detach().cpu().numpy() for k, v in result.as_dict().items()
            if k != "meta" and v is not None}
    np.savez_compressed(path, **data)


def load_npz(path: str) -> Dict[str, Any]:
    with np.load(path, allow_pickle=True) as f:
        return {k: f[k] for k in f.files}
