"""Linear-Gaussian spatial sensor-network (SNLG) simulator (PyTorch port of
``particle_filters_tpu/simulators/sensor_network_lg.py``).

    x_t = α x_{t−1} + v_t,   v_t ~ N(0, Σ),  Σ_ij = α₀ exp(−‖rᵢ−rⱼ‖²/β) + α₁ δᵢⱼ
    z_t = x_t + w_t,         w_t ~ N(0, σ_z² I)

over an n×n grid (d = n²), for S noise levels × R trials × T steps. The
(S, R) cells run as one batched recursion; the noise comes from a CPU
``torch.Generator`` seeded with ``cfg.seed`` (other paths than the JAX
package's per-cell threefry keys). ``SNLGDataset.save_npz``/``load_npz``
use the JAX package's keys, so a file written by either package loads in
the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from particle_filters_tpu_torch.core.linalg import chol_with_jitter


@dataclasses.dataclass(frozen=True)
class SNLGConfig:
    """Validated config, with the JAX package's defaults and checks."""

    d: int = 64
    alpha: float = 0.9
    alpha0: float = 3.0
    alpha1: float = 0.01
    beta: float = 20.0
    T: int = 10
    trials: int = 100
    sigmas: Tuple[float, ...] = (2.0, 1.0, 0.5)
    seed: int = 123

    def __post_init__(self) -> None:
        n = int(round(self.d**0.5))
        if n * n != self.d:
            raise ValueError("d must be a perfect square (e.g., 64 = 8×8).")
        if self.T <= 0 or self.trials <= 0:
            raise ValueError("T and trials must be positive integers.")
        if any(s <= 0 for s in self.sigmas):
            raise ValueError("All observation std deviations must be positive.")
        if self.alpha1 < 0:
            raise ValueError("alpha1 (nugget) must be nonnegative.")
        if self.beta <= 0:
            raise ValueError("beta must be positive.")


def make_grid_coords(d: int, device="cuda") -> torch.Tensor:
    """(d, 2) row-major integer grid coordinates, f32."""
    n = int(np.sqrt(d))
    xs, ys = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1).to(
        device=device, dtype=torch.float32
    )


def se_kernel_cov(coords: torch.Tensor, alpha0: float, beta: float, alpha1: float) -> torch.Tensor:
    """Σ_ij = α₀ exp(−‖rᵢ−rⱼ‖²/β) + α₁ δᵢⱼ, symmetrized."""
    diff = coords[:, None, :] - coords[None, :, :]
    dist2 = torch.sum(diff * diff, dim=-1)
    K = alpha0 * torch.exp(-dist2 / beta)
    K = K + alpha1 * torch.eye(coords.shape[0], dtype=K.dtype, device=K.device)
    return 0.5 * (K + K.T)


@dataclasses.dataclass(frozen=True)
class SNLGDataset:
    """X (S, R, T+1, d); Z (S, R, T, d); grid coords; process covariance Σ."""

    X: torch.Tensor
    Z: torch.Tensor
    coords: torch.Tensor
    Sigma: torch.Tensor
    config: Optional[SNLGConfig] = None

    def save_npz(self, path: str) -> None:
        cfg = self.config
        np.savez_compressed(
            path,
            X=self.X.detach().cpu().numpy(),
            Z=self.Z.detach().cpu().numpy(),
            coords=self.coords.detach().cpu().numpy(),
            Sigma=self.Sigma.detach().cpu().numpy(),
            sigmas=np.array(cfg.sigmas, dtype=np.float64),
            alpha=np.array([cfg.alpha], dtype=np.float64),
            T=np.array([cfg.T], dtype=np.int32),
            trials=np.array([cfg.trials], dtype=np.int32),
            d=np.array([cfg.d], dtype=np.int32),
            seed=np.array([cfg.seed], dtype=np.int64),
        )

    def dump_config_json(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(dataclasses.asdict(self.config), f, indent=2)

    @classmethod
    def load_npz(cls, path: str, device="cuda") -> "SNLGDataset":
        with np.load(path) as f:
            cfg = SNLGConfig(
                d=int(f["d"][0]),
                alpha=float(f["alpha"][0]),
                T=int(f["T"][0]),
                trials=int(f["trials"][0]),
                sigmas=tuple(float(s) for s in f["sigmas"]),
                seed=int(f["seed"][0]),
            )
            return cls(
                **{k: torch.as_tensor(f[k], device=device) for k in ("X", "Z", "coords", "Sigma")},
                config=cfg,
            )


def _snlg_recursion(L, alpha: float, sigmas, E_v, E_w):
    """X (S, R, T+1, d) with X[..., 0, :] = 0 and Z (S, R, T, d) from the
    standard normals E_v, E_w (S, R, T, d): v_t = L e_v,t and w_t = σ_s e_w,t."""
    V = E_v @ L.T
    W = sigmas[:, None, None, None] * E_w
    x = torch.zeros(E_v.shape[:2] + E_v.shape[-1:], dtype=E_v.dtype, device=E_v.device)
    xs, zs = [x], []
    for t in range(E_v.shape[2]):
        x = alpha * x + V[:, :, t]
        xs.append(x)
        zs.append(x + W[:, :, t])
    return torch.stack(xs, dim=2), torch.stack(zs, dim=2)


def simulate_snlg_dataset(
    cfg: SNLGConfig, dtype: torch.dtype = torch.float32, device="cuda"
) -> SNLGDataset:
    """Simulate all S noise levels × R trials: X (S, R, T+1, d) including
    x₀ = 0, Z (S, R, T, d), on ``device`` (the card unless ``"cpu"``)."""
    coords = make_grid_coords(cfg.d, device=device)
    Sigma = se_kernel_cov(coords, cfg.alpha0, cfg.beta, cfg.alpha1).to(dtype)
    L = chol_with_jitter(Sigma)
    S, R = len(cfg.sigmas), cfg.trials
    gen = torch.Generator(device="cpu").manual_seed(int(cfg.seed))
    E_v, E_w = (torch.randn((S, R, cfg.T, cfg.d), generator=gen, dtype=dtype).to(device)
                for _ in range(2))
    sigmas = torch.tensor(cfg.sigmas, dtype=dtype, device=device)
    X, Z = _snlg_recursion(L, cfg.alpha, sigmas, E_v, E_w)
    return SNLGDataset(X=X, Z=Z, coords=coords, Sigma=Sigma, config=cfg)
