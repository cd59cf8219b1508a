"""Multi-target acoustic tracking (MAT) simulator (PyTorch port of
``particle_filters_tpu/simulators/acoustic_tracking.py``).

C targets with 2-D constant-velocity dynamics [x, y, vx, vy], the article's
process noise, reflective area boundaries, and an S-sensor grid measuring
additive acoustic amplitudes Z(t, s) = Σ_c ψ / (‖p_c − r_s‖² + d₀).

Targets propagate as one batched product a step in a Python loop; boundary
reflection is branchless ``torch.where``; the acoustic model is one
broadcast reduction over any leading axes (time, particles). The noise
comes from a ``torch.Generator`` on the device seeded with ``cfg.seed``
(another stream than the JAX package's). ``MATDataset.save_npz``/
``load_npz`` use the JAX package's keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class MATDynamicsConfig:
    dt: float = 1.0


@dataclass(frozen=True)
class MATScenarioConfig:
    n_targets: int = 4
    n_steps: int = 100
    area_xy: Tuple[float, float] = (40.0, 40.0)
    sensor_grid_shape: Tuple[int, int] = (5, 5)
    psi: float = 10.0
    d0: float = 0.1
    seed: int = 7
    use_article_init: bool = True


def build_cv_transition(dt: float, device="cuda") -> torch.Tensor:
    """Constant-velocity transition F for the state [x, y, vx, vy]."""
    return torch.tensor([[1.0, 0.0, dt, 0.0],
                         [0.0, 1.0, 0.0, dt],
                         [0.0, 0.0, 1.0, 0.0],
                         [0.0, 0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def article_process_noise_cov(device="cuda") -> torch.Tensor:
    """The article's fixed (4, 4) process noise covariance V."""
    V = torch.tensor([[1.0 / 3.0, 0.0, 0.5, 0.0],
                      [0.0, 1.0 / 3.0, 0.0, 0.5],
                      [0.5, 0.0, 1.0, 0.0],
                      [0.0, 0.5, 0.0, 1.0]], dtype=torch.float32, device=device)
    return (1.0 / 20.0) * V


def article_initial_states(n_targets: int, device="cuda") -> torch.Tensor:
    """The article's deterministic 4-target initial states."""
    if n_targets != 4:
        raise ValueError("Article initial states are defined for n_targets == 4.")
    return torch.tensor([[12.0, 6.0, 0.001, 0.001],
                         [32.0, 32.0, -0.001, -0.005],
                         [20.0, 13.0, -0.1, 0.01],
                         [15.0, 35.0, 0.002, 0.002]], dtype=torch.float32, device=device)


def make_sensor_grid(area_xy: Tuple[float, float], grid_shape: Tuple[int, int],
                     device="cuda") -> torch.Tensor:
    """(S, 2) sensor grid over the area, boundaries inclusive."""
    width, height = area_xy
    n_r, n_c = grid_shape
    xs = torch.linspace(0.0, width, n_c, device=device)
    ys = torch.linspace(0.0, height, n_r, device=device)
    XX, YY = torch.meshgrid(xs, ys, indexing="xy")
    return torch.stack([XX.reshape(-1), YY.reshape(-1)], dim=1)


def _reflect(pos, vel, lo, hi, eps):
    """Reflection at the boundaries: a position at or past a wall mirrors
    into the area, ``eps`` inside it, and its velocity flips."""
    below = pos <= lo
    above = pos >= hi
    pos = torch.where(below, -pos + eps, torch.where(above, 2.0 * hi - pos - eps, pos))
    vel = torch.where(below | above, -vel, vel)
    return pos, vel


def simulate_cv_targets(n_steps: int, n_targets: int, area_xy: Tuple[float, float],
                        dyn_cfg: MATDynamicsConfig, generator, use_article_init: bool = True,
                        init_vel_std: float = 0.5, enforce_boundaries: bool = True,
                        device="cuda") -> torch.Tensor:
    """(n_steps, n_targets, 4) CV trajectories with reflective boundaries,
    drawn from ``generator`` (which lives on ``device``)."""
    F = build_cv_transition(dyn_cfg.dt, device)
    V = article_process_noise_cov(device)
    L = torch.linalg.cholesky(V + 1e-12 * torch.eye(4, device=device))
    width, height = area_xy
    eps = 1e-6

    if use_article_init and n_targets == 4:
        x0 = article_initial_states(n_targets, device)
    else:
        def uniform(lo, hi):
            u = torch.rand((n_targets, 1), generator=generator, device=device)
            return lo + (hi - lo) * u

        px = uniform(0.25 * width, 0.75 * width)
        py = uniform(0.25 * height, 0.75 * height)
        vx, vy = (init_vel_std * torch.randn((n_targets, 1), generator=generator,
                                             device=device) for _ in range(2))
        x0 = torch.cat([px, py, vx, vy], dim=1)

    noise = torch.randn((n_steps - 1, n_targets, 4), generator=generator, device=device) @ L.T
    x, traj = x0, [x0]
    for w in noise:
        x = x @ F.T + w
        if enforce_boundaries:
            px, vx = _reflect(x[:, 0], x[:, 2], 0.0, width, eps)
            py, vy = _reflect(x[:, 1], x[:, 3], 0.0, height, eps)
            x = torch.stack([px, py, vx, vy], dim=1)
        traj.append(x)
    return torch.stack(traj)


def acoustic_measurement_model(positions: torch.Tensor, sensors: torch.Tensor, psi: float,
                               d0: float) -> torch.Tensor:
    """Z(…, s) = Σ_c ψ / (‖p_c − r_s‖² + d₀), noiseless. ``positions``
    (..., C, 2), ``sensors`` (S, 2) → (..., S)."""
    d2 = torch.sum((positions[..., :, None, :] - sensors[None, :, :]) ** 2, dim=-1)
    return torch.sum(psi / (d2 + d0), dim=-2)


@dataclass(frozen=True)
class MATDataset:
    """X (T, C, 4); P (T, C, 2); S sensors (S, 2); Z (T, S); meta [W, H, ψ, d₀, dt]."""

    X: torch.Tensor
    P: torch.Tensor
    S: torch.Tensor
    Z: torch.Tensor
    meta: torch.Tensor

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {"X": self.X, "P": self.P, "S": self.S, "Z": self.Z, "meta": self.meta}

    def save_npz(self, path: str) -> None:
        np.savez_compressed(path, **{k: v.detach().cpu().numpy()
                                     for k, v in self.as_dict().items()})

    @classmethod
    def load_npz(cls, path: str, device="cuda") -> "MATDataset":
        with np.load(path) as f:
            return cls(**{k: torch.as_tensor(f[k], device=device)
                          for k in ("X", "P", "S", "Z", "meta")})


def simulate_acoustic_dataset(cfg: MATScenarioConfig, dyn_cfg: MATDynamicsConfig,
                              device="cuda") -> MATDataset:
    """The full MAT dataset on ``device`` (the card unless ``"cpu"``)."""
    gen = torch.Generator(device=device).manual_seed(int(cfg.seed))
    sensors = make_sensor_grid(cfg.area_xy, cfg.sensor_grid_shape, device)
    X = simulate_cv_targets(cfg.n_steps, cfg.n_targets, cfg.area_xy, dyn_cfg, gen,
                            use_article_init=cfg.use_article_init, device=device)
    P = X[..., :2]
    Z = acoustic_measurement_model(P, sensors, psi=cfg.psi, d0=cfg.d0)
    meta = torch.tensor([cfg.area_xy[0], cfg.area_xy[1], cfg.psi, cfg.d0, dyn_cfg.dt],
                        dtype=torch.float32, device=device)
    return MATDataset(X=X, P=P, S=sensors, Z=Z, meta=meta)
