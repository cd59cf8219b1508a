"""Lorenz-96 chaotic dynamics simulator with sparse observations (PyTorch
port of ``particle_filters_tpu/simulators/lorenz96.py``).

RK4-integrated L96 dynamics, deterministic spin-up, a perturbed ensemble,
sparse linear observations every ``obs_interval`` steps on every
``obs_fraction``-th variable, npz + JSON persistence (the JAX package's
layout), RMSE and spread. ``l96_rhs`` is ``torch.roll`` arithmetic over any
leading batch axes, so the ensemble integrates as one (Np, nx) batch; the
integration is a Python loop over the steps. The perturbations and the
observation noise come from a ``torch.Generator`` on the device seeded with
``seed`` (another stream than the JAX package's).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch


def l96_rhs(x: torch.Tensor, F: float = 8.0) -> torch.Tensor:
    """dx_a/dt = (x_{a+1} − x_{a−2}) x_{a−1} − x_a + F (cyclic), batched over
    leading axes."""
    xp1 = torch.roll(x, -1, dims=-1)
    xm1 = torch.roll(x, 1, dims=-1)
    xm2 = torch.roll(x, 2, dims=-1)
    return (xp1 - xm2) * xm1 - x + F


def rk4_step(x: torch.Tensor, dt: float, f) -> torch.Tensor:
    """One classical RK4 step."""
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def l96_integrate(x0: torch.Tensor, dt: float, steps: int, F: float = 8.0,
                  q_std: float = 0.0, generator=None) -> torch.Tensor:
    """``steps`` RK4 steps of L96 from ``x0``: (steps+1, ...) including x0.
    With ``q_std > 0`` each step adds N(0, q_std²) noise drawn from
    ``generator`` (a new one seeded 0 when None). Batched over leading axes."""
    rhs = lambda z: l96_rhs(z, F)  # noqa: E731
    noise = None
    if q_std > 0.0:
        if generator is None:
            generator = torch.Generator(device=x0.device).manual_seed(0)
        noise = q_std * torch.randn((steps,) + tuple(x0.shape), generator=generator,
                                    dtype=x0.dtype, device=x0.device)
    x, traj = x0, [x0]
    for k in range(steps):
        x = rk4_step(x, dt, rhs)
        if noise is not None:
            x = x + noise[k]
        traj.append(x)
    return torch.stack(traj)


@dataclasses.dataclass(frozen=True)
class ObsModel:
    """Sparse linear observation: components ``H_idx`` of the state."""

    H_idx: torch.Tensor  # (ny,) int
    R: torch.Tensor  # (ny, ny)

    def H(self, x: torch.Tensor) -> torch.Tensor:
        return torch.index_select(x, -1, self.H_idx.long())

    def JH(self, x: torch.Tensor) -> torch.Tensor:
        ny, nx = self.H_idx.shape[0], x.shape[-1]
        rows = torch.arange(ny, device=x.device)
        J = torch.zeros((ny, nx), dtype=x.dtype, device=x.device)
        return J.index_put((rows, self.H_idx.long()), torch.ones((), dtype=x.dtype,
                                                                 device=x.device))


@dataclasses.dataclass(frozen=True)
class Lorenz96Config:
    nx: int = 1000
    F: float = 8.0
    dt: float = 0.01
    spinup_steps: int = 1000
    total_steps: int = 1500
    Np: int = 20
    obs_interval: int = 20
    obs_fraction: int = 4
    obs_error_std: float = 1.0
    perturbation_std: Optional[float] = None
    seed: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Lorenz96SimulationResult:
    """Truth and ensemble trajectories, sparse observations, the observation
    system and the config, with the JAX package's ``.npz``/``.json`` layout."""

    truth_traj: torch.Tensor  # (T+1, nx)
    ensemble_traj: torch.Tensor  # (Np, T+1, nx)
    observations: torch.Tensor  # (n_obs_times, ny)
    obs_times: torch.Tensor  # (n_obs_times,)
    H_idx: torch.Tensor  # (ny,)
    R: torch.Tensor  # (ny, ny)
    config: Optional[Dict[str, Any]] = None

    @property
    def obs_model(self) -> ObsModel:
        return ObsModel(H_idx=self.H_idx, R=self.R)

    def save(self, filepath: str, overwrite: bool = False) -> None:
        path = Path(filepath)
        if not str(path).endswith(".npz"):
            path = path.with_suffix(".npz")
        if path.exists() and not overwrite:
            raise FileExistsError(f"File already exists: {path}")
        np.savez(path, **{k: getattr(self, k).detach().cpu().numpy()
                          for k in ("truth_traj", "ensemble_traj", "observations",
                                    "obs_times", "H_idx", "R")})
        with open(path.with_suffix(".json"), "w") as f:
            json.dump(self.config, f, indent=2)

    @classmethod
    def load(cls, filepath: str, device="cuda") -> "Lorenz96SimulationResult":
        path = Path(filepath)
        if not str(path).endswith(".npz"):
            path = path.with_suffix(".npz")
        config_path = path.with_suffix(".json")
        config = json.loads(config_path.read_text()) if config_path.exists() else {}
        with np.load(path) as data:
            arrays = {k: torch.as_tensor(data[k], device=device)
                      for k in ("truth_traj", "ensemble_traj", "observations", "obs_times",
                                "H_idx", "R")}
        return cls(**arrays, config=config)


def simulate_lorenz96(nx: int = 1000, F: float = 8.0, dt: float = 0.01,
                      spinup_steps: int = 1000, total_steps: int = 1500, Np: int = 20,
                      obs_interval: int = 20, obs_fraction: int = 4,
                      obs_error_std: float = 1.0, perturbation_std: Optional[float] = None,
                      x0=None, seed: Optional[int] = None, dtype=torch.float32,
                      device="cuda") -> Lorenz96SimulationResult:
    """Truth, ensemble and sparse observations, on ``device`` (the card
    unless ``"cpu"``): x_a(0) = F (+1 every 5th), a deterministic spin-up,
    a √2-perturbed ensemble integrated as one batch, H = every
    ``obs_fraction``-th variable, observations every ``obs_interval`` steps."""
    device = torch.device(device)
    if perturbation_std is None:
        perturbation_std = float(np.sqrt(2.0))
    if x0 is None:
        x0_arr = torch.full((nx,), F, dtype=dtype, device=device)
        x0_arr[::5] = F + 1.0
    else:
        x0_arr = torch.as_tensor(np.asarray(x0), dtype=dtype, device=device)
        if tuple(x0_arr.shape) != (nx,):
            raise ValueError(f"x0 must have shape ({nx},), got {tuple(x0_arr.shape)}")
    gen = torch.Generator(device=device).manual_seed(0 if seed is None else int(seed))

    x_at_spinup = l96_integrate(x0_arr, dt, spinup_steps, F=F)[-1]
    truth_traj = l96_integrate(x_at_spinup, dt, total_steps, F=F)
    pert = perturbation_std * torch.randn((Np, nx), generator=gen, dtype=dtype, device=device)
    ensemble_traj = l96_integrate(x_at_spinup[None, :] + pert, dt, total_steps,
                                  F=F).transpose(0, 1)

    H_idx = torch.arange(0, nx, obs_fraction, device=device)
    ny = int(H_idx.shape[0])
    R = (obs_error_std**2) * torch.eye(ny, dtype=dtype, device=device)
    obs_times = torch.arange(0, total_steps + 1, obs_interval, device=device)
    true_obs = truth_traj[obs_times][:, H_idx]
    observations = true_obs + obs_error_std * torch.randn(
        true_obs.shape, generator=gen, dtype=dtype, device=device)
    config = {
        "nx": int(nx), "F": float(F), "dt": float(dt), "spinup_steps": int(spinup_steps),
        "total_steps": int(total_steps), "Np": int(Np), "obs_interval": int(obs_interval),
        "obs_fraction": int(obs_fraction), "obs_error_std": float(obs_error_std),
        "perturbation_std": float(perturbation_std), "seed": seed, "ny": ny,
        "n_obs_times": int(obs_times.shape[0]),
    }
    return Lorenz96SimulationResult(truth_traj=truth_traj, ensemble_traj=ensemble_traj,
                                    observations=observations, obs_times=obs_times,
                                    H_idx=H_idx, R=R, config=config)


def compute_rmse(forecast: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """RMSE over all elements."""
    return torch.sqrt(torch.mean((forecast - truth) ** 2))


def compute_ensemble_spread(ensemble: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Ensemble standard deviation (population, as ``jnp.std``)."""
    return torch.std(ensemble, dim=axis, correction=0)
