"""Unscented Kalman filter, 2nx+1 sigma points, additive noise (PyTorch port
of ``particle_filters_tpu/models/unscented_kalman_filter.py``).

Scaled sigma-point weights (λ, γ, Wm, Wc), symmetrized jittered-Cholesky
sigma points built as one broadcast (mean ± γ·Lᵀ rows) and propagated
through ``g``/``h`` with one ``torch.func.vmap``, the unscented mean in the
JAX package's f32-safe deviation form, a Cholesky-solve gain and a
symmetrized posterior. Pure methods; ``run`` loops over the steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from particle_filters_tpu_torch.core.linalg import chol_solve, chol_with_jitter, symmetrize
from particle_filters_tpu_torch.core.structs import as_f32
from particle_filters_tpu_torch.models.extended_kalman_filter import _run


@dataclasses.dataclass(frozen=True)
class UKFState:
    """Posterior (mean, cov) at discrete time t."""

    mean: torch.Tensor  # (nx,)
    cov: torch.Tensor  # (nx, nx)
    t: torch.Tensor  # scalar int32


def make_ukf_state(mean, cov, t: int = 0, device="cuda") -> UKFState:
    return UKFState(mean=as_f32(mean, device), cov=as_f32(cov, device),
                    t=torch.tensor(t, dtype=torch.int32, device=device))


class UnscentedKalmanFilter:
    """UKF for additive Gaussian noise:

        x_k = g(x_{k−1}, u_{k−1}) + w,  w ~ N(0, Q)
        z_k = h(x_k) + v,               v ~ N(0, R)

    with 2·nx+1 scaled sigma points (alpha, beta, kappa, jitter as in the
    JAX package; in f32 use alpha ≳ 0.05, as its note says). ``Q`` and ``R``
    live on ``device`` (the card unless ``device="cpu"``).
    """

    def __init__(self, g: Callable, h: Callable, Q, R, *, alpha: float = 1e-3,
                 beta: float = 2.0, kappa: float = 0.0, jitter: float = 0.0,
                 device="cuda") -> None:
        self.device = torch.device(device)
        self.g = g
        self.h = h
        self.Q = as_f32(Q, self.device)
        self.R = as_f32(R, self.device)
        self.alpha, self.beta, self.kappa = float(alpha), float(beta), float(kappa)
        self.jitter = float(jitter)
        self.nx = int(self.Q.shape[0])
        if tuple(self.Q.shape) != (self.nx, self.nx):
            raise ValueError("Q must be (nx, nx).")
        self.nz = int(self.R.shape[0])
        if tuple(self.R.shape) != (self.nz, self.nz):
            raise ValueError("R must be (nz, nz).")

        self._lambda = self.alpha**2 * (self.nx + self.kappa) - self.nx
        self._gamma = float(np.sqrt(self.nx + self._lambda))
        n_sigma = 2 * self.nx + 1
        wm = np.full(n_sigma, 1.0 / (2.0 * (self.nx + self._lambda)))
        wc = wm.copy()
        wm[0] = self._lambda / (self.nx + self._lambda)
        wc[0] = wm[0] + (1.0 - self.alpha**2 + self.beta)
        self.Wm = as_f32(wm, self.device)
        self.Wc = as_f32(wc, self.device)

    def _sigma_points(self, mean, cov):
        """(2nx+1, nx) sigma points: [μ; μ ± γ·(L columns)]."""
        L = chol_with_jitter(symmetrize(cov), jitter=self.jitter)
        offsets = self._gamma * L.T  # row i = γ·L[:, i]
        return torch.cat([mean[None, :], mean[None, :] + offsets, mean[None, :] - offsets])

    def _ut_mean(self, Y):
        """Unscented mean in deviation form: Y₀ + w₁ Σᵢ(Yᵢ − Y₀)."""
        return Y[0] + self.Wm[1] * torch.sum(Y[1:] - Y[0], dim=0)

    def _weighted_outer(self, A, B):
        """Σᵢ Wcᵢ Aᵢ ⊗ Bᵢ."""
        return (self.Wc[:, None] * A).T @ B

    def predict(self, state: UKFState, u=None) -> UKFState:
        """Unscented transform through g."""
        X = self._sigma_points(state.mean, state.cov)
        X_prop = torch.func.vmap(lambda xi: self.g(xi, u))(X)
        x_pred = self._ut_mean(X_prop)
        DX = X_prop - x_pred
        return UKFState(mean=x_pred, cov=self.Q + self._weighted_outer(DX, DX), t=state.t + 1)

    def update(self, pred: UKFState, z) -> UKFState:
        """Unscented transform through h, then the Kalman update."""
        z = as_f32(z, self.device)
        X = self._sigma_points(pred.mean, pred.cov)
        Z = torch.func.vmap(self.h)(X)
        z_pred = self._ut_mean(Z)
        DZ = Z - z_pred
        S = symmetrize(self.R + self._weighted_outer(DZ, DZ))
        Pxz = self._weighted_outer(X - pred.mean, DZ)
        L = chol_with_jitter(S, jitter=self.jitter)
        K = chol_solve(L, Pxz.T).T
        x_post = pred.mean + K @ (z - z_pred)
        P_post = symmetrize(pred.cov - K @ S @ K.T)
        return UKFState(mean=x_post, cov=P_post, t=pred.t)

    def step(self, state: UKFState, z, u=None) -> UKFState:
        """Predict then update."""
        return self.update(self.predict(state, u=u), z)

    def run(self, state0: UKFState, zs, us=None):
        """Filter a (T, nz) sequence: final state, means (T, nx), covs (T, nx, nx)."""
        return _run(self, state0, zs, us)
