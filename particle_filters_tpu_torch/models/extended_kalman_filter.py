"""Extended Kalman filter with pluggable models and AD Jacobians (PyTorch
port of ``particle_filters_tpu/models/extended_kalman_filter.py``).

Default Jacobians come from ``torch.func.jacfwd`` (the JAX package uses
``jax.jacfwd``); the forward-difference Jacobians are kept for parity. The
gain is a Cholesky solve; the update is standard or Joseph-stabilized with
optional innovation jitter. Every method is pure (state in, state out), so
``torch.func.vmap`` runs many filters at once; ``run`` loops over the steps
where the JAX package scans.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from particle_filters_tpu_torch.core.linalg import chol_solve, chol_with_jitter, symmetrize
from particle_filters_tpu_torch.core.structs import as_f32


@dataclasses.dataclass(frozen=True)
class EKFState:
    """Posterior (mean, cov) at discrete time t."""

    mean: torch.Tensor  # (nx,)
    cov: torch.Tensor  # (nx, nx)
    t: torch.Tensor  # scalar int32


def make_ekf_state(mean, cov, t: int = 0, device="cuda") -> EKFState:
    return EKFState(mean=as_f32(mean, device), cov=as_f32(cov, device),
                    t=torch.tensor(t, dtype=torch.int32, device=device))


def _jacfwd(fn):
    """``torch.func.jacfwd`` of ``fn`` w.r.t. its first argument, in that
    argument's dtype: jacfwd's tangent of a 0-d tensor times a Python float
    comes out f64."""
    jac = torch.func.jacfwd(fn, argnums=0)
    return lambda x, *args: jac(x, *args).to(x.dtype)


def numerical_jacobian_g(g, x, u, eps: float = 1e-3) -> torch.Tensor:
    """Forward-difference Jacobian of g(x, u) w.r.t. x, vectorized over the
    perturbations (eps 1e-3 suits f32)."""
    y0 = g(x, u)
    E = eps * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    ys = torch.func.vmap(lambda dx: g(x + dx, u))(E)  # (nx, ny)
    return ((ys - y0) / eps).T


def numerical_jacobian_h(h, x, eps: float = 1e-3) -> torch.Tensor:
    """Forward-difference Jacobian of h(x)."""
    z0 = h(x)
    E = eps * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    zs = torch.func.vmap(lambda dx: h(x + dx))(E)
    return ((zs - z0) / eps).T


class ExtendedKalmanFilter:
    """EKF for additive Gaussian noise:

        x_k = g(x_{k−1}, u_{k−1}) + w,  w ~ N(0, Q)
        z_k = h(x_k) + v,               v ~ N(0, R)

    ``g`` and ``h`` are torch functions of one state; ``jac_g`` / ``jac_h``
    default to ``torch.func.jacfwd`` of them. ``Q`` and ``R`` live on
    ``device`` (the card unless ``device="cpu"``).
    """

    def __init__(self, g: Callable, h: Callable, Q, R,
                 jac_g: Optional[Callable] = None, jac_h: Optional[Callable] = None, *,
                 joseph: bool = False, jitter: float = 0.0, device="cuda") -> None:
        self.device = torch.device(device)
        self.g = g
        self.h = h
        self.Q = as_f32(Q, self.device)
        self.R = as_f32(R, self.device)
        nx, nz = self.Q.shape[0], self.R.shape[0]
        if tuple(self.Q.shape) != (nx, nx):
            raise ValueError("Q must be square.")
        if tuple(self.R.shape) != (nz, nz):
            raise ValueError("R must be square.")
        self.nx, self.nz = nx, nz
        self.jac_g = jac_g if jac_g is not None else _jacfwd(g)
        self.jac_h = jac_h if jac_h is not None else _jacfwd(h)
        self.joseph = bool(joseph)
        self.jitter = float(jitter)

    def predict(self, state: EKFState, u=None) -> EKFState:
        """Time update: x⁻ = g(x, u), P⁻ = G P Gᵀ + Q."""
        x_pred = self.g(state.mean, u)
        G = self.jac_g(state.mean, u)
        P_pred = G @ state.cov @ G.T + self.Q
        return EKFState(mean=x_pred, cov=P_pred, t=state.t + 1)

    def update(self, pred: EKFState, z) -> EKFState:
        """Measurement update; gain via Cholesky solve."""
        z = as_f32(z, self.device)
        H = self.jac_h(pred.mean)
        y = z - self.h(pred.mean)
        S = H @ pred.cov @ H.T + self.R
        if self.jitter > 0.0:
            S = S + self.jitter * torch.eye(self.nz, device=self.device)
        L = chol_with_jitter(S)
        K = chol_solve(L, (pred.cov @ H.T).T).T
        x_post = pred.mean + K @ y
        I = torch.eye(self.nx, device=self.device)
        if self.joseph:
            A = I - K @ H
            P_post = A @ pred.cov @ A.T + K @ self.R @ K.T
        else:
            P_post = (I - K @ H) @ pred.cov
        return EKFState(mean=x_post, cov=symmetrize(P_post), t=pred.t)

    def step(self, state: EKFState, z, u=None) -> EKFState:
        """Predict then update."""
        return self.update(self.predict(state, u=u), z)

    def run(self, state0: EKFState, zs, us=None):
        """Filter a (T, nz) sequence: the final state and the stacked
        posteriors (means (T, nx), covs (T, nx, nx))."""
        return _run(self, state0, zs, us)


def _run(filt, state0, zs, us):
    """The step loop shared by the EKF and the UKF."""
    zs = as_f32(zs, filt.device)
    s, means, covs = state0, [], []
    for k in range(zs.shape[0]):
        s = filt.step(s, zs[k], u=None if us is None else us[k])
        means.append(s.mean)
        covs.append(s.cov)
    return s, torch.stack(means), torch.stack(covs)
