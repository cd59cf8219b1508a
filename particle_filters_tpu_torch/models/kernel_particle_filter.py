"""Kernel particle filter: particle flow in an RKHS (PyTorch port of
``particle_filters_tpu/models/kernel_particle_filter.py``).

Gaspari-Cohn covariance localization, diagonal matrix-valued or scalar RBF
kernels with their divergence terms, the Gaussian-prior score
∇log p(x|y) = JHᵀR⁻¹(y − Hx) − B⁻¹(x − x₀), and the adaptive pseudo-time
flow

    f_s(x) = B · mean_m[ K(x, xₘ) ∇log p(xₘ|y) + ∇ₓ·K(x, xₘ) ]

with a per-particle Mahalanobis cap on each move. Every kernel and
divergence is evaluated for all query-ensemble pairs at once, (Np, Np, n)
broadcasts and products. The update is simultaneous (Jacobi), as in the
JAX package and the reference's loop, which writes into a copy against a
frozen ensemble (``tests/unit/test_kpf_update_order.py``). The pseudo-time
loop is a Python loop with one host read of s a pseudo-step, where the JAX
package runs a ``lax.while_loop``; the f32 arithmetic of s and of the step
sizes is the JAX package's, so both take the same number of steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from particle_filters_tpu_torch.core.linalg import chol_solve, chol_with_jitter


def gaspari_cohn(r) -> torch.Tensor:
    """Gaspari-Cohn compact-support correlation taper of ``r`` = distance /
    cutoff radius: values in [0, 1], zero for r > 2."""
    r = torch.as_tensor(r)
    r_safe = torch.clamp(r, min=1e-12)  # guards the 1/r term
    p1 = 1 - 5 * r**2 / 3 + 5 * r**3 / 8 + r**4 / 2 - r**5 / 4
    p2 = 4 - 5 * r + 5 * r**2 / 3 + 5 * r**3 / 8 - r**4 / 2 + r**5 / 12 - 2 / (3 * r_safe)
    zero = torch.zeros_like(p1)
    out = torch.where((r >= 0) & (r <= 1), p1, zero)
    return torch.where((r > 1) & (r <= 2), p2, out)


def build_localization_matrix(n: int, radius: float, metric=None,
                              device="cuda") -> torch.Tensor:
    """(n, n) Gaspari-Cohn localization matrix on ``device``; ``radius=inf``
    disables localization."""
    if np.isinf(radius):
        return torch.ones((n, n), device=device)
    if metric is None:
        idx = torch.arange(n, device=device)
        D = torch.abs(idx[:, None] - idx[None, :]).to(torch.float32)
    else:
        D = torch.as_tensor(metric, dtype=torch.float32, device=device)
        if tuple(D.shape) != (n, n):
            raise ValueError("metric must be (n, n).")
    return gaspari_cohn(D / float(radius))


def rbf_1d(d: torch.Tensor, ell) -> Tuple[torch.Tensor, torch.Tensor]:
    """K(d) = exp(−½(d/ℓ)²) and dK/dx."""
    K = torch.exp(-0.5 * (d / ell) ** 2)
    return K, -(d / ell**2) * K


def scalar_kernel_full_matrix(x, ensemble, lengthscale):
    """Isotropic scalar kernel against the whole ensemble: (k (Np,),
    grad_k (Np, n), divK (n,))."""
    D = x[None, :] - ensemble
    k = torch.exp(-0.5 * torch.sum(D**2, dim=1) / lengthscale**2)
    grad_k = -(k[:, None] / lengthscale**2) * D
    divK = torch.sum(grad_k).expand(x.shape[0]).clone()
    return k, grad_k, divK


def matrix_kernel_and_divergence(x, ensemble, lengthscales):
    """Diagonal matrix-valued kernel against the whole ensemble:
    (K_blocks (Np, n), divK (n,))."""
    D = x[None, :] - ensemble
    K, dK = rbf_1d(D, torch.as_tensor(lengthscales)[None, :])
    return K, torch.sum(dK, dim=0)


@dataclasses.dataclass(frozen=True)
class Model:
    """Observation model: H(x) → (m,), its Jacobian JH(x) → (m, n), noise R.
    ``H`` and ``JH`` act on one state and run under ``torch.func.vmap``."""

    H: Optional[Callable] = None
    JH: Optional[Callable] = None
    R: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class KPFConfig:
    """The JAX package's ``KPFConfig``. ``random_order`` and ``bounded_loop``
    are accepted for parity and change nothing: the update is always
    simultaneous, and ``bounded_loop`` is a workaround for the TPU compiler
    that gives the same result."""

    ds_init: float = 0.2
    ds_min: float = 1e-3
    c_move_max: float = 2.0
    min_steps: int = 5
    max_steps: int = 100
    kernel_type: str = "diagonal"  # "diagonal" | "scalar"
    lengthscale_mode: str = "std"  # "std" | "fixed"
    fixed_lengthscale: float = 1.0
    reg: float = 1e-6
    localization_radius: float = np.inf
    random_order: bool = True
    bounded_loop: bool = False


@dataclasses.dataclass(frozen=True)
class KPFState:
    """Flow result."""

    particles: torch.Tensor  # (Np, n)
    weights: torch.Tensor  # (Np,)
    s: torch.Tensor  # pseudo-time reached (scalar)
    steps: torch.Tensor  # scalar int32
    ds_history: torch.Tensor  # (max_steps,) step sizes, 0 where unused


class KernelParticleFilter:
    """Matrix-kernel particle flow filter. Tensors live on the prior
    ensemble's device; matrix products run in full f32 on the card only
    with TF32 off, which the caller sets."""

    def __init__(self, model: Model, config: Optional[KPFConfig] = None):
        self.model = model
        self.cfg = config or KPFConfig()

    @staticmethod
    def mean_and_cov(X: torch.Tensor, reg: float = 0.0):
        """Sample mean and covariance with a ridge; the N − 1 normalization,
        unlike the SIR filter's moments."""
        mu = torch.mean(X, dim=0)
        A = X - mu
        B = (A.T @ A) / max(1, X.shape[0] - 1)
        if reg > 0:
            B = B + reg * torch.eye(B.shape[1], dtype=B.dtype, device=B.device)
        return mu, B

    def _prior_stats(self, X: torch.Tensor):
        x0, B = self.mean_and_cov(X, reg=self.cfg.reg)
        L = build_localization_matrix(B.shape[0], self.cfg.localization_radius,
                                      device=B.device).to(B.dtype)
        return x0, B * L

    def _lengthscales(self, X: torch.Tensor) -> torch.Tensor:
        if self.cfg.lengthscale_mode == "fixed":
            return torch.full((X.shape[1],), self.cfg.fixed_lengthscale, dtype=X.dtype,
                              device=X.device)
        return torch.std(X, dim=0, correction=0) + 1e-12

    def _scores(self, X, x0, B_inv, y, LR):
        """∇log p(x|y) for all particles."""
        def score_one(x):
            z = chol_solve(LR, y - self.model.H(x))
            return self.model.JH(x).T @ z - B_inv @ (x - x0)

        return torch.func.vmap(score_one)(X)

    def prior_factor(self, B, jitter: Optional[float] = None):
        """The Cholesky factor of B + reg·I that ``analyze`` takes, and the
        jitter it took (0-d): ``chol_with_jitter``'s ladder, or exactly
        ``jitter`` where one is given. Without localization B has the rank
        of the ensemble, so which rung factorizes depends on the Cholesky
        routine (LAPACK's or cuSOLVER's)."""
        eye = torch.eye(B.shape[0], dtype=B.dtype, device=B.device)
        if jitter is None:
            return chol_with_jitter(B + self.cfg.reg * eye, return_jitter=True)
        return chol_with_jitter(B + self.cfg.reg * eye, jitter=jitter, max_tries=0,
                                return_jitter=True)

    def analyze(self, X, y, lengthscales=None, generator=None, *,
                jitter: Optional[float] = None) -> KPFState:
        """Move the prior ensemble X (Np, n) to the posterior by integrating
        the kernel flow over pseudo-time s ∈ [0, 1]. ``generator`` is
        accepted for parity with the reference's shuffled evaluation order;
        the update is simultaneous, so it is unused. ``jitter`` fixes the
        factor's jitter (:meth:`prior_factor`)."""
        del generator
        X = torch.as_tensor(X)
        y = torch.as_tensor(y, dtype=X.dtype, device=X.device)
        Np, n = X.shape
        cfg = self.cfg
        eye = torch.eye(n, dtype=X.dtype, device=X.device)

        x0, B = self._prior_stats(X)
        LB, _ = self.prior_factor(B, jitter)
        B_inv = chol_solve(LB, eye)
        LR = chol_with_jitter(torch.as_tensor(self.model.R, dtype=X.dtype, device=X.device),
                              initial=1e-10)

        use_scalar = cfg.kernel_type == "scalar"
        if use_scalar:
            if lengthscales is not None:
                ell = torch.as_tensor(lengthscales, dtype=X.dtype,
                                      device=X.device).reshape(-1)[0]
            elif cfg.lengthscale_mode == "fixed":
                ell = torch.tensor(cfg.fixed_lengthscale, dtype=X.dtype, device=X.device)
            else:
                ell = torch.mean(torch.std(X, dim=0, correction=0))
        else:
            ell = (torch.as_tensor(lengthscales, dtype=X.dtype, device=X.device)
                   if lengthscales is not None else self._lengthscales(X))

        def velocity(Xc, G):
            """f_s at every particle at once."""
            D = Xc[:, None, :] - Xc[None, :, :]  # (Np, Np, n) x_i − x_m
            if use_scalar:
                k = torch.exp(-0.5 * torch.sum(D**2, dim=-1) / ell**2)  # (Np, Np)
                ones = torch.ones((1, n), dtype=X.dtype, device=X.device)
                term1 = torch.mean(k * torch.sum(G, dim=1)[None, :], dim=1)[:, None] * ones
                grad_k = -(k[:, :, None] / ell**2) * D
                term2 = torch.sum(grad_k, dim=(1, 2))[:, None] * ones / Np
            else:
                K = torch.exp(-0.5 * (D / ell[None, None, :]) ** 2)
                dK = -(D / ell[None, None, :] ** 2) * K
                term1 = torch.mean(K * G[None, :, :], dim=1)  # (Np, n)
                term2 = torch.sum(dK, dim=1) / Np  # (Np, n)
            return (term1 + term2) @ B.T

        def clamp_moves(V, ds):
            """Per-particle Mahalanobis cap on the move."""
            dx = ds * V
            move = torch.sqrt(torch.einsum("pi,ij,pj->p", dx, B_inv, dx))
            scale = torch.where(move > cfg.c_move_max,
                                cfg.c_move_max / torch.clamp(move, min=1e-12),
                                torch.ones_like(move))
            return dx * scale[:, None]

        Xc = X
        G = self._scores(X, x0, B_inv, y, LR)
        s = torch.zeros((), dtype=X.dtype, device=X.device)
        ds = torch.tensor(cfg.ds_init, dtype=X.dtype, device=X.device)
        hist = torch.zeros((cfg.max_steps,), dtype=X.dtype, device=X.device)
        steps = 0
        while (float(s) < 1.0 and steps < cfg.max_steps) or steps < cfg.min_steps:
            ds_eff = torch.where(s + ds > 1.0, 1.0 - s, ds)
            # steps past s = 1 forced by min_steps take a step of 0
            ds_eff = torch.clamp(ds_eff, min=0.0)
            if steps < cfg.max_steps:
                hist[steps] = ds_eff
            Xc = Xc + clamp_moves(velocity(Xc, G), ds_eff)
            G = self._scores(Xc, x0, B_inv, y, LR)
            s = s + ds_eff
            steps += 1

        return KPFState(particles=Xc,
                        weights=torch.full((Np,), 1.0 / Np, dtype=X.dtype, device=X.device),
                        s=s, steps=torch.tensor(steps, dtype=torch.int32, device=X.device),
                        ds_history=hist)
