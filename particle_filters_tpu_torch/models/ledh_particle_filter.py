"""EKF/UKF-assisted LEDH (local EDH) particle-flow particle filter (PyTorch
port of ``particle_filters_tpu/models/ledh_particle_filter.py``).

Per-particle linearization Hⁱ = Jh(ηⁱ), per-particle flow matrices Aⁱ, bⁱ,
Euler migration of ηⁱ and of the auxiliary path η̄ⁱ, the flow log-det θⁱ,
and the invertible weights w ∝ w·θ·p(z|x)p(x|x₋)/p(η₀|x₋). The flow is the
JAX package's Woodbury form (:meth:`LEDHFlowPF._per_particle_factors`): its
two factorizations are one single-shot Cholesky of a stacked (2, nx, nx)
pair per particle — under the particle ``torch.func.vmap`` one batched
``cholesky_ex`` over (N, 2, nx, nx) — and the log-dets come from their
diagonals. Aⁱ is applied as an operator and never formed
(:func:`_apply_flow_matrix`, outside the particle vmap): Aⁱ only ever
multiplies vectors, so a λ-step applies it twice, to four vectors and then
to one, with products and triangular solves nx²·k in work a particle where
the formed matrix took nx³. Where the Jacobian is the same for every
particle, the vmap computes W and the factors once, and one factor serves
all the particles' rows; there Aⁱ formed once a trial would take less
card work once n·k > nx.
The steps, runs and batched trials are those of
:class:`~particle_filters_tpu_torch.models.edh_particle_filter._FlowPF`,
with a process group too (its condition number then the max over the
ranks' first particles, as the JAX package's ``pmax``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from particle_filters_tpu_torch.core.linalg import (
    chol_nojitter,
    chol_solve,
    chol_with_jitter,
    cond_spd,
    cond_spd_power,
    symmetrize,
)
from particle_filters_tpu_torch.models.edh_particle_filter import _FlowPF, _lambda_grid
from particle_filters_tpu_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class LEDHConfig:
    """The JAX package's ``LEDHConfig``."""

    n_particles: int = 512
    n_lambda_steps: int = 8
    resample_ess_ratio: float = 0.0
    cond_mode: str = "power"  # "power" (cond_spd_power) | "eigh" (cond_spd)


def _check_beta_schedule(beta: np.ndarray, n_steps: int) -> None:
    """A temper schedule 0 = β₀ < β₁ < … < β_n = 1, as the Woodbury flow needs."""
    if beta.shape != (n_steps + 1,):
        raise ValueError(
            f"beta_schedule must have shape ({n_steps + 1},) = (n_lambda_steps + 1,); "
            f"got {beta.shape}."
        )
    if not np.all(np.diff(beta) > 0.0):
        raise ValueError("beta_schedule must be strictly increasing.")
    if not np.all(beta[1:] > 0.0):
        raise ValueError("beta_schedule values past index 0 must be positive "
                         "(the flow divides by λ).")
    if beta[0] != 0.0:
        raise ValueError(f"beta_schedule must start at 0.0 (got {beta[0]!r}); "
                         "the flow integrates pseudo-time from λ=0.")
    if beta[-1] != 1.0:
        raise ValueError(f"beta_schedule must end at 1.0 (got {beta[-1]!r}); "
                         "the weight correction assumes full tempering to λ=1.")


def _apply_flow_matrix(W, LK, LKt, Pt, V):
    """Aⁱ applied to every particle's rows, V (n, k, nx) → (n, k, nx):
    Aⁱv = −½ P (Wv − W K⁻¹ Wv) with K = LK LKᵀ (LKt = LKᵀ), by two
    products with W and two triangular solves with LK, each k wide. W and
    K are symmetric, so the rows are V W, then its product with K⁻¹ from
    the right, and so on; Pt = −½Pᵀ, shared by a trial's particles,
    multiplies all n·k rows in one product. W and LK are (n, nx, nx), one
    a particle, or (nx, nx) where the Jacobian is the same for every
    particle: then one W and one LK serve all n·k rows.
    ``LEDHFlowPF.operator_applies`` counts the applies (two a λ-step),
    across calls."""
    LEDHFlowPF.operator_applies += 1
    rows = V.reshape(-1, V.shape[-1]) if W.dim() == 2 else V
    t = rows @ W
    y = torch.linalg.solve_triangular(LKt, t, upper=True, left=False)  # t LK⁻ᵀ
    r = torch.linalg.solve_triangular(LK, y, upper=False, left=False)  # t K⁻¹
    return ((t - r @ W) @ Pt).reshape(V.shape)


class LEDHFlowPF(_FlowPF):
    """Local EDH flow PF (per-particle linearization). The constructor is
    :class:`~particle_filters_tpu_torch.models.edh_particle_filter.EDHFlowPF`'s;
    ``step``, ``run`` and ``run_trials`` also take ``beta_schedule``, an
    optional (n_lambda_steps + 1,) temper schedule from 0 to 1 that replaces
    the uniform λ grid (flow at β_k with Euler increments β_{k+1} − β_k)."""

    operator_applies = 0  # see _apply_flow_matrix
    # The d×d matrices the single-shot Cholesky of _lambda_step factored,
    # over all trials and calls: 2·B·n a λ-step with a Jacobian a particle,
    # 2·B where one Jacobian serves every particle.
    factored_matrices = 0

    def __init__(self, tracker, g, h, jacobian_h, log_trans_pdf, log_like_pdf, R,
                 config: Optional[LEDHConfig] = None, device="cuda", group=None,
                 distributed_resample: str = "all_gather", neighbor_radius: int = 2) -> None:
        super().__init__(tracker, g, h, jacobian_h, log_trans_pdf, log_like_pdf, R,
                         config or LEDHConfig(), device, group, distributed_resample,
                         neighbor_radius)
        self.R_inv = chol_solve(self.LR, torch.eye(self.R.shape[0], device=self.device))

    def _run_trials(self, generator, states, tracker_states, zs, *rest):
        # The trial vmap runs the λ-steps' Python once for all B trials, so
        # they count one trial's matrices, and B multiplies them here.
        before = LEDHFlowPF.factored_matrices
        out = super()._run_trials(generator, states, tracker_states, zs, *rest)
        one_trial = LEDHFlowPF.factored_matrices - before
        LEDHFlowPF.factored_matrices = before + zs.shape[0] * one_trial
        return out

    def _per_particle_factors(self, lam, one_minus_c, eta_i, P, P_inv, z, I):
        """ONE particle's Wⁱ, the Cholesky factor LK of Kⁱ, uⁱ and half the
        log-det increment.

        With Wⁱ = HⁱᵀR⁻¹Hⁱ and Kⁱ = P⁻¹/λ + Wⁱ (Woodbury):
        HⁱᵀSⁱ⁻¹Hⁱ = Wⁱ − Wⁱ Kⁱ⁻¹ Wⁱ, Aⁱ = −½ P (Wⁱ − Wⁱ Kⁱ⁻¹ Wⁱ) and
        uⁱ = P HⁱᵀR⁻¹(z − eⁱ). det(I + εAⁱ) = det(Kⁱ − (ε/2λ)Wⁱ)/det(Kⁱ),
        both SPD (ε ≤ λ on the grid): the log-dets come from the Cholesky
        diagonals."""
        Hi = self.Jh(eta_i)
        ei = self.h(eta_i) - Hi @ eta_i
        W = symmetrize(Hi.T @ (self.R_inv @ Hi))  # (nx, nx) PSD
        jit_eye = 1e-8 * I
        # Both SPD factorizations in one call: K ⪰ P⁻¹/λ is SPD by
        # construction, so the single-shot Cholesky, not the jitter ladder.
        Ls = chol_nojitter(torch.stack([
            P_inv / lam + W + jit_eye,
            P_inv / lam + one_minus_c * W + jit_eye,
        ]))
        # Under vmap LK is a strided slice of the pair; one copy makes it
        # contiguous, so that its four solves read it in place.
        LK, L_num = Ls[0].contiguous(), Ls[1]
        u = P @ (Hi.T @ (self.R_inv @ (z - ei)))
        half_logdet = (torch.sum(torch.log(torch.diagonal(L_num)))
                       - torch.sum(torch.log(torch.diagonal(LK))))
        return W, LK, u, half_logdet

    def _lambda_step(self, lam, dlam, one_minus_c, eta, etabar, eta0, P, P_inv, z, I):
        """One λ-step of all n particles (eta, etabar, eta0 (n, nx)): the
        migrations and the log-det increments. Aⁱ is applied by
        :func:`_apply_flow_matrix` and never formed: once to the four
        vectors u, η₀, η̄, η, once to s = (I + λAⁱ)u + Aⁱη₀, and
        bⁱ = (I + 2λAⁱ)s."""
        with span("pf.ledh.factors"):
            W, LK, u, half_logdets = torch.func.vmap(
                self._per_particle_factors, in_dims=(None, None, 0, None, None, None, None)
            )(lam, one_minus_c, eta, P, P_inv, z, I)
        shared = W.stride(0) == 0 and LK.stride(0) == 0
        LEDHFlowPF.factored_matrices += 2 * (1 if shared else eta.shape[0])
        if shared:
            # The vmap expands what no particle changes: the Jacobian is
            # the same for every particle, and so are W and LK.
            W, LK = W[0], LK[0]
        apply = functools.partial(_apply_flow_matrix, W, LK, LK.mT, -0.5 * P.mT)
        Au, Aeta0, Aetabar, Aeta = apply(torch.stack([u, eta0, etabar, eta], dim=1)).unbind(1)
        s = torch.add(u, Au, alpha=lam) + Aeta0
        b = torch.add(s, apply(s[:, None])[:, 0], alpha=2.0 * lam)
        return (torch.add(eta, Aeta + b, alpha=dlam), torch.add(etabar, Aetabar + b, alpha=dlam),
                2.0 * half_logdets)

    def _cond_first_particle(self, lam, eta_0, P):
        """cond(S⁰) for particle 0 only, as the reference records it."""
        H0 = self.Jh(eta_0)
        S0 = lam * (H0 @ P @ H0.T) + self.R
        if self.cfg.cond_mode == "eigh":
            return cond_spd(S0)
        return cond_spd_power(symmetrize(S0))

    def _grid(self, beta_schedule):
        """(λ_k, ε_k) pairs as Python floats with f32 values."""
        n_steps = max(1, int(self.cfg.n_lambda_steps))
        if beta_schedule is None:
            dlam, lams = _lambda_grid(n_steps)
            return [(lam, float(np.float32(dlam))) for lam in lams]
        if isinstance(beta_schedule, torch.Tensor):
            beta_schedule = beta_schedule.detach().cpu().numpy()
        beta = np.asarray(beta_schedule, np.float32)
        _check_beta_schedule(beta, n_steps)
        return list(zip(beta[1:].tolist(), np.diff(beta).tolist()))

    def _flow(self, eta0, ts, P, z, u, beta_schedule=None):
        n, nx = eta0.shape
        I = torch.eye(nx, device=eta0.device)
        P_inv = chol_solve(chol_with_jitter(P, initial=1e-9), I)
        eta, etabar, theta_log, conds = eta0, eta0, torch.zeros(n, device=eta0.device), []
        for lam, dlam in self._grid(beta_schedule):
            # c = ε/(2λ) and 1 − c in f32, as the JAX package computes them
            c = np.float32(dlam) / (np.float32(2.0) * np.float32(lam))
            one_minus_c = float(np.float32(1.0) - c)
            conds.append(self._cond_first_particle(lam, eta[0], P))
            eta, etabar, logdets = self._lambda_step(lam, dlam, one_minus_c, eta, etabar, eta0,
                                                     P, P_inv, z, I)
            theta_log = theta_log + logdets
        return eta, theta_log, torch.stack(conds)
