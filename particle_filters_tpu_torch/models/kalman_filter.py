"""General (time-varying) Kalman filter (PyTorch port of
``particle_filters_tpu/models/kalman_filter.py``).

    x_k = Φ_{k−1} x_{k−1} + B_{k−1} u_{k−1} + Γ_{k−1} w_{k−1},  w ~ N(0, Q)
    y_k = H_k x_k + v_k,                                        v ~ N(0, R)

Same outputs as the JAX package (priors, posteriors, gains, innovations,
S, total log-likelihood), standard or Joseph update, Cholesky-solve gain,
jitter on S. The JAX ``lax.scan`` is a Python loop over the steps; a
time-varying matrix is a stacked (N, ...) tensor. Pure, so
``torch.func.vmap`` runs many sequences at once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from particle_filters_tpu_torch.core.linalg import _LOG_2PI, chol_solve, chol_with_jitter
from particle_filters_tpu_torch.core.structs import as_f32


@dataclasses.dataclass(frozen=True)
class KFResults:
    """Outputs of the general Kalman filter."""

    x_pred: torch.Tensor  # (N, nx)
    P_pred: torch.Tensor  # (N, nx, nx)
    x_filt: torch.Tensor  # (N, nx)
    P_filt: torch.Tensor  # (N, nx, nx)
    K: torch.Tensor  # (N, nx, ny)
    innov: torch.Tensor  # (N, ny)
    S: torch.Tensor  # (N, ny, ny)
    loglik: torch.Tensor  # scalar


def _as_stacked(M, N: int, name: str, device, ndim: int = 2) -> torch.Tensor:
    """A time-invariant matrix broadcast to a (N, ...) stack, or an
    already-stacked (N, ...) input, validated."""
    M = as_f32(M, device)
    if M.ndim == ndim:
        return M.expand((N,) + M.shape)
    if M.ndim == ndim + 1:
        if M.shape[0] != N:
            raise ValueError(f"{name} must have leading length N={N} (got {M.shape[0]}).")
        return M
    raise ValueError(f"{name} must have {ndim} or {ndim + 1} dims, got {M.ndim}.")


def kalman_filter_general(
    Y, Phi, H, Gamma, Q, R, *,
    B=None,
    U: Optional[torch.Tensor] = None,
    x0,
    P0,
    use_joseph: bool = False,
    jitter: float = 1e-9,
    device="cuda",
) -> KFResults:
    """Run the general Kalman filter over an observation sequence Y (N, ny)
    on ``device`` (the card unless ``device="cpu"``)."""
    Y = as_f32(Y, device)
    if Y.ndim != 2:
        raise ValueError("Y must be 2D with shape (N, ny).")
    N, ny = Y.shape
    x0 = as_f32(x0, device).reshape(-1)
    nx = x0.shape[0]
    P0 = as_f32(P0, device)

    Phi_s = _as_stacked(Phi, N, "Phi", device)
    H_s = _as_stacked(H, N, "H", device)
    Gamma_s = _as_stacked(Gamma, N, "Gamma", device)
    Q_s = _as_stacked(Q, N, "Q", device)
    R_s = _as_stacked(R, N, "R", device)
    if B is None:
        B_s = torch.zeros((N, nx, 1), device=device)
    else:
        B_s = _as_stacked(B, N, "B", device)
    nu_dim = B_s.shape[-1]
    if U is None:
        U_arr = torch.zeros((N, nu_dim), device=device)
    else:
        U_arr = as_f32(U, device)
        if tuple(U_arr.shape) != (N, nu_dim):
            raise ValueError("U must have shape (N, n_u) matching B_k.")

    I = torch.eye(nx, device=device)
    jit_eye = jitter * torch.eye(ny, device=device)
    m, P = x0, P0
    loglik = torch.zeros((), device=device)
    outs = []
    for k in range(N):
        Phi_k, H_k, Gam_k, Q_k, R_k, B_k = Phi_s[k], H_s[k], Gamma_s[k], Q_s[k], R_s[k], B_s[k]
        m_minus = Phi_k @ m + B_k @ U_arr[k]
        P_minus = Phi_k @ P @ Phi_k.T + Gam_k @ Q_k @ Gam_k.T
        nu_k = Y[k] - H_k @ m_minus
        S_k = H_k @ P_minus @ H_k.T + R_k + jit_eye
        L = chol_with_jitter(S_k)
        K_k = chol_solve(L, (P_minus @ H_k.T).T).T
        m = m_minus + K_k @ nu_k
        if use_joseph:
            ImKH = I - K_k @ H_k
            P = ImKH @ P_minus @ ImKH.T + K_k @ R_k @ K_k.T
        else:
            P = P_minus - K_k @ (H_k @ P_minus)
        quad = nu_k @ chol_solve(L, nu_k)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        loglik = loglik + (-0.5) * (quad + logdet + ny * _LOG_2PI)
        outs.append((m_minus, P_minus, m, P, K_k, nu_k, S_k))
    x_pred, P_pred, x_filt, P_filt, K_all, innov, S_all = (torch.stack(a) for a in zip(*outs))
    return KFResults(x_pred=x_pred, P_pred=P_pred, x_filt=x_filt, P_filt=P_filt,
                     K=K_all, innov=innov, S=S_all, loglik=loglik)
