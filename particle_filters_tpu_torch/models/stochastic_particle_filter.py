"""Stochastic particle flow (SPF) with a generalized homotopy (PyTorch port
of ``particle_filters_tpu/models/stochastic_particle_filter.py``).

:class:`LinearGaussianBayes` (precisions, Hessians, scores and the exact
Kalman posterior), the spectral condition number κ₂ and dκ₂/dβ by
eigendecomposition and eigenvalue perturbation, the "optimal" β(λ) solving
β'' = µ·dκ₂/dβ by RK4 shooting with a multisection (or bracket-and-bisect)
root find on the slope, and the Euler-Maruyama homotopy SDE with drift
K₁∇log p + K₂∇log h and diffusion Q ∈ {scaled identity, M⁻¹}.

Every function takes a leading batch: a model whose fields carry a batch
axis (B, n), (B, n, n) is B independent problems, solved together (the JAX
package vmaps them). The shooting is a Python loop of RK4 steps over a
(B, K) block of candidate slopes, K = 62 for the doubling ladder and 64 a
multisection round, so a solve is ~7 sequential scans of ``n_grid − 1``
steps whatever B. The tabulated right-hand side indexes its (B, 2048)
eigen table directly (the JAX package's one-hot product is a TPU stand-in
for the gather) with the same linear interpolation. The SDE's per-step
matrices depend on β alone, so they are formed for all λ-steps at once
and the particle loop is a few products a step. The draws (the initial
normals and the (n_steps, ..., N, n) noise) are kept apart from the
integration: pass ``normals=`` to feed another package's. Products run in
full f32 on the card only with TF32 off, which the caller sets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from particle_filters_tpu_torch.core.linalg import chol_with_jitter, symmetrize
from particle_filters_tpu_torch.core.structs import as_f32

B_LO, B_HI = -0.5, 1.5  # the clip interval of the shooting's right-hand side


EIGH_BATCH = 16384  # matrices a call to cuSOLVER's batched syev


def eigh(a: torch.Tensor):
    """``torch.linalg.eigh`` of (..., n, n), at most ``EIGH_BATCH`` matrices
    a call: on the card cuSOLVER's batched syev (n ≤ 32) failed with
    CUSOLVER_STATUS_INVALID_VALUE on the 40960 9×9 matrices of SPF example
    2's β table in one call (H100, torch 2.11, CUDA 12.8)."""
    n = a.shape[-1]
    flat = a.reshape(-1, n, n)
    if flat.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(a)
    parts = [torch.linalg.eigh(c) for c in torch.split(flat, EIGH_BATCH)]
    w = torch.cat([p[0] for p in parts]).reshape(a.shape[:-1])
    V = torch.cat([p[1] for p in parts]).reshape(a.shape)
    return w, V


def _per_matrix(fn, a: torch.Tensor) -> torch.Tensor:
    """``fn`` of each (n, n) matrix of ``a`` (..., n, n), so that a jitter
    rung is chosen matrix by matrix, as under ``jax.vmap``."""
    if a.ndim == 2:
        return fn(a)
    flat = a.reshape((-1,) + tuple(a.shape[-2:]))
    out = torch.func.vmap(fn)(flat)
    return out.reshape(a.shape[:-2] + out.shape[1:])


def chol_solve_eye(a: torch.Tensor) -> torch.Tensor:
    """A⁻¹ via jittered Cholesky (per matrix of a batch)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.cholesky_solve(eye.expand(a.shape), _per_matrix(
        lambda m: chol_with_jitter(m, initial=1e-12), a))


def linspace(start: float, stop: float, num: int, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """The JAX package's ``jnp.linspace``: start·(1 − s) + stop·s with
    s = i·(1/div) in ``dtype`` (XLA multiplies by the reciprocal), the end
    point appended. Grids from 0 to 1 equal JAX's bit for bit; others lie
    within an ulp."""
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) * (
        torch.tensor(1.0, dtype=dtype) / torch.tensor(div, dtype=dtype))
    out = torch.tensor(start, dtype=dtype) * (1 - step) + torch.tensor(stop, dtype=dtype) * step
    return torch.cat([out, torch.tensor([stop], dtype=dtype, device=device)])


@dataclasses.dataclass(frozen=True)
class LinearGaussianBayes:
    """Single-update linear-Gaussian model: prior x ~ N(m0, P0), likelihood
    z|x ~ N(Hx, R). Build with :meth:`create` so the precisions and Hessians
    are formed once. Fields may carry a leading batch axis."""

    m0: torch.Tensor  # (..., n)
    P0: torch.Tensor  # (..., n, n)
    H: torch.Tensor  # (..., d, n)
    R: torch.Tensor  # (..., d, d)
    z: torch.Tensor  # (..., d)
    P0_inv: torch.Tensor
    R_inv: torch.Tensor
    Hess_log_p0: torch.Tensor  # −P0⁻¹
    Hess_log_h: torch.Tensor  # −HᵀR⁻¹H
    M0: torch.Tensor  # P0⁻¹
    Mh: torch.Tensor  # HᵀR⁻¹H

    @classmethod
    def create(cls, m0, P0, H, R, z, *, device="cuda") -> "LinearGaussianBayes":
        P0, H, R = (as_f32(a, device) for a in (P0, H, R))
        batch = P0.shape[:-2]
        m0 = as_f32(m0, device).reshape(batch + (-1,))
        z = as_f32(z, device).reshape(batch + (-1,))
        n, d = m0.shape[-1], z.shape[-1]
        if P0.shape[-2:] != (n, n) or H.shape[-2:] != (d, n) or R.shape[-2:] != (d, d):
            raise ValueError("Inconsistent shapes for LinearGaussianBayes.")
        P0_inv = chol_solve_eye(P0)
        R_inv = chol_solve_eye(R)
        Mh = symmetrize(H.mT @ R_inv @ H)
        return cls(m0=m0, P0=P0, H=H, R=R, z=z, P0_inv=P0_inv, R_inv=R_inv,
                   Hess_log_p0=-P0_inv, Hess_log_h=-Mh, M0=symmetrize(P0_inv), Mh=Mh)

    @property
    def n(self) -> int:
        return self.m0.shape[-1]

    @property
    def d(self) -> int:
        return self.z.shape[-1]

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.m0.shape[:-1])

    def _rows(self, v, x):
        """``v`` (..., k) against points ``x`` that carry a particle axis
        past the model's batch axes."""
        return v.unsqueeze(-2) if self.batch_shape and x.ndim > v.ndim else v

    def grad_log_p0(self, x: torch.Tensor) -> torch.Tensor:
        """∇log p₀ = −P0⁻¹(x − m0), over the leading axes of ``x``."""
        return -(x - self._rows(self.m0, x)) @ self.P0_inv.mT

    def grad_log_h(self, x: torch.Tensor) -> torch.Tensor:
        """∇log h = HᵀR⁻¹(z − Hx), over the leading axes of ``x``."""
        return (self._rows(self.z, x) - x @ self.H.mT) @ (self.R_inv @ self.H)

    def kalman_posterior(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The exact posterior (m, P)."""
        S = self.H @ self.P0 @ self.H.mT + self.R
        K = self.P0 @ self.H.mT @ chol_solve_eye(S)
        innov = self.z - (self.H @ self.m0[..., None])[..., 0]
        m_post = self.m0 + (K @ innov[..., None])[..., 0]
        eye = torch.eye(self.n, dtype=self.P0.dtype, device=self.P0.device)
        return m_post, symmetrize((eye - K @ self.H) @ self.P0)


def kappa2_and_derivative(M: torch.Tensor, dM_dbeta: torch.Tensor,
                          eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectral condition number κ₂(M) and dκ₂/dβ by first-order eigenvalue
    perturbation, over leading batch axes."""
    M = symmetrize(M)
    dM = symmetrize(dM_dbeta)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    w, V = eigh(M + eps * eye)
    lam_min = torch.clamp(torch.abs(w[..., 0]), min=eps)
    lam_max = torch.clamp(torch.abs(w[..., -1]), min=eps)
    vmin, vmax = V[..., :, 0], V[..., :, -1]
    dlam_min = ((vmin[..., None, :] @ dM) @ vmin[..., :, None])[..., 0, 0]
    dlam_max = ((vmax[..., None, :] @ dM) @ vmax[..., :, None])[..., 0, 0]
    kappa = lam_max / lam_min
    dkappa = dlam_max / lam_min - (lam_max * dlam_min) / lam_min**2
    return kappa, dkappa


def _eigen_table(M0, Mh, n_tab, dtype):
    """λ_min, λ_max and their β-derivatives of M(β) = M0 + β·Mh on an
    ``n_tab``-point grid of the clip interval, for each (B) problem, packed
    as adjacent pairs (B, n_tab − 1, 8): row i holds the four at grid
    points i and i + 1, so one gather serves an interpolation."""
    tab = linspace(B_LO, B_HI, n_tab, dtype, M0.device)
    eye = torch.eye(M0.shape[-1], dtype=dtype, device=M0.device)
    M = symmetrize(M0[:, None] + tab[None, :, None, None] * Mh[:, None]) + 1e-12 * eye
    w, V = eigh(M)
    vmin, vmax = V[..., :, 0], V[..., :, -1]
    quad = lambda v: ((v[..., None, :] @ Mh[:, None]) @ v[..., :, None])[..., 0, 0]  # noqa: E731
    parts = torch.stack([torch.clamp(torch.abs(w[..., 0]), min=1e-12),
                         torch.clamp(torch.abs(w[..., -1]), min=1e-12),
                         quad(vmin), quad(vmax)], dim=-1)  # (B, n_tab, 4)
    return torch.cat([parts[:, :-1], parts[:, 1:]], dim=-1)


def solve_beta_star_bisection(
    M0,
    Mh,
    mu,
    n_grid: int = 501,
    s_lo: float = -5.0,
    s_hi: float = 5.0,
    max_bracket_expand: int = 30,
    max_bisect_iter: int = 60,
    rhs_mode: str = "tabulated",
    n_beta_tab: int = 2048,
    bounded: bool = False,
    solver: str = "multisection",
    multisect_width: int = 64,
    multisect_rounds: int = 5,
):
    """Optimal β(λ): shoot β'' = µ·dκ₂/dβ from β(0) = 0 to hit β(1) = 1.

    ``M0``, ``Mh`` are (n, n) or a batch (..., n, n) of problems; ``mu`` a
    float or one a problem. Returns ``(lam (n_grid,), beta, betadot)``,
    beta and betadot (..., n_grid).

    ``rhs_mode``: ``"tabulated"`` interpolates λ_min, λ_max and their
    β-derivatives from one batched ``eigh`` over ``n_beta_tab`` points of
    [−0.5, 1.5] and forms dκ₂/dβ's rational expression exactly at every
    RK4 stage (interpolating dκ₂/dβ itself fails near a singular M(β));
    ``"exact"`` takes an ``eigh`` at every stage.

    ``solver``: ``"multisection"`` evaluates the doubling ladder
    s_lo·2^k, s_hi·2^k in one batched shooting, then ``multisect_rounds``
    splits of the bracket into ``multisect_width`` points, keeping the first
    sign change; ``"bisection"`` expands the bracket by doubling
    (``bounded=True``: always ``max_bracket_expand`` masked rounds, the same
    result) and bisects ``max_bisect_iter`` times.
    """
    M0 = symmetrize(torch.as_tensor(M0))
    Mh = symmetrize(torch.as_tensor(Mh))
    dtype, device = M0.dtype, M0.device
    batch = M0.shape[:-2]
    n = M0.shape[-1]
    M0, Mh = M0.reshape(-1, n, n), Mh.reshape(-1, n, n)
    B = M0.shape[0]
    mu = torch.as_tensor(mu, dtype=dtype, device=device).reshape(-1)
    mu = mu.expand(B).reshape(B, 1)
    lam = linspace(0.0, 1.0, n_grid, dtype, device)
    h = lam[1] - lam[0]
    h_half, h_sixth = 0.5 * h, h / 6.0

    if rhs_mode == "tabulated":
        pairs = _eigen_table(M0, Mh, n_beta_tab, dtype)
        inv_db = torch.tensor((n_beta_tab - 1) / (B_HI - B_LO), dtype=dtype)

        def rhs(beta):  # (B, K)
            pos = (torch.clamp(beta, B_LO, B_HI) - B_LO) * inv_db
            i0 = torch.clamp(pos.to(torch.int64), 0, n_beta_tab - 2)
            frac = (pos - i0.to(dtype))[..., None]
            rows = torch.gather(pairs, 1, i0[..., None].expand(i0.shape + (8,)))
            lam_min, lam_max, dlam_min, dlam_max = torch.unbind(
                rows[..., :4] * (1.0 - frac) + rows[..., 4:] * frac, dim=-1)
            return mu * (dlam_max / lam_min - (lam_max * dlam_min) / lam_min**2)

    elif rhs_mode == "exact":

        def rhs(beta):
            beta = torch.clamp(beta, B_LO, B_HI)
            _, dk = kappa2_and_derivative(
                M0[:, None] + beta[..., None, None] * Mh[:, None], Mh[:, None])
            return mu * dk

    else:
        raise ValueError("rhs_mode must be 'tabulated' or 'exact'.")

    def shoot(s0, keep: bool = False):
        """RK4 from β(0) = 0 with slopes ``s0`` (B, K); the end point, or
        with ``keep`` the trajectories (B, K, n_grid) of β and β'."""
        y1, y2 = torch.zeros_like(s0), s0
        betas, betadots = [y1], [y2]
        for _ in range(n_grid - 1):
            k11, k12 = y2, rhs(y1)
            k21, k22 = y2 + h_half * k12, rhs(y1 + h_half * k11)
            k31, k32 = y2 + h_half * k22, rhs(y1 + h_half * k21)
            k41, k42 = y2 + h * k32, rhs(y1 + h * k31)
            y1, y2 = (y1 + h_sixth * (k11 + 2 * k21 + 2 * k31 + k41),
                      y2 + h_sixth * (k12 + 2 * k22 + 2 * k32 + k42))
            if keep:
                betas.append(y1)
                betadots.append(y2)
        if keep:
            return torch.stack(betas, dim=-1), torch.stack(betadots, dim=-1)
        return y1

    def F(s0):
        return shoot(s0) - 1.0

    def first_change(S, FS):
        """The first bracket [S_j, S_j+1] whose F changes sign, per row
        (j = 0 where none does)."""
        change = torch.sign(FS[:, :-1]) != torch.sign(FS[:, 1:])
        j = torch.argmax(change.to(torch.int32), dim=1, keepdim=True)
        return torch.gather(S, 1, j), torch.gather(S, 1, j + 1)

    if solver == "multisection":
        ladder = sorted([s_lo * 2.0**k for k in range(max_bracket_expand + 1)]
                        + [s_hi * 2.0**k for k in range(max_bracket_expand + 1)])
        cand = torch.tensor(ladder, dtype=dtype, device=device).expand(B, -1)
        lo, hi = first_change(cand, F(cand))
        split = linspace(0.0, 1.0, multisect_width, dtype, device)
        for _ in range(multisect_rounds):
            grid = lo + (hi - lo) * split
            lo, hi = first_change(grid, F(grid))
    elif solver == "bisection":
        lo = torch.full((B, 1), s_lo, dtype=dtype, device=device)
        hi = torch.full((B, 1), s_hi, dtype=dtype, device=device)
        f_both = F(torch.cat([lo, hi], dim=1))
        f_lo, f_hi = f_both[:, :1], f_both[:, 1:]
        for _ in range(max_bracket_expand):
            # Rows whose bracket holds a sign change freeze; without
            # ``bounded`` the loop ends once every row does.
            done = torch.sign(f_lo) != torch.sign(f_hi)
            if not bounded and bool(done.all()):
                break
            lo = torch.where(done, lo, lo * 2.0)
            hi = torch.where(done, hi, hi * 2.0)
            f_both = F(torch.cat([lo, hi], dim=1))
            f_lo = torch.where(done, f_lo, f_both[:, :1])
            f_hi = torch.where(done, f_hi, f_both[:, 1:])
        for _ in range(max_bisect_iter):
            mid = 0.5 * (lo + hi)
            f_mid = F(mid)
            same = torch.sign(f_mid) == torch.sign(f_lo)
            lo, f_lo, hi = (torch.where(same, mid, lo), torch.where(same, f_mid, f_lo),
                            torch.where(same, hi, mid))
    else:
        raise ValueError("solver must be 'multisection' or 'bisection'.")

    beta, betadot = shoot(0.5 * (lo + hi), keep=True)
    beta, betadot = beta[:, 0], betadot[:, 0]
    beta = beta.clone()
    beta[:, 0], beta[:, -1] = 0.0, 1.0
    beta = torch.clamp(beta, 0.0, 1.0)
    return lam, beta.reshape(batch + (n_grid,)), betadot.reshape(batch + (n_grid,))


def draw_spf_normals(generator, N: int, n: int, n_steps: int, batch_shape=(),
                     device=None):
    """The SPF's draws: the initial normals (..., N, n), then the SDE's
    (n_steps, ..., N, n)."""
    device = generator.device if device is None else device
    eps0 = torch.randn(tuple(batch_shape) + (N, n), generator=generator, device=device)
    noise = torch.randn((n_steps,) + tuple(batch_shape) + (N, n), generator=generator,
                        device=device)
    return eps0, noise


def run_generalized_spf(
    model: LinearGaussianBayes,
    N: int = 2000,
    n_steps: int = 300,
    beta_mode: str = "optimal",
    mu: float = 1e-2,
    Q_mode: str = "inv_M",
    q_scale: float = 1e-2,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    beta_rhs_mode: str = "tabulated",
    beta_bounded: bool = False,
    beta_solver: str = "multisection",
    normals=None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Generalized SPF: temper the prior into the posterior by integrating
    dX = [K₁∇log p + K₂∇log h] dλ + √Q dW over λ ∈ [0, 1].

    ``generator`` (default: ``seed`` on the model's device) draws the
    initial normals and the SDE noise (:func:`draw_spf_normals`) unless
    ``normals = (eps0, noise)`` gives them; draws with leading axes past the
    model's batch, (R, N, n) and (n_steps, R, N, n) say, are R runs of the
    model sharing one β schedule. ``beta_*`` forward to
    :func:`solve_beta_star_bisection`. A batched model runs its problems
    together. Returns (final particles (..., N, n), the mean (..., n), info
    with the λ/β/β' grids).
    """
    if beta_mode not in ("linear", "optimal"):
        raise ValueError("beta_mode must be 'linear' or 'optimal'.")
    if Q_mode not in ("scaled_identity", "inv_M"):
        raise ValueError("Q_mode must be 'scaled_identity' or 'inv_M'.")
    n, dtype, device = model.n, model.P0.dtype, model.P0.device
    batch = model.batch_shape
    nb = len(batch)
    if normals is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        normals = draw_spf_normals(generator, N, n, n_steps, batch, device)
    eps0, noise = (as_f32(a, device) for a in normals)
    # Leading axes of the draws past the model's batch (independent runs of
    # one model, say) are broadcast against the model's fields.
    ex = eps0.ndim - 2 - nb

    def lift(v, keep=nb):
        return v.reshape(v.shape[:keep] + (1,) * ex + v.shape[keep:])

    m0, z = lift(model.m0)[..., None, :], lift(model.z)[..., None, :]
    Ht, P0_inv_t = lift(model.H).mT, lift(model.P0_inv).mT
    RinvH = lift(model.R_inv @ model.H)
    X = m0 + eps0 @ lift(_per_matrix(chol_with_jitter, model.P0)).mT

    if beta_mode == "linear":
        lam_grid = linspace(0.0, 1.0, n_steps + 1, dtype, device)
        beta_grid = lam_grid.expand(batch + (n_steps + 1,))
        betadot_grid = torch.ones_like(beta_grid)
    else:
        lam_grid, beta_grid, betadot_grid = solve_beta_star_bisection(
            model.M0, model.Mh, mu=mu, n_grid=n_steps + 1, rhs_mode=beta_rhs_mode,
            bounded=beta_bounded, solver=beta_solver)

    # The per-step matrices depend on β alone: all λ-steps at once, (S, ..., n, n).
    def at_steps(v):
        return v[..., :-1].movedim(-1, 0)[..., None, None]

    beta, beta_p = at_steps(beta_grid), at_steps(betadot_grid)
    H0, Hh = model.Hess_log_p0, model.Hess_log_h
    eye = torch.eye(n, dtype=dtype, device=device)
    M = -symmetrize(H0 + beta * Hh)  # S = H0 + β·Hh is negative definite
    LM = _per_matrix(lambda m: chol_with_jitter(m, initial=1e-12), M)
    Minv = torch.cholesky_solve(eye.expand(M.shape), LM)
    Sinv = -Minv
    if Q_mode == "scaled_identity":
        Q, LQ = (q_scale**2) * eye, (q_scale * eye).expand(M.shape)
    else:  # inv_M: Q = M⁻¹ (SPD)
        Q = Minv
        LQ = _per_matrix(lambda m: chol_with_jitter(m, initial=1e-12), Q)
    K2t = lift(-beta_p * Sinv, nb + 1).mT
    K1t = lift(0.5 * Q + 0.5 * beta_p * (Sinv @ Hh @ Sinv), nb + 1).mT
    beta = lift(beta, nb + 1)

    dlam = torch.tensor(1.0 / n_steps, dtype=dtype)
    diffusion = torch.sqrt(dlam) * (noise @ lift(LQ, nb + 1).mT)  # (S, ..., N, n)
    for k in range(n_steps):
        G_h = (z - X @ Ht) @ RinvH
        G_p = -(X - m0) @ P0_inv_t + beta[k] * G_h
        X = X + dlam * (G_p @ K1t[k] + G_h @ K2t[k]) + diffusion[k]
    info = {"lam": lam_grid, "beta": beta_grid, "betadot": betadot_grid}
    return X, torch.mean(X, dim=-2), info
