"""Robust SPD linear algebra: Cholesky with and without a jitter ladder,
triangular solves, Gaussian log-densities and condition numbers (PyTorch
port of ``particle_filters_tpu/core/linalg.py``).

The JAX module's unrolled and blocked Cholesky/TRSM machinery works around
XLA:TPU's serial ``cholesky`` and ``triangular_solve``; ``torch.linalg`` needs
no such workaround, so only the API is ported, on ``cholesky_ex`` and
``solve_triangular``. Matrix products run in full f32 on the card only with
TF32 off, which the caller sets (the JAX package's ``with_f32_matmuls``):
the package sets no global flags.

Every function is pure and works under ``torch.func.vmap``.
:func:`mvn_logpdf_chol` multiplies the points by L⁻ᵀ as rows: under vmap a
constant factor (a flow's per-particle log-density) is inverted once and
the batched points fold into one matrix product, where a batched triangular
solve would copy the factor once per point — 16 GB for a 64×64 factor over
the 10⁶ particles of a batched EDH-10000.
"""

from __future__ import annotations

from typing import Optional

import torch

_LOG_2PI = 1.8378770664093453


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    """0.5 (A + Aᵀ)."""
    return 0.5 * (a + a.transpose(-1, -2))


def _nan_where_failed(L: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """The factor, NaN where ``cholesky_ex`` failed: the failure contract of
    ``jnp.linalg.cholesky`` (non-SPD input gives a non-finite factor)."""
    failed = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(failed, torch.full_like(L, float("nan")), L)


def chol_nojitter(a: torch.Tensor) -> torch.Tensor:
    """Single-shot Cholesky of (..., n, n) SPD matrices; non-SPD input gives
    NaNs in its factor. For inputs SPD by construction, where the ladder of
    :func:`chol_with_jitter` would be waste (the LEDH flow's K = P⁻¹/λ + W)."""
    L, info = torch.linalg.cholesky_ex(a)
    return _nan_where_failed(L, info)


def chol_with_jitter(
    a: torch.Tensor,
    jitter: float = 0.0,
    max_tries: int = 6,
    initial: float = 1e-9,
    factor: float = 10.0,
    return_jitter: bool = False,
):
    """Cholesky factor of an SPD matrix with a jitter ladder.

    The rungs ``jitter`` then ``jitter + initial·factor^k`` are factorized in
    one batched ``cholesky_ex`` call; the first rung on which the WHOLE input
    factorizes wins. If every rung fails the (non-finite) base attempt is
    returned, as in the JAX package. Under ``torch.func.vmap`` the rung is
    chosen per batch element, as under ``jax.vmap``. With ``return_jitter``
    also returns the jitter of the rung taken, a 0-d tensor.
    """
    a = symmetrize(a)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    rungs = [jitter] + [jitter + initial * factor**k for k in range(max_tries)]
    eps = torch.tensor(rungs, dtype=a.dtype, device=a.device).reshape(
        (-1,) + (1,) * a.ndim
    )
    Ls = chol_nojitter(a.unsqueeze(0) + eps * eye)  # (R, ..., n, n)
    ok = torch.isfinite(Ls).flatten(1).all(dim=1)
    idx = torch.argmax(ok.to(torch.int32))  # first finite rung; 0 if none
    return (Ls[idx], eps.flatten()[idx]) if return_jitter else Ls[idx]


# --- triangular solves -------------------------------------------------------
def _tri_solve(a, b_mat, upper: bool):
    vec = b_mat.ndim == a.ndim - 1
    if vec:
        b_mat = b_mat.unsqueeze(-1)
    x = torch.linalg.solve_triangular(a, b_mat, upper=upper)
    return x.squeeze(-1) if vec else x


def tri_solve_lower(l: torch.Tensor, b_mat: torch.Tensor) -> torch.Tensor:
    """Solve L X = B with L lower-triangular; B is (..., n, m) or (..., n)."""
    return _tri_solve(l, b_mat, upper=False)


def tri_solve_lower_t(l: torch.Tensor, b_mat: torch.Tensor) -> torch.Tensor:
    """Solve Lᵀ X = B given the LOWER factor L (backward substitution)."""
    return _tri_solve(l.transpose(-1, -2), b_mat, upper=True)


def chol_solve(chol_l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the lower Cholesky factor L (A = L Lᵀ): two
    triangular solves."""
    return tri_solve_lower_t(chol_l, tri_solve_lower(chol_l, b))


def solve_psd(a: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Solve with an SPD ``a`` via jittered Cholesky."""
    return chol_solve(chol_with_jitter(a, jitter=jitter), b)


def inv_psd(a: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return chol_solve(chol_with_jitter(a, jitter=jitter), eye)


# --- densities and condition numbers ------------------------------------------
def mvn_logpdf_chol(x: torch.Tensor, mean: torch.Tensor, chol_l: torch.Tensor) -> torch.Tensor:
    """log N(x; mean, L Lᵀ) given the lower Cholesky factor L, vectorized
    over the leading axes of ``x``: the differences times L⁻ᵀ as rows."""
    d = x.shape[-1]
    eye = torch.eye(d, dtype=chol_l.dtype, device=chol_l.device)
    l_inv = torch.linalg.solve_triangular(chol_l, eye, upper=False)
    sol = (x - mean) @ l_inv.transpose(-1, -2)
    maha = torch.sum(sol * sol, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(chol_l, dim1=-2, dim2=-1))))
    return -0.5 * (maha + logdet + d * _LOG_2PI)


def mvn_logpdf(x, mean, cov, jitter: float = 0.0) -> torch.Tensor:
    """log N(x; mean, cov) with jittered Cholesky."""
    return mvn_logpdf_chol(x, mean, chol_with_jitter(cov, jitter=jitter))


def diag_gaussian_logpdf(x, mean, var) -> torch.Tensor:
    """Elementwise-independent Gaussian log-density, summed over the last axis."""
    var = torch.clamp(var, min=1e-38)
    z = (x - mean) ** 2 / var
    return -0.5 * torch.sum(z + torch.log(var) + _LOG_2PI, dim=-1)


def cond_spd(a: torch.Tensor) -> torch.Tensor:
    """Condition number of an SPD matrix via ``eigvalsh`` (diagnostic only)."""
    ev = torch.linalg.eigvalsh(symmetrize(a))
    return torch.abs(ev[..., -1]) / torch.clamp(torch.abs(ev[..., 0]), min=1e-38)


def cond_spd_power(
    a: torch.Tensor, chol_l: Optional[torch.Tensor] = None, iters: int = 24
) -> torch.Tensor:
    """Fast cond₂(a) estimate for SPD ``a`` (..., n, n): ``iters`` rounds of
    power iteration for λmax and Cholesky inverse iteration for λmin, from
    the JAX package's deterministic start (the diagonal plus a ramp), so the
    two agree to f32 rounding. Pass ``chol_l`` when a factor of ``a`` is in
    hand; otherwise one is taken with a tiny fixed jitter."""
    a = symmetrize(a)
    n = a.shape[-1]
    if chol_l is None:
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        tr = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        chol_l = chol_nojitter(a + (1e-10 / n) * tr * eye)
    v = torch.diagonal(a, dim1=-2, dim2=-1) + torch.arange(
        1, n + 1, dtype=a.dtype, device=a.device
    )
    w = v
    for _ in range(iters):
        v = (a @ v.unsqueeze(-1)).squeeze(-1)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)
        w = chol_solve(chol_l, w)
        w = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-30)
    lam_max = torch.sum(v * (a @ v.unsqueeze(-1)).squeeze(-1), dim=-1)
    lam_min = torch.sum(w * (a @ w.unsqueeze(-1)).squeeze(-1), dim=-1)
    return torch.clamp(torch.abs(lam_max) / torch.clamp(torch.abs(lam_min), min=1e-38), min=1.0)
