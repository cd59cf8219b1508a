"""Robust SPD linear algebra: the parts of ``particle_filters_tpu/core/linalg.py``
that the SIR path calls.

The JAX module's unrolled and blocked Cholesky/TRSM machinery works around
XLA:TPU's serial ``cholesky``; ``torch.linalg`` needs no such workaround, so
only the API is ported.
"""

from __future__ import annotations

import torch


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    """0.5 (A + Aᵀ)."""
    return 0.5 * (a + a.transpose(-1, -2))


def chol_with_jitter(
    a: torch.Tensor,
    jitter: float = 0.0,
    max_tries: int = 6,
    initial: float = 1e-9,
    factor: float = 10.0,
) -> torch.Tensor:
    """Cholesky factor of an SPD matrix with a jitter ladder.

    The rungs ``jitter`` then ``jitter + initial·factor^k`` are factorized in
    one batched ``cholesky_ex`` call; the first rung that factorizes wins.
    A failed rung's factor is set to NaN, so if every rung fails the
    (non-finite) base attempt is returned, as in the JAX package.
    """
    a = symmetrize(a)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    rungs = [jitter] + [jitter + initial * factor**k for k in range(max_tries)]
    eps = torch.tensor(rungs, dtype=a.dtype, device=a.device).reshape(
        (-1,) + (1,) * a.ndim
    )
    stacked = a.unsqueeze(0) + eps * eye  # (R, ..., n, n)
    Ls, info = torch.linalg.cholesky_ex(stacked)
    failed = (info != 0).reshape(info.shape + (1, 1))
    Ls = torch.where(failed, torch.full_like(Ls, float("nan")), Ls)
    ok = torch.isfinite(Ls).flatten(1).all(dim=1)
    idx = torch.argmax(ok.to(torch.int32))  # first finite rung; 0 if none
    return Ls[idx]
