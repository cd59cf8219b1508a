"""Linear Gaussian state-space model simulator (PyTorch port of
``particle_filters_tpu/simulators/lgssm.py``).

    x_1 ~ N(0, Σ)
    x_{n+1} = A x_n + B v_n,  v_n ~ N(0, I)
    y_n     = C x_n + D w_n,  w_n ~ N(0, I)

The noise comes from a CPU ``torch.Generator`` seeded with ``seed`` (other
paths than the JAX package's threefry stream, the same on every device);
the recursion itself is :func:`_lgssm_recursion`, which takes the noise, so
tests can inject it. ``LGSSMSimulationResult.to_file``/``from_file`` use the
JAX package's ``.npz`` keys (X, Y, A, B, C, D), so a file written by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from particle_filters_tpu_torch.core.linalg import chol_with_jitter
from particle_filters_tpu_torch.core.structs import as_f32

_KEYS = ("X", "Y", "A", "B", "C", "D")


@dataclasses.dataclass(frozen=True)
class LGSSMParams:
    """System matrices of the LGSSM."""

    A: torch.Tensor  # (nx, nx)
    B: torch.Tensor  # (nx, nv)
    C: torch.Tensor  # (ny, nx)
    D: torch.Tensor  # (ny, nw)
    Sigma: torch.Tensor  # (nx, nx) initial-state covariance


@dataclasses.dataclass(frozen=True)
class LGSSMSimulationResult:
    """Latent states X (N, nx), observations Y (N, ny) and the matrices."""

    X: torch.Tensor
    Y: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    D: torch.Tensor

    def to_file(self, path: str, format: str = "npz", overwrite: bool = False) -> None:
        if format != "npz":
            raise ValueError(f"Unsupported format: {format!r} (only 'npz').")
        target = path if path.endswith(".npz") else f"{path}.npz"
        if os.path.exists(target) and not overwrite:
            raise FileExistsError(f"File already exists: {target}")
        np.savez(target, **{k: getattr(self, k).detach().cpu().numpy() for k in _KEYS})

    save = to_file

    @classmethod
    def from_file(cls, path: str, device="cuda") -> "LGSSMSimulationResult":
        target = path if path.endswith(".npz") else f"{path}.npz"
        with np.load(target) as d:
            return cls(**{k: torch.as_tensor(d[k], device=device) for k in _KEYS})


def _lgssm_recursion(x0, V, W, A, B, C, D):
    """X_1 = x0, X_{n+1} = A X_n + B V_n, Y_n = C X_n + D W_n over the rows
    of V (burn-in + N, nv) and W (N, nw); the first len(V) − N steps are
    burn-in and are dropped."""
    burn_in = V.shape[0] - W.shape[0]
    x = x0
    for v in V[:burn_in]:
        x = A @ x + B @ v
    xs, ys = [], []
    for v, w in zip(V[burn_in:], W):
        xs.append(x)
        ys.append(C @ x + D @ w)
        x = A @ x + B @ v
    return torch.stack(xs), torch.stack(ys)


def simulate_lgssm(
    A, B, C, D, Sigma, N: int, *,
    seed: Optional[int] = None,
    burn_in: int = 0,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> LGSSMSimulationResult:
    """Simulate N steps of the LGSSM after ``burn_in`` discarded steps, with
    the JAX package's validation. The noise is drawn on the host; the
    recursion runs on ``device``, the card unless ``device="cpu"``."""
    if N <= 0:
        raise ValueError("N must be positive.")
    if burn_in < 0:
        raise ValueError("burn_in must be >= 0.")
    A, B, C, D, Sigma = (as_f32(m, device).to(dtype) for m in (A, B, C, D, Sigma))
    nx, nv = B.shape
    ny, nw = D.shape
    if A.shape != (nx, nx):
        raise ValueError(f"A must be ({nx},{nx}), got {tuple(A.shape)}.")
    if C.shape[1] != nx:
        raise ValueError(f"C must have {nx} columns, got {tuple(C.shape)}.")
    gen = torch.Generator(device="cpu").manual_seed(int(seed or 0))
    z0, V, W = (torch.randn(shape, generator=gen, dtype=dtype).to(device)
                for shape in ((nx,), (burn_in + N, nv), (N, nw)))
    x0 = chol_with_jitter(Sigma) @ z0
    X, Y = _lgssm_recursion(x0, V, W, A, B, C, D)
    return LGSSMSimulationResult(X, Y, A, B, C, D)


def lgssm_noise_covs(params: LGSSMParams):
    """Process / measurement covariances Q = BBᵀ, R = DDᵀ for the filters."""
    return params.B @ params.B.T, params.D @ params.D.T
