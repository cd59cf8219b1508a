"""1-D stochastic volatility model simulator (PyTorch port of
``particle_filters_tpu/simulators/stochastic_volatility.py``).

Model:

    X_1 ~ N(0, σ² / (1 − α²))         (stationary init, unless x0 given)
    X_t = α X_{t−1} + σ V_t,          V_t ~ N(0, 1)
    Y_t = β exp(X_t / 2) W_t,         W_t ~ N(0, 1)

The noise comes from a ``torch.Generator`` (Philox on CUDA), so a seed gives
other paths than the JAX package's threefry stream; the recursion itself is
:func:`_sv_recursion`, which takes the noise, so tests can inject it.
``SV1DResults.save``/``load`` use the JAX package's ``.npz`` keys, so a file
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SV1DParams:
    alpha: float  # AR(1) coefficient, |alpha| < 1
    sigma: float  # state noise std >= 0
    beta: float  # observation scale >= 0


@dataclasses.dataclass(frozen=True)
class SV1DResults:
    """X (n,), Y (n,) plus the generating parameters."""

    X: torch.Tensor
    Y: torch.Tensor
    alpha: float = 0.0
    sigma: float = 0.0
    beta: float = 0.0
    n: int = 0
    seed: Optional[int] = None

    def save(self, filename: str) -> None:
        np.savez(
            filename,
            X=self.X.detach().cpu().numpy(),
            Y=self.Y.detach().cpu().numpy(),
            alpha=self.alpha,
            sigma=self.sigma,
            beta=self.beta,
            n=self.n,
            seed=self.seed if self.seed is not None else -1,
        )

    @classmethod
    def load(cls, filename: str, device="cuda") -> "SV1DResults":
        target = filename if filename.endswith(".npz") else f"{filename}.npz"
        with np.load(target) as d:
            seed = int(d["seed"])
            return cls(
                X=torch.as_tensor(d["X"], device=device),
                Y=torch.as_tensor(d["Y"], device=device),
                alpha=float(d["alpha"]),
                sigma=float(d["sigma"]),
                beta=float(d["beta"]),
                n=int(d["n"]),
                seed=None if seed == -1 else seed,
            )


def _sv_recursion(x_init, V, W, alpha, sigma, beta):
    """X_1 = x_init, X_t = α X_{t−1} + σ V_{t−1}; Y = β exp(X/2) W.

    ``V`` holds the n−1 state innovations and ``W`` the n observation
    noises; all three are tensors of one dtype and device.
    """
    alpha_ = torch.as_tensor(alpha, dtype=W.dtype, device=W.device)
    sigma_ = torch.as_tensor(sigma, dtype=W.dtype, device=W.device)
    beta_ = torch.as_tensor(beta, dtype=W.dtype, device=W.device)
    xs = [x_init]
    for v in V:
        xs.append(alpha_ * xs[-1] + sigma_ * v)
    X = torch.stack(xs)
    Y = beta_ * torch.exp(0.5 * X) * W
    return X, Y


def simulate_sv_1d(
    n: int,
    alpha: float,
    sigma: float,
    beta: float,
    *,
    seed: Optional[int] = None,
    x0: Optional[float] = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> SV1DResults:
    """Simulate the 1-D SV model, with the JAX package's input validation
    and stationary initialization. The AR(1) recursion runs on the host
    (n scalar steps) and the result is moved to ``device``, the card
    unless ``device="cpu"``."""
    if n <= 0:
        raise ValueError("n must be positive.")
    if not np.isfinite(alpha) or abs(alpha) >= 1:
        raise ValueError("alpha must be finite with |alpha| < 1 for stationarity.")
    if sigma < 0 or not np.isfinite(sigma):
        raise ValueError("sigma must be a finite, nonnegative scalar.")
    if beta < 0 or not np.isfinite(beta):
        raise ValueError("beta must be a finite, nonnegative scalar.")

    if seed is None:
        seed = 0
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    z0 = torch.randn((), generator=gen, dtype=dtype)
    V = torch.randn((n - 1,), generator=gen, dtype=dtype)
    W = torch.randn((n,), generator=gen, dtype=dtype)

    if x0 is None:
        var0 = max(sigma**2 / (1.0 - alpha**2), 0.0)
        x_init = torch.sqrt(torch.tensor(var0, dtype=dtype)) * z0
    else:
        x_init = torch.tensor(float(x0), dtype=dtype)

    X, Y = _sv_recursion(x_init, V, W, alpha, sigma, beta)
    return SV1DResults(
        X=X.to(device),
        Y=Y.to(device),
        alpha=float(alpha),
        sigma=float(sigma),
        beta=float(beta),
        n=int(n),
        seed=int(seed),
    )


# --- SSM callables for the filters (g, h, log-densities) ------------------
def sv_transition_sample(generator, params: SV1DParams, x):
    """x' = α x + σ v, elementwise over x."""
    v = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    return params.alpha * x + params.sigma * v


def sv_transition_logpdf(params: SV1DParams, x_next, x):
    var = params.sigma**2
    z = (x_next - params.alpha * x) ** 2 / var
    return -0.5 * (z + math.log(var) + math.log(2 * math.pi))


def sv_obs_logpdf(params: SV1DParams, y, x):
    """log p(y|x) with y ~ N(0, β² exp(x))."""
    var = params.beta**2 * torch.exp(x)
    return -0.5 * (y**2 / var + torch.log(var) + math.log(2 * math.pi))
