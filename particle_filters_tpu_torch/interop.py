"""Turn the JAX package's states and constructor inputs, given as numpy
arrays, into this package's, so both packages can start from one state.

- A ``PFState`` (any object with the fields particles, log_weights, mean,
  cov, t) becomes this package's :class:`PFState`.
- A fused carry ``(particles_t, logw, off_u)`` becomes this package's:
  for nx = 1 the JAX (8, N/8) layout is read row-major into (N,); for
  nx > 1 particles stay (nx, N); log-weights become (N,).
- ``Q`` becomes the f32 ``(Q, Lq)`` pair both filters build, with
  ``Lq = cholesky(Q + 1e-10·I)`` taken in numpy as the JAX fused filter does.
"""

from __future__ import annotations

import numpy as np
import torch

from particle_filters_tpu_torch.core.structs import PFState
from particle_filters_tpu_torch.ops.fused_pf import noise_factor


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def state_from_jax(state, *, device="cuda"):
    """A JAX ``PFState`` or fused 3-tuple carry (numpy-convertible leaves)
    as this package's state on ``device`` (the card unless ``"cpu"``)."""
    if isinstance(state, tuple):
        particles_t, logw, off_u = (np.asarray(a, np.float32) for a in state)
        # Log-weights ride (8, N/8) only for nx = 1, a (1, N) row otherwise.
        particles = particles_t.reshape(-1) if logw.shape[0] == 8 else particles_t
        return (
            _t(particles, device),
            _t(logw.reshape(-1), device),
            _t(off_u, device),
        )
    return PFState(
        particles=_t(state.particles, device, np.float32),
        log_weights=_t(state.log_weights, device, np.float32),
        mean=_t(state.mean, device, np.float32),
        cov=_t(state.cov, device, np.float32),
        t=_t(state.t, device, np.int32),
    )


def params_from_jax(Q, *, device="cuda"):
    """``(Q, Lq)`` as f32 tensors, with the JAX fused filter's
    ``Lq = cholesky(Q + 1e-10·I)``."""
    return _t(Q, device, np.float32), _t(noise_factor(Q), device)
