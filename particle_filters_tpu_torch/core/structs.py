"""Filter state as plain dataclasses of tensors.

The JAX package registers its dataclasses as pytrees so they flow through
``jit``/``scan``; PyTorch runs eagerly, so a plain dataclass is enough.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def as_f32(a, device) -> torch.Tensor:
    """A tensor, array or nested list as an f32 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(a, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class PFState:
    """Particle posterior (counterpart of ``particle_filters_tpu`` ``PFState``).

    ``log_weights`` are the authoritative representation; the linear
    ``weights`` are derived on read.
    """

    particles: torch.Tensor  # (Np, nx)
    log_weights: torch.Tensor  # (Np,)
    mean: torch.Tensor  # (nx,)
    cov: torch.Tensor  # (nx, nx)
    t: torch.Tensor  # scalar int32

    @property
    def weights(self) -> torch.Tensor:
        """Normalized linear weights (view of ``log_weights``)."""
        return torch.exp(self.log_weights)
