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


def state_fields(state) -> tuple:
    """A state dataclass's fields as a tuple (no copies), the form
    ``torch.func.vmap`` takes; ``type(state)(*fields)`` rebuilds it."""
    return tuple(getattr(state, f.name) for f in dataclasses.fields(state))


def stack_states(states):
    """Per-trial states of one dataclass stacked on a leading trial axis
    (dict fields stacked key by key)."""

    def stack(vals):
        if isinstance(vals[0], dict):
            return {k: stack([v[k] for v in vals]) for k in vals[0]}
        return torch.stack(vals)

    return type(states[0])(*(stack(vals) for vals in zip(*map(state_fields, states))))


def index_state(state, i: int):
    """Trial ``i`` of a state stacked by :func:`stack_states` (views)."""

    def take(v):
        return {k: take(x) for k, x in v.items()} if isinstance(v, dict) else v[i]

    return type(state)(*(take(v) for v in state_fields(state)))


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
