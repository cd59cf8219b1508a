"""Blocked inclusive cumulative sum along the last axis (PyTorch port of
``particle_filters_tpu/core/block_cumsum.py``).

The JAX package blocks its cumsum for the TPU's speed; the port blocks it
for determinism. ``torch.cumsum`` of a floating-point CUDA tensor is not
deterministic (PyTorch lists it so): a row scanned whole takes CUB's
decoupled look-back scan, whose additions associate in the order the tiles
finish, and two calls on one input can differ in the last bit. Here the
last axis is cut into rows of 128, each row is scanned by one product with
the 128×128 upper-triangular matrix of ones, and the row totals are
scanned the same way, recursively, then added back as offsets. A matrix
product of fixed shapes gives the same bits on every run (cuBLAS
guarantees it on one GPU architecture and SM count), on the card and on
the CPU. The products and offsets run in f64 and round once at the end, so
the sum is also closer to the exact one than an f32 scan; TF32 settings do
not touch f64 products. Integers take ``torch.cumsum``: exact in any order.
"""

from __future__ import annotations

import torch

_LANES = 128
_ONES_UPPER: dict = {}  # the triangle of ones, one per device


def _ones_upper(device: torch.device) -> torch.Tensor:
    m = _ONES_UPPER.get(device)
    if m is None:
        m = torch.ones((_LANES, _LANES), dtype=torch.float64, device=device).triu_()
        _ONES_UPPER[device] = m
    return m


def _scan(x: torch.Tensor, ones_upper: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    lead = x.shape[:-1]
    rows = -(-n // _LANES)
    pad = rows * _LANES - n
    if pad:
        x = torch.cat([x, x.new_zeros(lead + (pad,))], dim=-1)
    c = x.reshape(lead + (rows, _LANES)) @ ones_upper
    if rows > 1:
        tot = c[..., -1]
        c = c + (_scan(tot, ones_upper) - tot)[..., None]  # each row's exclusive offset
    return c.reshape(lead + (rows * _LANES,))[..., :n]


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of ``x`` along its last axis, the same bits
    on every call: rows of 128 scanned by a product with a triangle of ones,
    in f64, the row totals likewise, recursively."""
    if not x.is_floating_point():
        return torch.cumsum(x, dim=-1)
    return _scan(x.to(torch.float64), _ones_upper(x.device)).to(x.dtype)
