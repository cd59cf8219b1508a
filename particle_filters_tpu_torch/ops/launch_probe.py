"""Probe X3: the floor cost of one kernel launch.

Replaces ``benchmarks/profile_small_n.py::_noop_kernel`` (``out = x + 1`` on
one (8, 128) f32 tile), the launch-floor stage of the small-N step profile
(``benchmarks/profile_small_n.py`` of this package). ``csrc/launch_probe.cu``
launches one block of 1024 threads; the tile is too small for bytes or
operations to matter, so its time is the launch's.
"""

from __future__ import annotations

import ctypes

import torch

from particle_filters_tpu_torch.ops._nvcc import Kernel

TILE = (8, 128)
_KERNEL = Kernel("X3 launch probe", "pf_launch_probe", ("launch_probe.cu",), "pf_add_one",
                 (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int))


def add_one_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of X3."""
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` on an (8, 128) f32 tile.

    A CUDA tensor goes through the kernel; a CPU tensor through its plain
    version. ``add_one.launches`` counts kernel launches.
    """
    if tuple(x.shape) != TILE or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"need a contiguous float32 {TILE} tile; got {tuple(x.shape)} {x.dtype}."
        )
    if x.device.type == "cpu":
        return add_one_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}.")
    out = torch.empty_like(x)
    _KERNEL(x.device, x.data_ptr(), out.data_ptr(), x.numel())
    add_one.launches += 1
    return out


add_one.launches = 0
