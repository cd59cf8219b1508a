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

from particle_filters_tpu_torch.ops._nvcc import load_library

TILE = (8, 128)
_LIB = "pf_launch_probe"
_SOURCES = ("launch_probe.cu",)


def add_one_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of X3."""
    return x + 1.0


def _library() -> ctypes.CDLL:
    lib = load_library(_LIB, *_SOURCES)
    fn = lib.pf_add_one
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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
    lib = _library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pf_add_one(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"X3 launch probe failed: CUDA error {err}.")
    add_one.launches += 1
    return out


add_one.launches = 0
