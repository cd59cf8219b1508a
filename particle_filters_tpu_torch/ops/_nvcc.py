"""Build CUDA sources of this package with ``nvcc`` into a shared library
with a plain C interface, load it with ``ctypes``, and launch its kernels.

The library goes to ``build/torch_kernels/`` beside the package, under a
name keyed on a hash of the flags, the sources and the shared headers
(``csrc/*.cuh``), so an edit of either rebuilds and an unchanged tree reuses
the previous build. Nothing is built at import: the
first call of a kernel's wrapper on a CUDA tensor builds it.

Every entry point has one C shape, ``int symbol(args..., cudaStream_t)``,
returning a CUDA error code; a wrapper holds a :class:`Kernel` and calls it
with the device and the arguments, which is the one place that sets the
signature, enters the device, passes its stream and turns an error into an
exception.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit.")
    return found


def build_key(*sources: str) -> str:
    """The hash that names a build: the flags, ``csrc/<sources>`` and every
    header ``csrc/*.cuh`` (a source may include any of them), by name and
    bytes."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / s for s in sources] + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return digest.hexdigest()[:16]


@functools.cache
def load_library(name: str, *sources: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>`` from ``csrc/<sources>``."""
    paths = [CSRC / s for s in sources]
    lib_path = BUILD_DIR / f"lib{name}_{build_key(*sources)}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {name}:\n{res.stderr}"
            )
        os.replace(tmp, lib_path)  # atomic: a concurrent build never loads a partial file
    return ctypes.CDLL(str(lib_path))


@functools.cache
def _entry(lib, symbol: str, argtypes: tuple):
    fn = getattr(lib, symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]  # the stream last
    fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def on_device(device):
    """Enter ``device`` and yield its current stream's handle."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream().cuda_stream


@dataclass(frozen=True)
class Kernel:
    """The entry point ``symbol`` of ``lib<library>`` built from
    ``csrc/<sources>``, taking ``argtypes`` and then the stream; ``name``
    says which kernel failed."""

    name: str
    library: str
    sources: tuple
    symbol: str
    argtypes: tuple

    def entry(self):
        """The loaded entry point (built if needed), its signature set once."""
        return _entry(load_library(self.library, *self.sources), self.symbol, self.argtypes)

    def __call__(self, device, *args) -> None:
        """Launch on ``device``'s current stream; raise on a CUDA error."""
        fn = self.entry()
        with on_device(device) as stream:
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}.")
