"""particle_filters_tpu_torch — the PyTorch / CUDA port of particle_filters_tpu.

Module for module beside the JAX package: ``core``, ``simulators``,
``resampling``, ``models``, ``ops`` and ``utils``, with the hand-written
Hopper kernels under ``ops`` (wrappers) and ``csrc`` (CUDA sources), and the
profiling probes and the filter columns under ``benchmarks``. Its entry points put their tensors on
the card unless given ``device="cpu"``. It imports ``torch`` and never
``jax``, and sets no global torch flags.
"""

from particle_filters_tpu_torch.models import ParticleFilter, PFState
from particle_filters_tpu_torch.ops.fused_pf import FusedSIRFilter
from particle_filters_tpu_torch.simulators import simulate_sv_1d

__all__ = ["FusedSIRFilter", "PFState", "ParticleFilter", "simulate_sv_1d"]
