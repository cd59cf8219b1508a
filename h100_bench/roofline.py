"""The card's peaks and the work each operation needs at a cell's shapes,
from which the per-layer readers take their shares of the roofline.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s of
float32 outside the tensor cores (the programs run float32 with TF32 off).
Bytes count each input read once and each output written once; operations
count what the algorithm the configuration states needs, whatever an
implementation reads again or recomputes. The least time is the larger of
the two.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
F32 = 4


def least_s(nbytes: float, ops: float = 0.0) -> float:
    """The least time the card could take: bytes at the HBM's rate or the
    operations at the float32 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def b1_bytes(n: int, nx: int = 1) -> int:
    """One propagate-and-weight step over n particles: the particles and
    log-weights read and written."""
    return 2 * F32 * (nx + 1) * n


def resample_bytes(rows: int, d: int) -> int:
    """Systematic resampling of ``rows`` rows of width d, as kernel B2 does
    it: the particles read and the resampled particles written, one int32
    start a row read (the same bytes as one float32 weight a row)."""
    return F32 * rows * (2 * d + 1)


def ledh_ops(particles: int, d: int) -> float:
    """One LEDH λ-step of one particle with a dense d×d Jacobian, in the
    Woodbury form: W = HᵀR⁻¹H (two products), two Cholesky factors, one
    triangular solve with d right-hand sides, YᵀY and P·G."""
    return particles * (4 + 2 / 3 + 1 + 2 + 2) * d**3


def edh_ops(trials: int, particles: int, d: int) -> float:
    """One EDH λ-step: the flow matrices once a trial (H P Hᵀ, the Cholesky of
    S, S⁻¹H, P Hᵀ and the product A) and one d×d affine map a particle."""
    return trials * (4 + 1 / 3 + 2 + 2 + 2) * d**3 + trials * particles * 2 * d * d


def flow_weight_ops(particles: int, d: int) -> float:
    """The weight correction of one step a particle: two Gaussian densities,
    each a d×d triangular product."""
    return particles * 2 * 2 * d * d
