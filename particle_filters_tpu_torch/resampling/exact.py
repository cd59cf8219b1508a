"""Exact systematic child-run ends past the float32 N = 2²⁴ ceiling (PyTorch
port of ``particle_filters_tpu/resampling/exact.py``).

Past 2²⁴ the f32 product M·cdf_j loses unit spacing, and no floating
cumsum is the same on two backends. The JAX package's quantized-integer
convention fixes both, and this module computes the same integers:

1.  q_i = round(w_i · 2^(64 − e_max − e2)) (round half to even), where
    e_max is the f32 exponent of max(w) and e2 the f32 exponent of the
    exact integer total V of the coarse quantization round(w_i·2^(24−e_max)),
    rendered by the fixed Horner evaluation of its three 15-bit digits.
    The scale is a power of two, so every float step is exact.
2.  Q_j = Σ_{i≤j} q_i, Q_total = Q_{N−1} (about 2⁴⁰).
3.  U = min(⌊round(u·2²⁴)·Q_total / 2²⁴⌋, Q_total − 1), and the run ends
    t_j = ⌊(M·Q_j + Q_total − 1 − U) / Q_total⌋, clamped to [0, M].

The JAX package carries these integers in 15-bit int32 limbs and divides by
a double-single reciprocal estimate with an exact correction. Here they are
torch int64: q_i ≤ 2⁴³ and Q_total < 2⁴⁴ (section "bounds" below), so
``cumsum`` is exact and, integer addition being associative, the card and
the CPU agree by construction. Only M·Q_j (up to 2⁷¹ at M = 2²⁷) and
n_u·Q_total (up to 2⁶⁸) overflow one int64; each is taken as an exact split
(:func:`_floor_mul_div`, :func:`exact_u`). The running maximum that the f32
path applies to its cdf is not needed: integer sums cannot descend.

Every function works on weights of shape (..., N), one convention per row;
the JAX package's are 1-D.

With a process group (``parallel/distributed_resample.py``) each rank
quantizes its slice on the global grid: e_max from an ``all_reduce(MAX)``
of the largest weight, V from a sum over ranks of the int64 coarse totals
(exact, so the same for any layout), and the ranks' slices of Q offset by
their exclusive int64 shard totals: the same integers as the one-device
call on the gathered weights.

Bounds: the coarse integers are < 2²⁵ with the largest ≥ 2²⁴, so e2 ≥ 24
and q_i ≤ 2⁴¹ (the clamp at 2⁴³ is the JAX package's); Σ w·scale ≤
2⁴¹·(V + N/2)/V, which is < 2⁴⁴ for N ≤ 2²⁷.
"""

from __future__ import annotations

import torch

from particle_filters_tpu_torch.core import comm

EXACT_THRESHOLD = 1 << 24  # hard.py switches to this path above 2^24
_M_MAX = 1 << 27  # largest supported output count M
_MASK15 = (1 << 15) - 1


def _f32_exponent(x: torch.Tensor) -> torch.Tensor:
    """IEEE exponent of a positive normal f32 (exact bit extraction), int32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


def _pow2i(e: torch.Tensor) -> torch.Tensor:
    """Exact f32 2^e from an int32 exponent (bit construction)."""
    e = torch.clamp(e, -126, 127).to(torch.int32)
    return ((e + 127) << 23).contiguous().view(torch.float32)


def clean_weights(weights: torch.Tensor) -> torch.Tensor:
    """f32, nonnegative, finite: the input contract of the quantizer."""
    w = weights.to(torch.float32)
    return torch.clamp(torch.where(torch.isfinite(w), w, torch.zeros_like(w)), min=0.0)


def weight_scale_pow2(e_max: torch.Tensor, v_total: torch.Tensor) -> torch.Tensor:
    """The convention's exact power-of-two scale 2^(64 − e_max − e2).

    ``e2`` is the f32 exponent of the int64 total ``v_total`` rendered from
    its 15-bit digits v₂, v₁, v₀ by the JAX package's fixed Horner
    evaluation ((v₂·2¹⁵ + v₁)·2¹⁵ + v₀, rounded in f32 after each add): the
    rendering's rounding is part of the convention."""
    base = 32768.0
    v0 = (v_total & _MASK15).to(torch.float32)
    v1 = ((v_total >> 15) & _MASK15).to(torch.float32)
    v2 = (v_total >> 30).to(torch.float32)
    vf = (v2 * base + v1) * base + v0
    e2 = _f32_exponent(torch.clamp(vf, min=1.0))
    return _pow2i(64 - e_max - e2)


def quantize_weights(weights: torch.Tensor, group=None) -> torch.Tensor:
    """The convention's int64 integers q_i = round(w_i·2^(64 − e_max − e2)),
    along the last axis; with ``group``, this rank's slice of those of the
    weights of every rank (1-D)."""
    w = clean_weights(weights)
    w_max = comm.pmax(torch.amax(w, dim=-1, keepdim=True), group)
    e_max = _f32_exponent(torch.clamp(w_max, min=2.0**-40))
    coarse = torch.round(w * _pow2i(24 - e_max)).to(torch.int64)  # < 2^25: exact
    v_total = comm.psum(coarse.sum(dim=-1, keepdim=True), group)
    r = w * weight_scale_pow2(e_max, v_total)  # times a power of two: exact
    r = torch.clamp(torch.where(torch.isfinite(r), r, torch.zeros_like(r)), 0.0, 2.0**43)
    return torch.round(r).to(torch.int64)  # half to even, as the JAX limb split


def exact_u(u: torch.Tensor, q_total: torch.Tensor) -> torch.Tensor:
    """U = min(⌊round(u·2²⁴)·Q_total / 2²⁴⌋, Q_total − 1): u on the Q_total
    grid, exactly. With Q_total = q_h·2²⁴ + q_l the product splits into
    n_u·q_h + ⌊n_u·q_l / 2²⁴⌋, both terms inside int64."""
    n_u = torch.round(u.to(torch.float32) * 2.0**24).to(torch.int64)
    q_h, q_l = q_total >> 24, q_total & ((1 << 24) - 1)
    U = n_u * q_h + ((n_u * q_l) >> 24)
    return torch.minimum(U, q_total - 1)


def _floor_mul_div(m: int, Q: torch.Tensor, q_total: torch.Tensor, off: torch.Tensor):
    """⌊(m·Q + off) / q_total⌋ exactly in int64 for m ≤ 2²⁷, 0 ≤ Q ≤ q_total
    < 2⁴⁶, 0 ≤ off < q_total: with m = m_h·2¹⁴ + m_l, m_h·Q = a·q_total + r
    and the rest r·2¹⁴ + m_l·Q + off < 2⁶¹."""
    m_h, m_l = m >> 14, m & ((1 << 14) - 1)
    a = m_h * Q
    hi, r = a // q_total, a % q_total
    return (hi << 14) + (r * (1 << 14) + m_l * Q + off) // q_total


def exact_run_ends_from_cumsum(
    Q: torch.Tensor, q_total: torch.Tensor, U: torch.Tensor, m: int
) -> torch.Tensor:
    """t_j = ⌊(m·Q_j + Q_total − 1 − U) / Q_total⌋, clamped to [0, m], int32.
    ``q_total`` and ``U`` broadcast against ``Q`` (keep the last axis)."""
    if m > _M_MAX:
        raise ValueError(f"exact resampling supports M <= 2^27; got {m}.")
    t = _floor_mul_div(m, Q, q_total, q_total - 1 - U)
    return torch.clamp(t, 0, m).to(torch.int32)


def exact_child_run_ends_u(weights: torch.Tensor, m: int, u: torch.Tensor) -> torch.Tensor:
    """The exact run ends of weights (..., N) with M outputs for the given u
    (one per row): bit-identical to the JAX package's
    ``exact_child_run_ends`` for the same weights, M and u."""
    if m > _M_MAX:
        raise ValueError(f"exact resampling supports M <= 2^27; got {m}.")
    Q = torch.cumsum(quantize_weights(weights), dim=-1)
    q_total = Q[..., -1:]
    U = exact_u(torch.as_tensor(u, device=weights.device)[..., None], q_total)
    return exact_run_ends_from_cumsum(Q, q_total, U, m)


def exact_child_run_ends(generator, weights: torch.Tensor, m: int) -> torch.Tensor:
    """:func:`exact_child_run_ends_u` with u ~ U[0, 1) from ``generator``,
    one per row."""
    u = torch.rand(weights.shape[:-1], generator=generator, dtype=torch.float32,
                   device=weights.device)
    return exact_child_run_ends_u(weights, m, u)
