"""Blockwise (memory-bounded) Sinkhorn-OT resampling for large N (PyTorch
port of ``particle_filters_tpu/resampling/ot_blockwise.py``).

The same damped dual Sinkhorn as ``resampling/ot.py`` without ever forming
the N×N cost matrix (17 GB at N = 65536):

- a cost block C[:, j-block] = ‖xᵢ‖² − 2 xᵢ·xⱼ + ‖xⱼ‖² is rebuilt from the
  particles by one (N, d)×(d, B) product a block;
- each c-transform half-update is a logsumexp streamed over column blocks
  with a running (max, sum) pair, the flash-attention recurrence;
- the barycentric projection streams the transport plan by row blocks.

Memory is O(N·block + N·d). The loops are Python loops, so autograd
differentiates through them (it keeps each block's temporaries: use it at
small N). It equals the dense path to f32 rounding. N need not be a
multiple of ``block``: the padded log-masses are −inf, and the running max
starts from the first block, which always holds a real particle, so no
−inf − (−inf) arises in values or gradients. The cost products run in full
f32 on the card only with TF32 off, which the caller sets.
"""

from __future__ import annotations

import math

import torch

from particle_filters_tpu_torch.core.weights import uniform_logw
from particle_filters_tpu_torch.resampling.soft import log_normalize_lastaxis


def _pad_to_blocks(x: torch.Tensor, block: int, fill: float):
    """``x`` padded along its first axis to a multiple of ``block`` with
    ``fill``, and the unpadded length."""
    n = x.shape[0]
    pad = (-n) % block
    if pad == 0:
        return x, n
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)]), n


def _cost_block(q, q_sq, kb, kb_sq):
    """C between the rows of ``q`` and the rows of ``kb``, clamped at 0."""
    return torch.clamp(q_sq[:, None] - 2.0 * (q @ kb.T) + kb_sq[None, :], min=0.0)


def _streaming_lse_rows(q, q_sq, keys, keys_sq, pot, logmass, epsilon, block):
    """For every row i of ``q``: logsumexp_j [logmass_j + (pot_j − C_ij)/ε],
    streamed over column blocks of ``keys`` (padded to blocks; padded
    ``logmass`` is −inf) without forming C. Returns (Nq,)."""
    m = s = None
    for lo in range(0, keys.shape[0], block):
        sl = slice(lo, lo + block)
        t = logmass[None, sl] + (pot[None, sl] - _cost_block(q, q_sq, keys[sl], keys_sq[sl])) / epsilon
        bm = torch.amax(t, dim=1)
        if m is None:  # the first block holds a real column: bm is finite
            m, s = bm, torch.sum(torch.exp(t - bm[:, None]), dim=1)
            continue
        m_new = torch.maximum(m, bm)
        # rescale the running sum to the new max (flash-attention recurrence)
        s = s * torch.exp(m - m_new) + torch.sum(torch.exp(t - m_new[:, None]), dim=1)
        m = m_new
    return m + torch.log(torch.clamp(s, min=1e-30))


def sinkhorn_ot_resample_blockwise(
    particles: torch.Tensor,
    weights: torch.Tensor,
    *,
    epsilon: float = 0.1,
    n_iters: int = 50,
    damping: float = 0.5,
    block: int = 512,
    min_val: float = 1e-12,
):
    """Entropy-regularized OT resampling without forming the N×N cost.

    The semantics of ``resampling.ot.sinkhorn_ot_resample`` (damped dual
    c-transforms, barycentric projection divided by the target mass
    b_j = 1/N, uniform output weights); memory O(N·block).
    """
    n, d = particles.shape
    dtype = particles.dtype

    w = torch.clamp(weights, min=min_val)
    a = w / torch.sum(w)
    log_a = torch.log(a)
    log_b = torch.full((n,), -math.log(n), dtype=dtype, device=particles.device)

    x, _ = _pad_to_blocks(particles, block, 0.0)
    la, _ = _pad_to_blocks(log_a, block, -math.inf)
    lb, _ = _pad_to_blocks(log_b, block, -math.inf)
    n_pad = x.shape[0]
    x_sq = torch.sum(x * x, dim=1)

    f = torch.zeros((n_pad,), dtype=dtype, device=particles.device)
    g = torch.zeros_like(f)
    for _ in range(n_iters):
        f = (1.0 - damping) * f + damping * (
            -epsilon * _streaming_lse_rows(x, x_sq, x, x_sq, g, lb, epsilon, block))
        g = (1.0 - damping) * g + damping * (
            -epsilon * _streaming_lse_rows(x, x_sq, x, x_sq, f, la, epsilon, block))

    # Barycentric projection x'_j = Σ_i P_ij x_i / b_j, streamed over row
    # blocks: P_ij = exp(log a_i + log b_j + (f_i + g_j − C_ij)/ε).
    num = torch.zeros((n_pad, d), dtype=dtype, device=particles.device)
    for lo in range(0, n_pad, block):
        sl = slice(lo, lo + block)
        Cb = _cost_block(x[sl], x_sq[sl], x, x_sq)  # (B, N_pad)
        P = torch.exp(la[sl, None] + lb[None, :] + (f[sl, None] + g[None, :] - Cb) / epsilon)
        num = num + P.T @ x[sl]
    # Divide by the target mass b_j = 1/N, as the dense path does, not by
    # the empirical column sum (they differ before full convergence).
    return (num * n)[:n], torch.exp(log_b)


def ot_resample_blockwise(
    generator,
    particles: torch.Tensor,
    log_weights: torch.Tensor,
    *,
    epsilon: float = 0.1,
    n_iters: int = 50,
    damping: float = 0.5,
    block: int = 512,
):
    """The shared resampler interface (the generator is unused)."""
    del generator
    logw_n, _ = log_normalize_lastaxis(log_weights)
    new_p, _ = sinkhorn_ot_resample_blockwise(
        particles, torch.exp(logw_n), epsilon=epsilon, n_iters=n_iters,
        damping=damping, block=block,
    )
    return new_p, uniform_logw(particles.shape[0], log_weights.dtype, log_weights.device)
