"""The torch prep of the windowed resample probes X1 and X2.

Ports the gather-free prep of ``particle_filters_tpu/ops/resample_pallas.py``
that the probes ``benchmarks/exp_kernel_var.py`` (X1) and
``benchmarks/exp_resample_dma.py`` (X2) feed their kernels with. Outputs are
cut into sub-groups of ``SUB`` = 128 consecutive positions and particles into
fine chunks of 128; a sub-group's ancestors lie in a few consecutive fine
chunks, starting at chunk ``a0``:

- :func:`leading_starts`: ``scf[m] = starts[128·m]``, the fine chunks'
  leading starts, padded past N with 2**30;
- :func:`rank_window` (``_rank_window``): ``(a0, a_hi)``, the fine chunks of
  each sub-group's first and last ancestor, by one scatter and a cumsum
  (``torch.cumsum`` where the JAX package has ``blocked_cumsum``; the ranks
  are integers, so they are equal);
- :func:`fine_chunks` (``_blocked_pallas_path:171-192``): the (rows, 128)
  starts as f32 with sentinel ``big`` past N, the telescoping particle
  differences ``p[j] − p[j−1]``, and the chunk bases ``p[128·m − 1]``, with
  ``extra`` sentinel rows past the last chunk.

Positions and starts are compared in f32, exact below 2**24.
"""

from __future__ import annotations

import torch

SUB = 128  # outputs per sub-group = particles per fine chunk
_PAD_START = 2**30  # the JAX package's pad of the ragged last chunk


def leading_starts(starts: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """``starts[128·m]`` for m < ``n_chunks``, 2**30 past the end (int32)."""
    pad = n_chunks * SUB - starts.shape[0]
    starts_pad = torch.cat([starts, starts.new_full((pad,), _PAD_START)])
    return starts_pad.view(n_chunks, SUB)[:, 0]


def rank_window(scf: torch.Tensor, n_subs_pad: int):
    """Fine chunks ``(a0, a_hi)`` (int32, (n_subs_pad,)) of each
    sub-group's first and last ancestor, ranked among the sorted leading
    starts ``scf``:

        rank_hi[s] = #{scf ≤ 128·s + 127} = #{⌊scf/128⌋ ≤ s}
        rank_lo[s] = #{scf ≤ 128·s}       = rank_hi[s−1] + #{scf = 128·s}
        a0 = max(rank_lo − 1, 0),  a_hi = rank_hi − 1
    """
    scf_cl = scf.clamp(0, n_subs_pad * SUB)  # sentinels -> top bucket
    c_hi = (scf_cl // SUB).long()
    aligned = (scf_cl % SUB == 0).to(torch.int32)
    marks = torch.zeros((n_subs_pad + 1, 2), dtype=torch.int32, device=scf.device)
    marks.index_add_(0, c_hi, torch.stack([torch.ones_like(aligned), aligned], dim=1))
    rank_hi = torch.cumsum(marks[:, 0], dim=0, dtype=torch.int32)
    rank_lo = torch.cat([rank_hi.new_zeros(1), rank_hi[:-1]]) + marks[:, 1]
    a0 = torch.clamp(rank_lo[:-1] - 1, min=0)
    a_hi = rank_hi[:-1] - 1
    return a0, a_hi


def fine_chunks(starts: torch.Tensor, particles: torch.Tensor, n_subs_pad: int,
                extra: int):
    """``(starts_f, diffs, chunk_base)`` of ``ceil(N/128) + extra`` rows:
    starts_f (rows, 128) f32 with ``big = 128·n_subs_pad + 256`` past N,
    diffs (rows, 128·d) f32 with ``diffs[j] = p[j] − p[j−1]`` (p[−1] = 0,
    zeros past N), chunk_base (rows, d) f32 with ``chunk_base[m] =
    p[128·m − 1]`` (row 0 and rows past N: 0)."""
    n, d = particles.shape
    n_fc_ext = -(-n // SUB) + extra
    pad = n_fc_ext * SUB - n
    big = float(n_subs_pad * SUB + 256)
    starts_f = torch.cat(
        [starts.to(torch.float32), starts.new_full((pad,), big, dtype=torch.float32)]
    ).view(n_fc_ext, SUB)
    p = particles.to(torch.float32)
    zeros = p.new_zeros((pad, d))
    prev = torch.cat([p.new_zeros((1, d)), p[:-1]])
    diffs = torch.cat([p - prev, zeros]).view(n_fc_ext, SUB * d)
    p_pad = torch.cat([p, zeros]).view(n_fc_ext, SUB, d)
    chunk_base = torch.cat([p.new_zeros((1, d)), p_pad[:-1, SUB - 1, :]])
    return starts_f, diffs, chunk_base
