"""Systematic resampling of a cloud split over ranks (PyTorch port of
``particle_filters_tpu/parallel/distributed_resample.py``), in its two modes.

Rank r holds particles [r·n, (r+1)·n) of N = S·n and their globally
normalized log-weights; after the resample it holds output slots
[r·n, (r+1)·n) of the global systematic resample, with u drawn from the
replicated generator (the same draw on every rank, and the same as the
one-device resample's).

- :func:`all_gather_systematic_resample`: the whole cloud gathered on every
  rank, its N child-run starts, and kernel B2 in its M→n form writing only
  the rank's n outputs (offset r·n). O(N) memory a rank during the step.
- :func:`neighbor_exchange_systematic_resample`: only the ±radius
  neighbouring ranks' particles, exchanged point to point, O((2r+1)·n)
  memory. Each rank computes the run ends of its own particles in global
  coordinates; the pool's starts are its neighbours' run ends, led by the
  run end of the mass before the pool, and B2 merges the (2r+1)·n pooled
  starts with the rank's n outputs. The pool suffices exactly when that
  first start is at most r·n and the pool's last run end at least
  (r+1)·n; the ranks agree on it (``all_reduce(MIN)``) and, where it does
  not, all take the exact all-gather path for the same u, which reports
  ``ok = False``: a pool-sizing signal, never a wrong result.

The run ends: below N = 2²⁴ in f32. In all-gather mode they are the
one-device path's (kernel S on the card). In neighbour mode each rank
takes its cdf from its own weights (``resampling.hard._cdf``, the torch
chain on the card too), the ranks' offsets are their cdfs' last entries
added in rank order, so rank r's last global cdf value is bit for bit rank
r+1's offset and the pooled starts are sorted; the cdf is normalized by the
sum of the shard totals, where the one-device path divides by its last
entry, so an f32 run end may differ by one from the all-gather mode's at a
rare ceil boundary. Past 2²⁴ (or ``exact=True``)
the exact integer convention of ``resampling/exact.py``, quantized on the
global grid: the starts are bit-identical to ``exact_child_run_ends_u`` on
the gathered weights for the same u, at any layout.

The values are copies (B2), where the JAX package telescopes a scatter-add
and a cumsum: the port's values are exact.
"""

from __future__ import annotations

from typing import Optional

import torch

from particle_filters_tpu_torch.core import comm
from particle_filters_tpu_torch.ops.resample import resample_by_starts
from particle_filters_tpu_torch.resampling.exact import (
    EXACT_THRESHOLD,
    exact_run_ends_from_cumsum,
    exact_u,
    quantize_weights,
)
from particle_filters_tpu_torch.resampling.hard import (
    _cdf,
    _child_run_ends_u,
    _uniform,
    _weights_from,
)


def _draw_u(generator, u, like):
    """The resample's u: the one-device path's draw (one f32 of shape (1,))."""
    return _uniform(generator, (1,), like) if u is None else u.reshape(1).to(like)


def all_gather_systematic_resample(generator, particles, logw, *, group, u=None,
                                   exact: Optional[bool] = None, log_z=None):
    """This rank's slice of the global systematic resample, from the
    gathered cloud: ``(new_local_particles, starts)`` with the N global
    starts. ``particles`` (n, d), ``logw`` (n,) log-weights (normalized or
    not: they are normalized over the gathered vector, as the one-device
    path normalizes them); ``u`` (a test hook) replaces the draw. ``log_z``,
    the whole cloud's log-normalizer (the same bits on every rank), is
    passed on as the one-device path takes it: kernel S then reads the
    gathered log-weights in its log domain."""
    n = particles.shape[0]
    p_all = comm.all_gather_cat(particles, group)
    # As the one-device path (``systematic_resample_values_batched``) takes them.
    w_all = comm.all_gather_cat(logw, group)[None]
    if log_z is None:
        w_all = _weights_from(None, w_all)
    else:
        log_z = log_z.reshape(1)
    u = _draw_u(generator, u, w_all)
    t = _child_run_ends_u(w_all, p_all.shape[0], u, exact=exact, log_z=log_z)[0]
    starts = torch.cat([t.new_zeros(1), t[:-1]])
    out = resample_by_starts(p_all, starts, n_out=n, offset=comm.rank(group) * n)
    return out, starts


def _local_run_ends(w_local, u, group, n_total: int, exact: bool):
    """The global run ends of this rank's particles, ``(t_local,
    run_end)``: ``run_end(s)`` is the run end of all mass before rank s
    (0 ≤ s ≤ S), the same value on every rank."""
    s_total = comm.size(group)
    r = comm.rank(group)
    if exact:
        Q = torch.cumsum(quantize_weights(w_local, group), dim=0)
        totals = comm.all_gather_cat(Q[-1:], group)
        offsets = torch.cat([totals.new_zeros(1), torch.cumsum(totals, 0)])
        q_total = offsets[-1:]
        U = exact_u(u, q_total)

        def run_end(s):
            return exact_run_ends_from_cumsum(offsets[s:s + 1], q_total, U, n_total)[0]

        return exact_run_ends_from_cumsum(offsets[r] + Q, q_total, U, n_total), run_end
    cdf = _cdf(w_local)
    totals = comm.all_gather_cat(cdf[-1:], group)
    # Added in rank order, one at a time: offsets[s] + cdf_s[-1] rounds to
    # exactly offsets[s + 1] on every rank, so the global cdf ascends.
    offsets = [totals.new_zeros(())]
    for s in range(s_total):
        offsets.append(offsets[-1] + totals[s])
    total = offsets[-1]

    def ends(c):
        return torch.ceil(n_total * (c / total) - u).clamp_(0.0, n_total).to(torch.int32)

    return ends(offsets[r] + cdf), lambda s: ends(offsets[s])


def neighbor_pool_starts(w_local, u, *, group, radius: int, exact: bool):
    """``(t_local, t_before, ok_local)``: this rank's global run ends, the
    run end of the mass before its pool (its first pooled particle's start)
    and whether the pool of ranks r−radius…r+radius holds every ancestor of
    its output slots."""
    n = w_local.shape[0]
    s_total, r = comm.size(group), comm.rank(group)
    lo, hi = max(0, r - radius), min(s_total - 1, r + radius)
    t_local, run_end = _local_run_ends(w_local, u, group, n * s_total, exact)
    t_before = run_end(lo)
    ok_local = bool(t_before <= r * n) and bool(run_end(hi + 1) >= (r + 1) * n)
    return t_local, t_before, ok_local


def neighbor_exchange_systematic_resample(generator, particles, logw, *, group,
                                          radius: int = 2, exact: Optional[bool] = None,
                                          u=None):
    """Systematic resample of the global cloud, exact by construction:
    ``(new_local_particles, ok)``.

    ``particles`` (n, d) and ``logw`` (n,), globally normalized, are this
    rank's slice. When every ancestor of this rank's output slots lies
    within ``radius`` ranks on every rank (``ok`` True, the common case)
    the values come from the neighbour pool; otherwise every rank takes
    :func:`all_gather_systematic_resample` for the same u. ``exact``: None
    picks f32 up to N = 2²⁴ and the exact integer run ends past it;
    True/False force either (the rescue uses the same). ``u`` (a test
    hook) replaces the draw from the replicated ``generator``.
    """
    n = particles.shape[0]
    s_total, r = comm.size(group), comm.rank(group)
    if exact is None:
        exact = n * s_total > EXACT_THRESHOLD
    w_local = torch.exp(logw)
    u = _draw_u(generator, u, w_local)
    t_local, t_before, ok_local = neighbor_pool_starts(w_local, u, group=group,
                                                       radius=radius, exact=exact)
    ok_all = comm.pmin(torch.tensor([int(ok_local)], dtype=torch.int32,
                                    device=particles.device), group)
    if not bool(ok_all.item()):
        out, _ = all_gather_systematic_resample(None, particles, logw, group=group, u=u,
                                                exact=exact)
        return out, False
    # Every rank takes part in every offset's exchange (the pairs that
    # exist), in one order; it keeps what it received, in rank order.
    vals = [comm.shift(particles, group, o) for o in range(-radius, radius + 1)]
    ends = [comm.shift(t_local, group, o) for o in range(-radius, radius + 1)]
    vals = torch.cat([v for v in vals if v is not None])
    ends = torch.cat([e for e in ends if e is not None])
    starts = torch.cat([t_before.reshape(1).to(torch.int32), ends[:-1]])
    return resample_by_starts(vals, starts, n_out=n, offset=r * n), True

