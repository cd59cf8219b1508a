"""The few collectives the multi-device layer is built from, over a
``torch.distributed`` process group (the port's counterpart of a mesh
axis name). ``group=None`` means one device everywhere in the package; these
helpers take ``group=None`` as one device too: the sums, maxima and
gathers are then the identity, rank 0 of 1.

Sums are taken by an ``all_gather`` and a sum in rank order, not by
``all_reduce``: every rank then holds the same bits, whatever algorithm the
backend picks, so a branch taken on the host from a sum (the resample
trigger) is taken alike on every rank and their collectives stay matched.
The operands are scalars and moment rows, so the gather costs no more than
the reduce. A maximum is exact and goes through ``all_reduce(MAX)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (all
    ranks' ``x`` of one shape)."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ranks of ``x``, added in rank order: the same bits on every rank."""
    return x if group is None else all_gather_cat(x[None], group).sum(0)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
    return out


def rank_stream(generator, group, device):
    """This rank's own generator: ``generator`` itself without a group;
    with one, a generator seeded from one draw of the replicated
    ``generator`` (the same draw on every rank) and the rank."""
    if group is None:
        return generator
    seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device).item())
    seed = (seed + (rank(group) + 1) * 0x9E3779B97F4A7C15) % 2**64
    return torch.Generator(device=device).manual_seed(seed)


def shift(x: torch.Tensor, group, off: int) -> Optional[torch.Tensor]:
    """The ``x`` of rank ``r + off`` on rank r, or None where that rank does
    not exist (no wrap-around): the counterpart of the JAX package's
    ``lax.ppermute`` ring, by ``batch_isend_irecv``. Every rank's ``x`` has
    one shape; ``off = 0`` returns ``x`` itself without a copy."""
    if off == 0:
        return x
    r, s = rank(group), size(group)
    src, dst = r + off, r - off
    x = x.contiguous()
    out = torch.empty_like(x) if 0 <= src < s else None
    ops = []
    if 0 <= dst < s:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
    if out is not None:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _AllGatherGrad(torch.autograd.Function):
    """``all_gather_cat`` whose gradient is the all-reduced gradient's slice
    of this rank: every rank uses the gathered tensor in its own way, so the
    gradient of its rows is the sum of all ranks'."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad.narrow(ctx.dim, rank(ctx.group) * ctx.n, ctx.n), None, None


def all_gather_grad(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Differentiable ``all_gather_cat`` (see ``_AllGatherGrad``)."""
    return x if group is None else _AllGatherGrad.apply(x, group, dim)


class _SumToReplicated(torch.autograd.Function):
    """``psum`` whose gradient passes through unchanged: for a sum that feeds
    only a loss computed alike on every rank, each rank's rows then get the
    loss's gradient once."""

    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum_to_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumToReplicated.apply(x, group)
