"""Sharded fused path (PyTorch port of
``particle_filters_tpu/parallel/fused_sharded.py``): kernel B1 on each
rank's particles, the ranks' rows folded, B2 writing each rank's slice.

- per rank: one B1 launch over its n = N/S particles as rank r of the
  whole cloud, its Philox counters those of the particles' global indices,
  so S ranks draw the normals one card would (``ops/fused_pf.py``);
- the moments: each rank's partials rows ``all_gather``ed and combined in
  rank order on every rank (``ops.fused_pf.fold_ranks``): the global
  log-normalizer, ESS and moments, the same bits on every rank;
- the ESS-triggered resample: all-gather (the gathered cloud's starts, B2
  writing the rank's slice) or neighbour exchange
  (``parallel/distributed_resample.py``).

In all-gather mode the sharded filter is the one-device filter: the same
initial cloud, the same normals, the same resample steps and ancestry; the
plain version is bit-equal to it where a rank's count is a multiple of the
block, and on the card one rank is (the kernel's own row); more ranks on
the card sum the moments' partials in another order.
Where JAX wraps the filter's methods in ``shard_map``, each rank here
calls the returned functions on its shard.
"""

from __future__ import annotations

from particle_filters_tpu_torch.ops.fused_pf import FusedSIRFilter


def make_sharded_fused_pf(model, Q, *, Np: int, mesh, axis: str = "particles",
                          resample_thresh: float = 0.5, distributed_resample: str = "all_gather",
                          neighbor_radius: int = 2, device="cuda") -> FusedSIRFilter:
    """A :class:`FusedSIRFilter` on ``mesh``'s ``axis`` (a ``DeviceMesh``;
    or a process group). ``Np`` is the global count; it must divide over
    the axis's ranks."""
    group = mesh.get_group(axis) if hasattr(mesh, "get_group") else mesh
    return FusedSIRFilter(model, Q, Np=Np, resample_thresh=resample_thresh, group=group,
                          distributed_resample=distributed_resample,
                          neighbor_radius=neighbor_radius, device=device)


def _sharded(pf: FusedSIRFilter) -> FusedSIRFilter:
    if pf.group is None:
        raise ValueError("pf must be built with make_sharded_fused_pf.")
    return pf


def make_sharded_fused_init(pf: FusedSIRFilter):
    """``init(generator, mean, cov) -> state``: this rank's columns of the
    cloud drawn from the replicated generator."""
    return _sharded(pf).initialize


def make_sharded_fused_run(pf: FusedSIRFilter):
    """``run(generator, state, zs) -> (state, history)`` of this rank's
    shard; the history (global moments, ESS, evidence, the resample and
    exchange flags) is replicated, in the one-device schema."""
    return _sharded(pf).run


def make_sharded_fused_step(pf: FusedSIRFilter):
    """One ``step(generator, state, z) -> (state, info)`` of this rank's shard."""
    return _sharded(pf).step
