"""Sharded SIR particle filtering (PyTorch port of
``particle_filters_tpu/parallel/sharded.py``).

A :class:`~particle_filters_tpu_torch.models.particle_filter.ParticleFilter`
built with ``group`` (the particle axis's process group, the counterpart of
``axis_name='particles'``) runs on every rank of it, each rank holding its
N/S particles: propagate and weight are local, the log-normalizer, ESS and
moments are global (``core.weights`` with the group), and the ESS-triggered
systematic resample is the global one, all-gather or neighbour exchange
(``parallel/distributed_resample.py``). Where JAX wraps ``pf.run`` in
``shard_map``, each rank here calls the returned ``run`` on its shard.
"""

from __future__ import annotations

from particle_filters_tpu_torch.core import comm
from particle_filters_tpu_torch.core.structs import PFState


def particles_group(mesh_or_group):
    """The particle axis's process group of a ``DeviceMesh`` (its
    ``"particles"`` dim), or the group itself."""
    if hasattr(mesh_or_group, "get_group"):
        return mesh_or_group.get_group("particles")
    return mesh_or_group


def rank_rows(n_global: int, group):
    """This rank's rows [r·n, (r+1)·n) of ``n_global`` split over ``group``."""
    s = comm.size(group)
    if n_global % s:
        raise ValueError(f"{n_global} particles must divide over {s} ranks.")
    n = n_global // s
    return slice(comm.rank(group) * n, (comm.rank(group) + 1) * n)


def shard_pf_state(state: PFState, mesh) -> PFState:
    """This rank's slice of a global ``PFState`` (particles and log-weights;
    the moments and t are replicated). ``mesh`` is a ``DeviceMesh`` or the
    particle group."""
    rows = rank_rows(state.particles.shape[0], particles_group(mesh))
    return PFState(particles=state.particles[rows].contiguous(),
                   log_weights=state.log_weights[rows].contiguous(),
                   mean=state.mean, cov=state.cov, t=state.t)


def make_sharded_pf_run(pf, mesh=None):
    """``run(generator, state0, zs, us=None) -> (final, history)`` of this
    rank's shard; ``pf`` must have been built with ``group`` (``mesh``'s
    particle group, when a mesh is given). The history is replicated."""
    if pf.group is None:
        raise ValueError("ParticleFilter must be constructed with group=<the particle "
                         "axis's process group>.")
    if mesh is not None and particles_group(mesh) is not pf.group:
        raise ValueError("pf.group is not the mesh's particle group.")

    def run(generator, state0, zs, us=None):
        return pf.run(generator, state0, zs, us)

    return run
