"""Sharded particle-flow filtering (PyTorch port of
``particle_filters_tpu/parallel/flow_sharded.py``): EDH and LEDH with the
particle axis split over a process group.

The flow and the weight correction are per rank (the tracker's mean and
covariance are replicated); the log-normalizer, ESS and moments are global,
and the ESS-triggered resample gathers the cloud and writes each rank's
slice through B2 (``models/edh_particle_filter.py``'s note). Build the
filter with ``group`` and wrap its ``run`` with
:func:`make_sharded_flow_run`; it serves both ``EDHFlowPF`` and
``LEDHFlowPF`` (LEDH's ``beta_schedule`` passes through).
"""

from __future__ import annotations

from particle_filters_tpu_torch.models.edh_particle_filter import FlowPFState
from particle_filters_tpu_torch.parallel.sharded import particles_group, rank_rows


def shard_flow_state(state: FlowPFState, mesh) -> FlowPFState:
    """This rank's slice of a global ``FlowPFState`` (``mesh`` a
    ``DeviceMesh`` or the particle group). Initialize globally and cut: the
    cloud is the one-device draw, so a sharded run without process noise
    follows the one-device run to float rounding."""
    rows = rank_rows(state.particles.shape[0], particles_group(mesh))
    return FlowPFState(particles=state.particles[rows], weights=state.weights[rows],
                       log_weights=state.log_weights[rows], mean=state.mean, cov=state.cov,
                       diagnostics=state.diagnostics)


def make_sharded_flow_run(pf, mesh=None, **run_kwargs):
    """``run(generator, state0, tracker_state0, zs) -> (final, ts, hist)``
    of this rank's shard; ``pf`` an ``EDHFlowPF`` or ``LEDHFlowPF`` built
    with ``group``, ``run_kwargs`` (``process_noise_sampler``, LEDH's
    ``beta_schedule``) forwarded to ``pf.run``. The tracker state and the
    history are replicated."""
    if getattr(pf, "group", None) is None:
        raise ValueError("flow filter must be constructed with group=<the particle "
                         "axis's process group>.")
    if mesh is not None and particles_group(mesh) is not pf.group:
        raise ValueError("pf.group is not the mesh's particle group.")

    def run(generator, state0, tracker_state0, zs):
        return pf.run(generator, state0, tracker_state0, zs, **run_kwargs)

    return run
