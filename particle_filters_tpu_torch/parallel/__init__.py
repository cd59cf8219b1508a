"""Particle-axis parallelism over ``torch.distributed`` (PyTorch port of
``particle_filters_tpu/parallel``).

The JAX package shards with ``shard_map`` over a mesh ``('batch',
'particles')`` in one process; here one process runs each rank, joined by
a process group, and the filters take that group as ``group`` where the
JAX package's take ``axis_name``. Per-particle propagate and weight are
local; normalization, ESS and moments are collectives
(``core.weights``); the resample's ancestry crosses ranks through an
``all_gather`` or the memory-bounded neighbour exchange. Four filter
families ride it: the general SIR (``sharded.py``), the fused B1 path
(``fused_sharded.py``), the EDH/LEDH flows (``flow_sharded.py``) and
differentiable-PF training (``dpf_sharded.py``). ``launch.py`` starts the
ranks (``run_ranks``) or opens one rank's group (``process_group``).
"""

from particle_filters_tpu_torch.parallel.distributed_resample import (
    all_gather_systematic_resample,
    neighbor_exchange_systematic_resample,
)
from particle_filters_tpu_torch.parallel.dpf_sharded import (
    make_sharded_dpf_train_step,
    sharded_soft_resample,
)
from particle_filters_tpu_torch.parallel.flow_sharded import (
    make_sharded_flow_run,
    shard_flow_state,
)
from particle_filters_tpu_torch.parallel.fused_sharded import (
    make_sharded_fused_init,
    make_sharded_fused_pf,
    make_sharded_fused_run,
    make_sharded_fused_step,
)
from particle_filters_tpu_torch.parallel.launch import process_group, run_ranks
from particle_filters_tpu_torch.parallel.mesh import make_mesh
from particle_filters_tpu_torch.parallel.sharded import make_sharded_pf_run, shard_pf_state

__all__ = [
    "make_mesh",
    "make_sharded_pf_run",
    "shard_pf_state",
    "make_sharded_dpf_train_step",
    "sharded_soft_resample",
    "neighbor_exchange_systematic_resample",
    "all_gather_systematic_resample",
    "make_sharded_fused_pf",
    "make_sharded_fused_init",
    "make_sharded_fused_run",
    "make_sharded_fused_step",
    "make_sharded_flow_run",
    "shard_flow_state",
    "process_group",
    "run_ranks",
]
