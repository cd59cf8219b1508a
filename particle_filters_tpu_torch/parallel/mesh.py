"""Mesh construction (PyTorch port of ``particle_filters_tpu/parallel/mesh.py``).

A 2-D ``DeviceMesh`` with dims ``("batch", "particles")`` over the ranks
of the initialized default process group: ``batch`` shards independent
sequences (data parallelism), ``particles`` shards the particle ensemble.
``mesh.get_group("particles")`` is the process group the filters take as
``group``, the counterpart of the JAX package's ``axis_name="particles"``.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_batch: int = 1, n_particles: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``(n_batch, n_particles)`` mesh ``("batch", "particles")`` over the
    default group's ranks, all on the particle axis by default.

    The JAX version may leave devices out of its mesh; here every rank of
    the group runs the same program, so the mesh must hold them all."""
    world = dist.get_world_size()
    if n_particles is None:
        if world % n_batch != 0:
            raise ValueError(f"{world} ranks not divisible by n_batch={n_batch}.")
        n_particles = world // n_batch
    if n_batch * n_particles > world:
        raise ValueError(f"Mesh {n_batch}x{n_particles} needs more than {world} ranks.")
    if n_batch * n_particles < world:
        raise ValueError(f"Mesh {n_batch}x{n_particles} leaves out some of the {world} "
                         "ranks; every rank of the group joins the mesh.")
    return init_device_mesh(device_type, (n_batch, n_particles),
                            mesh_dim_names=("batch", "particles"))
