"""A rank's row block of a padded mesh or field.

Port of `disco4est_tpu/parallel/sharding.py` (the MPI-partition role): the
JAX package shards every element-major array over one device-mesh axis
"e"; here each rank takes its own block of rows, [rank·B, (rank+1)·B) with
B = rows / ranks, onto its device.  Elements are SFC-ordered, so an equal
block of a padded layout is exactly p4est's (weighted) partition.
"""

from __future__ import annotations

import dataclasses

from disco4est_tpu_torch.mesh.builder import MeshData
from disco4est_tpu_torch.parallel.repartition import (
    MORTAR_FIELDS,
    element_fields,
)


def _block(n_rows: int, rank: int, n_ranks: int):
    if n_rows % n_ranks != 0:
        raise ValueError(f"{n_rows} elements not divisible by {n_ranks} "
                         "ranks; pad or repartition first")
    B = n_rows // n_ranks
    return slice(rank * B, (rank + 1) * B)


def shard_field(u, rank: int, n_ranks: int, device=None):
    """Rows [rank·B, (rank+1)·B) of an element-major field [n·B, ...]."""
    u = u[_block(u.shape[0], rank, n_ranks)]
    return u.to(device).clone() if device is not None else u.clone()


def shard_mesh_data(mesh: MeshData, rank: int, n_ranks: int,
                    device=None) -> MeshData:
    """The rank's block of every element-major tensor of a (padded) mesh,
    on `device`.  The mortar tables index the whole mesh and are left
    empty: the block serves element-local operators and the halo apply
    (`parallel/halo.py`, which carries the rank's own mortar rows)."""
    blk = _block(mesh.n_elements, rank, n_ranks)
    dev = device if device is not None else mesh.device
    repl = {name: getattr(mesh, name)[blk].to(dev).clone()
            for name in element_fields(mesh)}
    for name in MORTAR_FIELDS:
        t = getattr(mesh, name)
        if t is not None:
            repl[name] = t[:0].to(dev)
    return dataclasses.replace(mesh, **repl)
