"""Distributed execution: one process per rank on `torch.distributed`.

Port of `disco4est_tpu/parallel/` (the reference's MPI program model,
`driver.c:13-313`): `comm` (the process group and the collectives),
`repartition` (node-weighted SFC layouts, field migration, padded meshes),
`sharding` (a rank's row block), `halo` (the halo-exchange SIPG apply) and
`mg` (the shard-resident multigrid).
"""
