"""Checkpoint / restore.

Port of `disco4est_tpu/io/checkpoint.py` (role of the reference's
`IO/d4est_checkpoint.c` with its two formats, `d4est_checkpoint_type.h:4`):

- `P4EST_H5`-analog: the forest structure (tree/level/anchor arrays), the
  storage degree, nodal fields and a structural checksum, in one
  topology-independent `.npz`;
- `HISTORY`-analog: the per-AMR-level refinement logs, REPLAYED on load
  from the initial mesh (`d4est_checkpoint_load_mesh_from_amr_history`).

The file format is the JAX package's, key for key and dtype for dtype
(`tree` int32, `level` int8, `anchor` int32, `deg`, `checksum` int64,
`n_elements`, `field_<name>`, `amr_history_lens` / `amr_history` int64,
`extra_json` uint8), so a checkpoint written by either package loads in
the other.  Fields are written from the device with one `.cpu()` copy each
and load back as f64 tensors on the caller's device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from disco4est_tpu_torch.amr.amr import refine_and_balance
from disco4est_tpu_torch.geometry.base import Connectivity
from disco4est_tpu_torch.io import to_host
from disco4est_tpu_torch.mesh.tree import Forest


def save(path: str, forest: Forest, fields: dict, *, deg: int,
         amr_history: list | None = None, extra: dict | None = None):
    """Write forest + nodal fields (+ optional AMR history and a JSON
    `extra` dict) to `path`.npz."""
    payload = {
        "tree": forest.tree,
        "level": forest.level,
        "anchor": forest.anchor,
        "deg": np.asarray(deg),
        "checksum": np.asarray(forest.checksum(), np.int64),
        "n_elements": np.asarray(forest.n_elements),
    }
    for name, arr in fields.items():
        payload[f"field_{name}"] = to_host(arr)
    if amr_history is not None:
        payload["amr_history_lens"] = np.asarray(
            [len(h) for h in amr_history], np.int64)
        payload["amr_history"] = (
            np.concatenate([np.asarray(h, np.int64) for h in amr_history])
            if amr_history else np.zeros(0, np.int64))
    if extra:
        payload["extra_json"] = np.frombuffer(json.dumps(extra).encode(),
                                              dtype=np.uint8)
    np.savez(path, **payload)


def load(path: str, conn: Connectivity, *, device):
    """Restore (forest, fields, deg, amr_history, extra); `fields` maps each
    stored name to an f64 tensor on `device`.

    Validates the structural checksum as the reference validates
    `p4est_checksum` on load (`d4est_checkpoint.h:12-13`): a mismatch
    raises `ValueError`."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    forest = Forest(
        conn,
        data["tree"].astype(np.int32),
        data["level"].astype(np.int8),
        data["anchor"].astype(np.int32),
    )
    if int(data["checksum"]) != forest.checksum():
        raise ValueError("checkpoint checksum mismatch")
    fields = {
        k[len("field_"):]: torch.as_tensor(data[k], dtype=torch.float64,
                                           device=device)
        for k in data.files if k.startswith("field_")
    }
    history = None
    if "amr_history_lens" in data.files:
        lens = data["amr_history_lens"]
        history = (np.split(data["amr_history"], np.cumsum(lens)[:-1])
                   if len(lens) else [])
    extra = None
    if "extra_json" in data.files:
        extra = json.loads(bytes(data["extra_json"]).decode())
    return forest, fields, int(data["deg"]), history, extra


def replay_amr_history(initial_forest: Forest, history: list) -> Forest:
    """Rebuild a forest by replaying per-level refinement logs (the
    size-independent restore path, `driver.c:156-227`)."""
    forest = initial_forest
    for log in history:
        log = np.asarray(log)
        if len(log) != forest.n_elements:
            raise ValueError(
                f"history entry length {len(log)} != {forest.n_elements}")
        forest = refine_and_balance(forest, log < 0)
    return forest
