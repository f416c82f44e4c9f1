"""hp-AMR: marking, refinement, 2:1 balance, and field transfer.

Port of `disco4est_tpu/amr/amr.py` (role of the reference's
`hpAMR/d4est_amr.c`: `d4est_amr_step`:868 = mark → refine with replace
callback → 2:1 balance recording split elements → hp-prolong nodal fields
onto children).

refinement_log protocol (matching `hpAMR/d4est_amr.h:18-39`):
  log[e] < 0  ⇒  h-refine, children get degree |log[e]|
  log[e] > 0  ⇒  set degree to log[e] (p-refine/coarsen)
  log[e] = deg ⇒ no-op

Forests, lineage and logs are host numpy, once per epoch; fields are torch
tensors on the mesh's device, and the transfer is a batched hp-prolong
grouped by depth (one `einsum` over gathered per-element [B, nl, nl]
matrices per axis).
"""

from __future__ import annotations

import numpy as np
import torch

from disco4est_tpu_torch.mesh.tree import Forest, ROOT
from disco4est_tpu_torch.ops import tensor
from disco4est_tpu_torch.ops.operators import DB


def refine_and_balance(forest: Forest, h_flags: np.ndarray) -> Forest:
    """Refine flagged leaves then re-establish 2:1 balance."""
    return forest.refine(np.asarray(h_flags, bool)).balance()


def element_lineage(old: Forest, new: Forest):
    """For each new leaf: the old leaf covering it and the relationship.

    Returns (src[Enew], child_id[Enew], dl[Enew]): child_id = -1 for a
    copied (same) leaf and c ∈ [0, 2^dim) for the c-th child at the FIRST
    split of the old leaf; dl = levels descended (balance may cascade, so
    dl > 1 occurs).  The old leaf is found by `Forest.find_leaves`, tree by
    tree, so no packed tree-and-key integer wraps past 16 trees (ROADMAP
    C8).
    """
    dim = old.dim
    h_new = (ROOT >> new.level.astype(np.int64))[:, None]
    center = new.anchor.astype(np.int64) + h_new // 2
    src = old.find_leaves(new.tree, center)
    dl = new.level.astype(np.int64) - old.level[src].astype(np.int64)
    child = np.full(len(src), -1, np.int64)
    h_old = ROOT >> old.level[src].astype(np.int64)
    rel = new.anchor.astype(np.int64) - old.anchor[src].astype(np.int64)
    bits = (rel >= (h_old // 2)[:, None]).astype(np.int64)
    cid = sum(bits[:, d] << d for d in range(dim))
    gen1 = dl >= 1
    child[gen1] = cid[gen1]
    return src, child, dl


def transfer_field(old: Forest, new: Forest, u, deg: int):
    """hp-prolong nodal fields from the old forest onto the new one
    (`d4est_amr.c:339-430`).  Handles multi-level descent (balance
    cascades) by repeated child prolongation along the anchor path."""
    src, child, dl = element_lineage(old, new)
    dim = old.dim
    nl = deg + 1
    dev = u.device
    out = torch.zeros((new.n_elements,) + (nl,) * dim, dtype=u.dtype,
                      device=dev)
    copy_idx = np.where(dl == 0)[0]
    if len(copy_idx):
        out[torch.as_tensor(copy_idx, device=dev)] = u[
            torch.as_tensor(src[copy_idx], device=dev)]

    hp1 = torch.as_tensor(
        np.stack([DB.hp_prolong(deg, deg, c) for c in (0, 1)]),
        dtype=u.dtype, device=dev,
    )  # [2, nl, nl]

    def prolong_child(vals, cid_bits):
        # vals [B, nl...]; apply the child interpolation per axis by bit
        for d in range(dim):
            mats = hp1[torch.as_tensor(cid_bits[:, d], device=dev)]
            ax = vals.ndim - 1 - d
            v = torch.movedim(vals, ax, -1)
            v = torch.einsum("bij,b...j->b...i", mats, v)
            vals = torch.movedim(v, -1, ax)
        return vals

    max_dl = int(dl.max()) if len(dl) else 0
    for depth in range(1, max_dl + 1):
        idx = np.where(dl == depth)[0]
        if not len(idx):
            continue
        # descend `depth` levels from the old leaf to the new leaf,
        # prolonging through the anchor path
        vals = u[torch.as_tensor(src[idx], device=dev)]
        rel = new.anchor[idx].astype(np.int64) - old.anchor[src[idx]].astype(
            np.int64)
        for g in range(depth):
            h_old = ROOT >> (old.level[src[idx]].astype(np.int64) + g)
            # position of the (g+1)-th-generation cell holding the new leaf
            bits = ((rel % h_old[:, None]) >= (h_old // 2)[:, None]).astype(
                np.int64)
            vals = prolong_child(vals, bits)
        out[torch.as_tensor(idx, device=dev)] = vals
    return out


def transfer_field_p(u, deg_old: int, deg_new: int, dim: int):
    """p-prolong/restrict a nodal field to a new uniform degree
    (`d4est_operators_apply_p_prolong` per axis)."""
    if deg_new == deg_old:
        return u
    P = (
        DB.p_prolong(deg_old, deg_new)
        if deg_new > deg_old
        else DB.p_restrict(deg_old, deg_new)
    )
    return tensor.apply_iso(P, u, dim)


def p_balance_log(
    mesh,
    deg_e: np.ndarray,
    refinement_log: np.ndarray,
    p_balance_if_diff: int,
    max_degree: int,
    predictor: np.ndarray | None = None,
    gamma_p: float = 1.0,
):
    """Degree-jump limiting across faces (`hpAMR/d4est_amr.c:917-991`):
    for each element, p_balance[e] = max over its faces (conforming AND
    hanging) of (neighbor_deg − own_deg); when that jump ≥
    `p_balance_if_diff` and deg < max_degree − 1, the refinement log is
    bumped one degree (h-marked elements get one higher child degree).

    With a `predictor` (smooth_pred), bumped elements additionally get
    predictor *= gamma_p (`d4est_amr_smooth_pred_compute_post_p_balance_
    predictor`).  Returns (new_log, new_predictor).  Host numpy, from the
    mesh's neighbor and mortar tables."""
    deg = np.asarray(deg_e, np.int64)
    log = np.asarray(refinement_log, np.int64).copy()
    nbr = mesh.nbr_elem.cpu().numpy()
    conf = (mesh.conf_mask & ~mesh.bnd_mask).cpu().numpy()
    jump = np.where(conf, deg[nbr] - deg[:, None], 0).max(axis=1)
    ce = mesh.hc_elem.cpu().numpy()
    fe = mesh.hc_fine.cpu().numpy()
    if ce.size:
        # the coarse side sees each fine partner; each fine side the coarse
        np.maximum.at(jump, ce, (deg[fe] - deg[ce][:, None]).max(axis=1))
        np.maximum.at(
            jump, fe.reshape(-1), (deg[ce][:, None] - deg[fe]).reshape(-1)
        )
    bump = (jump >= p_balance_if_diff) & (deg < max_degree - 1)
    log[bump & (log < 0)] -= 1
    log[bump & (log >= 0)] += 1
    pred = predictor
    if predictor is not None:
        pred = np.asarray(predictor).copy()
        pred[bump] *= gamma_p
    return log, pred


def amr_step(forest: Forest, refinement_log: np.ndarray, fields: dict,
             deg: int):
    """One AMR step at one uniform degree: h-refine per the log, 2:1
    balance, transfer fields.  Returns (new_forest, new_fields);
    mixed-degree meshes go through `amr_step_hp`."""
    h_flags = np.asarray(refinement_log) < 0
    new_forest = refine_and_balance(forest, h_flags)
    new_fields = {
        k: transfer_field(forest, new_forest, v, deg) for k, v in fields.items()
    }
    return new_forest, new_fields


def amr_step_hp(
    forest: Forest,
    deg_e: np.ndarray,
    refinement_log: np.ndarray,
    fields_own: dict,
    deg_storage: int,
    max_degree: int | None = None,
):
    """Full hp-AMR step on a mixed-degree mesh.

    `fields_own` are PADDED own-degree coefficient tensors at storage
    degree `deg_storage` (see laplacian/hp.py).  Returns
    (new_forest, new_deg_e, new_fields_own, new_deg_storage).

    Transfer = P(old own→old storage) → p-prolong(old→new storage)
    → h-prolong onto children → L2-restrict to the new own degrees —
    exact for copies, h-children and p-refines; an L2 projection only for
    genuine p-coarsening (matching `d4est_operators_apply_p_restrict`).
    """
    from disco4est_tpu_torch.laplacian.hp import (
        prolong_padded,
        restrict_padded,
    )

    log = np.asarray(refinement_log).astype(np.int64)
    deg_e = np.asarray(deg_e, np.int64)
    new_forest = refine_and_balance(forest, log < 0)

    src, _, _ = element_lineage(forest, new_forest)
    deg_after_mark = np.where(log < 0, -log, log)
    new_deg_e = deg_after_mark[src].astype(np.int32)
    new_storage = int(max(deg_storage, new_deg_e.max(initial=1)))
    if max_degree is not None:
        assert new_deg_e.max(initial=1) <= max_degree

    dim = forest.dim
    new_fields = {}
    for k, v in fields_own.items():
        u = prolong_padded(v, deg_e, deg_storage, dim)
        u = transfer_field_p(u, deg_storage, new_storage, dim)
        u = transfer_field(forest, new_forest, u, new_storage)
        new_fields[k] = restrict_padded(u, new_deg_e, new_storage, dim)
    return new_forest, new_deg_e, new_fields, new_storage
