"""Directed face tables: the array-program replacement for p4est face
iteration.

The reference resolves face cases {full-full, hanging, boundary} ×
{local, ghost} inside a `p4est_iterate` callback per apply
(`Mesh/d4est_mortars.c:601-806`).  Here the classification runs ONCE per
mesh epoch and yields static index tables; the SIPG apply is then three
batched kernels (conforming, boundary, hanging) with no tree traversal.

Directed-face convention: every (element, face) pair owns the computation
of its own element's Au contribution (the reference's "minus side" role),
so interior conforming faces appear twice — once per side — and the apply
needs no cross-element scatter beyond neighbor *gathers*.

Face-node ordering: for face dir a0, tangent axes (t1 < t2), nodes stored
[n_t2, n_t1] with t1 fastest.  Orientation codes (cross-tree faces) encode
(swap, flip_t1, flip_t2): code = 4*swap + 2*flip2 + flip1; 2D: code = flip.

Port of `disco4est_tpu/mesh/faces.py` (host numpy), copied unchanged but
for the leaf search, which goes through `Forest.find_leaves` (no packed
tree-and-key integer; ROADMAP C8).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from disco4est_tpu_torch.mesh.tree import Forest, ROOT, _canonicalize_points

# face kinds
CONF = 0
BOUNDARY = 1
FINE = 2  # I am the finer side of a hanging face (neighbor is coarser)
COARSE = 3  # I am the coarser side (neighbors are 2^{dim-1} finer elements)


@dataclasses.dataclass
class FaceTables:
    dim: int
    kind: np.ndarray  # [E, 2d] int8
    nbr_elem: np.ndarray  # [E, 2d] int32 (conforming: neighbor; else self)
    nbr_face: np.ndarray  # [E, 2d] int8
    orient: np.ndarray  # [E, 2d] int8 orientation code (0 = identity)
    # hanging, coarse-side mortars (one row per coarse (elem, face)):
    hc_elem: np.ndarray  # [M] int32
    hc_face: np.ndarray  # [M] int8
    hc_fine: np.ndarray  # [M, K] int32 fine neighbors, mortar-subface order
    hc_fine_face: np.ndarray  # [M, K] int8
    hc_orient: np.ndarray  # [M] int8
    # hanging, fine-side rows (one per fine (elem, face)):
    hf_elem: np.ndarray  # [Mf] int32
    hf_face: np.ndarray  # [Mf] int8
    hf_coarse: np.ndarray  # [Mf] int32
    hf_coarse_face: np.ndarray  # [Mf] int8
    hf_subface: np.ndarray  # [Mf] int8 (position of my face in coarse face)
    hf_orient: np.ndarray  # [Mf] int8


def _tangent_axes(dim: int, face: int):
    a0 = face // 2
    return [a for a in range(dim) if a != a0]


def _orientation_code(conn, tree: int, f: int) -> int:
    """Orientation code of the tree-face transform as seen from `tree`
    through its face `f` (identity for same-tree element faces)."""
    dim = conn.dim
    amap = conn.axis_map[tree, f]
    aflip = conn.axis_flip[tree, f]
    nf = int(conn.nbr_face[tree, f])
    tm = _tangent_axes(dim, f)
    tn = _tangent_axes(dim, nf)
    if dim == 2:
        return int(aflip[tm[0]])
    b1 = int(amap[tm[0]])
    swap = 1 if b1 == tn[1] else 0
    return 4 * swap + 2 * int(aflip[tm[1]]) + int(aflip[tm[0]])


def orientation_perm(dim: int, n: int, code: int) -> np.ndarray:
    """Index array p so that my_face_nodes = nbr_face_flat[p].

    My face node (j2, j1) (j1 fast) corresponds to neighbor node (i2, i1)
    through flips and the tangent-axis swap; assumes the node set is
    symmetric under reversal (true for LGL and Gauss).
    """
    if dim == 2:
        j1 = np.arange(n)
        i1 = (n - 1 - j1) if (code & 1) else j1
        return i1
    j2, j1 = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v1 = (n - 1 - j1) if (code & 1) else j1
    v2 = (n - 1 - j2) if (code & 2) else j2
    if code & 4:
        i1, i2 = v2, v1
    else:
        i1, i2 = v1, v2
    return (i2 * n + i1).reshape(-1)


def build_face_tables(forest: Forest) -> FaceTables:
    dim = forest.dim
    E = forest.n_elements
    nf = 2 * dim
    K = 1 << (dim - 1)
    conn = forest.conn

    kind = np.zeros((E, nf), np.int8)
    nbr_elem = np.tile(np.arange(E, dtype=np.int32)[:, None], (1, nf))
    nbr_face = np.zeros((E, nf), np.int8)
    orient = np.zeros((E, nf), np.int8)

    anchor = forest.anchor.astype(np.int64)
    h = (ROOT >> forest.level.astype(np.int64))[:, None]

    hc_rows = []
    hf_rows = []

    for f in range(nf):
        a0, side = divmod(f, 2)
        # center of the same-level neighbor cell, in my frame
        center = anchor + h // 2
        center[:, a0] += np.where(side == 1, h[:, 0], -h[:, 0])
        tree = forest.tree.astype(np.int32).copy()
        valid = np.ones(E, bool)
        crossed = (center[:, a0] < 0) | (center[:, a0] >= ROOT)
        pt, tr, valid = _canonicalize_points(conn, tree, center.copy(), valid)
        # boundary faces
        kind[~valid, f] = BOUNDARY
        live = np.where(valid)[0]
        if len(live) == 0:
            continue
        idx = forest.find_leaves(tr[live], pt[live])
        lv_e = forest.level[live].astype(np.int32)
        lv_n = forest.level[idx].astype(np.int32)

        # orientation + neighbor face id
        o_codes = np.zeros(len(live), np.int8)
        nb_faces = np.full(len(live), f ^ 1, np.int8)
        cr = crossed[live]
        if cr.any():
            trees_cr = forest.tree[live[cr]]
            nb_faces[cr] = conn.nbr_face[trees_cr, f]
            o_codes[cr] = [
                _orientation_code(conn, int(t), f) for t in trees_cr
            ]

        # conforming
        conf = lv_n == lv_e
        le = live[conf]
        kind[le, f] = CONF
        nbr_elem[le, f] = idx[conf]
        nbr_face[le, f] = nb_faces[conf]
        orient[le, f] = o_codes[conf]

        # I'm fine side (neighbor coarser by 1)
        fine = lv_n == lv_e - 1
        for j in np.where(fine)[0]:
            e = live[j]
            ne = idx[j]
            # subface: my position within the neighbor's face, computed in
            # the COARSE element's frame (mortar subfaces are indexed in
            # the coarse side's tangent-bit order).
            sub_c = _subface_in_coarse_frame(forest, e, ne, int(nb_faces[j]), dim)
            hf_rows.append(
                (e, f, ne, nb_faces[j], sub_c, o_codes[j])
            )
            kind[e, f] = FINE
            nbr_elem[e, f] = ne
            nbr_face[e, f] = nb_faces[j]
            orient[e, f] = o_codes[j]

        # I'm coarse side (neighbor cell is refined)
        coarse = lv_n > lv_e
        for j in np.where(coarse)[0]:
            e = live[j]
            kind[e, f] = COARSE

    # Build coarse-side mortar rows by pairing with fine rows:
    # group fine rows by (coarse elem, coarse face).
    groups: dict[tuple, list] = {}
    for (e, f, ne, nfc, sub, oc) in hf_rows:
        groups.setdefault((ne, int(nfc)), []).append((e, f, sub, oc))
    for (ce, cf), members in sorted(groups.items()):
        if len(members) != K:
            raise RuntimeError(
                f"hanging face of elem {ce} face {cf} has {len(members)} "
                f"fine members, expected {K}: mesh not 2:1 balanced?"
            )
        fines = np.zeros(K, np.int32)
        ffaces = np.zeros(K, np.int8)
        oc_any = members[0][3]
        for (e, f, sub_c, oc) in members:
            fines[sub_c] = e
            ffaces[sub_c] = f
        hc_rows.append((ce, cf, fines, ffaces, oc_any))

    def _arr(rows, i, dtype, shape=None):
        if not rows:
            return np.zeros((0,) if shape is None else (0, *shape), dtype)
        return np.array([r[i] for r in rows], dtype)

    return FaceTables(
        dim=dim,
        kind=kind,
        nbr_elem=nbr_elem,
        nbr_face=nbr_face,
        orient=orient,
        hc_elem=_arr(hc_rows, 0, np.int32),
        hc_face=_arr(hc_rows, 1, np.int8),
        hc_fine=_arr(hc_rows, 2, np.int32, (K,)),
        hc_fine_face=_arr(hc_rows, 3, np.int8, (K,)),
        hc_orient=_arr(hc_rows, 4, np.int8),
        hf_elem=_arr(hf_rows, 0, np.int32),
        hf_face=_arr(hf_rows, 1, np.int8),
        hf_coarse=_arr(hf_rows, 2, np.int32),
        hf_coarse_face=_arr(hf_rows, 3, np.int8),
        hf_subface=_arr(hf_rows, 4, np.int8),
        hf_orient=_arr(hf_rows, 5, np.int8),
    )


def _subface_in_coarse_frame(
    forest: Forest, e: int, ce: int, cf: int, dim: int
) -> int:
    """Subface index of fine element e within coarse element ce's face cf,
    computed in the COARSE element's tangent frame by locating e's center
    in ce's coordinates."""
    conn = forest.conn
    h = np.int64(ROOT >> int(forest.level[e]))
    center = forest.anchor[e].astype(np.int64) + h // 2
    tree = np.array([forest.tree[e]], np.int32)
    pt = center[None, :].copy()
    valid = np.ones(1, bool)
    if forest.tree[e] != forest.tree[ce]:
        # push the center across the shared face into ce's tree:
        # step outward through e's face that touches ce. The canonicalize
        # helper handles the transform; nudge along the face normal.
        a0, side = divmod(_face_of_fine_towards(forest, e, ce, dim), 2)
        pt[0, a0] += h if side else -h
        pt, tree, valid = _canonicalize_points(conn, tree, pt, valid)
        if not valid[0]:
            raise RuntimeError("fine->coarse transform failed")
        # undo the step in the coarse frame: we only need tangential
        # position, and the stepped point lies inside ce (it crossed the
        # face into ce), so no undo is needed.
    tang = _tangent_axes(dim, int(cf))
    hp = np.int64(ROOT >> int(forest.level[ce]))
    rel = pt[0] - forest.anchor[ce].astype(np.int64)
    bits = 0
    for b, a in enumerate(tang):
        if rel[a] >= hp // 2:
            bits |= 1 << b
    return bits


def _face_of_fine_towards(forest: Forest, e: int, ce: int, dim: int) -> int:
    """Which face of fine element e touches coarse element ce (they are in
    different trees; find via the stored table search)."""
    # Try each face: step outward and see if we land inside ce.
    conn = forest.conn
    h = np.int64(ROOT >> int(forest.level[e]))
    hp = np.int64(ROOT >> int(forest.level[ce]))
    for f in range(2 * dim):
        a0, side = divmod(f, 2)
        center = forest.anchor[e].astype(np.int64) + h // 2
        center[a0] += h if side else -h
        pt = center[None, :].copy()
        tree = np.array([forest.tree[e]], np.int32)
        valid = np.ones(1, bool)
        pt, tree, valid = _canonicalize_points(conn, tree, pt, valid)
        if not valid[0] or tree[0] != forest.tree[ce]:
            continue
        rel = pt[0] - forest.anchor[ce].astype(np.int64)
        if np.all((rel >= 0) & (rel < hp)):
            return f
    raise RuntimeError("no face of fine element touches coarse element")
