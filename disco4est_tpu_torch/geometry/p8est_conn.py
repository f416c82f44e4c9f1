"""p8est-style connectivities and the conversion to our transform encoding.

The reference builds its multi-block domains on p4est connectivities
(`Geometry/d4est_connectivity_cubed_sphere.c`, p4est's
`p8est_connectivity_new_sphere`).  Here the same (tree_to_tree,
tree_to_face-with-orientation) data is converted ONCE into our
`Connectivity` encoding (per-face axis permutation + flips), using p8est's
face-corner permutation tables (p8est_connectivity.h) — after which all
mesh code is independent of p4est conventions.

Face numbering matches p4est: 0=x−,1=x+,2=y−,3=y+,4=z−,5=z+.
tree_to_face value = face + 6·orientation.

Port of `disco4est_tpu/geometry/p8est_conn.py` (host numpy, copied
unchanged).
"""

from __future__ import annotations

import numpy as np

from disco4est_tpu_torch.geometry.base import Connectivity

# p8est face-corner tables (p8est_connectivity.h).
P8_FACE_CORNERS = np.array(
    [
        [0, 2, 4, 6],
        [1, 3, 5, 7],
        [0, 1, 4, 5],
        [2, 3, 6, 7],
        [0, 1, 2, 3],
        [4, 5, 6, 7],
    ]
)
P8_FACE_PERMUTATIONS = np.array(
    [
        [0, 1, 2, 3],
        [0, 2, 1, 3],
        [1, 0, 3, 2],
        [1, 3, 0, 2],
        [2, 0, 3, 1],
        [2, 3, 0, 1],
        [3, 1, 2, 0],
        [3, 2, 1, 0],
    ]
)
P8_FACE_PERMUTATION_SETS = np.array(
    [[1, 2, 5, 6], [0, 3, 4, 7], [0, 4, 3, 7]]
)
P8_FACE_PERMUTATION_REFS = np.array(
    [
        [0, 1, 1, 0, 0, 1],
        [2, 0, 0, 1, 1, 0],
        [2, 0, 0, 1, 1, 0],
        [0, 2, 2, 0, 0, 1],
        [0, 2, 2, 0, 0, 1],
        [1, 0, 0, 2, 2, 0],
    ]
)


def _tangent_axes(f: int):
    a0 = f // 2
    return [a for a in range(3) if a != a0]


def connectivity_from_p8est(
    tree_to_tree: np.ndarray, tree_to_face: np.ndarray
) -> Connectivity:
    """Convert p8est (tree_to_tree, tree_to_face+6·orientation) arrays
    into axis_map/axis_flip form.  Self-connections (tree_to_tree == own
    tree with same face) are physical boundaries."""
    T = tree_to_tree.shape[0]
    dim = 3
    nbr_tree = -np.ones((T, 6), np.int32)
    nbr_face = np.zeros((T, 6), np.int32)
    axis_map = np.tile(np.arange(dim, dtype=np.int8), (T, 6, 1))
    axis_flip = np.zeros((T, 6, dim), np.int8)

    for t in range(T):
        for f in range(6):
            nt = int(tree_to_tree[t, f])
            code = int(tree_to_face[t, f])
            nf = code % 6
            r = code // 6
            if nt == t and nf == f:
                continue  # physical boundary
            nbr_tree[t, f] = nt
            nbr_face[t, f] = nf
            # face-corner permutation: corner c of my face -> corner
            # perm[c] of the neighbor's face
            ref = P8_FACE_PERMUTATION_REFS[f, nf]
            pset = P8_FACE_PERMUTATION_SETS[ref, r]
            perm = P8_FACE_PERMUTATIONS[pset]
            tm = _tangent_axes(f)  # my tangent axes (t1 < t2)
            tn = _tangent_axes(nf)
            # bit b of my face-corner index lives on my axis tm[b]; see
            # where it lands in the neighbor's face-corner bits.
            amap = np.arange(dim, dtype=np.int8)
            aflip = np.zeros(dim, np.int8)
            for b in (0, 1):
                toggled = perm[1 << b] ^ perm[0]
                if toggled == 1:
                    amap[tm[b]] = tn[0]
                    aflip[tm[b]] = perm[0] & 1
                elif toggled == 2:
                    amap[tm[b]] = tn[1]
                    aflip[tm[b]] = (perm[0] >> 1) & 1
                else:  # pragma: no cover - invalid table entry
                    raise ValueError("invalid p8est permutation")
            # normal axis: maps to the neighbor's normal axis; flipped iff
            # both trees see the shared face from the same side.
            amap[f // 2] = nf // 2
            aflip[f // 2] = 1 if (f % 2) == (nf % 2) else 0
            axis_map[t, f] = amap
            axis_flip[t, f] = aflip
    return Connectivity(
        dim=dim,
        nbr_tree=nbr_tree,
        nbr_face=nbr_face,
        axis_map=axis_map,
        axis_flip=axis_flip,
    )


# --------------------------------------------------------------------------
# Connectivity data (vertex-space boxes + adjacency).
# 13-tree sphere: p4est's p8est_connectivity_new_sphere (p8est_connectivity
# .c:690): trees 0-5 outer shells, 6-11 inner shells, 12 core cube.
# 7-tree sphere: reference `d4est_connectivity_new_sphere_7tree`: 6 inner
# shells + core.
# --------------------------------------------------------------------------

_SHELL_VERTS = np.array(
    [
        [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1],
        [-1, -1, 2], [1, -1, 2], [-1, 1, 2], [1, 1, 2],
    ],
    np.float64,
)
_CUBE_VERTS = np.array(
    [
        [-1, -1, -1], [1, -1, -1], [-1, 1, -1], [1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1],
    ],
    np.float64,
)


def sphere13_data():
    tree_to_tree = np.array(
        [
            [5, 3, 4, 1, 6, 0],
            [5, 3, 0, 2, 7, 1],
            [5, 3, 1, 4, 8, 2],
            [2, 0, 1, 4, 9, 3],
            [2, 0, 3, 5, 10, 4],
            [2, 0, 4, 1, 11, 5],
            [11, 9, 10, 7, 12, 0],
            [11, 9, 6, 8, 12, 1],
            [11, 9, 7, 10, 12, 2],
            [8, 6, 7, 10, 12, 3],
            [8, 6, 9, 11, 12, 4],
            [8, 6, 10, 7, 12, 5],
            [11, 9, 6, 8, 10, 7],
        ]
    )
    tree_to_face = np.array(
        [
            [1, 7, 7, 2, 5, 5],
            [9, 8, 3, 2, 5, 5],
            [6, 0, 3, 6, 5, 5],
            [1, 7, 7, 2, 5, 5],
            [9, 8, 3, 2, 5, 5],
            [6, 0, 3, 6, 5, 5],
            [1, 7, 7, 2, 2, 4],
            [9, 8, 3, 2, 5, 4],
            [6, 0, 3, 6, 15, 4],
            [1, 7, 7, 2, 19, 4],
            [9, 8, 3, 2, 22, 4],
            [6, 0, 3, 6, 6, 4],
            [10, 22, 4, 16, 22, 4],
        ]
    )
    verts = np.stack([_SHELL_VERTS] * 12 + [_CUBE_VERTS])  # [13, 8, 3]
    return tree_to_tree, tree_to_face, verts


def sphere7_data():
    """Reference `d4est_connectivity_new_sphere_7tree`
    (`d4est_connectivity_cubed_sphere.c:6-67`)."""
    tree_to_tree = np.array(
        [
            [5, 3, 4, 1, 6, 0],
            [5, 3, 0, 2, 6, 1],
            [5, 3, 1, 4, 6, 2],
            [2, 0, 1, 4, 6, 3],
            [2, 0, 3, 5, 6, 4],
            [2, 0, 4, 1, 6, 5],
            [5, 3, 0, 2, 4, 1],
        ]
    )
    tree_to_face = np.array(
        [
            [1, 7, 7, 2, 2, 5],
            [9, 8, 3, 2, 5, 5],
            [6, 0, 3, 6, 15, 5],
            [1, 7, 7, 2, 19, 5],
            [9, 8, 3, 2, 22, 5],
            [6, 0, 3, 6, 6, 5],
            [10, 22, 4, 16, 22, 4],
        ]
    )
    verts = np.stack([_SHELL_VERTS] * 6 + [_CUBE_VERTS])  # [7, 8, 3]
    return tree_to_tree, tree_to_face, verts


def sphere12_hole_data():
    """12-tree cubed sphere WITH SPHERE HOLE: the 13-tree connectivity
    minus the core cube — the inner-shell trees' face 4 (the face that
    connected to the core) becomes a physical boundary at the excision
    sphere r = R0.  Role of the reference's
    `d4est_geometry_sphere_with_cube_hole` family
    (`Geometry/d4est_geometry_sphere_with_cube_hole.c`), with the hole
    surface spherical (pure angular inner map) as BoyenYorkModel's
    `cubed_sphere_with_sphere_hole` domain requires."""
    t2t, t2f, verts = sphere13_data()
    t2t = t2t[:12].copy()
    t2f = t2f[:12].copy()
    for t in range(6, 12):
        t2t[t, 4] = t  # boundary: self-connection, same face
        t2f[t, 4] = 4
    return t2t, t2f, verts[:12]
