"""Cubed-sphere geometries (7-tree, 13-tree and the 12-tree sphere with a
hole), with compactified shells.

Port of `disco4est_tpu/geometry/cubed_sphere.py` (role of the reference's
`Geometry/d4est_geometry_cubed_sphere.c`):
- 13-tree sphere (`d4est_geometry_cubed_sphere_X` :316): 6 outer shells
  (R1→R2, pure angular tan map, optionally compactified so the outer
  boundary sits at r→∞), 6 inner shells (R0→R1, cube-to-sphere blend),
  1 core cube of half-width Clength = R0/√3;
- 7-tree sphere (`..._7tree_X` :499): 6 inner shells + core;
- 12-tree sphere with a spherical hole at r = R0: 6 outer + 6 pure
  angular inner shells, no core.

`x(tree, rst)` is one expression for every tree: the tree's vertex box
and its orientation (the reference's `switch (which_tree % 6)` sign
permutation) are tensor gathers by the tree id, and each `where` between
the outer, inner and core maps evaluates every branch.  So the base
class's autodiff Jacobian (`torch.func.jacfwd` under `vmap`) traces it
for all trees at once.
"""

from __future__ import annotations

import numpy as np
import torch

from disco4est_tpu_torch.geometry.base import Geometry
from disco4est_tpu_torch.geometry.p8est_conn import (
    connectivity_from_p8est,
    sphere12_hole_data,
    sphere13_data,
    sphere7_data,
)

# switch(tree % 6) of the reference: xyz as signed permutation of
# (qx, qy, q).  Case k: xyz = ORIENT[k] @ [q·x, q·y, q].
_ORIENT = np.zeros((6, 3, 3))
_ORIENT[0] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]  # front: (+qx, -q, +qy)
_ORIENT[1] = [[1, 0, 0], [0, 1, 0], [0, 0, 1]]  # top: (+qx, +qy, +q)
_ORIENT[2] = [[1, 0, 0], [0, 0, 1], [0, -1, 0]]  # back: (+qx, +q, -qy)
_ORIENT[3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]  # right: (+q, -qx, -qy)
_ORIENT[4] = [[0, -1, 0], [-1, 0, 0], [0, 0, -1]]  # bottom: (-qy, -qx, -q)
_ORIENT[5] = [[0, 0, -1], [-1, 0, 0], [0, 1, 0]]  # left: (-q, -qx, +qy)

_KINDS = {
    # kind: (connectivity data, outer-shell trees, geometry regions as in
    # `d4est_geometry_cubed_sphere_get_region`, reference :42-67)
    "13tree": (sphere13_data, 6, 3),
    "7tree": (sphere7_data, 0, 2),
    "12tree_hole": (sphere12_hole_data, 6, 2),
}


def _gather(table, idx):
    """table[idx] for an integer tensor idx of any shape, 0-d included
    (plain indexing by a 0-d tensor reads it as a host integer, which
    `vmap` cannot trace)."""
    out = torch.index_select(table, 0, idx.reshape(-1))
    return out.reshape(idx.shape + table.shape[1:])


class CubedSphereGeometry(Geometry):
    """kind: '13tree' (outer + inner + core), '7tree' (inner + core) or
    '12tree_hole' (outer + pure angular inner, no core)."""

    dim = 3

    def __init__(
        self,
        kind: str = "13tree",
        R0: float = 1.0,
        R1: float = 2.0,
        R2: float = 3.0,
        compactify_outer_shell: bool = False,
        compactify_inner_shell: bool = False,
    ):
        if kind not in _KINDS:
            raise ValueError(kind)
        data, self.n_outer, self.n_regions = _KINDS[kind]
        self.kind = kind
        self.R0, self.R1, self.R2 = float(R0), float(R1), float(R2)
        self.compactify_outer = bool(compactify_outer_shell)
        self.compactify_inner = bool(compactify_inner_shell)
        self.Clength = self.R0 / np.sqrt(3.0)
        t2t, t2f, verts = data()
        self.conn = connectivity_from_p8est(t2t, t2f)
        self.verts = verts  # [T, 8, 3] vertex-space boxes
        self.n_trees_total = verts.shape[0]
        # no core tree on the holed sphere (tree == core_tree never true)
        self.core_tree = -1 if kind == "12tree_hole" else self.n_trees_total - 1

    def _key(self):
        return (
            self.kind, self.R0, self.R1, self.R2,
            self.compactify_outer, self.compactify_inner,
        )

    def __eq__(self, other):
        return (
            isinstance(other, CubedSphereGeometry)
            and self._key() == other._key()
        )

    def __hash__(self):
        return hash(self._key())

    def tree_region(self, tree):
        t = np.asarray(tree)
        if self.kind == "13tree":
            return np.where(t < 6, 0, np.where(t < 12, 1, 2)).astype(np.int32)
        return np.where(t < 6, 0, 1).astype(np.int32)

    def x(self, tree, rst):
        """rst in [0,1]^3 tree coords -> physical xyz; `tree` an integer
        tensor broadcastable against rst[..., 0]."""
        kw = dict(dtype=rst.dtype, device=rst.device)
        tree = torch.broadcast_to(torch.as_tensor(tree, device=rst.device),
                                  rst.shape[:-1])
        verts = _gather(torch.as_tensor(self.verts, **kw), tree)  # [..., 8, 3]
        # trilinear octree_to_vertex (vertex bits: x fastest)
        r, s, t = rst[..., 0], rst[..., 1], rst[..., 2]
        w = torch.stack(
            [
                (1 - r) * (1 - s) * (1 - t),
                r * (1 - s) * (1 - t),
                (1 - r) * s * (1 - t),
                r * s * (1 - t),
                (1 - r) * (1 - s) * t,
                r * (1 - s) * t,
                (1 - r) * s * t,
                r * s * t,
            ],
            dim=-1,
        )
        abc = torch.einsum("...v,...vc->...c", w, verts)
        a, b, c = abc[..., 0], abc[..., 1], abc[..., 2]

        # --- outer shell (13-tree trees 0..5): pure angular map ---------
        tanx = torch.tan(a * (np.pi / 4.0))
        tany = torch.tan(b * (np.pi / 4.0))
        if self.compactify_outer:
            m = (2.0 - 1.0) / ((1.0 / self.R2) - (1.0 / self.R1))
            tt = (1.0 * self.R1 - 2.0 * self.R2) / (self.R1 - self.R2)
            R_out = m / (c - tt)
        else:
            R_out = self.R1 * (2.0 - c) + self.R2 * (c - 1.0)
        q_out = R_out / torch.sqrt(tanx**2 + tany**2 + 1.0)

        # --- inner shell: cube-to-sphere blend --------------------------
        p = 2.0 - c
        if self.compactify_inner:
            m = (2.0 - 1.0) / ((1.0 / self.R1) - (1.0 / self.R0))
            tt = (1.0 * self.R0 - 2.0 * self.R1) / (self.R0 - self.R1)
            R_in = m / (c - tt)
        else:
            R_in = self.R0 * (2.0 - c) + self.R1 * (c - 1.0)
        x_in = p * a + (1.0 - p) * tanx
        y_in = p * b + (1.0 - p) * tany
        q_in = R_in / torch.sqrt(
            1.0 + (1.0 - p) * (tanx**2 + tany**2) + 2.0 * p
        )

        if self.kind == "12tree_hole":
            # holed sphere: the INNER shells are pure angular too (the
            # excision surface r = R0 is a sphere, not a cube)
            R_in2 = self.R0 * (2.0 - c) + self.R1 * (c - 1.0)
            x_in, y_in = tanx, tany
            q_in = R_in2 / torch.sqrt(tanx**2 + tany**2 + 1.0)

        if self.n_outer:
            is_outer = tree < 6
            xs = torch.where(is_outer, tanx, x_in)
            ys = torch.where(is_outer, tany, y_in)
            qs = torch.where(is_outer, q_out, q_in)
        else:
            xs, ys, qs = x_in, y_in, q_in

        vec = torch.stack([qs * xs, qs * ys, qs], dim=-1)
        Q = _gather(torch.as_tensor(_ORIENT, **kw), tree % 6)  # [..., 3, 3]
        xyz_shell = torch.einsum("...ij,...j->...i", Q, vec)

        xyz_core = abc * self.Clength
        is_core = (tree == self.core_tree)[..., None]
        return torch.where(is_core, xyz_core, xyz_shell)
