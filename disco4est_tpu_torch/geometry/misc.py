"""Miscellaneous reference geometries: trapezoid, pizza-half, hole-in-a-box.

Port of `disco4est_tpu/geometry/misc.py`:

- `TrapGeometry`: single bilinear quad tree with vertices
  (0,0), (1,-1/2), (0,1), (1,3/2) — role of
  `Geometry/d4est_geometry_trap.c:4-36` (the vertex-bilinear map);
- `PizzaHalfGeometry`: single-tree 2D wedge from the vertical chord
  x = 0 to the circular arc of radius R1 centred at (-R0/√2, 0) —
  `Geometry/d4est_geometry_pizza_half.c:80-125` (`map_cube_to_slab` with
  cmin=0, cmax=1, emin=R0/√2, emax=R1, then the x -= R0/√2 shift);
- `HoleInABoxGeometry`: cube of side `box_length` with a spherical
  excision of radius `inner_radius`/√3 — the FULL_WEDGE general-wedge
  map with curvature 1 at zmin = inner_radius/√3 (sphere) and curvature
  0 at zmax = box_length/2 (flat box face), rotated per tree
  (`Geometry/d4est_geometry_hole_in_a_box.c:128-166`,
  `d4est_geometry_general_wedge.c:7-57`) on the 12-tree
  `d4est_connectivity_new_sphere_with_hole`.

  Deviation from the reference, kept from the JAX module by design: the
  reference applies the SAME [zmin, zmax] wedge span to both radial tree
  layers, so its two shells double-cover one physical shell.  The radial
  blend is split across the layers (trees 6-11 cover s ∈ [0, ½], trees
  0-5 cover s ∈ [½, 1]) so the 12-tree connectivity tiles the domain
  once, continuously at the layer interface.

The hole-in-a-box map gathers its tree's vertex box and orientation with
`index_select` (as `cubed_sphere.py` does), so `jacfwd` under `vmap`
traces every tree.
"""

from __future__ import annotations

import numpy as np
import torch

from disco4est_tpu_torch.geometry.base import Connectivity, Geometry
from disco4est_tpu_torch.geometry.cubed_sphere import _ORIENT, _gather
from disco4est_tpu_torch.geometry.p8est_conn import (
    connectivity_from_p8est,
    sphere12_hole_data,
)


class TrapGeometry(Geometry):
    """Trapezoid: one bilinear quad (`d4est_geometry_trap.c:10-15`; JAX
    `TrapGeometry`)."""

    dim = 2
    is_affine = False

    #: p4est corner order (x fastest): (0,0), (1,-1/2), (0,1), (1,3/2)
    VERTS = np.array([[0.0, 0.0], [1.0, -0.5], [0.0, 1.0], [1.0, 1.5]])

    def __init__(self):
        self.conn = Connectivity.single_tree(2)

    def __eq__(self, other):
        return isinstance(other, TrapGeometry)

    def __hash__(self):
        return hash("trap")

    def x(self, tree, rst):
        del tree  # single tree
        r, s = rst[..., 0], rst[..., 1]
        w = torch.stack(
            [(1 - r) * (1 - s), r * (1 - s), (1 - r) * s, r * s], dim=-1
        )
        verts = torch.as_tensor(self.VERTS, dtype=rst.dtype,
                                device=rst.device)
        return torch.einsum("...v,vc->...c", w, verts)


class PizzaHalfGeometry(Geometry):
    """Half pizza slice (`d4est_geometry_pizza_half_X`; JAX
    `PizzaHalfGeometry`)."""

    dim = 2
    is_affine = False

    def __init__(self, R0: float = 0.5, R1: float = 1.0):
        self.R0 = float(R0)
        self.R1 = float(R1)
        self.conn = Connectivity.single_tree(2)

    def _key(self):
        return (self.R0, self.R1)

    def __eq__(self, other):
        return (
            isinstance(other, PizzaHalfGeometry)
            and self._key() == other._key()
        )

    def __hash__(self):
        return hash(("pizza_half", self._key()))

    def x(self, tree, rst):
        del tree  # single tree
        xref, yref = rst[..., 0], rst[..., 1]
        emin = self.R0 / np.sqrt(2.0)
        emax = self.R1
        # map_cube_to_slab(xref, yref, cmin=0, cmax=1, emin, emax)
        xbar = emin + (emax - emin) * xref
        ybar = 2.0 * yref - 1.0
        xmax = emax / torch.sqrt(1.0 + ybar * ybar)  # cmax = 1: on the arc
        x = emin + (xmax - emin) * (xbar - emin) / (emax - emin)
        y = x * ybar
        return torch.stack([x - emin, y], dim=-1)


class HoleInABoxGeometry(Geometry):
    """Box with spherical hole (`d4est_geometry_hole_in_a_box_new`; JAX
    `HoleInABoxGeometry`).

    zmin = inner_radius/√3 (the hole is the sphere of that radius, the
    reference's parameter convention, `d4est_geometry_hole_in_a_box.c:192`),
    zmax = box_length/2.
    """

    dim = 3
    is_affine = False

    def __init__(self, inner_radius: float = 1.0, box_length: float = 10.0):
        self.inner_radius = float(inner_radius)
        self.box_length = float(box_length)
        self.zmin = self.inner_radius / np.sqrt(3.0)
        self.zmax = self.box_length / 2.0
        t2t, t2f, verts = sphere12_hole_data()
        self.conn = connectivity_from_p8est(t2t, t2f)
        self.verts = verts  # a, b in [-1,1]; c in [1,2] per layer

    def _key(self):
        return (self.inner_radius, self.box_length)

    def __eq__(self, other):
        return (
            isinstance(other, HoleInABoxGeometry)
            and self._key() == other._key()
        )

    def __hash__(self):
        return hash(("hole_in_a_box", self._key()))

    def x(self, tree, rst):
        kw = dict(dtype=rst.dtype, device=rst.device)
        tree = torch.broadcast_to(torch.as_tensor(tree, device=rst.device),
                                  rst.shape[:-1])
        verts = _gather(torch.as_tensor(self.verts, **kw), tree)  # [..., 8, 3]
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

        # two-layer radial blend: trees 6-11 inner (sphere side), 0-5 outer
        layer = torch.where(tree < 6, 1.0, 0.0).to(rst.dtype)
        sblend = (c - 1.0 + layer) / 2.0  # global s in [0, 1]

        tanx = torch.tan(a * (np.pi / 4.0))
        tany = torch.tan(b * (np.pi / 4.0))
        p = 1.0 / torch.sqrt(1.0 + tanx**2 + tany**2)
        fmin = self.zmin * p  # curvature 1: sphere r = zmin
        fmax = self.zmax  # curvature 0: flat box face
        q = fmin + (fmax - fmin) * sblend

        vec = torch.stack([q * tanx, q * tany, q], dim=-1)
        Q = _gather(torch.as_tensor(_ORIENT, **kw), tree % 6)  # [..., 3, 3]
        return torch.einsum("...ij,...j->...i", Q, vec)
