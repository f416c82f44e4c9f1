"""5-tree disk geometry (2D): center square + 4 circle-blended wedges.

Port of `disco4est_tpu/geometry/disk.py` (role of the reference's
`Geometry/d4est_geometry_disk.c:144-325`, `d4est_geometry_5treedisk_new`):
the disk of radius R1 with an inner square of half-diagonal R0 — tree 2
is the affine center square [-R0/√2, R0/√2]², trees 0/1/3/4 are the
bottom/left/right/top wedges whose outer edge blends onto the circle
r = R1 (`map_cube_to_slab`: x(c) interpolates between the straight chord
at c = 0 and the circular arc x·√(1+ȳ²) = const at c = 1).

The connectivity is p4est's `p4est_connectivity_new_disk_nonperiodic`
(p4est_connectivity.c:1880), converted to the axis-map encoding by
matching shared tree vertices (host numpy, copied unchanged).

`x` evaluates the five tree maps and picks each point's own with one
`where` per tree (the JAX module stacks them and uses
`take_along_axis`): every branch is traced for every point, so the base
class's `jacfwd` under `vmap` differentiates each tree's map.
"""

from __future__ import annotations

import numpy as np
import torch

from disco4est_tpu_torch.geometry.base import Connectivity, Geometry

# p4est_connectivity_new_disk_nonperiodic tables
_T2V = np.array(
    [
        [4, 5, 0, 1],
        [4, 0, 6, 2],
        [0, 1, 2, 3],
        [1, 5, 3, 7],
        [2, 3, 6, 7],
    ]
)
_T2T = np.array(
    [
        [1, 3, 0, 2],
        [1, 2, 0, 4],
        [1, 3, 0, 4],
        [2, 3, 0, 4],
        [1, 3, 2, 4],
    ]
)
_T2F = np.array(
    [
        [2, 6, 2, 2],
        [0, 0, 0, 4],
        [1, 0, 3, 2],
        [1, 1, 5, 1],
        [7, 3, 3, 3],
    ]
)

# 2D face -> local corner ids, ordered by increasing tangent coordinate
_FACE_CORNERS_2D = np.array([[0, 2], [1, 3], [0, 1], [2, 3]])


def connectivity_from_p4est_2d(
    tree_to_vertex: np.ndarray,
    tree_to_tree: np.ndarray,
    tree_to_face: np.ndarray,
) -> Connectivity:
    """2D converter (JAX `connectivity_from_p4est_2d`): orientations
    resolved by matching the SHARED tree vertices (robust against
    p4est's 2D orientation sign conventions)."""
    T = tree_to_tree.shape[0]
    dim = 2
    nbr_tree = -np.ones((T, 4), np.int32)
    nbr_face = np.zeros((T, 4), np.int32)
    axis_map = np.tile(np.arange(dim, dtype=np.int8), (T, 4, 1))
    axis_flip = np.zeros((T, 4, dim), np.int8)
    for t in range(T):
        for f in range(4):
            nt = int(tree_to_tree[t, f])
            nf = int(tree_to_face[t, f]) % 4
            if nt == t and nf == f:
                continue  # boundary
            mine = tree_to_vertex[t, _FACE_CORNERS_2D[f]]
            theirs = tree_to_vertex[nt, _FACE_CORNERS_2D[nf]]
            if tuple(mine) == tuple(theirs):
                tflip = 0
            elif tuple(mine) == tuple(theirs[::-1]):
                tflip = 1
            else:  # pragma: no cover
                raise ValueError("faces do not share vertices")
            a0, na0 = f // 2, nf // 2
            amap = np.arange(dim, dtype=np.int8)
            aflip = np.zeros(dim, np.int8)
            amap[a0] = na0
            aflip[a0] = 1 if (f % 2) == (nf % 2) else 0
            amap[1 - a0] = 1 - na0
            aflip[1 - a0] = tflip
            nbr_tree[t, f] = nt
            nbr_face[t, f] = nf
            axis_map[t, f] = amap
            axis_flip[t, f] = aflip
    return Connectivity(
        dim=dim,
        nbr_tree=nbr_tree,
        nbr_face=nbr_face,
        axis_map=axis_map,
        axis_flip=axis_flip,
    )


def _slab(xref, yref, cmin, cmax, emin, emax):
    """`d4est_geometry_5treedisk_map_cube_to_slab`."""
    xbar = emin + (emax - emin) * xref
    ybar = 2.0 * yref - 1.0
    root = torch.sqrt(1.0 + ybar * ybar)
    xmin = (1.0 - cmin) * emin + emin * cmin / root
    xmax = (1.0 - cmax) * emax + emax * cmax / root
    xx = xmin + (xmax - xmin) * (xbar - emin) / (emax - emin)
    return xx, xx * ybar


class DiskGeometry(Geometry):
    """5-tree disk (`d4est_geometry_5treedisk_X`; JAX `DiskGeometry`)."""

    dim = 2
    is_affine = False

    def __init__(self, R0: float = 0.5, R1: float = 1.0):
        self.R0 = float(R0)
        self.R1 = float(R1)
        self.conn = connectivity_from_p4est_2d(_T2V, _T2T, _T2F)

    def _key(self):
        return (self.R0, self.R1)

    def __eq__(self, other):
        return isinstance(other, DiskGeometry) and self._key() == other._key()

    def __hash__(self):
        return hash(("disk5", self._key()))

    def x(self, tree, rst):
        """rst in [0,1]² tree coords -> physical (x, y)."""
        tree = torch.broadcast_to(torch.as_tensor(tree, device=rst.device),
                                  rst.shape[:-1])
        xr, yr = rst[..., 0], rst[..., 1]
        R1 = self.R1
        s = self.R0 / np.sqrt(2.0)
        # tree 0 (bottom): (y, x) = slab(yref, xref, 1, 0, -R1, -s); x*=-1
        y0, x0 = _slab(yr, xr, 1.0, 0.0, -R1, -s)
        # tree 1 (left): (x, y) = slab(xref, yref, 1, 0, -R1, -s); y*=-1
        x1, y1 = _slab(xr, yr, 1.0, 0.0, -R1, -s)
        # tree 2 (center): affine square
        x2 = -s + 2.0 * s * xr
        y2 = -s + 2.0 * s * yr
        # tree 3 (right): (x, y) = slab(xref, yref, 0, 1, s, R1)
        x3, y3 = _slab(xr, yr, 0.0, 1.0, s, R1)
        # tree 4 (top): (y, x) = slab(yref, xref, 0, 1, s, R1)
        y4, x4 = _slab(yr, xr, 0.0, 1.0, s, R1)
        xs = (-x0, x1, x2, x3, x4)
        ys = (y0, -y1, y2, y3, y4)
        x, y = xs[4], ys[4]
        for t in (3, 2, 1, 0):
            on = tree == t
            x = torch.where(on, xs[t], x)
            y = torch.where(on, ys[t], y)
        return torch.stack([x, y], dim=-1)
