"""Brick (rectangular box) geometry, possibly multi-tree.

Port of `disco4est_tpu/geometry/brick.py` (role of the reference's
`Geometry/d4est_geometry_brick.c`): an axis-aligned box
[X0,X1]×[Y0,Y1](×[Z0,Z1]) covered by an (nx, ny, nz) grid of trees.  The
map is affine per tree and its Jacobian is analytic.
"""

from __future__ import annotations

import numpy as np
import torch

from disco4est_tpu_torch.geometry.base import Connectivity, Geometry


class BrickGeometry(Geometry):
    is_affine = True
    is_orthogonal = True

    def __init__(
        self,
        x0=(0.0, 0.0, 0.0),
        x1=(1.0, 1.0, 1.0),
        n_trees_per_dim=(1, 1, 1),
        dim: int = 3,
    ):
        self.dim = dim
        self.x0 = np.asarray(x0[:dim], np.float64)
        self.x1 = np.asarray(x1[:dim], np.float64)
        self.nt = tuple(int(n) for n in n_trees_per_dim[:dim])
        self.conn = _brick_connectivity(dim, self.nt)
        grid = np.stack(
            np.meshgrid(*[np.arange(n) for n in self.nt], indexing="ij"),
            axis=-1,
        ).reshape(-1, dim)
        # tree ids run x fastest (p4est brick order)
        keys = sum(
            grid[:, d] * int(np.prod(self.nt[:d])) for d in range(dim)
        )
        self.tree_origin = grid[np.argsort(keys)].astype(np.float64)
        self.cell = (self.x1 - self.x0) / np.asarray(self.nt, np.float64)
        # cubic cells => every element is a cube (MeshData.iso)
        self.is_isotropic = bool(
            np.allclose(self.cell, self.cell[0], rtol=1e-14)
        )

    def _key(self):
        return (self.dim, tuple(self.x0), tuple(self.x1), self.nt)

    def __eq__(self, other):
        return (
            isinstance(other, BrickGeometry) and self._key() == other._key()
        )

    def __hash__(self):
        return hash(self._key())

    def x(self, tree, rst):
        kw = dict(dtype=rst.dtype, device=rst.device)
        origin = torch.as_tensor(self.tree_origin, **kw)[tree]
        return torch.as_tensor(self.x0, **kw) + (origin + rst) * torch.as_tensor(
            self.cell, **kw
        )

    def dx(self, tree, rst):
        d = torch.diag(torch.as_tensor(self.cell, dtype=rst.dtype,
                                       device=rst.device))
        return torch.broadcast_to(d, (*rst.shape[:-1], self.dim, self.dim))


def _brick_connectivity(dim: int, nt: tuple) -> Connectivity:
    T = int(np.prod(nt))
    nbr_tree = -np.ones((T, 2 * dim), np.int32)
    nbr_face = np.zeros((T, 2 * dim), np.int32)
    axis_map = np.tile(np.arange(dim, dtype=np.int8), (T, 2 * dim, 1))
    axis_flip = np.zeros((T, 2 * dim, dim), np.int8)
    strides = [int(np.prod(nt[:d])) for d in range(dim)]

    def tid(coords):
        return sum(coords[d] * strides[d] for d in range(dim))

    for t in range(T):
        coords = [(t // strides[d]) % nt[d] for d in range(dim)]
        for d in range(dim):
            for side in (0, 1):
                f = 2 * d + side
                nc = list(coords)
                nc[d] += 1 if side else -1
                if 0 <= nc[d] < nt[d]:
                    nbr_tree[t, f] = tid(nc)
                    nbr_face[t, f] = 2 * d + (1 - side)
    return Connectivity(
        dim=dim,
        nbr_tree=nbr_tree,
        nbr_face=nbr_face,
        axis_map=axis_map,
        axis_flip=axis_flip,
    )
