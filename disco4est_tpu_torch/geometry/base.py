"""Geometry protocol: multi-block analytic maps + tree connectivity.

Port of `disco4est_tpu/geometry/base.py`.  A `Geometry` provides one map
`x(tree, rst)` from per-tree unit coordinates to physical space (torch
tensors in, torch tensors out).  The default Jacobian `dx` is forward-mode
autodiff (`torch.func.jacfwd` under `torch.func.vmap`), the counterpart of
the JAX package's `jax.jacfwd` under `jax.vmap`; subclasses may override
`dx` with an analytic Jacobian (the brick does).

`Connectivity` plays the role of p4est's `p4est_connectivity_t`: which
tree touches which through each face, and with what coordinate transform.
It is host numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Connectivity:
    """Tree-to-tree adjacency through faces.

    nbr_tree[t, f]   = neighboring tree id, or -1 at a physical boundary.
    nbr_face[t, f]   = which face of the neighbor touches.
    axis_map[t, f]   = [dim] permutation: my axis a maps to neighbor axis
                       axis_map[a].
    axis_flip[t, f]  = [dim] sign flags: 1 if my axis a is reversed in the
                       neighbor's frame.
    """

    dim: int
    nbr_tree: np.ndarray  # [T, 2*dim] int32
    nbr_face: np.ndarray  # [T, 2*dim] int32
    axis_map: np.ndarray  # [T, 2*dim, dim] int8
    axis_flip: np.ndarray  # [T, 2*dim, dim] int8

    @property
    def n_trees(self) -> int:
        return self.nbr_tree.shape[0]

    @staticmethod
    def single_tree(dim: int) -> "Connectivity":
        """One tree, all faces physical boundary."""
        return Connectivity(
            dim=dim,
            nbr_tree=-np.ones((1, 2 * dim), np.int32),
            nbr_face=np.zeros((1, 2 * dim), np.int32),
            axis_map=np.tile(np.arange(dim, dtype=np.int8), (1, 2 * dim, 1)),
            axis_flip=np.zeros((1, 2 * dim, dim), np.int8),
        )


class Geometry:
    """Base geometry: subclasses define `x(tree, rst)`.

    `rst` is a float64 tensor of tree-local coordinates in [0, 1]^dim with
    shape [..., dim]; `tree` is an integer tensor broadcastable against
    rst's leading dims.  `is_affine` / `is_orthogonal` have the JAX
    package's meaning (constant / diagonal Jacobian).
    """

    dim: int
    conn: Connectivity
    is_affine: bool = False
    is_orthogonal: bool = False
    # geometry regions (`d4est_geometry.h:117-118` get_region): tree →
    # region id, for the per-region estimator statistics
    n_regions: int = 1

    def tree_region(self, tree):
        """Geometry region (`d4est_geometry.h:117-118` get_region) per tree,
        for the per-region estimator stats; one region unless a geometry
        says otherwise."""
        return np.zeros_like(np.asarray(tree), dtype=np.int32)

    def x(self, tree, rst):
        """Physical coordinates; rst [..., dim] -> [..., dim]."""
        raise NotImplementedError

    def dx(self, tree, rst):
        """Jacobian ∂x_i/∂rst_j, shape [..., dim, dim]; default autodiff."""
        lead = rst.shape[:-1]
        if rst.numel() == 0:  # vmap cannot map over an empty batch
            return rst.new_zeros((*lead, self.dim, self.dim))
        flat_tree = torch.broadcast_to(torch.as_tensor(tree), lead).reshape(-1)
        flat_rst = rst.reshape(-1, self.dim)
        jac = torch.func.vmap(
            lambda t, r: torch.func.jacfwd(lambda rr: self.x(t, rr))(r)
        )(flat_tree, flat_rst)
        return jac.reshape(*lead, self.dim, self.dim)
