"""Additive Schwarz preconditioner/smoother — element-block stage.

Port of `disco4est_tpu/solvers/schwarz.py` (role of the reference's
Schwarz family at zero overlap, `Solver/d4est_solver_schwarz*`):
subdomains of one element each with exact dense solves.  The diagonal
blocks of the SIPG operator come from probing `apply_sipg(...,
neighbors="zero")` with the n unit vectors, one mesh-wide apply each (the
JAX module folds all n into one vmapped batch, an [n, E, n] probe of
1.07 GB at level 5, deg 3), then one batched inverse.  Used as a Krylov
preconditioner and as a (damped) multigrid smoother.
"""

from __future__ import annotations

import dataclasses

import torch

from disco4est_tpu_torch.laplacian.sipg import apply_sipg
from disco4est_tpu_torch.mesh.builder import MeshData


def assemble_diag_blocks(mesh: MeshData, op=None):
    """Exact element-diagonal blocks of the operator: [E, n, n],
    blocks[e, i, j] = (A e_j)_i.

    `op(mesh, u)` defaults to the SIPG apply with neighbor couplings
    dropped; any operator supporting `neighbors="zero"` works.  Unit
    vector j, placed in every element at once, gives column j of every
    block."""
    if op is None:
        op = lambda m, u: apply_sipg(m, u, neighbors="zero")
    dim, nl = mesh.dim, mesh.nl
    E = mesh.n_elements
    n = nl**dim
    kw = dict(dtype=mesh.sigma.dtype, device=mesh.device)
    blocks = torch.empty((E, n, n), **kw)
    eye = torch.eye(n, **kw)
    for j in range(n):
        col = op(mesh, eye[j].reshape((1,) + (nl,) * dim).expand(
            (E,) + (nl,) * dim).contiguous())
        blocks[:, :, j] = col.reshape(E, n)
    return blocks


def _apply_blocks(blocks, r):
    """Per-element block times vector: [E, n, n] · r[E, nl...]."""
    E = r.shape[0]
    out = torch.matmul(blocks.to(r.dtype), r.reshape(E, -1, 1))
    return out.reshape(r.shape)


@dataclasses.dataclass
class BlockSchwarz:
    """Zero-overlap additive Schwarz: r ↦ blockwise A_ee⁻¹ r."""

    inv_blocks: torch.Tensor  # [E, n, n]

    @staticmethod
    def setup(mesh: MeshData, op=None) -> "BlockSchwarz":
        return BlockSchwarz(
            inv_blocks=torch.linalg.inv(assemble_diag_blocks(mesh, op=op)))

    def __call__(self, r):
        return _apply_blocks(self.inv_blocks, r)


def schwarz_smooth(A, M: BlockSchwarz, b, x, iterations: int = 3,
                   damping: float = 2.0 / 3.0):
    """Damped block-Schwarz smoothing iterations (the reference's
    `mg_smoother_schwarz` role at overlap 0)."""
    for _ in range(iterations):
        x = x + damping * M(b - A(x))
    return x
