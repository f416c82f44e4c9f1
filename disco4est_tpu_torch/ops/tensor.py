"""Batched tensor-product (Kronecker) applies.

Port of `disco4est_tpu/ops/tensor.py` (role of the reference's
`Kron/d4est_kron.h`): every per-element operator application is a batched
contraction over an element axis.  Element fields are tensors
`u[E, n_dim, ..., n_1]` with axis order (z, y, x), so `u.reshape(E, -1)`
matches the reference's x-fastest node ordering.

Direction convention (matches p4est): dir 0 = x = last axis, dir 1 = y,
dir 2 = z.  Face numbering: face 2·dir + side with side 0 = low.
"""

from __future__ import annotations

import numpy as np
import torch


def apply_axis(A, u, dir_: int):
    """Contract `A[m, n]` with `u[..., n_dim, ..., n_1]` along direction
    `dir_` (0 = last axis).  Returns a tensor with that axis resized to m."""
    A = torch.as_tensor(A, dtype=u.dtype, device=u.device)
    axis = u.ndim - 1 - dir_
    out = torch.movedim(u, axis, -1) @ A.T
    return torch.movedim(out, -1, axis)


def apply_tensor(mats, u, dim: int):
    """Apply mats[d] along direction d for d = 0..dim-1 (A₁⊗…⊗A_dim · u)."""
    out = u
    for d in range(dim):
        out = apply_axis(mats[d], out, d)
    return out


def apply_iso(A, u, dim: int):
    """Apply the same matrix along every direction (A⊗A⊗A · u)."""
    return apply_tensor([A] * dim, u, dim)


def tensor_weights(w_per_dir, dtype=torch.float64, device=None):
    """Outer product of 1D weight vectors -> [n_dim, ..., n_1] tensor."""
    dim = len(w_per_dir)
    kw = dict(dtype=dtype, device=device)
    out = torch.as_tensor(w_per_dir[dim - 1], **kw)
    for d in range(dim - 2, -1, -1):
        out = out[..., None] * torch.as_tensor(w_per_dir[d], **kw)
    return out


def face_slice(u, face: int, dim: int):
    """Extract the face plane of `u[..., n_dim, ..., n_1]` (the reference's
    slicer, `d4est_operators_apply_slicer`): the face direction's axis is
    dropped, the others keep their (z, y, x) order."""
    dir_, side = divmod(face, 2)
    axis = u.ndim - 1 - dir_
    return u.select(axis, 0 if side == 0 else u.shape[axis] - 1)


def np_face_slice_indices(face: int, dim: int, n: int) -> np.ndarray:
    """Flat volume-node indices of a face plane (x-fastest ordering).
    Host-side helper for building gather maps."""
    shape = (n,) * dim
    vol = np.arange(n**dim).reshape(shape)  # axes (z, y, x)
    dir_, side = divmod(face, 2)
    axis = dim - 1 - dir_
    idx = [slice(None)] * dim
    idx[axis] = 0 if side == 0 else -1
    return vol[tuple(idx)].reshape(-1)
