"""Stamm problem: an hp-AMR benchmark with an r³ point singularity.

Port of `disco4est_tpu/problems/stamm.py` (role of the reference's
`Problems/Stamm/stamm_fcns.h`):
    u = x(1−x)·y(1−y)[·z(1−z)] · |x−c|³,   u = 0 on ∂[0,1]^dim,
with c the singular point ([problem] c2x/c2y/c2z; default 0.5, 0.5, 0.5).
The reference transcribes a machine-generated closed form of f = −Δu
(`stamm_fcns.h:150-230`); here, as in the JAX module, f comes from
autodiff of the analytic solution: `torch.func.hessian` under
`torch.func.vmap` (the counterpart of `jax.hessian` under `jax.vmap`).
"""

from __future__ import annotations

import torch


def neg_laplacian(fcn, dim: int):
    """Pointwise f(x...) = −Δ fcn by autodiff, mapped over point arrays
    of any shape."""

    def u_at(p):
        return fcn(*[p[i] for i in range(dim)])

    hess = torch.func.vmap(torch.func.hessian(u_at))

    def f(*coords):
        pts = torch.stack([torch.as_tensor(c) for c in coords], dim=-1)
        flat = pts.reshape(-1, dim)
        if flat.shape[0] == 0:
            return torch.zeros_like(pts[..., 0])
        lap = torch.diagonal(hess(flat), dim1=-2, dim2=-1).sum(-1)
        # the reference sets the singular point to 0 (`stamm_rhs_fcn`:
        # `if (x == c2x && ...) return 0.`); autodiff gives 0·∞ = NaN
        # there: masked the same way
        lap = torch.where(torch.isfinite(lap), lap, 0.0)
        return -lap.reshape(pts.shape[:-1])

    return f


class StammProblem:
    def __init__(self, c=(0.5, 0.5, 0.5), dim=3):
        self.c = c[:dim]
        self.dim = dim
        self.rhs = neg_laplacian(self.analytic, dim)

    def analytic(self, *coords):
        poly = 1.0
        for x in coords:
            poly = poly * x * (1.0 - x)
        r2 = sum((x - c) ** 2 for x, c in zip(coords, self.c))
        return poly * r2**1.5

    def boundary(self, *coords):
        return torch.zeros_like(coords[0])
