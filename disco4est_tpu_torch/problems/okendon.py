"""Okendon problem: a power-law nonlinearity.

Port of `disco4est_tpu/problems/okendon.py` (role of the reference's
`Problems/Okendon/okendon_fcns.h`):
    F(u) = A u + M[(u²)^{p/2}],   J(u₀)v = A v + M[p·(u₀²)^{(p−1)/2} ⊙ v]
with analytic solution u = M_p · r^{2/(1−p)} (`okendon_fcns.h:86-92`, the
3D bracket of :90).

The regularizer 1e-300 of (u² + 1e-300) underflows to 0 in f32, so the
terms are meant for f64 fields (the driver's Jacobian solves are f64).
"""

from __future__ import annotations

import dataclasses

import torch

from disco4est_tpu_torch.laplacian.nonlinear import (
    apply_mass_fof,
    apply_mass_fof_lin,
)
from disco4est_tpu_torch.laplacian.sipg import apply_sipg
from disco4est_tpu_torch.mesh.builder import MeshData


@dataclasses.dataclass(frozen=True)
class OkendonParams:
    p: float = 0.5

    @property
    def Mp(self):
        q = 2.0 / (1.0 - self.p)
        return 1.0 / (q * (1.0 + q)) ** (1.0 / (1.0 - self.p))

    def analytic(self, x, y, z):
        r2 = x * x + y * y + z * z
        return self.Mp * r2 ** (1.0 / (1.0 - self.p))

    def boundary(self, x, y, z):
        return self.analytic(x, y, z)

    def initial_guess(self, x, y, z):
        return torch.ones_like(x)


def fof(params: OkendonParams):
    return lambda xyz, u_q: (u_q * u_q + 1e-300) ** (0.5 * params.p)


def dfof(params: OkendonParams):
    return lambda xyz, u0_q: params.p / (u0_q * u0_q + 1e-300) ** (
        0.5 * (1.0 - params.p))


def residual(mesh: MeshData, u, g, params: OkendonParams):
    return apply_sipg(mesh, u, g) + apply_mass_fof(mesh, u, fof(params))


def jacobian_apply(mesh: MeshData, u0, v, params: OkendonParams):
    return apply_sipg(mesh, v) + apply_mass_fof_lin(mesh, u0, v,
                                                     dfof(params))
