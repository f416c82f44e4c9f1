"""BoyenYorkModel: one Bowen-York black hole (Hamiltonian constraint on an
excised sphere).

Port of `disco4est_tpu/problems/boyen_york.py` (role of the reference's
`Problems/BoyenYorkModel/boyen_york_model_fcns.h`): solve, on the holed
sphere r ∈ [R0, R2],

    −∇²ψ + h(x)·ψ⁻⁷ = 0,   h = ¾ (P²/r⁴)(1 − a²/r²)²,

with the exact Bowen-York solution as Dirichlet data:

    ψ = (1 + 2E/r + 6a²/r² + 2a²E/r³ + a⁴/r⁴)^{1/4},  E = √(P² + 4a²)

(`boyen_york_model_analytic_solution` :67-95, `_helmholtz_fcn` :110-128).
The sign of the nonlinear term is the JAX module's: the one under which
the analytic solution is exact (its `residual` docstring says why it
differs from the reference's :130-145).  API only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from disco4est_tpu_torch.laplacian.nonlinear import (
    apply_mass_fof,
    apply_mass_fof_lin,
)
from disco4est_tpu_torch.laplacian.sipg import apply_sipg
from disco4est_tpu_torch.mesh.builder import MeshData


@dataclasses.dataclass(frozen=True)
class BoyenYorkParams:
    a: float = 1.0
    P: float = 1.0

    @property
    def E(self) -> float:
        return math.sqrt(self.P**2 + 4.0 * self.a**2)

    def analytic(self, x, y, z):
        r2 = x * x + y * y + z * z
        r = torch.sqrt(r2)
        a2 = self.a * self.a
        E = self.E
        s = (1.0 + 2.0 * E / r + 6.0 * a2 / r2 + 2.0 * a2 * E / (r * r2)
             + a2 * a2 / (r2 * r2))
        return s**0.25

    boundary = analytic

    def initial_guess(self, x, y, z):
        return self.analytic(x, y, z)

    def helmholtz(self, x, y, z):
        r2 = x * x + y * y + z * z
        return 0.75 * (self.P**2 / (r2 * r2)) * (1.0 - self.a**2 / r2) ** 2


def residual(mesh: MeshData, u, g, params: BoyenYorkParams):
    """F(ψ) = Aψ (Dirichlet data g) − M[h·ψ⁻⁷]."""

    def fof(xyz, u_q):
        x, y, z = xyz
        return -params.helmholtz(x, y, z) / (u_q * u_q) ** 3.5

    return apply_sipg(mesh, u, g) + apply_mass_fof(mesh, u, fof)


def jacobian_apply(mesh: MeshData, u0, v, params: BoyenYorkParams):
    """J(ψ₀)v = Av + M[7h·ψ₀⁻⁸ ⊙ v] (sign per `residual`)."""

    def dfof(xyz, u0_q):
        x, y, z = xyz
        return 7.0 * params.helmholtz(x, y, z) / (u0_q * u0_q) ** 4

    return apply_sipg(mesh, v) + apply_mass_fof_lin(mesh, u0, v, dfof)
