"""ConstantDensityStar: a nonlinear GR star (Hamiltonian constraint).

Port of `disco4est_tpu/problems/constant_density_star.py` (role of the
reference's `Problems/ConstantDensityStar/`, the README quickstart
problem): solve the Lichnerowicz-type equation

    −∇²ψ = 2π ρ(x) ψ⁵      on [0,1]³,  ψ = ψ_analytic on ∂Ω

for a constant-density ball ρ = ρ₀·1{|x−c|<R}, whose analytic solution is
  ψ(r) = C₀·u_α(r)         for r ≤ R   (u_α = √(αR)/√(r²+(αR)²))
  ψ(r) = 1 + β/r           for r > R
with α from the matching condition ρ₀R² = (3/2π)f(α)², f(a)=a⁵/(1+a²)³
(`constant_density_star_fcns.h:150-240`).

Weak form per the reference: F(ψ) = A ψ + M[−2πρψ⁵];  J(ψ₀)v = A v +
M[−10πρψ₀⁴ ⊙ v].  The parameters are host floats (the bisection is
numpy, a copy of the JAX module's); the fields take torch tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from disco4est_tpu_torch.laplacian.nonlinear import (
    apply_mass_fof,
    apply_mass_fof_lin,
)
from disco4est_tpu_torch.laplacian.sipg import apply_sipg
from disco4est_tpu_torch.mesh.builder import MeshData


@dataclasses.dataclass(frozen=True)
class CDSParams:
    R: float = 0.0625
    cx: float = 0.5
    cy: float = 0.5
    cz: float = 0.5
    rho0_div_rhoc: float = 0.001
    rho0: float = 0.0
    C0: float = 0.0
    alpha: float = 0.0
    beta: float = 0.0

    @staticmethod
    def create(R=0.0625, cx=0.5, cy=0.5, cz=0.5, rho0_div_rhoc=0.001):
        rhoc = (3.0 / (2.0 * np.pi)) * (1.0 / (R * R)) * (5.0**5 / 6.0**6)
        rho0 = rho0_div_rhoc * rhoc
        C0 = (1.0 / (2.0 * np.pi * rho0 / 3.0)) ** 0.25

        def f_of(a):
            f = a**5 / (1.0 + a * a) ** 3
            return rho0 * R * R - (3.0 / (2.0 * np.pi)) * f * f

        # bisection on [√5, 1000√5] (`d4est_util_bisection` usage)
        lo, hi = np.sqrt(5.0), 1000.0 * np.sqrt(5.0)
        flo = f_of(lo)
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            fm = f_of(mid)
            if flo * fm <= 0:
                hi = mid
            else:
                lo, flo = mid, fm
        alpha = 0.5 * (lo + hi)
        u_alpha_at_R = np.sqrt(alpha * R) / np.sqrt(R * R + (alpha * R) ** 2)
        beta = R * (C0 * u_alpha_at_R - 1.0)
        return CDSParams(
            R=float(R), cx=float(cx), cy=float(cy), cz=float(cz),
            rho0_div_rhoc=float(rho0_div_rhoc), rho0=float(rho0),
            C0=float(C0), alpha=float(alpha), beta=float(beta),
        )

    # ---- fields ---------------------------------------------------------

    def _r2(self, x, y, z):
        return (x - self.cx) ** 2 + (y - self.cy) ** 2 + (z - self.cz) ** 2

    def psi(self, x, y, z):
        r2 = self._r2(x, y, z)
        aR = self.alpha * self.R
        out = r2 > self.R**2
        inner = self.C0 * np.sqrt(aR) / torch.sqrt(r2 + aR * aR)
        # the star's center is a Lobatto node of every brick from level 1
        # up: the outer branch reads r² only where it is selected, so no
        # 1/0 is ever formed
        outer = 1.0 + self.beta / torch.sqrt(torch.where(out, r2, 1.0))
        return torch.where(out, outer, inner)

    def rho(self, x, y, z):
        r2 = self._r2(x, y, z)
        return torch.where(r2 > self.R**2, 0.0, torch.full_like(r2, self.rho0))

    def initial_guess(self, x, y, z):
        return torch.ones_like(x)


def fof(params: CDSParams):
    """−2πρψ⁵ at the quadrature points."""
    return lambda xyz, psi_q: -2.0 * np.pi * params.rho(*xyz) * psi_q**5


def dfof(params: CDSParams):
    """−10πρψ₀⁴ at the quadrature points."""
    return lambda xyz, psi0_q: -10.0 * np.pi * params.rho(*xyz) * psi0_q**4


def residual(mesh: MeshData, u, g, params: CDSParams):
    """F(ψ) = Aψ (with Dirichlet data g) + M[−2πρψ⁵]."""
    return apply_sipg(mesh, u, g) + apply_mass_fof(mesh, u, fof(params))


def jacobian_apply(mesh: MeshData, u0, v, params: CDSParams):
    """J(ψ₀)v = Av + M[−10πρψ₀⁴ ⊙ v] (homogeneous BCs)."""
    return apply_sipg(mesh, v) + apply_mass_fof_lin(mesh, u0, v,
                                                     dfof(params))
