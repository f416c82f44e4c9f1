"""TwoPunctures: Bowen-York binary-black-hole initial data (the flagship
nonlinear problem).

Port of `disco4est_tpu/problems/two_punctures.py` (role of the
reference's `Problems/TwoPunctures/two_punctures_cactus_fcns.h`): solve
the punctured Hamiltonian constraint for the correction u

    −∇²u = (1/8)·A_{ij}A^{ij}·ψ⁻⁷,   ψ = 1 + m₊/(2r₊) + m₋/(2r₋) + u,

with the Bowen-York extrinsic curvature A_ij of two punctures at (±b,0,0)
carrying linear momenta P± (`BY_Aijofxyz` / `BY_KKofxyz`, fcns.h:79-205;
defaults m± = M/2, b = 3M, P± = (0, ±0.2M, 0), fcns.h:46-75).

    F(u) = A u + M[−(1/8)K²ψ⁻⁷],   J(u₀)v = A v + M[(7/8)K²ψ₀⁻⁸ ⊙ v]

Boundary: Robin ∂u/∂n + u/r = 0 at the outer sphere (coefficient 1/r,
rhs 0), on the 7-tree or 13-tree cubed sphere.  Robin data take the
general apply (`fast_path_available` refuses them).
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
class TwoPuncturesParams:
    M: float = 1.0
    par_b: float = 3.0
    m_plus: float = 0.5
    m_minus: float = 0.5
    P_plus: tuple = (0.0, 0.2, 0.0)
    P_minus: tuple = (0.0, -0.2, 0.0)
    TP_epsilon: float = 0.0

    def KK(self, x, y, z):
        """A_ij A^ij of the two Bowen-York punctures (`BY_KKofxyz`)."""
        Aij = self._Aij(x, y, z)
        return sum(Aij[i][j] * Aij[i][j] for i in range(3) for j in range(3))

    def _Aij(self, x, y, z):
        P_p, P_m = self.P_plus, self.P_minus
        b = self.par_b
        r2p = (x - b) ** 2 + y * y + z * z
        r2m = (x + b) ** 2 + y * y + z * z
        if self.TP_epsilon > 0:
            r2p = torch.sqrt(r2p**2 + self.TP_epsilon**4)
            r2m = torch.sqrt(r2m**2 + self.TP_epsilon**4)
        rp = torch.sqrt(r2p)
        rm = torch.sqrt(r2m)
        n_p = [(x - b) / rp, y / rp, z / rp]
        n_m = [(x + b) / rm, y / rm, z / rm]
        npPp = sum(n_p[i] * P_p[i] for i in range(3))
        nmPm = sum(n_m[i] * P_m[i] for i in range(3))
        A = [[None] * 3 for _ in range(3)]
        for i in range(3):
            for j in range(3):
                a = (
                    1.5
                    * (P_p[i] * n_p[j] + P_p[j] * n_p[i]
                       + npPp * n_p[i] * n_p[j])
                    / r2p
                    + 1.5
                    * (P_m[i] * n_m[j] + P_m[j] * n_m[i]
                       + nmPm * n_m[i] * n_m[j])
                    / r2m
                )
                if i == j:
                    a = a - 1.5 * (npPp / r2p + nmPm / r2m)
                A[i][j] = a
        return A

    def psi_puncture(self, x, y, z, u):
        """ψ = 1 + m₊/2r₊ + m₋/2r₋ + u."""
        b = self.par_b
        rp = torch.sqrt((x - b) ** 2 + y * y + z * z)
        rm = torch.sqrt((x + b) ** 2 + y * y + z * z)
        return 1.0 + 0.5 * self.m_plus / rp + 0.5 * self.m_minus / rm + u

    def initial_guess(self, x, y, z):
        return torch.zeros_like(x)

    def robin_coeff(self, x, y, z):
        """1/r (`two_punctures_robin_coeff_sphere_fcn`)."""
        return 1.0 / torch.sqrt(x * x + y * y + z * z)


def fof(params: TwoPuncturesParams):
    """−⅛K²ψ⁻⁷ at the quadrature points."""

    def f(xyz, u_q):
        x, y, z = xyz
        psi = params.psi_puncture(x, y, z, u_q)
        return -0.125 * params.KK(x, y, z) / psi**7

    return f


def dfof(params: TwoPuncturesParams):
    """⅞K²ψ₀⁻⁸ at the quadrature points."""

    def df(xyz, u0_q):
        x, y, z = xyz
        psi = params.psi_puncture(x, y, z, u0_q)
        return 0.875 * params.KK(x, y, z) / psi**8

    return df


def residual(mesh: MeshData, u, params: TwoPuncturesParams, robin_coeff):
    """F(u) = Au (Robin bc) + M[−⅛K²ψ⁻⁷]
    (`two_punctures_neg_1o8_K2_psi_neg7`)."""
    Au = apply_sipg(mesh, u, robin_coeff=robin_coeff)
    return Au + apply_mass_fof(mesh, u, fof(params))


def jacobian_apply(mesh: MeshData, u0, v, params: TwoPuncturesParams,
                   robin_coeff):
    """J(u₀)v = Av + M[⅞K²ψ₀⁻⁸ ⊙ v]
    (`two_punctures_plus_7o8_K2_psi_neg8`)."""
    Av = apply_sipg(mesh, v, robin_coeff=robin_coeff)
    return Av + apply_mass_fof_lin(mesh, u0, v, dfof(params))
