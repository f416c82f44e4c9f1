"""Multi-puncture Bowen-York initial data (N black holes with momenta and
spins).

Port of `disco4est_tpu/problems/multi_puncture.py` (role of the
reference's `Problems/TwoPunctures/multi_puncture_fcns.h`): the punctured
Hamiltonian constraint for N punctures at X_n with masses M_n, momenta
P_n and spins S_n:

    A_ij = Σ_n [ (3/2r_n²)(P_i n_j + P_j n_i − (δ_ij − n_i n_j)P·n)
               + (3/r_n³)((S×n)_i n_j + (S×n)_j n_i) ]      (:292-330)
    ψ = 1 + u + Σ_n M_n/(2 r_n)                             (:359-383)
    F(u) = A u + M[−⅛ A_ij A^ij ψ⁻⁷]
    J(u₀)v = A v + M[⅞ A_ij A^ij ψ₀⁻⁸ ⊙ v]

with the Robin boundary u/r + ∂u/∂n = 0 of TwoPunctures.  API only: no
driver problem class uses it, as in the JAX package.
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
class Puncture:
    xyz: tuple
    M: float
    P: tuple = (0.0, 0.0, 0.0)
    S: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class MultiPunctureParams:
    punctures: tuple  # tuple[Puncture, ...]

    def _Aij(self, x, y, z):
        A = [[0.0] * 3 for _ in range(3)]
        for p in self.punctures:
            dx = x - p.xyz[0]
            dy = y - p.xyz[1]
            dz = z - p.xyz[2]
            r2 = dx * dx + dy * dy + dz * dz
            r = torch.sqrt(r2)
            n = [dx / r, dy / r, dz / r]
            P, S = p.P, p.S
            SxN = [
                -n[2] * S[1] + n[1] * S[2],
                n[2] * S[0] - n[0] * S[2],
                -n[1] * S[0] + n[0] * S[1],
            ]
            PdotN = P[0] * n[0] + P[1] * n[1] + P[2] * n[2]
            for a in range(3):
                for b in range(3):
                    gab = 1.0 if a == b else 0.0
                    t1 = (1.5 / r2) * (
                        P[a] * n[b] + P[b] * n[a]
                        - (gab - n[a] * n[b]) * PdotN
                    )
                    t2 = (3.0 / (r2 * r)) * (SxN[a] * n[b] + SxN[b] * n[a])
                    A[a][b] = A[a][b] + t1 + t2
        return A

    def KK(self, x, y, z):
        """A_ij A^ij summed over the punctures (`AijAij_fcn`)."""
        A = self._Aij(x, y, z)
        return sum(A[i][j] * A[i][j] for i in range(3) for j in range(3))

    def psi_puncture(self, x, y, z, u):
        s = 1.0 + u
        for p in self.punctures:
            r = torch.sqrt((x - p.xyz[0]) ** 2 + (y - p.xyz[1]) ** 2
                           + (z - p.xyz[2]) ** 2)
            s = s + 0.5 * p.M / r
        return s

    def initial_guess(self, x, y, z):
        return torch.zeros_like(x)

    def robin_coeff(self, x, y, z):
        return 1.0 / torch.sqrt(x * x + y * y + z * z)


def fof(params: MultiPunctureParams):
    """−⅛K²ψ⁻⁷ at the quadrature points."""

    def f(xyz, u_q):
        x, y, z = xyz
        psi = params.psi_puncture(x, y, z, u_q)
        return -0.125 * params.KK(x, y, z) / psi**7

    return f


def dfof(params: MultiPunctureParams):
    """⅞K²ψ₀⁻⁸ at the quadrature points."""

    def df(xyz, u0_q):
        x, y, z = xyz
        psi = params.psi_puncture(x, y, z, u0_q)
        return 0.875 * params.KK(x, y, z) / psi**8

    return df


def residual(mesh: MeshData, u, params: MultiPunctureParams, robin_coeff):
    Au = apply_sipg(mesh, u, robin_coeff=robin_coeff)
    return Au + apply_mass_fof(mesh, u, fof(params))


def jacobian_apply(mesh: MeshData, u0, v, params: MultiPunctureParams,
                   robin_coeff):
    Av = apply_sipg(mesh, v, robin_coeff=robin_coeff)
    return Av + apply_mass_fof_lin(mesh, u0, v, dfof(params))
