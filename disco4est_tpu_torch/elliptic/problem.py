"""The elliptic system interface: every solver is matrix-free and sees the
PDE only through two callbacks.

Port of `disco4est_tpu/elliptic/problem.py` (role of the reference's
`EllipticSystem/d4est_elliptic_eqns.h:26-37`: `apply_lhs` = Jacobian-vector
product at the current linearization point, `build_residual` = nonlinear
residual; and `d4est_elliptic_data.h`, the vector bundle {u, u0, Au,
rhs}).  The "vectors" are element-major nodal tensors [E, nl...] on the
mesh's device.
"""

from __future__ import annotations

from typing import Callable

from disco4est_tpu_torch.mesh.builder import MeshData


class EllipticProblem:
    """Base protocol.  Subclasses (or instances with injected callables)
    define the PDE.  `u0` is the frozen linearization point of Jacobian
    applies (the reference threads it through `prob_vecs->u0`)."""

    def apply_lhs(self, mesh: MeshData, u, u0=None):
        raise NotImplementedError

    def build_residual(self, mesh: MeshData, u):
        raise NotImplementedError


class LinearProblem(EllipticProblem):
    """A u = rhs for a fixed linear operator (e.g. SIPG Poisson)."""

    def __init__(self, A: Callable, rhs):
        self.A = A
        self.rhs = rhs

    def apply_lhs(self, mesh, u, u0=None):
        return self.A(u)

    def build_residual(self, mesh, u):
        return self.A(u) - self.rhs
