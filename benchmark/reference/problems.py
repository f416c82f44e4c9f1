"""The cells' problems, stated plainly for the reference.

- `Sinx`: -lap u = 3 pi^2 u on [0, 1]^3 with u = prod_d sin(pi x_d + phi_d)
  and Dirichlet data u (d4est's `poisson_sinx` with per-axis phases);
- `Star`: the constant-density star, -lap psi = 2 pi rho psi^5 with
  rho = rho0 inside |x - c| <= R and 0 outside, Dirichlet data the
  analytic psi (d4est's `ConstantDensityStar`).

Each gives `numbers(brick, u, l2)`: what the cell compares (the residual
in the 2-norm of the solver's own stopping test), from a
solution u handed in as [E, p+1, p+1, p+1] in Morton order and the L2
error the solver reported for it; and `solve(brick)`: the reference's own
solution and L2 error, in the brick's dtype (the control).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.brick import Brick


class Sinx:
    def __init__(self, phases):
        self.phases = tuple(float(p) for p in phases)

    def u(self, x, y, z):
        p = self.phases
        return (torch.sin(math.pi * x + p[0]) * torch.sin(math.pi * y + p[1])
                * torch.sin(math.pi * z + p[2]))

    def f(self, x, y, z):
        return 3.0 * math.pi**2 * self.u(x, y, z)

    def _error(self, brick: Brick, U):
        z, y, x = brick.node_coords()
        return U - self.u(x, y, z)

    def numbers(self, brick: Brick, u, l2: float) -> dict:
        """residual: |b - A u|, the 2-norm that the solver's stopping
        test bounds (ksp_atol); l2_gap: the distance of the reported L2
        error from the reference's L2 error of u."""
        U = brick.to_grid(u.to(brick.device, brick.dtype))
        b = brick.rhs(self.f, self.u)
        r = b - brick.apply(U)
        l2_ref = float(brick.l2_norm(self._error(brick, U)))
        return dict(
            residual=float(torch.linalg.vector_norm(r)),
            l2_gap=abs(l2 - l2_ref),
        )

    def solve(self, brick: Brick):
        U = brick.solver()(brick.rhs(self.f, self.u))
        return brick.from_grid(U), float(brick.l2_norm(self._error(brick, U)))


class Star:
    def __init__(self, center, R=0.0625, rho0_div_rhoc=0.001):
        self.c = tuple(float(v) for v in center)
        self.R = float(R)
        rhoc = 3.0 / (2.0 * math.pi) / R**2 * 5.0**5 / 6.0**6
        self.rho0 = rho0_div_rhoc * rhoc
        self.C0 = (3.0 / (2.0 * math.pi * self.rho0)) ** 0.25

        # alpha > sqrt(5) solves rho0 R^2 = (3 / 2 pi) f(alpha)^2,
        # f(a) = a^5 / (1 + a^2)^3, by bisection
        def g(a):
            return (self.rho0 * R * R
                    - 3.0 / (2.0 * math.pi) * (a**5 / (1 + a * a) ** 3) ** 2)

        lo, hi = math.sqrt(5.0), 1000.0 * math.sqrt(5.0)
        glo = g(lo)
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            gm = g(mid)
            if glo * gm <= 0:
                hi = mid
            else:
                lo, glo = mid, gm
        self.alpha = 0.5 * (lo + hi)
        aR = self.alpha * R
        self.beta = R * (self.C0 * math.sqrt(aR) / math.sqrt(R * R + aR * aR)
                         - 1.0)

    def _r2(self, x, y, z):
        return (x - self.c[0]) ** 2 + (y - self.c[1]) ** 2 + (z - self.c[2]) ** 2

    def psi(self, x, y, z):
        r2 = self._r2(x, y, z)
        aR = self.alpha * self.R
        inside = r2 <= self.R**2
        inner = self.C0 * math.sqrt(aR) / torch.sqrt(r2 + aR * aR)
        outer = 1.0 + self.beta / torch.sqrt(torch.where(inside, 1.0, r2))
        return torch.where(inside, inner, outer)

    def rho(self, x, y, z):
        return torch.where(self._r2(x, y, z) <= self.R**2, self.rho0, 0.0)

    def residual(self, brick: Brick, U):
        """F(psi) = A psi - (load of the Dirichlet data)
        + int (-2 pi rho psi^5) phi."""
        src = lambda x, y, z, q: -2.0 * math.pi * self.rho(x, y, z) * q**5
        return (brick.apply(U) - brick.boundary_load(self.psi)
                + brick.mass_quad(U, src))

    def numbers(self, brick: Brick, u, l2: float) -> dict:
        """residual: |F(u)|; l2_gap as for `Sinx`."""
        U = brick.to_grid(u.to(brick.device, brick.dtype))
        z, y, x = brick.node_coords()
        l2_ref = float(brick.l2_norm(U - self.psi(x, y, z)))
        return dict(
            residual=float(torch.linalg.vector_norm(self.residual(brick, U))),
            l2_gap=abs(l2 - l2_ref),
        )

    def solve(self, brick: Brick, newton_steps=8, cg_steps=50):
        """Newton from psi = 1; each Jacobian solve is CG preconditioned by
        the exact inverse of the Laplacian part."""
        inv = brick.solver()
        z, y, x = brick.node_coords()
        U = torch.ones_like(x)
        dsrc = lambda x, y, z, q: -10.0 * math.pi * self.rho(x, y, z) * q**4
        best = None
        for _ in range(newton_steps):
            F = self.residual(brick, U)
            fn = float(torch.linalg.vector_norm(F))
            if best is not None and fn >= best[0]:
                break
            best = (fn, U)
            U0 = U
            J = lambda V: brick.apply(V) + _mass_coeff(brick, V, U0, dsrc)
            dU = _pcg(J, -F, inv, cg_steps)
            U = U + dU
        U = best[1]
        return brick.from_grid(U), float(brick.l2_norm(U - self.psi(x, y, z)))


def _mass_coeff(brick: Brick, V, U0, dsrc):
    """int dsrc(x, psi0) v phi: the frozen-psi0 Jacobian's mass term."""
    Vq = brick.Vq
    U0q = brick.tensor(U0, Vq, Vq, Vq)
    return brick.mass_quad(V, lambda x, y, z, q: dsrc(x, y, z, U0q) * q)


def _pcg(A, b, M, steps):
    x = torch.zeros_like(b)
    r = b.clone()
    z = M(r)
    p = z.clone()
    rz = torch.sum(r * z)
    b_norm = torch.linalg.vector_norm(b)
    for _ in range(steps):
        Ap = A(p)
        a = rz / torch.sum(p * Ap)
        x = x + a * p
        r = r - a * Ap
        if torch.linalg.vector_norm(r) <= 1e-14 * b_norm:
            break
        z = M(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x

