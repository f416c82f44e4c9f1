"""Plain reference: one multigrid V-cycle on the uniform brick.

An independent statement of the V-cycle that the multigrid cells'
preconditioner applies, in plain f64 PyTorch on `brick.py`'s own
operator at every level.  Nothing here imports the program under test.

- levels: `Brick.build(level - k, deg)` for k = 0 .. level, the brick
  coarsened once a level down to one element (a uniform brick's forest
  coarsens family by family, so that is every level there is);
- prolongation from level l - 1 to level l: along each axis, each parent
  element's Gauss-Lobatto-Legendre Lagrange basis evaluated at its two
  children's nodes, the tensor product of the three; restriction is its
  transpose;
- smoother: the three-term Chebyshev iteration on [lmin, lmax] (Saad,
  *Iterative Methods for Sparse Linear Systems*, 2nd ed., Alg. 12.1; the
  role of upstream's `d4est_solver_multigrid_smoother_cheby.c`), `steps`
  updates of x, before and after the coarse correction at every level
  but the coarsest;
- bottom: conjugate gradients from zero on the coarsest operator,
  stopped once ||r|| <= rtol ||b|| (checked before each step), at most
  `bottom_max` steps; `bottom_steps` runs exactly that many instead, to
  pin the step at which two implementations stop where their stopping
  tests lie within rounding of each other.

One departure: the Chebyshev bounds are an input (`bounds`, one (lmin,
lmax) per level, finest first), the program's own CG-Lanczos estimates,
so that one V-cycle can be compared with another.  The estimate itself
is checked on its own against the dense spectrum (`dense_matrix`).

Fields go in and come out as [E, p+1, p+1, p+1] in Morton order, mapped
to the global nodal grid as the benchmark's check maps them
(`Brick.to_grid`, `Brick.from_grid`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.brick import Brick, lagrange, lobatto


def prolongation_1d(level: int, deg: int) -> np.ndarray:
    """[2^level (p+1), 2^(level-1) (p+1)]: coarse nodal values along one
    axis -> the fine ones; fine element 2e + c is child c of element e."""
    xl, _ = lobatto(deg + 1)
    # child c covers [-1, 0] (c = 0) or [0, 1] (c = 1) of its parent
    children = [lagrange(xl, 0.5 * (xl + (2 * c - 1)))[0] for c in (0, 1)]
    return np.kron(np.eye(1 << (level - 1)), np.vstack(children))


def chebyshev(A, b, x, lmin: float, lmax: float, steps: int):
    """`steps` updates of x by the Chebyshev iteration on [lmin, lmax]."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    r = b - A(x)
    d = r / theta
    for k in range(steps):
        x = x + d
        if k == steps - 1:
            break
        r = r - A(d)
        rho_next = 1.0 / (2.0 * sigma1 - rho)
        d = (rho_next * rho) * d + (2.0 * rho_next / delta) * r
        rho = rho_next
    return x


def conjugate_gradients(A, b, rtol: float, max_steps: int, steps=None):
    """(x, steps taken): CG from x = 0, stopped once ||r|| <= rtol ||b||,
    or after exactly `steps` steps where that is given."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r
    rr = torch.sum(r * r)
    tol = rtol * float(torch.sqrt(torch.sum(b * b)))
    k = 0
    while k < (max_steps if steps is None else steps):
        if steps is None and float(torch.sqrt(rr)) <= tol:
            break
        Ap = A(p)
        alpha = rr / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_next = torch.sum(r * r)
        p = r + (rr_next / rr) * p
        rr = rr_next
        k += 1
    return x, k


class VCycle:
    """The V-cycle on the level-`level` brick at degree `deg`, every level
    in `dtype` on `device`; `bounds` holds (lmin, lmax) per level, finest
    first."""

    def __init__(self, level, deg, bounds, *, prefactor=2.0, steps=8,
                 bottom_rtol=1e-10, bottom_max=100, dtype=torch.float64,
                 device="cpu"):
        if len(bounds) != level + 1:
            raise ValueError(f"{len(bounds)} bounds for {level + 1} levels")
        self.bricks = [Brick.build(level - k, deg, prefactor=prefactor,
                                   dtype=dtype, device=device)
                       for k in range(level + 1)]
        # P[k]: level k + 1 (coarser) -> level k, one axis
        self.P = [torch.as_tensor(prolongation_1d(level - k, deg),
                                  dtype=dtype, device=device)
                  for k in range(level)]
        self.bounds = [(float(a), float(b)) for a, b in bounds]
        self.steps, self.bottom_rtol = steps, bottom_rtol
        self.bottom_max = bottom_max
        self.bottom_steps = None  # a pinned step count, else the test
        self.last_bottom_steps = None  # the count of the last cycle

    def _cycle(self, k, B):
        brick = self.bricks[k]
        if k == len(self.bricks) - 1:
            X, self.last_bottom_steps = conjugate_gradients(
                brick.apply, B, self.bottom_rtol, self.bottom_max,
                self.bottom_steps)
            return X
        lmin, lmax = self.bounds[k]
        X = chebyshev(brick.apply, B, torch.zeros_like(B), lmin, lmax,
                      self.steps)
        P = self.P[k]
        R_c = brick.tensor(B - brick.apply(X), P.T, P.T, P.T)
        X = X + brick.tensor(self._cycle(k + 1, R_c), P, P, P)
        return chebyshev(brick.apply, B, X, lmin, lmax, self.steps)

    def __call__(self, r):
        """One V-cycle from a zero guess on the residual `r`
        ([E, p+1, p+1, p+1], Morton order); the correction, laid out as
        `r`."""
        fine = self.bricks[0]
        B = fine.to_grid(r.to(fine.device, fine.dtype))
        return fine.from_grid(self._cycle(0, B))


def dense_matrix(brick: Brick) -> torch.Tensor:
    """The brick's operator as a dense [n^3, n^3] matrix on its global grid
    (x fastest): the Kronecker sum of the one-dimensional SIPG and mass
    matrices.  Small levels only."""
    A, M = brick.A1, brick.M1
    kron = torch.kron
    return kron(kron(M, M), A) + kron(kron(M, A), M) + kron(kron(A, M), M)
