"""Plain reference: the SIPG Laplacian on the uniform unit brick.

An independent statement of the discretization the benchmark's cells
solve, written from the textbook definitions in NumPy and plain PyTorch:

- elements: the 2^L x 2^L x 2^L cubes of side h = 2^-L of [0, 1]^3, in
  Morton order (the bits of x lowest, then y, then z: p4est's order);
- unknowns: nodal values at the (p+1)^3 Gauss-Lobatto-Legendre points of
  each element, stored [element, z, y, x];
- the symmetric interior-penalty form, integrated exactly,

      a(u, v) = sum_K int grad u . grad v
                - sum_F int ({du/dn} [v] + {dv/dn} [u] - sigma [u][v]),

  with sigma = prefactor * p^2 / h on every face (the "max p squared over
  min h" penalty; on a uniform brick both of the port's face-h choices,
  volume over area and the tree's h, are h), and on the boundary
  [u] = u - g, {du/dn} = du/dn;
- the load M f with f interpolated at the nodes, and the Dirichlet data g
  at the boundary nodes.

On this mesh the operator is a sum of Kronecker products,
A = A1 (x) M1 (x) M1 + M1 (x) A1 (x) M1 + M1 (x) M1 (x) A1, of the global
one-dimensional SIPG matrix A1 and mass matrix M1, so every apply is three
small dense contractions of the global nodal grid, and a solve is a fast
diagonalization.  Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def lobatto(n: int):
    """n Gauss-Lobatto-Legendre nodes (ascending) and weights on [-1, 1]."""
    p = n - 1
    x = np.cos(np.pi * np.arange(n) / p)
    x_old = np.full_like(x, 2.0)
    P = np.zeros((n, n))
    for _ in range(100):
        if np.max(np.abs(x - x_old)) <= 2.3e-16:
            break
        x_old = x
        P[:, 0], P[:, 1] = 1.0, x
        for k in range(2, n):
            P[:, k] = ((2 * k - 1) * x * P[:, k - 1] - (k - 1) * P[:, k - 2]) / k
        x = x_old - (x * P[:, p] - P[:, p - 1]) / (n * P[:, p])
    P[:, 0], P[:, 1] = 1.0, x
    for k in range(2, n):
        P[:, k] = ((2 * k - 1) * x * P[:, k - 1] - (k - 1) * P[:, k - 2]) / k
    w = 2.0 / (p * n * P[:, p] ** 2)
    return x[::-1].copy(), w[::-1].copy()


def lagrange(nodes: np.ndarray, pts: np.ndarray):
    """Values and derivatives of the Lagrange basis of `nodes` at `pts`:
    two [len(pts), len(nodes)] matrices."""
    n = len(nodes)
    V = np.polynomial.legendre.legvander(nodes, n - 1)
    Vp = np.polynomial.legendre.legvander(pts, n - 1)
    dVp = np.zeros_like(Vp)
    for j in range(n):
        c = np.zeros(n)
        c[j] = 1.0
        dVp[:, j] = np.polynomial.legendre.legval(
            pts, np.polynomial.legendre.legder(c))
    Vinv = np.linalg.inv(V)
    return Vp @ Vinv, dVp @ Vinv


def morton_order(level: int) -> np.ndarray:
    """[2^L, 2^L, 2^L] (z, y, x) -> the element's Morton index."""
    n = 1 << level
    k, j, i = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                          indexing="ij")
    key = np.zeros_like(i)
    for b in range(level):
        key |= ((i >> b) & 1) << (3 * b)
        key |= ((j >> b) & 1) << (3 * b + 1)
        key |= ((k >> b) & 1) << (3 * b + 2)
    return key


@dataclasses.dataclass
class Brick:
    """The uniform brick at `level` and degree `deg`, its one-dimensional
    global operators in `dtype` on `device`."""

    level: int
    deg: int
    dtype: torch.dtype
    device: torch.device
    N: int
    h: float
    x: torch.Tensor  # [N*(p+1)] node coordinates along one axis
    xq: torch.Tensor  # [N*nq] Gauss points along one axis
    wq: torch.Tensor  # [N*nq] their weights times h/2
    M1: torch.Tensor  # [n, n] mass
    A1: torch.Tensor  # [n, n] SIPG stiffness, homogeneous Dirichlet
    Vq: torch.Tensor  # [N*nq, n] nodes -> Gauss points, per element
    beta_lo: torch.Tensor  # [n] boundary load of g at x = 0
    beta_hi: torch.Tensor  # [n] boundary load of g at x = 1
    perm: torch.Tensor  # [N^3] Morton index of each (z, y, x) element

    @staticmethod
    def build(level, deg, *, prefactor=2.0, dtype=torch.float64,
              device="cpu"):
        # float32 means float32: no TF32 products in the contractions
        torch.backends.cuda.matmul.allow_tf32 = False
        N = 1 << level
        h = 1.0 / N
        nl = deg + 1
        n = N * nl
        xl, _ = lobatto(nl)
        xe, we = np.polynomial.legendre.leggauss(nl + 1)  # exact to 2p+1
        phi, dphi = lagrange(xl, xe)
        Mhat = phi.T @ (we[:, None] * phi)
        Khat = dphi.T @ (we[:, None] * dphi)
        _, D = lagrange(xl, xl)  # D[a, b] = phi_b'(r_a)
        eye = np.eye(N)
        M1 = np.kron(eye, 0.5 * h * Mhat)
        A1 = np.kron(eye, (2.0 / h) * Khat)
        sigma = prefactor * deg**2 / h
        d0, d1 = (2.0 / h) * D[0], (2.0 / h) * D[-1]

        def face(jump, dn):
            return (-np.outer(jump, dn) - np.outer(dn, jump)
                    + sigma * np.outer(jump, jump))

        for e in range(N - 1):
            jump = np.zeros(n)
            dn = np.zeros(n)
            jump[e * nl + deg], jump[(e + 1) * nl] = 1.0, -1.0
            dn[e * nl:(e + 1) * nl] = 0.5 * d1
            dn[(e + 1) * nl:(e + 2) * nl] = 0.5 * d0
            A1 += face(jump, dn)
        betas = []
        for e, node, dn_e in ((0, 0, -d0), (N - 1, deg, d1)):
            jump = np.zeros(n)
            dn = np.zeros(n)
            jump[e * nl + node] = 1.0
            dn[e * nl:(e + 1) * nl] = dn_e
            A1 += face(jump, dn)
            betas.append(sigma * jump - dn)

        xg, wg = np.polynomial.legendre.leggauss(deg + 1)
        Vq_e, _ = lagrange(xl, xg)
        left = np.arange(N) * h
        x = (left[:, None] + 0.5 * h * (xl + 1.0)).reshape(-1)
        xq = (left[:, None] + 0.5 * h * (xg + 1.0)).reshape(-1)
        wq = np.tile(0.5 * h * wg, N)
        kw = dict(dtype=dtype, device=device)
        t = lambda a: torch.as_tensor(a, **kw)
        return Brick(
            level=level, deg=deg, dtype=dtype, device=torch.device(device),
            N=N, h=h, x=t(x), xq=t(xq), wq=t(wq), M1=t(M1), A1=t(A1),
            Vq=t(np.kron(eye, Vq_e)), beta_lo=t(betas[0]),
            beta_hi=t(betas[1]),
            perm=torch.as_tensor(morton_order(level).reshape(-1),
                                 device=device),
        )

    # ---- layouts -----------------------------------------------------

    def to_grid(self, u):
        """[E, p+1, p+1, p+1] in Morton order -> the global [n, n, n]
        (z, y, x) nodal grid."""
        N, nl = self.N, self.deg + 1
        g = u.reshape(-1, nl, nl, nl)[self.perm].reshape(N, N, N, nl, nl, nl)
        return g.permute(0, 3, 1, 4, 2, 5).reshape(N * nl, N * nl, N * nl)

    def from_grid(self, U):
        N, nl = self.N, self.deg + 1
        g = U.reshape(N, nl, N, nl, N, nl).permute(0, 2, 4, 1, 3, 5)
        out = torch.empty_like(g.reshape(N**3, nl, nl, nl))
        out[self.perm] = g.reshape(N**3, nl, nl, nl)
        return out

    # ---- operators on the global grid ---------------------------------

    @staticmethod
    def along(U, A, axis):
        """Apply the matrix A along `axis` (0 = z, 1 = y, 2 = x) of U."""
        return torch.movedim(torch.tensordot(A, U, dims=([1], [axis])), 0,
                             axis)

    def tensor(self, U, mz, my, mx):
        return self.along(self.along(self.along(U, mx, 2), my, 1), mz, 0)

    def apply(self, U):
        """A U, homogeneous Dirichlet data."""
        M, A = self.M1, self.A1
        W = self.along(U, M, 2)
        WM = self.along(W, M, 1)
        return (self.tensor(U, M, M, A) + self.along(self.along(W, A, 1), M, 0)
                + self.along(WM, A, 0))

    def mass(self, U):
        return self.tensor(U, self.M1, self.M1, self.M1)

    def node_coords(self):
        """The (z, y, x) coordinate grids of the nodes, each [n, n, n]."""
        return torch.meshgrid(self.x, self.x, self.x, indexing="ij")

    def boundary_load(self, g):
        """The load of the Dirichlet data g(x, y, z) on the six faces:
        sum over faces of beta (x) (M1 (x) M1) g_face."""
        x, M = self.x, self.M1
        lo = torch.zeros_like(x[:1])
        hi = torch.ones_like(x[:1])
        out = torch.zeros((len(x),) * 3, dtype=self.dtype, device=x.device)
        for side, beta in ((lo, self.beta_lo), (hi, self.beta_hi)):
            # faces normal to x, y and z: the face grid is (z, y), (z, x),
            # (y, x); mass-apply it, then spread along the normal by beta
            zz, yy = torch.meshgrid(x, x, indexing="ij")
            G = M @ g(side.expand_as(zz), yy, zz) @ M.T
            out += G[:, :, None] * beta[None, None, :]
            zz, xx = torch.meshgrid(x, x, indexing="ij")
            G = M @ g(xx, side.expand_as(zz), zz) @ M.T
            out += G[:, None, :] * beta[None, :, None]
            yy, xx = torch.meshgrid(x, x, indexing="ij")
            G = M @ g(xx, yy, side.expand_as(yy)) @ M.T
            out += G[None, :, :] * beta[:, None, None]
        return out

    def rhs(self, f, g):
        """b = M f + the boundary load of g; f and g are callables of
        (x, y, z) coordinate tensors."""
        z, y, x = self.node_coords()
        return self.mass(f(x, y, z)) + self.boundary_load(g)

    def l2_norm(self, E):
        """sqrt(E^T M E) of a nodal grid."""
        return torch.sqrt(torch.sum(E * self.mass(E)))

    def mass_quad(self, U, fq):
        """Vq^T (w J fq(xq, Vq U)) per element: the load of the pointwise
        function fq(x, y, z, u_q) under the degree's Gauss rule."""
        Vq = self.Vq
        Uq = self.tensor(U, Vq, Vq, Vq)
        zq, yq, xq = torch.meshgrid(self.xq, self.xq, self.xq, indexing="ij")
        w = self.wq
        wq3 = w[:, None, None] * w[None, :, None] * w[None, None, :]
        return self.tensor(wq3 * fq(xq, yq, zq, Uq), Vq.T, Vq.T, Vq.T)

    # ---- the fast-diagonalization solve -------------------------------

    def eig(self):
        """S, lam with A1 S = M1 S diag(lam) and S^T M1 S = I."""
        M = self.M1.double().cpu().numpy()
        A = self.A1.double().cpu().numpy()
        L = np.linalg.cholesky(M)
        Li = np.linalg.inv(L)
        lam, Q = np.linalg.eigh(Li @ A @ Li.T)
        S = Li.T @ Q
        kw = dict(dtype=self.dtype, device=self.x.device)
        return torch.as_tensor(S, **kw), torch.as_tensor(lam, **kw)

    def solver(self):
        """U -> A^{-1} U, in the brick's dtype."""
        S, lam = self.eig()
        denom = lam[:, None, None] + lam[None, :, None] + lam[None, None, :]
        St = S.T.contiguous()
        return lambda B: self.tensor(self.tensor(B, St, St, St) / denom,
                                     S, S, S)

