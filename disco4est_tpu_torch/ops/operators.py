"""Per-degree 1D reference-element operators.

Role of the reference's `dGMath/d4est_operators.c` lazily-built operator
tables (mass `mij`, differentiation `dij`, Vandermonde, interpolation,
flip).  Here each degree
gets an immutable `Operators1D` of small float64 numpy matrices built once
and cached in an `OperatorDB`; batched N-D applies are tensor contractions
in `disco4est_tpu_torch.ops.tensor`.

Operator definitions match the reference semantics
(`d4est_operators_build_mij_1d`: M = (V Vᵀ)⁻¹;
`d4est_operators_build_dij_1d`: D = dV·V⁻¹), so operator unit tests can
verify against dense numpy exactly as the reference's
`Tests/Unit/d4est_test_operators.c` does.

Port of `disco4est_tpu/ops/operators.py` (host numpy, copied unchanged)
for what the port uses: the per-degree tables, p-prolong / p-restrict
(`d4est_operators_build_p_prolong_1d`: nodal interpolation V_h(x)·V_H⁻¹;
`d4est_operators_build_hp_restrict_1d_aux`: L2 projection M_H⁻¹·Pᵀ·M_h)
and the parent-to-child hp-prolong of the AMR transfer and the mortars.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from disco4est_tpu_torch.ops import lgl


@dataclasses.dataclass(frozen=True)
class Operators1D:
    """All 1D operators for a single polynomial degree (float64 numpy)."""

    deg: int
    lobatto_nodes: np.ndarray  # [n]
    lobatto_weights: np.ndarray  # [n]
    gauss_nodes: np.ndarray  # [n]
    gauss_weights: np.ndarray  # [n]
    vandermonde: np.ndarray  # [n, n]  V_ij = P̃_j(x_i)
    inv_vandermonde: np.ndarray  # [n, n]
    grad_vandermonde: np.ndarray  # [n, n]
    mass: np.ndarray  # [n, n]  M = (V Vᵀ)⁻¹  (exact L2 mass)
    inv_mass: np.ndarray  # [n, n]
    diff: np.ndarray  # [n, n]  D = dV V⁻¹ (strong-form differentiation)
    diff_t: np.ndarray  # [n, n]
    flip: np.ndarray  # [n, n]  reversal permutation

    @property
    def n(self) -> int:
        return self.deg + 1


class OperatorDB:
    """Cache of `Operators1D` per degree plus cross-degree matrices.

    The reference keeps `double**` tables fetched-or-built on demand
    (`d4est_operators.c:9` `d4est_ops_init`); this cache plays the same role
    but all matrices are plain numpy, converted to torch tensors when a
    kernel needs them.
    """

    def __init__(self, max_degree: int = 20):
        self.max_degree = max_degree

    @functools.lru_cache(maxsize=None)
    def ops(self, deg: int) -> Operators1D:
        n = deg + 1
        x, w = lgl.lobatto_nodes_weights(n)
        gx, gw = lgl.gauss_nodes_weights(n)
        V = _vandermonde(x, deg)
        dV = _grad_vandermonde(x, deg)
        invV = np.linalg.inv(V)
        M = np.linalg.inv(V @ V.T)
        D = dV @ invV
        return Operators1D(
            deg=deg,
            lobatto_nodes=x,
            lobatto_weights=w,
            gauss_nodes=gx,
            gauss_weights=gw,
            vandermonde=V,
            inv_vandermonde=invV,
            grad_vandermonde=dV,
            mass=M,
            inv_mass=np.linalg.inv(M),
            diff=D,
            diff_t=np.ascontiguousarray(D.T),
            flip=np.eye(n)[::-1].copy(),
        )

    @functools.lru_cache(maxsize=None)
    def interp_to_points(self, deg: int, points: tuple) -> np.ndarray:
        """[len(points), deg+1] Lagrange interpolation matrix from the LGL
        nodes of `deg` to arbitrary points."""
        pts = np.asarray(points, dtype=np.float64)
        Vt = _vandermonde(pts, deg)
        return Vt @ self.ops(deg).inv_vandermonde

    # ---- p-prolong / p-restrict ----------------------------------------

    @functools.lru_cache(maxsize=None)
    def p_prolong(self, deg_H: int, deg_h: int) -> np.ndarray:
        """[n_h, n_H]: interpolate degree-H nodal values onto the LGL nodes
        of degree h (`d4est_operators_build_p_prolong_1d`)."""
        xh, _ = lgl.lobatto_nodes_weights(deg_h + 1)
        return self.interp_to_points(deg_H, tuple(xh))

    @functools.lru_cache(maxsize=None)
    def p_restrict(self, deg_h: int, deg_H: int) -> np.ndarray:
        """[n_H, n_h]: L2 projection from degree h down to degree H
        (`d4est_operators_build_p_restrict_1d` via `hp_restrict_1d_aux`:
        R = M_H⁻¹ Pᵀ M_h)."""
        P = self.p_prolong(deg_H, deg_h)
        Mh = self.ops(deg_h).mass
        invMH = self.ops(deg_H).inv_mass
        return invMH @ P.T @ Mh

    # ---- hp-prolong (parent -> 2 children in 1D) -----------------------

    @functools.lru_cache(maxsize=None)
    def hp_prolong(self, deg_H: int, deg_h: int, child: int) -> np.ndarray:
        """[n_h, n_H]: evaluate the degree-H parent at the child's LGL nodes
        mapped into the parent interval (child 0 ↦ [-1,0], child 1 ↦ [0,1])
        (`d4est_operators_build_hp_prolong_1d`)."""
        xh, _ = lgl.lobatto_nodes_weights(deg_h + 1)
        xp = 0.5 * (xh - 1.0) if child == 0 else 0.5 * (xh + 1.0)
        return self.interp_to_points(deg_H, tuple(xp))


def _vandermonde(x: np.ndarray, deg: int) -> np.ndarray:
    V = np.empty((len(x), deg + 1))
    for j in range(deg + 1):
        V[:, j] = lgl.jacobi(x, 0.0, 0.0, j)
    return V


def _grad_vandermonde(x: np.ndarray, deg: int) -> np.ndarray:
    dV = np.empty((len(x), deg + 1))
    for j in range(deg + 1):
        dV[:, j] = lgl.grad_jacobi(x, 0.0, 0.0, j)
    return dV


# A process-wide default DB (operators are immutable; sharing is safe).
DB = OperatorDB()
