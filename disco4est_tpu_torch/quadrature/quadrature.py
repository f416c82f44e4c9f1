"""Pluggable quadrature families.

Role of the reference's `Quadrature/d4est_quadrature.c` (function-pointer
getters for weights/points/interpolation per object, `d4est_quadrature.h:
117-129`).  Families: `legendre` (Gauss-Legendre, the reference default for
curved geometry), `lobatto` (GLL collocation), and — later — the
compactified families for infinite cubed-sphere shells
(`d4est_quadrature_compactified.c`), which become per-element custom rules.

A `Quadrature` hands out 1D nodes/weights for a quadrature degree and the
1D interpolation matrix from degree-`deg_l` LGL nodes to the quadrature
points; N-D applications are tensor products done by the callers.

Port of `disco4est_tpu/quadrature/quadrature.py` (host numpy, copied
unchanged).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from disco4est_tpu_torch.ops import lgl
from disco4est_tpu_torch.ops.operators import DB


@dataclasses.dataclass(frozen=True)
class Quadrature:
    kind: str = "legendre"  # 'legendre' | 'lobatto'

    def nodes_weights(self, deg_quad: int):
        if self.kind == "legendre":
            return lgl.gauss_nodes_weights(deg_quad + 1)
        elif self.kind == "lobatto":
            return lgl.lobatto_nodes_weights(deg_quad + 1)
        raise ValueError(f"unknown quadrature kind {self.kind}")

    @functools.lru_cache(maxsize=None)
    def _interp_cached(self, deg_l: int, deg_q: int):
        x, _ = self.nodes_weights(deg_q)
        if self.kind == "lobatto" and deg_l == deg_q:
            return np.eye(deg_l + 1)
        return DB.interp_to_points(deg_l, tuple(x))

    def interp(self, deg_l: int, deg_q: int) -> np.ndarray:
        """[nq, nl] interpolation matrix LGL(deg_l) -> quad points."""
        return self._interp_cached(deg_l, deg_q)
