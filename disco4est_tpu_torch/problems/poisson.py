"""Poisson problem family (sinx, Lorentzian).

Port of `disco4est_tpu/problems/poisson.py` (role of the reference's
`Problems/Poisson/*` drivers):
- sinx: u = Π sin(πx_d) on the unit brick (`poisson_sinx_fcns.h`; the
  reference's π constant differs from math.pi at digit 13, and the pinned
  regression digits depend on it, so it is kept);
- Lorentzian: u = 1/√(1+r²), f = 3/(1+r²)^{5/2}.

The functions take and return torch tensors.
"""

from __future__ import annotations

import torch

D4EST_PI = 3.14159265358932384626433832795  # reference's PI (sic)


class SinxProblem:
    dim = 3

    @staticmethod
    def analytic(*c):
        out = 1.0
        for x in c:
            out = out * torch.sin(D4EST_PI * x)
        return out

    @staticmethod
    def rhs(*c):
        return len(c) * D4EST_PI**2 * SinxProblem.analytic(*c)

    boundary = analytic


class LorentzianProblem:
    dim = 3

    @staticmethod
    def analytic(x, y, z):
        r2 = x * x + y * y + z * z
        return 1.0 / torch.sqrt(1.0 + r2)

    @staticmethod
    def rhs(x, y, z):
        r2 = x * x + y * y + z * z
        return 3.0 / (1.0 + r2) ** 2.5

    boundary = analytic
