"""Seeded data of the sinx problem: u = prod_d sin(pi x_d + phi_d), the
phases phi_d drawn uniformly from [0, 2 pi).  The frequency and amplitude
are the upstream problem's; the phases make the boundary data nonzero."""

from __future__ import annotations

import math

from benchmark.reference.problems import Sinx


def draw(rng, params: dict) -> dict:
    return {"phases": [float(v) for v in rng.uniform(0.0, 2.0 * math.pi, 3)]}


def options(data: dict) -> dict:
    return {}


def port_problem(driver, opts, data: dict):
    ref = Sinx(data["phases"])

    class SeededSinx:
        dim = 3
        analytic = staticmethod(ref.u)
        rhs = staticmethod(ref.f)
        boundary = staticmethod(ref.u)

    return SeededSinx


def reference(data: dict, sections: dict):
    return Sinx(data["phases"])
