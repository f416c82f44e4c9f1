"""Seeded data of the constant-density star: its centre drawn uniformly
within `offset` of (0.5, 0.5, 0.5) on each axis; the radius and the
density ratio are the configuration's ([problem] R, rho0_div_rhoc)."""

from __future__ import annotations

from benchmark.reference.problems import Star


def draw(rng, params: dict) -> dict:
    off = float(params["offset"])
    return {"center": [float(v) for v in 0.5 + rng.uniform(-off, off, 3)]}


def options(data: dict) -> dict:
    cx, cy, cz = data["center"]
    return {"problem": {"cx": repr(cx), "cy": repr(cy), "cz": repr(cz)}}


def port_problem(driver, opts, data: dict):
    return driver.CDSProblem(opts)


def reference(data: dict, sections: dict):
    p = sections.get("problem", {})
    return Star(data["center"], R=float(p.get("R", 0.0625)),
                rho0_div_rhoc=float(p.get("rho0_div_rhoc", 0.001)))
