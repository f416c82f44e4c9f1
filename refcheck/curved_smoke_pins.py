"""Reference values of the curved runs of `chip_smoke.py` phase 10, from
the JAX package on the CPU.

    JAX_PLATFORMS=cpu python refcheck/curved_smoke_pins.py [a|b|d ...]

Runs the JAX driver (`disco4est_tpu.driver.run_poisson`) on the options of
each pinned run and prints, per AMR level, the norm line, the element
count, the DOF, the histogram of the per-element degrees, the L2 error
and a digest of the forest's leaves (`forest_digest`, as
`chip_smoke.forest_digest`), as the Python literal that `chip_smoke.py`
pins:

- a: Lorentzian on the 13-tree sphere (R0 = 10, R1 = 20, R2 = 1000,
  compactified outer shell), level 1, deg 1, FACE_H_EQ_J_DIV_SJ_QUAD
  (`tests/test_regression_digits.py:28-62`);
- b: sinx on the 7-tree sphere (R0 = 1, R1 = 2), deg 3, level 3 (the
  first epoch of phase 10 (b); its level 4 is held to an f64 solve on
  the card);
- d: hp smooth_pred on the 7-tree sphere from level 1, deg 2,
  max_degree 4, percentile 25, two steps.

The sphere runs take the pointwise penalty: with volume/area h and
prefactor 2 the 7-tree operator is indefinite and the f32 inner CG of the
mixed solve stalls.  The JAX driver on the CPU solves with its generic
mixed-precision path (`use_structured = 0`), which refines to the f64
floor.  The per-level degrees are read by wrapping the driver's
`build_mesh`, which it calls once per epoch with that epoch's `deg_e`.
"""

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from disco4est_tpu import driver  # noqa: E402
from disco4est_tpu.problems.poisson import (  # noqa: E402
    LorentzianProblem,
    SinxProblem,
)
from disco4est_tpu.util.config import Options  # noqa: E402

OPTIONS = """
[initial_mesh]
min_level = {level}
region0_deg = {deg}
region0_deg_quad_inc = 0

[mesh_parameters]
face_h_type = FACE_H_EQ_J_DIV_SJ_QUAD
volume_h_type = VOL_H_EQ_CUBE_APPROX
max_degree = {max_degree}

[flux]
name = sipg
sipg_penalty_prefactor = 2.0
sipg_penalty_fcn = maxp_sqr_over_minh

[amr]
scheme = {scheme}
num_of_amr_steps = {steps}
percentile = 25
gamma_h = 10.0
gamma_p = 0.1
gamma_n = 1.0

[geometry]
{geometry}

[d4est_solver_krylov_petsc]
ksp_type = fcg
ksp_atol = 5e-15
use_structured = {use_structured}

[quadrature]
name = legendre
"""
SPHERE13 = """name = cubed_sphere
r0 = 10.0
r1 = 20.0
r2 = 1000.0
compactify_outer_shell = 1"""
SPHERE7 = """name = cubed_sphere_7tree
r0 = 1.0
r1 = 2.0"""

RUNS = {
    "a": dict(level=1, deg=1, max_degree=1, scheme="uniform_p", steps=0,
              geometry=SPHERE13, problem="lorentzian"),
    "b": dict(level=3, deg=3, max_degree=3, scheme="uniform_h", steps=0,
              geometry=SPHERE7, problem="sinx"),
    "d": dict(level=1, deg=2, max_degree=4, scheme="smooth_pred", steps=2,
              geometry=SPHERE7, problem="sinx"),
}
PROBLEMS = {"sinx": SinxProblem, "lorentzian": LorentzianProblem}


def forest_digest(forest):
    """sha256 of the leaves' (tree, level, anchor) as int64, 16 hex
    digits."""
    import hashlib

    h = hashlib.sha256()
    for a in (forest.tree, forest.level, forest.anchor):
        h.update(np.ascontiguousarray(a, np.int64).tobytes())
    return h.hexdigest()[:16]


def options(key, use_structured="0"):
    run = dict(RUNS[key])
    run.pop("problem")
    return OPTIONS.format(use_structured=use_structured, **run)


def run(key):
    epochs = []
    build = driver.build_mesh

    def recording_build(geom, forest, **kw):
        deg_e = np.asarray(kw["deg_e"])
        values, counts = np.unique(deg_e, return_counts=True)
        epochs.append((forest.n_elements,
                       {int(v): int(c) for v, c in zip(values, counts)},
                       forest_digest(forest)))
        return build(geom, forest, **kw)

    driver.build_mesh = recording_build
    try:
        res = driver.run_poisson(Options.load(options(key)),
                                 PROBLEMS[RUNS[key]["problem"]])
    finally:
        driver.build_mesh = build
    rows = res.norms.rows
    assert len(rows) == len(epochs)
    return res.norms.lines("L_2"), [
        (E, r["num_nodes"], hist, float(r["L_2"]), digest)
        for (E, hist, digest), r in zip(epochs, rows)
    ]


def main(argv):
    for key in argv or sorted(RUNS):
        lines, rows = run(key)
        print(f"{key}: {RUNS[key]}")
        for line in lines:
            print(f"    {line!r}")
        for row in rows:
            print(f"    ({row[0]}, {row[1]}, {row[2]}, {row[3]!r}, "
                  f"{row[4]!r}),")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
