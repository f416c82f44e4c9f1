"""Reference values of the nonlinear runs of `chip_smoke.py` phase 11, from
the JAX package on the CPU.

    JAX_PLATFORMS=cpu python refcheck/nonlinear_smoke_pins.py [a|b|c ...]

Runs the JAX driver (`disco4est_tpu.driver.run_nonlinear`) on the options
of each pinned run and prints, per AMR level, the norm line and the
Python literal that `chip_smoke.py` pins: elements, DOF, L2 error (or ‖F‖
where the problem has no analytic solution), Newton iterations, the ‖F‖
history, the Krylov iterations of each Newton step, Σ η², and a digest of
the forest's leaves (as `chip_smoke.forest_digest`); and Σ u over the
nodes of the last level.

- a: the CDS regression (`tests/test_cds.py`, `d4est_test_mpi.sh`):
  brick, level 2, deg 2, FACE_H_EQ_TREE_H, one smooth_pred step (gamma_h
  0.25, percentile 25), CG, snes_atol 1e-12;
- b: CDS at deg 3, uniform_h from level 4 to level 5 (2,097,152 DOF), the
  same options otherwise (several minutes on the CPU);
- c: TwoPunctures on the 7-tree sphere (R0 10, R1 1000, compactified
  inner shell), level 1, deg 2, region0_deg_quad_inc 1, FCG,
  snes_atol 1e-10.

CDS takes ψ_analytic as its Dirichlet data here, as the problem states
and the reference's digits need.  The JAX driver's `CDSProblem.boundary`
returns 1 (ROADMAP C11), which moves (a)'s level-2 L2 from 9.6079e-6 to
8.4215e-6; this script replaces that method before it runs, and touches
nothing else of the JAX package.  The Krylov counts are read by wrapping
the driver's `cg_solve` / `fcg_solve`, the Newton history by wrapping
`newton_solve`; neither changes an iterate.
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
from disco4est_tpu.solvers import newton  # noqa: E402
from disco4est_tpu.util.config import Options  # noqa: E402

OPTIONS = """
[initial_mesh]
min_level = {level}
region0_deg = {deg}
region0_deg_quad_inc = {dq_inc}

[mesh_parameters]
face_h_type = {face_h}
volume_h_type = VOL_H_EQ_CUBE_APPROX

[flux]
name = sipg
sipg_penalty_prefactor = 2.0
sipg_penalty_fcn = maxp_sqr_over_minh

[amr]
scheme = {scheme}
num_of_amr_steps = {steps}
percentile = 25
gamma_h = 0.25
gamma_p = 0.1
gamma_n = 1.0

[geometry]
{geometry}

[d4est_solver_newton]
snes_atol = {snes_atol}
snes_max_it = 30

[d4est_solver_krylov_petsc]
ksp_type = {ksp}
ksp_max_it = 10000

[quadrature]
name = legendre
"""
BRICK = "name = brick"
SPHERE7 = """name = cubed_sphere_7tree
r0 = 10.0
r1 = 1000.0
compactify_inner_shell = 1"""

RUNS = {
    "a": dict(level=2, deg=2, dq_inc=0, face_h="FACE_H_EQ_TREE_H",
              scheme="smooth_pred", steps=1, geometry=BRICK,
              snes_atol=1e-12, ksp="cg", problem="cds"),
    "b": dict(level=4, deg=3, dq_inc=0, face_h="FACE_H_EQ_TREE_H",
              scheme="uniform_h", steps=1, geometry=BRICK,
              snes_atol=1e-12, ksp="cg", problem="cds"),
    "c": dict(level=1, deg=2, dq_inc=1, face_h="FACE_H_EQ_VOLUME_DIV_AREA",
              scheme="uniform_h", steps=0, geometry=SPHERE7,
              snes_atol=1e-10, ksp="fcg", problem="two_punctures"),
}
PROBLEMS = {"cds": driver.CDSProblem,
            "two_punctures": driver.TwoPuncturesProblem}


def forest_digest(forest):
    """sha256 of the leaves' (tree, level, anchor) as int64, 16 hex
    digits."""
    import hashlib

    h = hashlib.sha256()
    for a in (forest.tree, forest.level, forest.anchor):
        h.update(np.ascontiguousarray(a, np.int64).tobytes())
    return h.hexdigest()[:16]


def options(key):
    run = dict(RUNS[key])
    run.pop("problem")
    return OPTIONS.format(**run)


def run(key):
    digests, newtons, krylov = [], [], []
    saved = dict(build_mesh=driver.build_mesh, cg_solve=driver.cg_solve,
                 fcg_solve=driver.fcg_solve)
    newton_solve = newton.newton_solve

    def recording_build(geom, forest, **kw):
        digests.append(forest_digest(forest))
        krylov.append([])
        return saved["build_mesh"](geom, forest, **kw)

    def counting(name):
        def solve(*args, **kw):
            res = saved[name](*args, **kw)
            krylov[-1].append(int(res.iterations))
            return res
        return solve

    def recording_newton(*args, **kw):
        res = newton_solve(*args, **kw)
        newtons.append(res)
        return res

    boundary = driver.CDSProblem.boundary
    driver.CDSProblem.boundary = lambda self, *c: self.params.psi(*c)
    driver.build_mesh = recording_build
    driver.cg_solve = counting("cg_solve")
    driver.fcg_solve = counting("fcg_solve")
    newton.newton_solve = recording_newton
    try:
        opts = Options.load(options(key))
        result = driver.run_nonlinear(opts, PROBLEMS[RUNS[key]["problem"]](
            opts))
    finally:
        driver.CDSProblem.boundary = boundary
        newton.newton_solve = newton_solve
        for name, fn in saved.items():
            setattr(driver, name, fn)
    rows = result.norms.rows
    key_norm = "L_2" if "L_2" in rows[-1] else "F_norm"
    out = [(r["num_quadrants"], r["num_nodes"], float(r[key_norm]),
            res.iterations, [float(f) for f in res.history], its,
            float(r["eta2_sum"]), digest)
           for r, res, its, digest in zip(rows, newtons, krylov, digests)]
    return result.norms.lines(key_norm), out, float(np.sum(result.u))


def main(argv):
    for key in argv or sorted(RUNS):
        lines, rows, u_sum = run(key)
        print(f"{key}: {RUNS[key]}")
        for line in lines:
            print(f"    {line!r}")
        for row in rows:
            print(f"    ({row[0]}, {row[1]}, {row[2]!r}, {row[3]}, "
                  f"{row[4]!r}, {row[5]!r}, {row[6]!r}, {row[7]!r}),")
        print(f"    sum u {u_sum!r}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
