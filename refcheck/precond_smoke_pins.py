"""Reference values of the preconditioned runs of `chip_smoke.py` phase 12,
from the JAX package on the CPU.

    JAX_PLATFORMS=cpu python refcheck/precond_smoke_pins.py [run ...]

Runs the JAX driver (`disco4est_tpu.driver.run_poisson` /
`run_nonlinear`) on the options of each pinned run and prints, per AMR
level, the norm line and the Python literal that `chip_smoke.py` pins:
elements, DOF, L2 error (or ‖F‖), the Krylov iterations of the level (a
list: one per Newton step on the nonlinear runs), and a digest of the
forest's leaves (as `chip_smoke.forest_digest`); and Σ u over the nodes of
the last level (of every level's Newton solution on the nonlinear runs).

- a: sinx on the brick, deg 3, uniform_h from level 4 to 5, `pc_type =
  multigrid` (Chebyshev smoother, CG bottom, FCG);
- cheby: the same at level 4 with `pc_type = cheby` (no `schwarz` run at
  that size: the JAX Schwarz FCG takes hundreds of iterations of 15
  subdomain applies on a 110,592-element replicated mesh, hours on the
  CPU; `chip_smoke.py` holds its L2 to phase 9 (a)'s level-4 pin);
- mg_so_reuse, mg_cheby_cheby, mg_block: sinx at level 2, deg 2,
  multigrid with the plugins schwarz_overlap / reuse_smoother, cheby /
  cheby and the block Schwarz smoother / cg; mg_none_cheby: none / cheby
  on one element (level 0, deg 3);
- d: hp smooth_pred from level 3, deg 2, max_degree 4, three steps
  (phase 9 (c)) with multigrid;
- cds: CDS at deg 3, uniform_h from level 4 to 5 (phase 11 (b)) with
  Newton-MG;
- tp_jq: TwoPunctures (phase 11 (c)'s options with the definite
  FACE_H_EQ_J_DIV_SJ_QUAD penalty), uniform_h from level 1 to 2, with
  `pc_type = none`: the JAX driver's Newton-MG V-cycle acts on the
  Dirichlet operator while the Jacobian has Robin data, and its FCG
  diverges (‖r‖ 0.044 → 0.095 in the first Jacobian solve's 400
  iterations at level 1; ROADMAP C13), so the pin is the unpreconditioned
  Newton's solution (the same discrete solution, to snes_atol);
- t_*: the CPU tests' runs (sinx at level 2, deg 2, with each pc_type;
  hp smooth_pred from level 1 with multigrid; CDS at level 2, deg 2 with
  each pc_type).

`--jax-coarse-levels` leaves the JAX `build_hierarchy` as it is (C12),
for the size of that fault's gap.

Two JAX faults are worked around here, nothing else of the package is
touched: CDS takes ψ_analytic as its Dirichlet data (the JAX driver's
`CDSProblem.boundary` returns 1, ROADMAP C11), and the multigrid's coarse
levels are built with the run's `face_h_type` (the JAX `build_hierarchy`
builds them with `build_mesh`'s default, ROADMAP C12; on the brick the
tree h of the CDS runs equals volume/area, so no run here moves).  The
Krylov counts are read by wrapping the driver's solve functions, the
forests by wrapping `build_mesh`, and the compiled programs are dropped
before each `mg_setup` (XLA:CPU otherwise runs out of code memory on a
long Newton-MG run); none of this changes an iterate.
"""

import functools
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
from disco4est_tpu.problems.poisson import SinxProblem  # noqa: E402
from disco4est_tpu.solvers import multigrid, newton  # noqa: E402
from disco4est_tpu.util.config import Options  # noqa: E402

LINEAR = """
[initial_mesh]
min_level = {level}
region0_deg = {deg}
region0_deg_quad_inc = 0

[mesh_parameters]
face_h_type = FACE_H_EQ_VOLUME_DIV_AREA
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
name = brick

[d4est_solver_krylov_petsc]
ksp_type = fcg
ksp_atol = 5e-15
pc_type = {pc}

[multigrid]
smoother_name = {smoother}
bottom_solver_name = {bottom}

[d4est_solver_schwarz]
num_nodes_overlap = 1
subdomain_iter = 15

[quadrature]
name = legendre
"""
NONLINEAR = """
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
scheme = uniform_h
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
pc_type = {pc}

[quadrature]
name = legendre
"""
MG = dict(pc="multigrid", smoother="mg_smoother_cheby",
          bottom="mg_bottom_solver_cg")
RUNS = {
    "a": dict(level=4, deg=3, max_degree=3, scheme="uniform_h", steps=1,
              **MG),
    "cheby": dict(level=4, deg=3, max_degree=3, scheme="uniform_h",
                  steps=0, **dict(MG, pc="cheby")),
    "mg_so_reuse": dict(level=2, deg=2, max_degree=2, scheme="uniform_h",
                        steps=0, **dict(
                            MG, smoother="mg_smoother_schwarz",
                            bottom="mg_bottom_solver_reuse_smoother")),
    # one element: the hierarchy is the fine level alone and the V-cycle
    # is the Chebyshev bottom (with no smoothing on two or more levels the
    # preconditioner is singular and FCG runs to its 10000 cap)
    "mg_none_cheby": dict(level=0, deg=3, max_degree=3, scheme="uniform_h",
                          steps=0, **dict(
                              MG, smoother="mg_smoother_none",
                              bottom="mg_bottom_solver_cheby")),
    "mg_cheby_cheby": dict(level=2, deg=2, max_degree=2, scheme="uniform_h",
                           steps=0, **dict(
                               MG, bottom="mg_bottom_solver_cheby")),
    "mg_block": dict(level=2, deg=2, max_degree=2, scheme="uniform_h",
                     steps=0, **dict(MG, smoother="schwarz")),
    "d": dict(level=3, deg=2, max_degree=4, scheme="smooth_pred", steps=3,
              **MG),
    "cds": dict(level=4, deg=3, dq_inc=0, face_h="FACE_H_EQ_TREE_H",
                steps=1, geometry="name = brick", snes_atol=1e-12,
                ksp="cg", problem="cds", pc="multigrid"),
}
RUNS["tp_jq"] = dict(level=1, deg=2, dq_inc=1,
                     face_h="FACE_H_EQ_J_DIV_SJ_QUAD", steps=1,
                     geometry="""name = cubed_sphere_7tree
r0 = 10.0
r1 = 1000.0
compactify_inner_shell = 1""", snes_atol=1e-10, ksp="fcg",
                     problem="two_punctures", pc="none")
# the CPU tests' small runs (`tests/test_torch_precond_driver.py`)
SMALL = dict(level=2, deg=2, max_degree=2, scheme="uniform_h", steps=0)
CDS_SMALL = dict(level=2, deg=2, dq_inc=0, face_h="FACE_H_EQ_TREE_H",
                 steps=0, geometry="name = brick", snes_atol=1e-12,
                 ksp="cg", problem="cds")
RUNS.update({
    "t_mg": dict(SMALL, **MG),
    "t_cheby": dict(SMALL, **dict(MG, pc="cheby")),
    "t_schwarz": dict(SMALL, **dict(MG, pc="schwarz")),
    "t_hp": dict(level=1, deg=2, max_degree=4, scheme="smooth_pred",
                 steps=3, **MG),
    "t_cds_mg": dict(CDS_SMALL, pc="multigrid"),
    "t_cds_cheby": dict(CDS_SMALL, pc="cheby"),
    "t_cds_schwarz": dict(CDS_SMALL, pc="schwarz"),
})
FACE_H = {"FACE_H_EQ_TREE_H": "tree_h",
          "FACE_H_EQ_VOLUME_DIV_AREA": "volume_div_area",
          "FACE_H_EQ_J_DIV_SJ_QUAD": "j_div_sj_quad"}
SOLVES = ("_linear_solve_fcg_mg", "_linear_solve_fcg_mg_hp",
          "_linear_solve_fcg_schwarz", "_linear_solve_fcg_schwarz_hp",
          "_linear_solve_cg_cheby", "_linear_solve_cg_cheby_hp")


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
    problem = run.pop("problem", None)
    return (LINEAR if problem is None else NONLINEAR).format(**run), problem


def run(key):
    text, problem = options(key)
    digests, krylov = [], []
    names = SOLVES + ("cg_solve", "fcg_solve")
    saved = {n: getattr(driver, n) for n in names}
    saved["build_mesh"] = driver.build_mesh
    coarse_build = multigrid.build_mesh

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

    # `mg_setup` jits a fresh Lanczos closure per level at every call (per
    # Newton step on the nonlinear runs): drop the compiled programs before
    # each, or XLA:CPU runs out of code memory on a long Newton-MG run
    mg_setup = multigrid.mg_setup

    def setup_clearing(*args, **kw):
        jax.clear_caches()
        return mg_setup(*args, **kw)

    multigrid.mg_setup = setup_clearing
    sums = []  # Σ u of each level's Newton solution
    newton_solve = newton.newton_solve

    def summing_newton(*args, **kw):
        res = newton_solve(*args, **kw)
        sums.append(float(np.sum(res.u)))
        return res

    newton.newton_solve = summing_newton
    boundary = driver.CDSProblem.boundary
    driver.CDSProblem.boundary = lambda self, *c: self.params.psi(*c)
    if problem is not None and not JAX_COARSE_LEVELS:
        multigrid.build_mesh = functools.partial(
            coarse_build, face_h_type=FACE_H[RUNS[key]["face_h"]])
    driver.build_mesh = recording_build
    # the linear driver's solves are the jitted `_linear_solve_*`; the
    # nonlinear driver calls `fcg_solve` (the V-cycle's bottom CG is the
    # multigrid module's own and is not counted)
    for n in (SOLVES if problem is None else ("cg_solve", "fcg_solve")):
        setattr(driver, n, counting(n))
    try:
        opts = Options.load(text)
        if problem is None:
            result = driver.run_poisson(opts, SinxProblem)
        else:
            cls = {"cds": driver.CDSProblem,
                   "two_punctures": driver.TwoPuncturesProblem}[problem]
            result = driver.run_nonlinear(opts, cls(opts))
    finally:
        driver.CDSProblem.boundary = boundary
        multigrid.build_mesh = coarse_build
        multigrid.mg_setup = mg_setup
        newton.newton_solve = newton_solve
        for name, fn in saved.items():
            setattr(driver, name, fn)
    rows = result.norms.rows
    key_norm = "L_2" if "L_2" in rows[-1] else "F_norm"
    out = [(r["num_quadrants"], r["num_nodes"], float(r[key_norm]), its,
            digest) for r, its, digest in zip(rows, krylov, digests)]
    return result.norms.lines(key_norm), out, sums or [
        float(np.sum(result.u))]


JAX_COARSE_LEVELS = False


def main(argv):
    global JAX_COARSE_LEVELS
    if "--jax-coarse-levels" in argv:
        JAX_COARSE_LEVELS = True
        argv = [a for a in argv if a != "--jax-coarse-levels"]
    for key in argv or list(RUNS):
        lines, rows, u_sum = run(key)
        print(f"{key}: {RUNS[key]}")
        for line in lines:
            print(f"    {line!r}")
        for row in rows:
            print(f"    ({row[0]}, {row[1]}, {row[2]!r}, {row[3]!r}, "
                  f"{row[4]!r}),")
        print(f"    sum u {u_sum!r}")  # per level on the nonlinear runs
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
