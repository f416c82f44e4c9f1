"""Reference values of the disk, trapezoid, pizza-half and hole-in-a-box
runs of `chip_smoke.py` phase 13 and of `tests/test_torch_geometry2d.py`,
from the JAX package on the CPU.

    JAX_PLATFORMS=cpu python refcheck/geometry_smoke_pins.py [key ...]

Runs the JAX driver (`disco4est_tpu.driver.run_poisson`) on the options of
each pinned run and prints, per AMR level, the norm line and the tuple
(elements, DOF, L2 error) that `chip_smoke.py` pins:

- a5, a6: sinx on the 5-tree disk (R0 = 0.5, R1 = 1), deg 3,
  FACE_H_EQ_J_DIV_SJ_QUAD, prefactor 2, level 5 and level 6 (the first
  two epochs of phase 13 (a); its level 7 is held to an f64 solve on the
  card);
- ap: sinx on the disk, level 3, uniform_p from deg 3 to 5,
  FACE_H_EQ_J_DIV_SJ_QUAD;
- trap, pizza: sinx on the trapezoid and the pizza-half (R0 = 0.5,
  R1 = 1), level 4, uniform_p from deg 2 to 4, FACE_H_EQ_J_DIV_SJ_QUAD
  (phase 13 (b));
- hole: the Lorentzian on the hole-in-a-box (inner_radius 1,
  box_length 10), deg 3, FACE_H_EQ_J_DIV_SJ_QUAD, uniform_h from level 1
  to 2, and hole3 its level 3 alone (phase 13 (c));
- t_disk, t_hole: the CPU tests' runs: sinx on the disk at level 2, deg 2,
  volume/area h, one uniform_h step; the Lorentzian on the hole-in-a-box
  at level 0, deg 2, FACE_H_EQ_J_DIV_SJ_QUAD, two uniform_h steps (the
  `ap` run is the tests' uniform_p one).

With the key `conv` it prints instead the L2 errors of the solves of
`test_disk_poisson_p_convergence` and
`test_trap_and_pizza_poisson_p_convergence`
(`tests/test_disk_and_tools.py:19,141`: the disk at level 1, deg 2 and 3;
the trapezoid and the pizza-half at level 1, deg 2 and 4; plain f64 CG to
1e-14), which the port's tests hold to 1e-8 relative.

The JAX driver on the CPU solves with its generic mixed-precision path
(`use_structured = 0`), which refines to the f64 floor.  Times on an
8-core CPU (JAX's compiles included): t_disk 8 s, t_hole 21 s, ap 18 s,
trap 14 s, pizza 6 s, hole 32 s, hole3 386 s, a5 46 s, a6 243 s;
conv ~20 s.
"""

import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

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
face_h_type = {face_h}
max_degree = {max_degree}

[flux]
name = sipg
sipg_penalty_prefactor = 2.0
sipg_penalty_fcn = maxp_sqr_over_minh

[amr]
scheme = {scheme}
num_of_amr_steps = {steps}

[geometry]
{geometry}

[d4est_solver_krylov_petsc]
ksp_type = fcg
ksp_atol = 5e-15
use_structured = {use_structured}

[quadrature]
name = legendre
"""
DISK = """name = disk
r0 = 0.5
r1 = 1.0"""
PIZZA = """name = pizza_half
r0 = 0.5
r1 = 1.0"""
HOLE = """name = hole_in_a_box
inner_radius = 1.0
box_length = 10.0"""
QUAD = "FACE_H_EQ_J_DIV_SJ_QUAD"

RUNS = {
    "a5": dict(level=5, deg=3, max_degree=3, scheme="uniform_h", steps=0,
               face_h=QUAD, geometry=DISK, problem="sinx"),
    "a6": dict(level=6, deg=3, max_degree=3, scheme="uniform_h", steps=0,
               face_h=QUAD, geometry=DISK, problem="sinx"),
    "ap": dict(level=3, deg=3, max_degree=5, scheme="uniform_p", steps=2,
               face_h=QUAD, geometry=DISK, problem="sinx"),
    "trap": dict(level=4, deg=2, max_degree=4, scheme="uniform_p", steps=2,
                 face_h=QUAD, geometry="name = trap", problem="sinx"),
    "pizza": dict(level=4, deg=2, max_degree=4, scheme="uniform_p", steps=2,
                  face_h=QUAD, geometry=PIZZA, problem="sinx"),
    "hole": dict(level=1, deg=3, max_degree=3, scheme="uniform_h", steps=1,
                 face_h=QUAD, geometry=HOLE, problem="lorentzian"),
    "hole3": dict(level=3, deg=3, max_degree=3, scheme="uniform_h",
                  steps=0, face_h=QUAD, geometry=HOLE, problem="lorentzian"),
    "t_disk": dict(level=2, deg=2, max_degree=2, scheme="uniform_h",
                   steps=1, face_h="FACE_H_EQ_VOLUME_DIV_AREA",
                   geometry=DISK, problem="sinx"),
    "t_hole": dict(level=0, deg=2, max_degree=2, scheme="uniform_h",
                   steps=2, face_h=QUAD, geometry=HOLE,
                   problem="lorentzian"),
}
PROBLEMS = {"sinx": SinxProblem, "lorentzian": LorentzianProblem}


def options(key, use_structured="0"):
    """The options text of a run (the port's CLI reads the same text)."""
    run = dict(RUNS[key])
    run.pop("problem")
    return OPTIONS.format(use_structured=use_structured, **run)


def run(key):
    res = driver.run_poisson(Options.load(options(key)),
                             PROBLEMS[RUNS[key]["problem"]])
    return res.norms.lines("L_2"), [
        (r["num_quadrants"], r["num_nodes"], float(r["L_2"]))
        for r in res.norms.rows
    ]


def convergence():
    """{(geometry, deg): L2 error} of the JAX tests' p-convergence solves."""
    import jax.numpy as jnp
    import numpy as np

    from disco4est_tpu.geometry.disk import DiskGeometry
    from disco4est_tpu.geometry.misc import PizzaHalfGeometry, TrapGeometry
    from disco4est_tpu.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu.mesh.builder import build_mesh
    from disco4est_tpu.mesh.tree import Forest
    from disco4est_tpu.solvers.cg import cg_solve

    pi = np.pi
    u_fcn = lambda x, y: jnp.sin(pi * x) * jnp.sin(pi * y)
    f_fcn = lambda x, y: 2 * pi**2 * u_fcn(x, y)
    out = {}
    for name, geom, degs in (("disk", DiskGeometry(0.5, 1.0), (2, 3)),
                             ("trap", TrapGeometry(), (2, 4)),
                             ("pizza", PizzaHalfGeometry(0.5, 1.0), (2, 4))):
        forest = Forest.uniform(geom.conn, 1)
        for deg in degs:
            mesh = build_mesh(geom, forest, deg=deg, deg_quad=deg + 1,
                              face_h_type="j_div_sj_quad")
            rhs = build_rhs_with_strong_bc(mesh, mesh.init_field(f_fcn),
                                           mesh.boundary_values(u_fcn))
            res = cg_solve(lambda v: apply_sipg(mesh, v), rhs, atol=1e-14,
                           rtol=0.0, max_iter=20000)
            err = res.x - mesh.init_field(u_fcn)
            out[(name, deg)] = float(jnp.sqrt(jnp.sum(
                mesh.l2_norm_sqr(err))))
    return out


def main(argv):
    if argv == ["conv"]:
        print(f"CONVERGENCE = {convergence()!r}")
        return
    for key in argv or sorted(RUNS):
        t0 = time.perf_counter()
        lines, pins = run(key)
        print(f"# {key} ({time.perf_counter() - t0:.1f} s)")
        for line in lines:
            print(f"#   {line}")
        print(f"{key!r}: {pins!r},")
        sys.stdout.flush()


if __name__ == "__main__":
    main(sys.argv[1:])
