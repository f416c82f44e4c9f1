"""The port's driver on cubed spheres == the JAX driver (CPU, f64).

- The Lorentzian regression on the 13-tree sphere (R0 = 10, R1 = 20,
  R2 = 1000, compactified outer shell; level 1, deg 1;
  FACE_H_EQ_J_DIV_SJ_QUAD): the CLI prints the JAX driver's norm line,
  and the reference digit, the L2 of |u − u_a| after plain f64 CG at atol
  1e-15 (`tests/test_regression_digits.py:28-62`), equals
  2706.02899845001593 to 1e-12 relative.
- `tests/test_curved_fast.py:78-107` through the port: the mixed-curved
  solve (tree-structured f32 inner CG) gives the f64 solve's L2 to 1e-9.
  The JAX curved solve always stops after 3 outer steps (ROADMAP C1); the
  port's stops when the residual stops contracting, so its outer count
  may differ from JAX's.
- hp smooth_pred on the 7-tree sphere (`chip_smoke.py` phase 10 (d)):
  the JAX driver's forests and degrees at every level, its L2 and η² to
  1e-10 relative.  Its mortars cross reoriented tree faces, so the
  builder's mortar permutations and the estimator's run.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from disco4est_tpu_torch import __main__ as cli
from disco4est_tpu_torch.driver import run_poisson
from disco4est_tpu_torch.problems.poisson import SinxProblem
from disco4est_tpu_torch.util.config import Options

LORENTZIAN = """
[initial_mesh]
min_level = 1
region0_deg = 1
region0_deg_quad_inc = 0
[mesh_parameters]
face_h_type = FACE_H_EQ_J_DIV_SJ_QUAD
[flux]
sipg_penalty_prefactor = 2.0
sipg_penalty_fcn = maxp_sqr_over_minh
[amr]
scheme = uniform_p
num_of_amr_steps = 0
[geometry]
name = cubed_sphere
R0 = 10
R1 = 20
R2 = 1000
compactify_outer_shell = 1
[d4est_solver_krylov_petsc]
ksp_type = fcg
ksp_atol = 5e-15
[quadrature]
name = legendre
"""
# `tests/test_curved_fast.py:86-102`
CURVED_FAST = """
[initial_mesh]
min_level = 0
region0_deg = 3
[mesh_parameters]
max_degree = 3
[amr]
scheme = uniform_h
num_of_amr_steps = 0
[geometry]
name = cubed_sphere_7tree
r0 = 1.0
r1 = 2.0
[d4est_solver_krylov_petsc]
use_mixed_precision = {m}
use_structured = 1
"""
# `chip_smoke.py` phase 10 (d) and `refcheck/curved_smoke_pins.py` d
SMOOTH_PRED = """
[geometry]
name = cubed_sphere_7tree
r0 = 1.0
r1 = 2.0
[initial_mesh]
min_level = 1
region0_deg = 2
[mesh_parameters]
face_h_type = FACE_H_EQ_J_DIV_SJ_QUAD
max_degree = 4
[amr]
scheme = smooth_pred
num_of_amr_steps = 2
percentile = 25.0
gamma_h = 10.0
gamma_p = 0.1
gamma_n = 1.0
[flux]
sipg_penalty_prefactor = 2.0
"""


def test_lorentzian_cli_prints_the_jax_norm_line():
    from disco4est_tpu.driver import run_poisson as jrun
    from disco4est_tpu.problems.poisson import LorentzianProblem as JLor
    from disco4est_tpu.util.config import Options as JOptions

    ref = jrun(JOptions.load(LORENTZIAN), JLor).norms.lines("L_2")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main([LORENTZIAN, "--problem=lorentzian", "--device=cpu"])
    lines = buf.getvalue().splitlines()
    assert code == 0
    assert lines[0] == ref[0] and lines[0].startswith("104 832 832 ")
    # on the CPU `use_structured = auto` is off: the generic mixed solve
    assert lines[1].startswith("solve level 0: path=mixed ")
    assert "fallback=no" in lines[1]


def test_lorentzian_reference_digit():
    from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.problems.poisson import LorentzianProblem as P
    from disco4est_tpu_torch.solvers.cg import cg_solve

    geom = CubedSphereGeometry("13tree", R0=10.0, R1=20.0, R2=1000.0,
                               compactify_outer_shell=True)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 1), deg=1,
                      face_h_type="j_div_sj_quad", penalty_prefactor=2.0,
                      penalty_fcn="maxp_sqr_over_minh", device="cpu")
    assert mesh.n_elements == 104 and mesh.local_nodes == 832
    rhs = build_rhs_with_strong_bc(mesh, mesh.init_field(P.rhs),
                                   mesh.boundary_values(P.boundary))
    res = cg_solve(lambda v: apply_sipg(mesh, v), rhs, atol=1e-15,
                   rtol=0.0, max_iter=5000)
    err = torch.abs(res.x - mesh.init_field(P.analytic))
    L2 = float(torch.sqrt(torch.sum(mesh.l2_norm_sqr(err))))
    assert abs(L2 - 2706.02899845001593) / 2706.0 < 1e-12, L2


def test_driver_mixed_curved_path():
    """The mixed-precision solve dispatches to the tree-structured curved
    apply on uniform multi-tree curved meshes (`use_structured = 1` forces
    it on the CPU) and reproduces the f64 digits."""
    ref = run_poisson(Options.load(CURVED_FAST.format(m=0)), SinxProblem,
                      device="cpu")
    got = run_poisson(Options.load(CURVED_FAST.format(m=1)), SinxProblem,
                      device="cpu")
    assert ref.solves[0].path == "cg"
    info = got.solves[0]
    assert info.path == "mixed-curved" and not info.fallback
    # no copy of the JAX stall test (ROADMAP C1): the refinement runs past
    # 3 outer steps while the residual still contracts
    assert info.outer_iterations >= 1
    a, b = ref.norms.rows[-1]["L_2"], got.norms.rows[-1]["L_2"]
    assert abs(a - b) <= 1e-9 * max(1.0, abs(a)), (a, b)


@pytest.fixture(scope="module")
def jax_smooth_pred():
    from disco4est_tpu import driver as jdriver
    from disco4est_tpu.problems.poisson import SinxProblem as JSinx
    from disco4est_tpu.util.config import Options as JOptions

    with _recording(jdriver) as epochs:
        res = jdriver.run_poisson(JOptions.load(SMOOTH_PRED), JSinx)
    return res, epochs


@contextlib.contextmanager
def _recording(driver_module):
    """Record (tree, level, anchor, deg_e) of every epoch's mesh build."""
    epochs = []
    build = driver_module.build_mesh

    def recording(geom, forest, **kw):
        epochs.append((forest.tree.copy(), forest.level.copy(),
                       forest.anchor.copy(), np.asarray(kw["deg_e"]).copy()))
        return build(geom, forest, **kw)

    driver_module.build_mesh = recording
    try:
        yield epochs
    finally:
        driver_module.build_mesh = build


def test_smooth_pred_on_sphere_matches_jax_driver(jax_smooth_pred):
    from disco4est_tpu_torch import driver

    ref, ref_epochs = jax_smooth_pred
    with _recording(driver) as epochs:
        result = run_poisson(Options.load(SMOOTH_PRED), SinxProblem,
                             device="cpu")
    assert len(epochs) == len(ref_epochs) == 3
    for got, want in zip(epochs, ref_epochs):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(set(epochs[1][1])) > 1  # hanging faces at level 1
    assert epochs[2][3].max() > 2  # p-refinement: mixed degrees at level 2
    for a, b in zip(result.norms.rows, ref.norms.rows):
        assert a["num_nodes"] == b["num_nodes"]
        assert abs(a["L_2"] - b["L_2"]) <= 1e-10 * b["L_2"]
    assert len(result.eta2_history) == len(ref.eta2_history) == 2
    for a, b in zip(result.eta2_history, ref.eta2_history):
        assert np.max(np.abs(a - np.asarray(b))) <= 1e-10 * np.max(b)
    assert [s.path for s in result.solves] == ["mixed", "mixed", "cg-hp"]
    assert not any(s.fallback for s in result.solves)
