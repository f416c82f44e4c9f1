"""The port's nonlinear path held to the reference digits that the JAX
package's tests pin (f64, CPU), without rerunning the JAX trajectories:

- the CDS regression through the port's CLI (`tests/test_cds.py`, the
  reference's `d4est_test_mpi.sh`): brick, level 2, deg 2,
  FACE_H_EQ_TREE_H, one smooth_pred step, CG: the lines
  `64 1728 1728 9.6078621…e-06` and `288 7776 7776 3.7944365…e-06`, both
  within 1e-8 relative of the reference digits.  The port's CDS takes
  ψ_analytic as Dirichlet data; the JAX driver's `CDSProblem.boundary`
  returns 1 (ROADMAP C11), which a test states;
- the Okendon Newton of `tests/test_problems.py:82`;
- the TwoPunctures point digit u(10, 0, 0) = 0.0004250131568938 of
  `tests/test_regression_digits.py:65` (56 DOF, dense Jacobian solves,
  the point probe);
- (the Stamm hp-AMR trajectory of `tests/test_regression_digits.py:268`
  is in `tests/test_torch_oracles.py`, rows 0-5);
- BoyenYork and MultiPuncture as `tests/test_breadth.py:68-113`;
- TwoPunctures, Okendon and Stamm through the port's CLI;
- `[parallelism] enable = 1` on one process raises, as in JAX.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from disco4est_tpu_torch import __main__ as cli
from disco4est_tpu_torch import driver
from disco4est_tpu_torch.geometry.brick import BrickGeometry
from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
from disco4est_tpu_torch.mesh.builder import build_mesh
from disco4est_tpu_torch.mesh.tree import Forest
from disco4est_tpu_torch.solvers.cg import cg_solve
from disco4est_tpu_torch.solvers.newton import NewtonParams, newton_solve
from disco4est_tpu_torch.util.config import Options

from torch_threads import torch_worker_threads  # noqa: F401


CDS_OPTIONS = """
[problem]
name = constant_density_star

[initial_mesh]
min_level = 2
region0_deg = 2
region0_deg_quad_inc = 0

[mesh_parameters]
face_h_type = FACE_H_EQ_TREE_H
volume_h_type = VOL_H_EQ_CUBE_APPROX

[flux]
name = sipg
sipg_penalty_prefactor = 2.0
sipg_penalty_fcn = maxp_sqr_over_minh

[amr]
scheme = smooth_pred
num_of_amr_steps = 1
percentile = 25
gamma_h = 0.25
gamma_p = 0.1
gamma_n = 1.0

[geometry]
name = brick

[d4est_solver_newton]
snes_atol = 1e-12
snes_max_it = 30

[d4est_solver_krylov_petsc]
ksp_type = cg
ksp_max_it = 10000

[quadrature]
name = legendre
"""
CDS_DIGITS = (9.607862111733e-06, 3.7944365819784e-06)  # test_cds.py:86,119

TP_OPTIONS = """
[problem]
name = two_punctures

[initial_mesh]
min_level = 0
region0_deg = 2
region0_deg_quad_inc = 1

[mesh_parameters]
face_h_type = FACE_H_EQ_VOLUME_DIV_AREA

[amr]
scheme = uniform_h
num_of_amr_steps = 0

[geometry]
name = cubed_sphere_7tree
r0 = 10.0
r1 = 1000.0
compactify_inner_shell = 1

[d4est_solver_newton]
snes_atol = 1e-10

[d4est_solver_krylov_petsc]
ksp_type = fcg
"""

OKENDON_OPTIONS = """
[problem]
name = okendon
p = 0.5

[initial_mesh]
min_level = 1
region0_deg = 2

[amr]
scheme = uniform_h
num_of_amr_steps = 0

[geometry]
name = brick
x0 = 0.2
y0 = 0.2
z0 = 0.2

[d4est_solver_newton]
snes_atol = 1e-10

[d4est_solver_krylov_petsc]
ksp_type = cg
"""

STAMM_OPTIONS = """
[initial_mesh]
min_level = 1
region0_deg = 2

[flux]
sipg_penalty_prefactor = 2.0

[amr]
scheme = uniform_h
num_of_amr_steps = 1

[geometry]
name = brick

[d4est_solver_krylov_petsc]
ksp_type = cg
use_mixed_precision = 0
"""


def _cli(text, tmp_path, problem=None):
    path = tmp_path / "options.input"
    path.write_text(text)
    argv = [str(path), "--device=cpu"]
    if problem:
        argv.append(f"--problem={problem}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue().splitlines()


def test_cds_regression_through_the_cli(tmp_path):
    lines = _cli(CDS_OPTIONS, tmp_path)
    assert len(lines) == 5, lines
    for line, (E, dof), digit in zip(lines, ((64, 1728), (288, 7776)),
                                     CDS_DIGITS):
        n_e, n_dof, n_q, l2 = line.split()
        assert (int(n_e), int(n_dof), int(n_q)) == (E, dof, dof)
        assert abs(float(l2) - digit) <= 1e-8 * digit, (line, digit)
    assert lines[0].startswith("64 1728 1728 9.6078621")
    assert lines[1].startswith("288 7776 7776 3.7944365")
    for level, line in enumerate(lines[2:4]):
        assert line.startswith(f"newton level {level}: iterations=")
        fields = dict(kv.split("=", 1) for kv in line.split()[3:])
        assert float(fields["F_norm"]) < 1e-12
        assert int(fields["krylov"]) == sum(
            int(k) for k in fields["krylov_steps"].split(","))
        assert len(fields["history"].split(",")) == int(
            fields["iterations"]) + 1
    assert lines[4].startswith("C1 = ")


def test_cds_boundary_data_differ_from_the_jax_driver():
    """ROADMAP C11: the JAX driver's `CDSProblem.boundary` is 1; the
    port's is ψ_analytic, which the reference's digits need."""
    import jax.numpy as jnp

    from disco4est_tpu.driver import CDSProblem as JCDS

    x = np.array([0.0, 0.25, 1.0])
    y = np.array([0.5, 1.0, 0.0])
    z = np.array([1.0, 0.0, 0.5])
    jax_bc = np.asarray(JCDS().boundary(*(jnp.asarray(c) for c in (x, y, z))))
    assert (jax_bc == 1.0).all()
    port = driver.CDSProblem()
    got = port.boundary(*(torch.as_tensor(c) for c in (x, y, z)))
    psi = port.params.psi(*(torch.as_tensor(c) for c in (x, y, z)))
    assert torch.equal(got, psi)
    assert float((got - 1.0).abs().min()) > 1e-7


@pytest.mark.parametrize("name", ["cds", "okendon", "two_punctures"])
def test_driver_jacobian_equals_the_problems(name):
    """`run_nonlinear` evaluates the frozen-u0 coefficient once per Newton
    step (`fof_lin_coeff`); its operator is the problem module's
    `jacobian_apply` bit for bit."""
    from disco4est_tpu_torch.laplacian.nonlinear import (
        apply_mass_coeff,
        fof_lin_coeff,
    )

    if name == "two_punctures":
        problem = driver.TwoPuncturesProblem()
        geom = CubedSphereGeometry("7tree", R0=10.0, R1=1000.0,
                                   compactify_inner_shell=True)
        mesh = build_mesh(geom, Forest.uniform(geom.conn, 0), deg=1,
                          device="cpu")
        bc = problem.robin_coeff_values(mesh)
    else:
        problem = (driver.CDSProblem() if name == "cds"
                   else driver.OkendonProblem())
        geom = BrickGeometry(x0=(0.2, 0.2, 0.2), x1=(1.0, 1.0, 1.0), dim=3)
        mesh = build_mesh(geom, Forest.uniform(geom.conn, 1), deg=2,
                          device="cpu")
        bc = mesh.boundary_values(problem.boundary)
    rng = np.random.default_rng(2)
    shape = (mesh.n_elements,) + (mesh.nl,) * 3
    u0 = 1.0 + 0.01 * torch.as_tensor(rng.standard_normal(shape))
    v = torch.as_tensor(rng.standard_normal(shape))
    coeff = fof_lin_coeff(mesh, u0, problem.dfof())
    got = problem.linear_apply(mesh, v, bc) + apply_mass_coeff(mesh, coeff, v)
    args = (problem.params, bc) if name == "two_punctures" else (
        problem.params,)
    assert torch.equal(got, problem.mod.jacobian_apply(mesh, u0, v, *args))


def test_okendon_newton():
    from disco4est_tpu_torch.problems.okendon import (
        OkendonParams,
        jacobian_apply,
        residual,
    )

    params = OkendonParams(p=0.5)
    geom = BrickGeometry(x0=(0.2, 0.2, 0.2), x1=(1.0, 1.0, 1.0), dim=3)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 1), deg=2,
                      device="cpu")
    g = mesh.boundary_values(params.boundary)
    result = newton_solve(
        residual=lambda u: residual(mesh, u, g, params),
        jacobian_solve=lambda u, rhs, rtol: cg_solve(
            lambda v: jacobian_apply(mesh, u, v, params), rhs,
            atol=1e-13, rtol=rtol, max_iter=5000).x,
        u0=mesh.init_field(params.analytic),
        params=NewtonParams(atol=1e-10, max_iter=20, inner_rtol=1e-8),
    )
    assert result.residual_norm < 1e-9, result.history
    u_a = mesh.init_field(params.analytic)
    err = float(torch.sqrt(torch.sum(mesh.l2_norm_sqr(result.u - u_a))))
    assert err < 0.05, err


def test_two_punctures_7tree_digit():
    """u(10, 0, 0) = 0.0004250131568938 (`d4est_test_twopunctures.sh:5`;
    7-tree, R0 10, R1 1000, compactified inner shell, deg 1, 56 DOF,
    FACE_H_EQ_J_DIV_SJ_MIN_LOBATTO, Robin 1/r), with dense Jacobian
    solves: the early Jacobian is indefinite."""
    from disco4est_tpu_torch.mesh.probe import interpolate_at_point
    from disco4est_tpu_torch.problems.two_punctures import (
        TwoPuncturesParams,
        jacobian_apply,
        residual,
    )

    geom = CubedSphereGeometry("7tree", R0=10.0, R1=1000.0,
                               compactify_inner_shell=True)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 0), deg=1,
                      face_h_type="j_div_sj_min_lobatto", device="cpu")
    assert mesh.n_elements == 7 and mesh.local_nodes == 56
    params = TwoPuncturesParams()
    rc = mesh.boundary_values_quad(params.robin_coeff)
    n, shape = mesh.local_nodes, (7, 2, 2, 2)
    eye = torch.eye(n, dtype=torch.float64).reshape((n,) + shape)

    def jac_solve(u0, rhs, rtol):
        A = torch.stack([jacobian_apply(mesh, u0, eye[i], params, rc)
                         .reshape(-1) for i in range(n)], dim=1)
        return torch.linalg.solve(A, rhs.reshape(-1)).reshape(shape)

    result = newton_solve(
        residual=lambda u: residual(mesh, u, params, rc),
        jacobian_solve=jac_solve,
        u0=mesh.init_field(params.initial_guess),
        params=NewtonParams(atol=1e-14, max_iter=50, inner_rtol=1e-12),
    )
    assert result.residual_norm < 1e-13, result.history
    val, _ = interpolate_at_point(mesh, result.u, (10.0, 0.0, 0.0))
    assert abs(val - 0.0004250131568938) < 1e-12, val


def _solve_by(deg):
    from disco4est_tpu_torch.problems.boyen_york import (
        BoyenYorkParams,
        jacobian_apply,
        residual,
    )

    params = BoyenYorkParams(a=1.0, P=1.0)
    geom = CubedSphereGeometry("12tree_hole", R0=1.5, R1=2.0, R2=4.0)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 0), deg=deg,
                      face_h_type="j_div_sj_quad",
                      penalty_fcn="meanp_sqr_over_meanh",
                      penalty_prefactor=2.0, device="cpu")
    g = mesh.boundary_values(params.boundary)
    res = newton_solve(
        residual=lambda u: residual(mesh, u, g, params),
        jacobian_solve=lambda u, rhs, rtol: cg_solve(
            lambda v: jacobian_apply(mesh, u, v, params), rhs,
            atol=1e-14, rtol=rtol, max_iter=20000).x,
        u0=mesh.init_field(params.initial_guess),
        params=NewtonParams(atol=1e-11, max_iter=20, inner_rtol=1e-10),
    )
    ua = mesh.init_field(params.analytic)
    err = float(torch.sqrt(torch.sum(mesh.l2_norm_sqr(res.u - ua))))
    return res, err


def test_boyen_york_newton():
    """`tests/test_breadth.py:68`: Newton converges on the excised sphere
    and the p-refined error drops."""
    res2, err2 = _solve_by(2)
    assert res2.residual_norm < 1e-10
    res3, err3 = _solve_by(3)
    assert err3 < 0.2 * err2, (err2, err3)
    assert err2 < 0.2


def test_multi_puncture_three_spinning():
    """`tests/test_breadth.py:113`: three spinning punctures, Newton–
    Krylov with the Robin outer boundary on the 7-tree sphere; and two
    spinless punctures reproduce TwoPunctures exactly (`:79`)."""
    from disco4est_tpu_torch.problems import multi_puncture as mp
    from disco4est_tpu_torch.problems import two_punctures as tp

    geom = CubedSphereGeometry("7tree", R0=1.0, R1=4.0, R2=8.0)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 0), deg=3,
                      face_h_type="j_div_sj_quad", device="cpu")
    two = mp.MultiPunctureParams(punctures=(
        mp.Puncture(xyz=(3.0, 0.0, 0.0), M=0.5, P=(0.0, 0.2, 0.0)),
        mp.Puncture(xyz=(-3.0, 0.0, 0.0), M=0.5, P=(0.0, -0.2, 0.0)),
    ))
    tpp = tp.TwoPuncturesParams()
    bc = mesh.boundary_values_quad(tpp.robin_coeff)
    rng = np.random.default_rng(0)
    u = 0.01 * torch.as_tensor(rng.standard_normal(
        (mesh.n_elements,) + (mesh.nl,) * 3))
    v = 0.1 * torch.as_tensor(rng.standard_normal(u.shape))
    assert float((tp.residual(mesh, u, tpp, bc)
                  - mp.residual(mesh, u, two, bc)).abs().max()) < 1e-12
    assert float((tp.jacobian_apply(mesh, u, v, tpp, bc)
                  - mp.jacobian_apply(mesh, u, v, two, bc)).abs().max()
                 ) < 1e-12

    params = mp.MultiPunctureParams(punctures=(
        mp.Puncture(xyz=(2.0, 0.0, 0.0), M=0.4, P=(0.0, 0.1, 0.0),
                    S=(0.0, 0.0, 0.1)),
        mp.Puncture(xyz=(-1.0, 1.7, 0.0), M=0.3, P=(-0.08, -0.05, 0.0),
                    S=(0.0, 0.05, 0.0)),
        mp.Puncture(xyz=(-1.0, -1.7, 0.0), M=0.3, P=(0.08, -0.05, 0.0),
                    S=(0.05, 0.0, 0.0)),
    ))
    bc = mesh.boundary_values_quad(params.robin_coeff)
    res = newton_solve(
        residual=lambda w: mp.residual(mesh, w, params, bc),
        jacobian_solve=lambda w, rhs, rtol: cg_solve(
            lambda z: mp.jacobian_apply(mesh, w, z, params, bc), rhs,
            atol=1e-14, rtol=rtol, max_iter=20000).x,
        u0=mesh.init_field(params.initial_guess),
        params=NewtonParams(atol=1e-10, max_iter=25, inner_rtol=1e-9),
    )
    assert res.residual_norm < 1e-9
    assert float(res.u.abs().max()) > 1e-3


@pytest.mark.parametrize("name,text,problem,key", [
    ("two_punctures", TP_OPTIONS, None, "F_norm"),
    ("okendon", OKENDON_OPTIONS, None, "L_2"),
    ("stamm", STAMM_OPTIONS, "stamm", "L_2"),
], ids=["two_punctures", "okendon", "stamm"])
def test_cli_runs_the_problem(tmp_path, name, text, problem, key):
    lines = _cli(text, tmp_path, problem)
    norms = [line for line in lines if len(line.split()) == 4
             and not line.startswith("C1")]
    assert norms, lines
    values = [float(line.split()[3]) for line in norms]
    assert all(np.isfinite(values)), lines
    if name == "two_punctures":  # no analytic solution: ‖F‖ ≤ snes_atol
        assert lines[0].startswith("7 189 448 ")
        assert values[0] <= 1e-10
        assert lines[1].startswith("newton level 0: iterations=")
    elif name == "okendon":
        assert values[0] < 0.05
        assert "newton level 0:" in lines[1]
    else:  # linear: the solve lines and a falling error
        assert [int(line.split()[0]) for line in norms] == [8, 64]
        assert values[1] < values[0]
        assert lines[2].startswith("solve level 0: path=cg")


NONLINEAR_OPTIONS = CDS_OPTIONS.replace("num_of_amr_steps = 1",
                                        "num_of_amr_steps = 0")


# The preconditioners run since ROADMAP A13, the K-slot Schwarz variant
# since A13b and IO, checkpoints, restart and the timings option since A14
# (held to the JAX driver in `tests/test_torch_precond_driver.py`,
# `test_torch_kslot.py` and `test_torch_restart.py`), `[parallelism]`
# (A15) one process per rank (`tests/test_torch_dist_driver.py`); the case
# left asks one process for more ranks than it has, which raises as the
# JAX driver does (`disco4est_tpu/driver.py:487-490`).
@pytest.mark.parametrize("edit,item", [
    (("[quadrature]", "[parallelism]\nenable = 1\n[quadrature]"),
     "more than one rank"),
    # the ids these cases had before the A14 cases went
], ids=["edit2-A15"])
def test_nonlinear_unported_options_raise(edit, item):
    opts = Options.load(NONLINEAR_OPTIONS.replace(*edit))
    with pytest.raises(ValueError, match=item):
        driver.run_nonlinear(opts, driver.CDSProblem(opts), device="cpu")


def test_nonlinear_unknown_scheme_raises():
    opts = Options.load(NONLINEAR_OPTIONS.replace("scheme = smooth_pred",
                                                  "scheme = uniform_p"))
    with pytest.raises(ValueError, match="uniform_p"):
        driver.run_nonlinear(opts, driver.CDSProblem(opts), device="cpu")
