"""The reference oracles through the port: the constructions of the digit
tests that pin the JAX package to the compiled C code, run on the port's
own modules on any device, each returning its numbers (a trajectory:
one dict a row).  The values they are held to, and the tolerances, are in
`refcheck/oracle_smoke_pins.py`; `tests/test_torch_oracles.py` checks
them on the CPU and `chip_smoke.py` phase 17 on the card.  The oracles:

- `sinx_regression`: the sinx regression of `tests/test_laplacian.py:
  95-154` (brick, level 2, deg 1, the reference's π, f64 CG): the true
  L2 error and the reference's grep digit, the L2 of the nodal |e|;
- `cds_amr`: the CDS Newton solve and one smooth_pred step of
  `tests/test_cds.py:64-126`, with the bi estimator of the second level;
- `two_punctures_13tree`: the 13-tree TwoPunctures digit of
  `tests/test_regression_digits.py:131-190` (dense Jacobian solves);
- `two_punctures_trajectory`: the 4-level TwoPunctures smooth_pred
  trajectory of `tests/test_tp_trajectory.py:64`;
- `stamm_trajectory`: the Stamm hp-AMR trajectory of
  `tests/test_regression_digits.py:268-420`, row by row.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from disco4est_tpu_torch.geometry.brick import BrickGeometry
from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
from disco4est_tpu_torch.mesh.builder import build_mesh
from disco4est_tpu_torch.mesh.tree import Forest
from disco4est_tpu_torch.solvers.cg import cg_solve
from disco4est_tpu_torch.solvers.newton import NewtonParams, newton_solve

# The reference's π (`Problems/Poisson/poisson_sinx_fcns.h:6`), which
# differs from math.pi at the 13th digit; the digits need it.
D4EST_PI = 3.14159265358932384626433832795

F64 = torch.float64


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _dense_solve(apply, u0, rhs, idx, shape):
    """Solve J(u0) d = rhs on the unknowns `idx` of the flat field by
    assembling J column by column (the unit vectors of `idx` through
    `apply(u0, v)`), then a dense LU; zero off `idx`."""
    n = int(np.prod(shape))
    dev = rhs.device
    cols = []
    for i in idx:
        e = torch.zeros(n, dtype=F64, device=dev)
        e[i] = 1.0
        cols.append(apply(u0, e.reshape(shape)).reshape(-1)[idx])
    A = torch.stack(cols, dim=1)
    d = torch.linalg.solve(A, rhs.reshape(-1)[idx])
    out = torch.zeros(n, dtype=F64, device=dev)
    out[idx] = d
    return out.reshape(shape)


def sinx_regression(device) -> dict:
    """The sinx regression (`tests/test_laplacian.py:95-154`): brick,
    level 2, deg 1, u = Π sin(π x_d) with the reference's π, f64 CG to
    atol 5e-15; `l2` is ‖u − u_a‖, `l2_interp_abs` the L2 of the nodal
    |u − u_a| interpolated to the quadrature points, the reference's grep
    digit (`d4est_linalg_vec_fabsdiff`, then interpolation)."""
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )

    t0 = time.perf_counter()
    geom = BrickGeometry(dim=3)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 2), deg=1,
                      device=device)

    def u_fcn(*c):
        out = 1.0
        for x in c:
            out = out * torch.sin(D4EST_PI * x)
        return out

    g = mesh.boundary_values(u_fcn)
    f = mesh.init_field(lambda *c: 3 * D4EST_PI**2 * u_fcn(*c))
    rhs = build_rhs_with_strong_bc(mesh, f, g)
    res = cg_solve(lambda v: apply_sipg(mesh, v), rhs, atol=5e-15,
                   rtol=1e-20, max_iter=10000)
    e = res.x - mesh.init_field(u_fcn)
    out = dict(
        n_elements=mesh.n_elements, local_nodes=mesh.local_nodes,
        l2=float(torch.sqrt(torch.sum(mesh.l2_norm_sqr(e)))),
        l2_interp_abs=float(torch.sqrt(torch.sum(mesh.l2_norm_sqr(e.abs())))),
        iterations=res.iterations,
    )
    _sync(device)
    out["seconds"] = time.perf_counter() - t0
    return out


def cds_amr(device) -> dict:
    """The CDS regression with one AMR step (`tests/test_cds.py:64-126`):
    Newton with CG inner solves on the level-2 deg-2 brick
    (FACE_H_EQ_TREE_H), the bi estimator, smooth_pred's top-25 % marking
    at one degree, the refined and balanced forest, and the Newton solve
    there, which starts from the initial guess as the JAX test's does;
    the L2 errors of both levels and √Ση² of the second."""
    from disco4est_tpu_torch.amr.amr import refine_and_balance
    from disco4est_tpu_torch.amr.smooth_pred import (
        SmoothPredParams,
        SmoothPredState,
        smooth_pred_mark,
    )
    from disco4est_tpu_torch.estimators.bi import estimate_bi
    from disco4est_tpu_torch.problems.constant_density_star import (
        CDSParams,
        jacobian_apply,
        residual,
    )

    t0 = time.perf_counter()
    params = CDSParams.create()
    geom = BrickGeometry(dim=3)
    deg = 2

    def solve_on(mesh):
        g = mesh.boundary_values(params.psi)
        res = newton_solve(
            residual=lambda u: residual(mesh, u, g, params),
            jacobian_solve=lambda u0, rhs, rtol: cg_solve(
                lambda v: jacobian_apply(mesh, u0, v, params), rhs,
                atol=1e-15, rtol=rtol, max_iter=20000).x,
            u0=mesh.init_field(params.initial_guess),
            params=NewtonParams(atol=1e-13, max_iter=30, inner_rtol=1e-12),
        )
        err = res.u - mesh.init_field(params.psi)
        l2 = float(torch.sqrt(torch.sum(mesh.l2_norm_sqr(err))))
        eta2 = estimate_bi(mesh, res.u, residual(mesh, res.u, g, params),
                           g=g, penalty_prefactor=2.0).cpu().numpy()
        return res, l2, eta2

    mesh = build_mesh(geom, Forest.uniform(geom.conn, 2), deg=deg,
                      face_h_type="tree_h", device=device)
    res0, l2_0, eta2 = solve_on(mesh)
    sp = SmoothPredParams(gamma_h=0.25, gamma_p=0.1, gamma_n=1.0,
                          percentile=25.0, max_degree=deg)
    log, _ = smooth_pred_mark(eta2, deg, SmoothPredState.fresh(
        mesh.n_elements, sp), sp, dim=3)
    forest = refine_and_balance(mesh.forest, log < 0)
    mesh2 = build_mesh(geom, forest, deg=deg, face_h_type="tree_h",
                       device=device)
    res1, l2_1, eta2_1 = solve_on(mesh2)
    out = dict(
        n_elements=(mesh.n_elements, mesh2.n_elements),
        local_nodes=(mesh.local_nodes, mesh2.local_nodes),
        marked=int((log < 0).sum()),
        l2=(l2_0, l2_1),
        estimator=float(np.sqrt(eta2_1.sum())),
        residual_norm=(res0.residual_norm, res1.residual_norm),
        newton_iterations=(res0.iterations, res1.iterations),
    )
    _sync(device)
    out["seconds"] = time.perf_counter() - t0
    return out


def two_punctures_13tree(device) -> dict:
    """The 13-tree TwoPunctures digit (`tests/test_regression_digits.py:
    131-190`; the reference's `d4est_test_twopunctures_2.sh`): 13-tree
    sphere R0 10, R1 20, R2 1000 with the compactified outer shell, level
    1, deg 1 (104 elements, 832 nodes), FACE_H_EQ_J_DIV_SJ_QUAD, Robin
    1/r; Newton with dense Jacobian solves; u(100, 0, 0)."""
    from disco4est_tpu_torch.mesh.probe import interpolate_at_point
    from disco4est_tpu_torch.problems import two_punctures as tp

    t0 = time.perf_counter()
    geom = CubedSphereGeometry("13tree", R0=10.0, R1=20.0, R2=1000.0,
                               compactify_outer_shell=True)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 1), deg=1,
                      face_h_type="j_div_sj_quad", penalty_prefactor=2.0,
                      penalty_fcn="maxp_sqr_over_minh", device=device)
    params = tp.TwoPuncturesParams()
    rc = mesh.boundary_values_quad(params.robin_coeff)
    shape = (mesh.n_elements,) + (2,) * 3
    idx = np.arange(mesh.local_nodes)
    res = newton_solve(
        residual=lambda u: tp.residual(mesh, u, params, rc),
        jacobian_solve=lambda u0, rhs, rtol: _dense_solve(
            lambda w, v: tp.jacobian_apply(mesh, w, v, params, rc),
            u0, rhs, idx, shape),
        u0=mesh.init_field(params.initial_guess),
        params=NewtonParams(atol=1e-14, max_iter=50, inner_rtol=1e-12),
    )
    val, _ = interpolate_at_point(mesh, res.u, (100.0, 0.0, 0.0))
    out = dict(n_elements=mesh.n_elements, local_nodes=mesh.local_nodes,
               residual_norm=res.residual_norm,
               newton_iterations=res.iterations, u_100=float(val))
    _sync(device)
    out["seconds"] = time.perf_counter() - t0
    return out


def two_punctures_trajectory(device, levels: int = 4) -> list:
    """The TwoPunctures smooth_pred trajectory (`tests/test_tp_trajectory.
    py:64`): 7-tree sphere R0 10, R1 1000, compactified inner shell,
    deg 1, FACE_H_EQ_J_DIV_SJ_MIN_LOBATTO, Robin 1/r, smooth_pred with
    percentile 5, γ = (1, 0.1, 1), initial_pred 1e4, max degree 7;
    Newton on the own-degree unknowns with dense Jacobian solves and the
    estimator with VOL_H_EQ_DIAM.  One dict per level: elements, true
    nodes, Ση², ‖F‖, Newton iterations, seconds."""
    from disco4est_tpu_torch.amr.amr import amr_step_hp
    from disco4est_tpu_torch.amr.smooth_pred import (
        SmoothPredParams,
        SmoothPredState,
        smooth_pred_mark,
        transfer_predictor,
    )
    from disco4est_tpu_torch.estimators.bi import estimate_bi
    from disco4est_tpu_torch.laplacian.hp import (
        adjoint_to_own,
        own_mask,
        restrict_to_own,
        to_max,
    )
    from disco4est_tpu_torch.problems import two_punctures as tp

    geom = CubedSphereGeometry("7tree", R0=10.0, R1=1000.0,
                               compactify_inner_shell=True)
    forest = Forest.uniform(geom.conn, 0)
    params = tp.TwoPuncturesParams()
    sp = SmoothPredParams(gamma_h=1.0, gamma_p=0.1, gamma_n=1.0,
                          percentile=5.0, max_degree=7, initial_pred=1e4)
    deg_e = np.full(7, 1, np.int32)
    storage, u_own, sp_state = 1, None, None
    rows = []
    for level in range(levels):
        t0 = time.perf_counter()
        mesh = build_mesh(geom, forest, deg=storage,
                          face_h_type="j_div_sj_min_lobatto",
                          penalty_prefactor=2.0,
                          penalty_fcn="maxp_sqr_over_minh", deg_e=deg_e,
                          device=device)
        rc = mesh.boundary_values_quad(params.robin_coeff)
        E = mesh.n_elements
        shape = (E,) + (storage + 1,) * 3
        idx = np.where(own_mask(mesh).reshape(-1).cpu().numpy() > 0.5)[0]

        def res_hp(uo, _m=mesh, _rc=rc):
            return adjoint_to_own(
                _m, tp.residual(_m, to_max(_m, uo), params, _rc))

        def jac_own(u0o, v, _m=mesh, _rc=rc):
            return adjoint_to_own(_m, tp.jacobian_apply(
                _m, to_max(_m, u0o), to_max(_m, v), params, _rc))

        if u_own is None:
            u_own = restrict_to_own(mesh, mesh.init_field(
                params.initial_guess))
        res = newton_solve(
            res_hp,
            lambda u0o, rhs, rtol, _a=jac_own, _i=idx, _s=shape:
                _dense_solve(_a, u0o, rhs, _i, _s),
            u_own, NewtonParams(atol=1e-13, max_iter=50, inner_rtol=1e-12))
        u_own = res.u
        F = to_max(mesh, res_hp(u_own))
        eta2 = estimate_bi(mesh, to_max(mesh, u_own), F, g=None,
                           penalty_prefactor=2.0,
                           vol_h="diam").cpu().numpy()
        _sync(device)
        rows.append(dict(n_elements=E, nodes=int(((deg_e + 1) ** 3).sum()),
                         eta2_sum=float(eta2.sum()),
                         residual_norm=res.residual_norm,
                         newton_iterations=res.iterations,
                         seconds=time.perf_counter() - t0))
        if level == levels - 1:
            break
        if sp_state is None or len(sp_state.predictor) != E:
            sp_state = SmoothPredState.fresh(E, sp)
        log, pred = smooth_pred_mark(eta2, deg_e, sp_state, sp, dim=3)
        forest2, deg_e2, fields, storage2 = amr_step_hp(
            forest, deg_e, log, {"u": u_own}, storage, 7)
        sp_state = SmoothPredState(
            transfer_predictor(forest, forest2, pred, deg_e, sp, log))
        forest, deg_e, storage = forest2, deg_e2, storage2
        u_own = fields["u"]
    return rows


def stamm_trajectory(device, rows: int = 6, on_row=None) -> list:
    """The Stamm hp-AMR trajectory (`tests/test_regression_digits.py:
    268-420`, the reference's `stamm_multigrid_pc.c` loop): per level the
    L2 of the interpolated |e| at the own degrees and √Ση² of the
    current solution, then the AMR step (uniform h at levels 0-1,
    smooth_pred with the mean marker and γ = (10, 0.1, 1) from level 2)
    and the f64 CG to atol 1e-15 on the new mesh (`apply_sipg_hp` where
    the degrees differ).  `rows` levels are recorded; each row's dict
    also carries the CG iterations and seconds of the solve that produced
    it (none for row 0, the initial 0.5).  `on_row(row)` runs as each row
    is ready."""
    from disco4est_tpu_torch.amr.amr import amr_step_hp
    from disco4est_tpu_torch.amr.smooth_pred import (
        SmoothPredParams,
        SmoothPredState,
        smooth_pred_mark,
        transfer_predictor,
    )
    from disco4est_tpu_torch.estimators.bi import estimate_bi
    from disco4est_tpu_torch.laplacian.hp import (
        adjoint_to_own,
        apply_mass_hp,
        apply_sipg_hp,
        init_field_own,
        norm_L2_interp_abs_own,
        to_max,
    )
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.problems.stamm import StammProblem

    prob = StammProblem(c=(0.5, 0.5, 0.5), dim=3)
    geom = BrickGeometry(dim=3)
    sp = SmoothPredParams(gamma_h=10.0, gamma_p=0.1, gamma_n=1.0,
                          marker="mean", sigma=0.25, max_degree=7,
                          initial_pred=0.0)
    kw = dict(penalty_prefactor=10.0, penalty_fcn="maxp_sqr_over_minh",
              face_h_type="tree_h", device=device)
    forest = Forest.uniform(geom.conn, 0)
    deg_e = np.full(1, 2, np.int32)
    storage, u, sp_state = 2, None, None
    solve = dict(cg_iterations=None, solve_seconds=None)
    mesh = build_mesh(geom, forest, deg=storage, deg_quad=storage,
                      deg_e=deg_e, **kw)
    out = []
    for level in range(rows):
        g = mesh.boundary_values(prob.boundary)
        if u is None:
            u = mesh.init_field(lambda x, y, z: 0.5 * torch.ones_like(x))
        # the reference's conventions on hp meshes: f at the own Lobatto
        # nodes, norms and the estimator's residual in the own basis
        rhs_own = apply_mass_hp(mesh, init_field_own(mesh, prob.rhs))
        l2 = float(norm_L2_interp_abs_own(mesh, u, prob.analytic))
        F = to_max(mesh, adjoint_to_own(mesh, apply_sipg(mesh, u))
                   - rhs_own)
        eta2 = estimate_bi(mesh, u, F, g=g,
                           penalty_prefactor=10.0).cpu().numpy()
        row = dict(level=level, n_elements=mesh.n_elements,
                   nodes=int(((deg_e + 1) ** 3).sum()), l2=l2,
                   estimator=float(np.sqrt(eta2.sum())),
                   max_degree=int(deg_e.max()), **solve)
        out.append(row)
        if on_row is not None:
            on_row(row)
        if level == rows - 1:
            break
        pred = None
        if level < 2:
            log = -deg_e.astype(np.int64)
        else:
            if sp_state is None:
                sp_state = SmoothPredState.fresh(mesh.n_elements, sp)
            log, pred = smooth_pred_mark(eta2, deg_e, sp_state, sp, dim=3)
            sp_state = SmoothPredState(pred)
        new_forest, new_deg_e, _, new_storage = amr_step_hp(
            forest, deg_e, log, {"u": u}, storage, 7)
        if pred is not None:
            sp_state = SmoothPredState(transfer_predictor(
                forest, new_forest, pred, deg_e, sp, log))
        forest, deg_e, storage = new_forest, new_deg_e, new_storage
        mesh = build_mesh(geom, forest, deg=storage, deg_quad=storage,
                          deg_e=deg_e, **kw)
        rhs = apply_mass_hp(mesh, init_field_own(mesh, prob.rhs))  # g = 0
        t0 = time.perf_counter()
        if (deg_e != storage).any():
            res = cg_solve(lambda v: apply_sipg_hp(mesh, v), rhs,
                           atol=1e-15, rtol=0.0, max_iter=200000)
            u = to_max(mesh, res.x)
        else:
            res = cg_solve(lambda v: apply_sipg(mesh, v), rhs, atol=1e-15,
                           rtol=0.0, max_iter=200000)
            u = res.x
        _sync(device)
        solve = dict(cg_iterations=res.iterations,
                     solve_seconds=time.perf_counter() - t0)
    return out
