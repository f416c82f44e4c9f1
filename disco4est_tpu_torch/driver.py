"""Driver: config → geometry → mesh → solve → norms → estimate → AMR.

Port of `disco4est_tpu/driver.py` (`geometry_from_options`,
`run_poisson`, and for the nonlinear problems `run_nonlinear` with
`CDSProblem`, `OkendonProblem` and `TwoPuncturesProblem`, below) for
every `pc_type` on bricks
and cubed spheres (7-tree and 13-tree, compactified shells included): the
AMR loop of the reference's problem drivers
(`Problems/Poisson/poisson_sinx_uniform.c:142`),

    for level in 0..num_of_amr_steps:
        mesh build → rhs → solve → norms → estimate → mark →
        refine + balance → transfer fields

with the schemes uniform_h, uniform_p and smooth_pred.  Each epoch's
solve takes one of these paths, as in the JAX driver:

- mixed degrees (`deg_e` differs from the storage degree, smooth_pred with
  p-refinement): plain f64 CG on the hp operator `apply_sipg_hp`
  (path `cg-hp`);
- mixed precision on (the default): f64 outer refinement whose inner f32
  CG runs, when `use_structured` is on, the structured apply
  (`laplacian/structured.py`, the CUDA kernel on a card) on a uniform
  brick (`mixed-structured`), the tree-structured curved apply
  (`laplacian/curved.py`) on a uniform multi-tree mesh of one degree
  (`mixed-curved`), and otherwise the generic f32 apply (`mixed`:
  hanging faces, curved adapted meshes);
- if that solve stagnates above the refinement floor, the plain f64
  solver (the "f64 fallback");
- mixed precision off: plain f64 CG or FCG (`ksp_type`);
- a preconditioner (`[d4est_solver_krylov_petsc] pc_type`, rebuilt each
  epoch; on mixed-degree epochs on the hp operator): f64 FCG with one
  multigrid V-cycle (`fcg-mg`, the `[multigrid]` smoother and bottom
  plugins) or one overlapping Schwarz apply (`fcg-schwarz`), or f64 CG
  with 8 Chebyshev steps (`cg-cheby`).

`use_structured = auto` means "on when the device is CUDA" (the JAX
driver: "on when the backend is a TPU").  Everything runs on the device
the caller names; a missing CUDA device raises, it never drops to the CPU.
Forests, marking and logs stay host numpy between epochs.  Options this
slice does not port raise `NotImplementedError` naming the ROADMAP item
that brings them.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from disco4est_tpu_torch.amr.amr import (
    amr_step_hp,
    p_balance_log,
    refine_and_balance,
    transfer_field,
)
from disco4est_tpu_torch.amr.smooth_pred import (
    SmoothPredParams,
    SmoothPredState,
    smooth_pred_mark,
    transfer_predictor,
)
from disco4est_tpu_torch.estimators.bi import estimate_bi
from disco4est_tpu_torch.geometry.brick import BrickGeometry
from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
from disco4est_tpu_torch.io.norms import NormLog, norm_L2, norm_Linfty
from disco4est_tpu_torch.laplacian import curved, structured
from disco4est_tpu_torch.laplacian.hp import (
    adjoint_to_own,
    apply_sipg_hp,
    to_max,
)
from disco4est_tpu_torch.laplacian.nonlinear import (
    apply_mass_coeff,
    assemble_fof_blocks,
    fof_lin_coeff,
)
from disco4est_tpu_torch.laplacian.sipg import (
    apply_sipg,
    build_rhs_with_strong_bc,
)
from disco4est_tpu_torch.mesh.builder import MeshData, build_mesh
from disco4est_tpu_torch.mesh.tree import Forest
from disco4est_tpu_torch.problems import (
    constant_density_star as cds,
    okendon,
    two_punctures,
)
from disco4est_tpu_torch.quadrature.quadrature import Quadrature
from disco4est_tpu_torch.solvers.cg import cg_solve
from disco4est_tpu_torch.solvers.cheby import cheby_smooth
from disco4est_tpu_torch.solvers.eigs import cg_eigs
from disco4est_tpu_torch.solvers.fcg import fcg_solve
from disco4est_tpu_torch.solvers.mixed import mixed_refine_solve
from disco4est_tpu_torch.solvers.multigrid import (
    BOTTOMS,
    SMOOTHERS,
    MGParams,
    build_hierarchy,
    mg_setup,
    set_matrix_operator,
    v_cycle,
)
from disco4est_tpu_torch.solvers.newton import NewtonParams, newton_solve
from disco4est_tpu_torch.solvers.schwarz_overlap import (
    build_overlapping_schwarz,
)
from disco4est_tpu_torch.util.config import Options

_ON = ("1", "true", "yes", "on")


def resolve_device(name) -> torch.device:
    """The device a run asks for; CUDA without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass --device=cpu to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def geometry_from_options(opts: Options):
    """[geometry] section → Geometry (reference `d4est_geometry_new`,
    `Geometry/d4est_geometry.c:127`): the brick and the cubed spheres."""
    name = opts.get("geometry", "name", required=True)
    g = lambda k, d: opts.get_float("geometry", k, d)
    if name == "brick":
        return BrickGeometry(
            x0=(g("x0", 0.0), g("y0", 0.0), g("z0", 0.0)),
            x1=(g("x1", 1.0), g("y1", 1.0), g("z1", 1.0)),
            dim=3,
        )
    if name in ("cubed_sphere", "cubed_sphere_7tree"):
        return CubedSphereGeometry(
            "13tree" if name == "cubed_sphere" else "7tree",
            R0=g("r0", 1.0), R1=g("r1", 2.0), R2=g("r2", 3.0),
            compactify_outer_shell=opts.get(
                "geometry", "compactify_outer_shell", False, cast=bool),
            compactify_inner_shell=opts.get(
                "geometry", "compactify_inner_shell", False, cast=bool),
        )
    if name in ("disk", "5treedisk", "trap", "trapezoid", "pizza_half",
                "hole_in_a_box"):
        raise NotImplementedError(
            f"geometry {name!r}: the disk and misc geometries are not "
            "ported yet (ROADMAP A11b)"
        )
    raise ValueError(f"unknown geometry {name}")


_FACE_H_MAP = {
    "FACE_H_EQ_TREE_H": "tree_h",
    "FACE_H_EQ_VOLUME_DIV_AREA": "volume_div_area",
    "FACE_H_EQ_J_DIV_SJ_QUAD": "j_div_sj_quad",
    "FACE_H_EQ_J_DIV_SJ_MIN_LOBATTO": "j_div_sj_min_lobatto",
}


def face_h_from_options(opts: Options) -> str:
    """[mesh_parameters] face_h_type with the reference's enum vocabulary
    (`Mesh/d4est_mesh.c:173-200`)."""
    name = opts.get(
        "mesh_parameters", "face_h_type", "FACE_H_EQ_VOLUME_DIV_AREA"
    )
    if name not in _FACE_H_MAP:
        raise ValueError(f"unknown face_h_type {name!r}")
    return _FACE_H_MAP[name]


def vol_h_from_options(opts: Options) -> str:
    """[mesh_parameters] volume_h_type (VOL_H_EQ_DIAM | VOL_H_EQ_CUBE_
    APPROX, `Mesh/d4est_mesh.h:31-49`) — the estimator volume-term h."""
    name = opts.get(
        "mesh_parameters", "volume_h_type", "VOL_H_EQ_CUBE_APPROX"
    )
    table = {
        "VOL_H_EQ_CUBE_APPROX": "cube_approx",
        "VOL_H_EQ_DIAM": "diam",
    }
    if name not in table:
        raise ValueError(f"unknown volume_h_type {name!r}")
    return table[name]


_SMOOTHER_MAP = {
    "mg_smoother_cheby": "cheby",
    "mg_smoother_schwarz": "schwarz_overlap",
    "mg_smoother_none": "none",
}
_BOTTOM_MAP = {
    "mg_bottom_solver_cg": "cg",
    "mg_bottom_solver_cheby": "cheby",
    "mg_bottom_solver_reuse_smoother": "reuse_smoother",
}


def mg_plugin_names(opts: Options):
    """[multigrid] smoother/bottom plugins, in the short names or the
    reference's `smoother_name = mg_smoother_*` vocabulary
    (`d4est_solver_multigrid.c` factories); an unknown name raises."""
    sm = opts.get("multigrid", "smoother_name",
                  opts.get("multigrid", "smoother", "cheby"))
    bt = opts.get("multigrid", "bottom_solver_name",
                  opts.get("multigrid", "bottom_solver", "cg"))
    sm = _SMOOTHER_MAP.get(sm, sm)
    bt = _BOTTOM_MAP.get(bt, bt)
    if sm not in SMOOTHERS:
        raise ValueError(f"unknown [multigrid] smoother {sm!r}")
    if bt not in BOTTOMS:
        raise ValueError(f"unknown [multigrid] bottom solver {bt!r}")
    return sm, bt


def mg_params_from_options(opts: Options) -> MGParams:
    """The `[mg_smoother_cheby]` bounds options and the plugins."""
    sm, bt = mg_plugin_names(opts)
    return MGParams(
        n_smooth=opts.get_int("mg_smoother_cheby", "cheby_imax", 8),
        eigs_cg_iters=opts.get_int("mg_smoother_cheby",
                                   "cheby_eigs_cg_imax", 10),
        lmax_lmin_ratio=opts.get_float(
            "mg_smoother_cheby", "cheby_eigs_lmax_lmin_ratio", 30.0),
        smoother=sm, bottom=bt,
    )


def _sin3_seed(mesh: MeshData):
    """The Lanczos start vector of the bounds estimates: Σ_d sin(3 x_d)."""
    return mesh.init_field(lambda *c: sum(torch.sin(3 * x) for x in c))


@dataclasses.dataclass
class SolveInfo:
    """What one level's linear solve did."""

    path: str  # "mixed-structured" | "mixed-curved" | "mixed" | "cg" |
    #            "fcg" | "cg-hp" | "fcg-mg" | "fcg-schwarz" | "cg-cheby"
    #            (preconditioned paths: "-hp" on mixed-degree epochs)
    outer_iterations: int  # refinement steps (0 for a plain Krylov solve)
    iterations: int  # inner f32 iterations, or the plain solve's
    residual_norm: float
    rhs_norm: float  # ‖b‖, the scale of the fallback test 1e-10·(1 + ‖b‖)
    fallback: bool  # True when the f64 fallback solve ran
    seconds: float  # the solve, preconditioner set-up excluded
    setup: dict = dataclasses.field(default_factory=dict)
    #              preconditioner set-up seconds by step (hierarchy,
    #              mg_setup, schwarz, eigs); empty without one

    def line(self, level: int) -> str:
        out = (
            f"solve level {level}: path={self.path} "
            f"outer={self.outer_iterations} iterations={self.iterations} "
            f"residual={self.residual_norm:.3e} "
            f"rhs_norm={self.rhs_norm:.3e} "
            f"fallback={'yes' if self.fallback else 'no'} "
            f"seconds={self.seconds:.3f}"
        )
        if self.setup:
            out += " setup=" + ",".join(f"{k}:{v:.3f}"
                                        for k, v in self.setup.items())
        return out


@dataclasses.dataclass
class DriverResult:
    mesh: MeshData  # the last epoch's mesh
    u: torch.Tensor  # the last epoch's solution (padded own degrees)
    norms: NormLog
    solves: list  # [SolveInfo] per level
    eta2_history: list = dataclasses.field(default_factory=list)
    #                    [np.ndarray η² per element] per smooth_pred marking
    precond: object = None  # the last epoch's preconditioner state
    #     (`MGHierarchy`, `OverlappingSchwarz` or the Chebyshev bounds)


def _refuse_unported(opts: Options):
    """Options of the JAX driver that this slice does not port."""
    pc_type = opts.get("d4est_solver_krylov_petsc", "pc_type", "none")
    if pc_type not in ("none", "schwarz", "multigrid", "cheby"):
        raise ValueError(f"unknown pc_type: {pc_type!r}")
    if (pc_type == "schwarz"
            and opts.get_int("d4est_solver_schwarz", "subdomain_chunk", 0) > 0):
        raise NotImplementedError(
            "[d4est_solver_schwarz] subdomain_chunk > 0: the K-slot "
            "Schwarz variant is not ported yet (ROADMAP A13b)"
        )
    # with any pc_type: the JAX driver drops to one device where it cannot
    # distribute (ROADMAP C6); the port refuses instead
    enable = str(opts.get("parallelism", "enable", "auto")).lower()
    if enable in _ON or opts.get_int("parallelism", "n_devices", 1) > 1:
        raise NotImplementedError(
            "[parallelism]: the distributed driver is not ported yet "
            "(ROADMAP A15)"
        )
    for section, key, what in (
        ("checkpoint", "prefix", "checkpoints"),
        ("initial_mesh", "load_from_checkpoint", "checkpoint restart"),
        ("d4est_vtk", "filename", "VTK output"),
        ("driver", "print_timings", "per-phase timings"),
    ):
        value = str(opts.get(section, key, "")).lower()
        if value not in ("", "0", "false", "no", "off"):
            raise NotImplementedError(
                f"[{section}] {key}: {what} are not ported yet "
                "(ROADMAP A14)"
            )


def run_poisson(opts: Options, problem, *, device) -> DriverResult:
    """Linear Poisson AMR-solve loop on the configured geometry, on
    `device`."""
    device = resolve_device(device)
    # IEEE f32 products everywhere: reduced-precision (TF32) products make
    # the inner f32 CG diverge, as the JAX package found on the TPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _refuse_unported(opts)

    geom = geometry_from_options(opts)
    level = opts.get_int("initial_mesh", "min_level", required=True)
    deg = opts.get_int("initial_mesh", "region0_deg", 1)
    dq_inc = opts.get_int("initial_mesh", "region0_deg_quad_inc", 0)
    quad_name = opts.get("quadrature", "name", "legendre")
    quad = Quadrature("legendre" if quad_name == "legendre" else "lobatto")
    penalty_fcn = opts.get("flux", "sipg_penalty_fcn", "maxp_sqr_over_minh")
    prefactor = opts.get_float("flux", "sipg_penalty_prefactor", 2.0)
    scheme = opts.get("amr", "scheme", "uniform_p")
    if scheme not in ("uniform_h", "uniform_p", "smooth_pred"):
        raise ValueError(f"unknown [amr] scheme: {scheme!r}")
    n_amr = opts.get_int("amr", "num_of_amr_steps", 0)
    p_bal = opts.get_int("amr", "p_balance_if_diff", -1)
    # max_degree defaults to the initial degree, so uniform_p changes
    # nothing unless [mesh_parameters] max_degree is set (JAX parity)
    max_degree = opts.get_int("mesh_parameters", "max_degree", deg)
    sp_params = SmoothPredParams(
        gamma_h=opts.get_float("amr", "gamma_h", 10.0),
        gamma_p=opts.get_float("amr", "gamma_p", 0.1),
        gamma_n=opts.get_float("amr", "gamma_n", 1.0),
        percentile=opts.get_float("amr", "percentile", 25.0),
        max_degree=max_degree,
        initial_pred=opts.get_float("amr", "initial_pred", 0.0),
    )
    ksp = opts.get("d4est_solver_krylov_petsc", "ksp_type", "cg")
    use_mixed = opts.get(
        "d4est_solver_krylov_petsc", "use_mixed_precision", True, cast=bool
    )
    mixed_opts = dict(
        inner_rtol=opts.get_float(
            "d4est_solver_krylov_petsc", "mixed_inner_rtol", 1e-6
        ),
        inner_max_iter=opts.get_int(
            "d4est_solver_krylov_petsc", "mixed_inner_max_iter", 20000
        ),
        max_outer=opts.get_int(
            "d4est_solver_krylov_petsc", "mixed_max_outer", 60
        ),
    )
    use_structured = str(
        opts.get("d4est_solver_krylov_petsc", "use_structured", "auto")
    ).lower()
    structured_on = use_structured in _ON or (
        use_structured == "auto" and device.type == "cuda"
    )
    face_h_type = face_h_from_options(opts)
    pc_type = opts.get("d4est_solver_krylov_petsc", "pc_type", "none")
    pc_opts = dict(
        pc_type=pc_type,
        mg_params=(mg_params_from_options(opts) if pc_type == "multigrid"
                   else None),
        # the coarse levels take the fine mesh's penalty options (C12)
        mesh_kwargs=dict(penalty_prefactor=prefactor,
                         penalty_fcn=penalty_fcn, face_h_type=face_h_type),
        overlap=opts.get_int("d4est_solver_schwarz", "num_nodes_overlap", 1),
        subdomain_iter=opts.get_int("d4est_solver_schwarz", "subdomain_iter",
                                    15),
        eigs_iters=opts.get_int("mg_smoother_cheby", "cheby_eigs_cg_imax",
                                10),
        ratio=opts.get_float("mg_smoother_cheby",
                             "cheby_eigs_lmax_lmin_ratio", 30.0),
    )
    precond = None

    forest = Forest.uniform(geom.conn, level)
    # hp state: per-element degrees and the storage degree (grows as
    # uniform_p or smooth_pred p-refines)
    deg_e = np.full(forest.n_elements, deg, np.int32)
    storage = deg
    norms = NormLog()
    solves, eta2_hist = [], []
    u = None
    sp_state = None
    for it in range(n_amr + 1):
        mixed = bool((deg_e != storage).any())
        mesh = build_mesh(
            geom, forest, deg=storage, quad=quad, deg_quad=storage + dq_inc,
            penalty_prefactor=prefactor, penalty_fcn=penalty_fcn,
            deg_e=deg_e, face_h_type=face_h_type, device=device,
        )
        g = mesh.boundary_values(problem.boundary)
        f = mesh.init_field(problem.rhs)
        rhs_max = build_rhs_with_strong_bc(mesh, f, g)
        rhs = adjoint_to_own(mesh, rhs_max) if mixed else rhs_max
        # the transferred field starts the solve when the shapes match
        x0 = torch.zeros_like(f) if u is None or u.shape != f.shape else u
        if pc_type != "none":
            info, u, precond = _solve_pc(mesh, rhs, x0, hp=mixed, **pc_opts)
        elif mixed:
            info, u = _solve_hp(mesh, rhs, x0)
        else:
            info, u = _solve(mesh, rhs, x0, use_mixed=use_mixed,
                             structured_on=structured_on, ksp=ksp,
                             mixed_opts=mixed_opts)
        solves.append(info)
        u_max = to_max(mesh, u) if mixed else u

        u_a = mesh.init_field(problem.analytic)
        norms.add(mesh, L_2=norm_L2(mesh, u_max - u_a),
                  L_infty=norm_Linfty(u_max - u_a))
        if it == n_amr:
            break

        pred = None
        if scheme == "uniform_h":
            log = -deg_e.astype(np.int64)
        elif scheme == "uniform_p":
            # raise every element's degree by one per step
            log = np.minimum(deg_e + 1, max_degree).astype(np.int64)
        else:
            F = apply_sipg(mesh, u_max) - rhs_max
            eta2 = estimate_bi(
                mesh, u_max, F, g=g, penalty_prefactor=prefactor,
                vol_h=vol_h_from_options(opts),
            ).cpu().numpy()
            eta2_hist.append(eta2)
            if sp_state is None or len(sp_state.predictor) != mesh.n_elements:
                sp_state = SmoothPredState.fresh(mesh.n_elements, sp_params)
            log, pred = smooth_pred_mark(eta2, deg_e, sp_state, sp_params,
                                         dim=mesh.dim)
            sp_state = SmoothPredState(pred)
        # optional degree-jump limiting ([amr] p_balance_if_diff,
        # `hpAMR/d4est_amr.c:917-991` + the smooth_pred post-p-balance
        # predictor update)
        if p_bal > 0:
            log, pred = p_balance_log(
                mesh, deg_e, log, p_bal, max_degree,
                predictor=pred, gamma_p=sp_params.gamma_p,
            )
            if pred is not None:
                sp_state = SmoothPredState(pred)
        new_forest, new_deg_e, fields, new_storage = amr_step_hp(
            forest, deg_e, log, {"u": u}, storage, max_degree
        )
        u = fields["u"]
        if sp_state is not None and pred is not None:
            sp_state = SmoothPredState(
                transfer_predictor(forest, new_forest, pred, deg_e,
                                   sp_params, log)
            )
        forest, deg_e, storage = new_forest, new_deg_e, new_storage

    return DriverResult(mesh=mesh, u=u, norms=norms, solves=solves,
                        eta2_history=eta2_hist, precond=precond)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _solve_hp(mesh: MeshData, rhs, x0):
    """A mixed-degree epoch: plain f64 CG on the hp operator (JAX
    `_linear_solve_cg_hp`)."""
    _sync(mesh.device)
    t0 = time.perf_counter()
    res = cg_solve(lambda v: apply_sipg_hp(mesh, v), rhs, x0=x0,
                   atol=5e-15, rtol=1e-20, max_iter=100000)
    _sync(mesh.device)
    info = SolveInfo(
        path="cg-hp", outer_iterations=0, iterations=res.iterations,
        residual_norm=float(res.residual_norm),
        rhs_norm=float(torch.linalg.norm(rhs.reshape(-1))), fallback=False,
        seconds=time.perf_counter() - t0,
    )
    return info, res.x


def _solve_pc(mesh: MeshData, rhs, x0, *, hp, pc_type, mg_params,
              mesh_kwargs, overlap, subdomain_iter, eigs_iters, ratio):
    """A preconditioned epoch (JAX `_linear_solve_fcg_mg(_hp)`,
    `_linear_solve_fcg_schwarz(_hp)`, `_linear_solve_cg_cheby(_hp)`): the
    preconditioner is set up on this epoch's mesh, then f64 FCG (multigrid,
    Schwarz) or CG (Chebyshev) runs on the operator, the hp one on
    mixed-degree epochs.  Returns (info, x, preconditioner state)."""
    op = apply_sipg_hp if hp else apply_sipg
    A = lambda v: op(mesh, v)
    setup = {}

    def step(name, fn):
        _sync(mesh.device)
        t = time.perf_counter()
        out = fn()
        _sync(mesh.device)
        setup[name] = time.perf_counter() - t
        return out

    if pc_type == "multigrid":
        state = step("hierarchy", lambda: build_hierarchy(
            mesh, mg_params, mesh_kwargs=mesh_kwargs))
        step("mg_setup", lambda: mg_setup(state, op, _sin3_seed))
        M = lambda r: v_cycle(state, op, r, torch.zeros_like(r))
        solver, path = fcg_solve, "fcg-mg"
    elif pc_type == "schwarz":
        state = M = step("schwarz", lambda: build_overlapping_schwarz(
            mesh, num_nodes_overlap=overlap, iterations=subdomain_iter,
            hp=hp))
        solver, path = fcg_solve, "fcg-schwarz"
    else:  # cheby: bounds from CG-Lanczos on the rhs, 8 steps per apply
        lmax = step("eigs", lambda: cg_eigs(A, rhs, eigs_iters))[1]
        state = (lmax / ratio, lmax)
        M = lambda r: cheby_smooth(A, r, torch.zeros_like(r), state[0],
                                   state[1], 8)
        solver, path = cg_solve, "cg-cheby"
    _sync(mesh.device)
    t0 = time.perf_counter()
    res = solver(A, rhs, x0=x0, M=M, atol=5e-15, rtol=1e-20,
                 max_iter=10000)
    _sync(mesh.device)
    info = SolveInfo(
        path=path + ("-hp" if hp else ""), outer_iterations=0,
        iterations=res.iterations, residual_norm=res.residual_norm,
        rhs_norm=float(torch.linalg.norm(rhs.reshape(-1))), fallback=False,
        seconds=time.perf_counter() - t0, setup=setup,
    )
    return info, res.x, state


def _solve(mesh: MeshData, rhs, x0, *, use_mixed, structured_on, ksp,
           mixed_opts):
    """A uniform-degree epoch: the mixed-structured, mixed-curved, generic
    mixed, f64 fallback or plain CG/FCG solve."""

    def plain_solve():
        solver, cap = (fcg_solve, 10000) if ksp == "fcg" else (
            cg_solve, 100000
        )
        return solver(lambda v: apply_sipg(mesh, v), rhs, x0=x0,
                      atol=5e-15, rtol=1e-20, max_iter=cap)

    _sync(mesh.device)
    t0 = time.perf_counter()
    fallback = False
    bnorm = float(torch.linalg.norm(rhs.reshape(-1)))
    if use_mixed:
        sb = structured.build_structured(mesh) if structured_on else None
        ts = (curved.build_tree_structured(mesh)
              if structured_on and sb is None else None)
        if sb is not None:
            # inner settings as the JAX driver has them on this path
            # (`driver.py:330-331`): the mixed_inner_* options are not
            # passed (ROADMAP C3)
            path = "mixed-structured"
            res = mixed_refine_solve(
                lambda v: apply_sipg(mesh, v), rhs, x0=x0,
                inner_solve=structured.make_inner_solve(
                    sb, rtol=1e-3, max_iter=400
                ),
                atol=5e-15, rtol=1e-20, max_outer=mixed_opts["max_outer"],
            )
        elif ts is not None:
            # inner settings of the JAX driver's curved solve
            # (`driver.py:347-349`; its call at `:963` passes none of the
            # mixed_* options, ROADMAP C3).  Its host-stepped outer loop
            # (`:370-390`) exists for a TPU stall and stops after 3 outer
            # steps (ROADMAP C1): the port runs `mixed_refine_solve`,
            # whose stall test compares with the previous residual.
            path = "mixed-curved"
            res = mixed_refine_solve(
                lambda v: apply_sipg(mesh, v), rhs, x0=x0,
                inner_solve=curved.make_inner_solve(
                    ts.astype(torch.float32),
                    curved.permute_mesh_lex(ts, mesh).astype(torch.float32),
                    rtol=1e-4, max_iter=400,
                ),
                atol=5e-15, rtol=1e-20, max_outer=30,
            )
        else:
            path = "mixed"
            mesh32 = mesh.astype(torch.float32)
            res = mixed_refine_solve(
                lambda v: apply_sipg(mesh, v), rhs, x0=x0,
                A32=lambda v: apply_sipg(mesh32, v), atol=5e-15, rtol=1e-20,
                **mixed_opts,
            )
        outer, iters = res.outer_iterations, res.inner_iterations
        if res.residual_norm > 1e-10 * (1.0 + bnorm):
            # the f32 inner solve stagnated/diverged well above the
            # refinement floor — fall back to the plain f64 solver
            fallback = True
            res = plain_solve()
            iters = res.iterations
    else:
        path = ksp if ksp == "fcg" else "cg"
        res = plain_solve()
        outer, iters = 0, res.iterations
    _sync(mesh.device)
    info = SolveInfo(
        path=path, outer_iterations=outer, iterations=iters,
        residual_norm=float(res.residual_norm), rhs_norm=bnorm,
        fallback=fallback, seconds=time.perf_counter() - t0,
    )
    return info, res.x


# ---------------------------------------------------------------------------
# Nonlinear problems (Newton–Krylov outer loop)
# ---------------------------------------------------------------------------
#
# Port of the JAX driver's nonlinear section (`driver.py:1071-1643`; role
# of the reference's nonlinear problem drivers,
# `Problems/TwoPunctures/two_punctures_cactus.c:280-660`,
# `ConstantDensityStar/constant_density_star.c`): per AMR level, build the
# mesh, solve with Newton (f64 Krylov on the frozen-u0 Jacobian), estimate
# with the bi estimator on the residual, mark, refine and transfer.


class CDSProblem:
    """ConstantDensityStar adapter (`Problems/ConstantDensityStar/`).

    Its Dirichlet data are ψ_analytic, as the problem states
    (`problems/constant_density_star.py`) and the reference's digits
    need: the JAX driver's `CDSProblem.boundary` returns 1 (ROADMAP C11),
    which moves the level-2 L2 from 9.6079e-6 to 8.4215e-6."""

    bc_type = "dirichlet"

    def __init__(self, opts: Options | None = None):
        o = opts or Options.load("[problem]\n")
        self.mod = cds
        self.params = cds.CDSParams.create(
            R=o.get_float("problem", "R", 0.0625),
            cx=o.get_float("problem", "cx", 0.5),
            cy=o.get_float("problem", "cy", 0.5),
            cz=o.get_float("problem", "cz", 0.5),
            rho0_div_rhoc=o.get_float("problem", "rho0_div_rhoc", 0.001),
        )

    def boundary(self, *c):
        return self.params.psi(*c)

    def initial_guess(self, *c):
        return self.params.initial_guess(*c)

    def analytic(self, *c):
        return self.params.psi(*c)

    def residual(self, mesh, u, bc):
        return self.mod.residual(mesh, u, bc, self.params)

    def dfof(self):
        return self.mod.dfof(self.params)

    def linear_apply(self, mesh, v, bc):
        """The Jacobian's linear part: A v with homogeneous data."""
        return apply_sipg(mesh, v)


class OkendonProblem:
    """Okendon power-law adapter (`Problems/Okendon/`)."""

    bc_type = "dirichlet"

    def __init__(self, opts: Options | None = None):
        o = opts or Options.load("[problem]\n")
        self.mod = okendon
        self.params = okendon.OkendonParams(p=o.get_float("problem", "p",
                                                          0.5))

    def boundary(self, *c):
        return self.params.boundary(*c)

    def initial_guess(self, *c):
        return self.params.initial_guess(*c)

    def analytic(self, *c):
        return self.params.analytic(*c)

    def residual(self, mesh, u, bc):
        return self.mod.residual(mesh, u, bc, self.params)

    def dfof(self):
        return self.mod.dfof(self.params)

    def linear_apply(self, mesh, v, bc):
        return apply_sipg(mesh, v)


class TwoPuncturesProblem:
    """TwoPunctures adapter (`Problems/TwoPunctures/two_punctures_cactus.c`),
    Robin BC u/r + du/dn = 0 at the outer sphere."""

    bc_type = "robin"
    analytic = None

    def __init__(self, opts: Options | None = None):
        o = opts or Options.load("[problem]\n")
        self.mod = two_punctures
        self.params = two_punctures.TwoPuncturesParams(
            par_b=o.get_float("problem", "par_b", 3.0),
            m_plus=o.get_float("problem", "M_plus", 0.5),
            m_minus=o.get_float("problem", "M_minus", 0.5),
            P_plus=(0.0, o.get_float("problem", "Py_plus", 0.2), 0.0),
            P_minus=(0.0, o.get_float("problem", "Py_minus", -0.2), 0.0),
        )

    def robin_coeff_values(self, mesh):
        return mesh.boundary_values_quad(self.params.robin_coeff)

    def initial_guess(self, *c):
        return self.params.initial_guess(*c)

    def residual(self, mesh, u, bc):
        return self.mod.residual(mesh, u, self.params, bc)

    def dfof(self):
        return self.mod.dfof(self.params)

    def linear_apply(self, mesh, v, bc):
        """A v with the Robin coefficient `bc` (the general apply)."""
        return apply_sipg(mesh, v, robin_coeff=bc)


def _level_operators(problem, hier, bc):
    """`A(mesh, v)` for every level of `hier`: the problem's linear part
    with its boundary data evaluated on that level's mesh (Robin
    coefficients; the Dirichlet problems' operator takes none)."""
    if problem.bc_type != "robin":
        return lambda m, v: problem.linear_apply(m, v, bc)
    coeff = {id(m): problem.robin_coeff_values(m) for m in hier.meshes}
    coeff[id(hier.meshes[0])] = bc
    return lambda m, v: problem.linear_apply(m, v, coeff[id(m)])


@dataclasses.dataclass
class NewtonInfo:
    """What one level's Newton solve did."""

    iterations: int
    residual_norm: float  # ‖F‖ at the last iterate
    history: list  # ‖F‖ of every iterate, the start included
    krylov: list  # Krylov iterations of each Newton step's Jacobian solve
    seconds: float

    def line(self, level: int) -> str:
        return (
            f"newton level {level}: iterations={self.iterations} "
            f"F_norm={self.residual_norm:.6e} krylov={sum(self.krylov)} "
            f"krylov_steps={','.join(map(str, self.krylov)) or '-'} "
            f"seconds={self.seconds:.3f} "
            f"history={','.join(f'{f:.6e}' for f in self.history)}"
        )


def run_nonlinear(opts: Options, problem, *, device) -> DriverResult:
    """Nonlinear AMR loop on `device`: Newton–Krylov per level, the bi
    estimator on the residual, then uniform_h or h-only smooth_pred
    refinement.  `DriverResult.solves` holds one `NewtonInfo` a level."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _refuse_unported(opts)
    if opts.get_int("checkpoint", "checkpoint_every_n_krylov_its", 0) > 0:
        raise NotImplementedError(
            "[checkpoint] checkpoint_every_n_krylov_its: mid-solve "
            "checkpoints are not ported yet (ROADMAP A14)"
        )

    geom = geometry_from_options(opts)
    level = opts.get_int("initial_mesh", "min_level", required=True)
    deg = opts.get_int("initial_mesh", "region0_deg", 1)
    dq_inc = opts.get_int("initial_mesh", "region0_deg_quad_inc", 0)
    quad_name = opts.get("quadrature", "name", "legendre")
    quad = Quadrature("legendre" if quad_name == "legendre" else "lobatto")
    penalty_fcn = opts.get("flux", "sipg_penalty_fcn", "maxp_sqr_over_minh")
    prefactor = opts.get_float("flux", "sipg_penalty_prefactor", 2.0)
    scheme = opts.get("amr", "scheme", "uniform_h")
    n_amr = opts.get_int("amr", "num_of_amr_steps", 0)
    ksp = opts.get("d4est_solver_krylov_petsc", "ksp_type", "fcg")
    ksp_iters = opts.get_int("d4est_solver_krylov_petsc", "ksp_max_it", 10000)
    if scheme not in ("uniform_h", "smooth_pred", "none"):
        raise ValueError(f"unknown nonlinear [amr] scheme: {scheme!r}")
    newton_params = NewtonParams(
        atol=opts.get_float("d4est_solver_newton", "snes_atol", 1e-11),
        rtol=opts.get_float("d4est_solver_newton", "snes_rtol", 1e-50),
        max_iter=opts.get_int("d4est_solver_newton", "snes_max_it", 30),
        monitor=opts.get("d4est_solver_newton", "snes_monitor", False,
                         cast=bool),
    )
    sp_params = SmoothPredParams(
        gamma_h=opts.get_float("amr", "gamma_h", 10.0),
        gamma_p=opts.get_float("amr", "gamma_p", 0.1),
        gamma_n=opts.get_float("amr", "gamma_n", 1.0),
        percentile=opts.get_float("amr", "percentile", 25.0),
        max_degree=deg,  # h-only marking in the nonlinear driver
        initial_pred=opts.get_float("amr", "initial_pred", 0.0),
    )
    pc_type = opts.get("d4est_solver_krylov_petsc", "pc_type", "none")
    mg_params = mg_params_from_options(opts)
    face_h_type = face_h_from_options(opts)
    robin = problem.bc_type == "robin"
    precond = None

    forest = Forest.uniform(geom.conn, level)
    norms = NormLog()
    solves, eta2_hist = [], []
    u = None
    sp_state = None
    for it in range(n_amr + 1):
        deg_e = np.full(forest.n_elements, deg, np.int32)
        mesh = build_mesh(
            geom, forest, deg=deg, quad=quad, deg_quad=deg + dq_inc,
            penalty_prefactor=prefactor, penalty_fcn=penalty_fcn,
            deg_e=deg_e, face_h_type=face_h_type, device=device,
        )
        if robin:
            bc = problem.robin_coeff_values(mesh)
            g_est = None
        else:
            bc = mesh.boundary_values(problem.boundary)
            g_est = bc
        if u is None or u.shape[0] != mesh.n_elements:
            u = mesh.init_field(problem.initial_guess)

        krylov_its = []
        # the preconditioner of this level (JAX `driver.py:1399-1439`):
        # multigrid takes its frozen-u0 blocks, bounds and smoother state
        # in each Jacobian solve; Schwarz and Chebyshev act on the linear
        # part alone.  The multigrid levels and the Chebyshev bounds take
        # the problem's own linear operator, Robin data included; the JAX
        # driver uses the Dirichlet `apply_sipg` there, and its Newton-MG
        # FCG diverges on TwoPunctures (ROADMAP C13)
        hier = schwarz_M = cheby_bounds = None
        linear = lambda m, v: problem.linear_apply(m, v, bc)
        if pc_type == "multigrid":
            hier = build_hierarchy(mesh, mg_params, mesh_kwargs=dict(
                penalty_prefactor=prefactor, penalty_fcn=penalty_fcn,
                face_h_type=face_h_type))
            linear = _level_operators(problem, hier, bc)
            precond = hier
        elif pc_type == "schwarz":
            precond = schwarz_M = build_overlapping_schwarz(
                mesh,
                num_nodes_overlap=opts.get_int("d4est_solver_schwarz",
                                               "num_nodes_overlap", 1),
                iterations=opts.get_int("d4est_solver_schwarz",
                                        "subdomain_iter", 15))
        elif pc_type == "cheby":
            _, lmax = cg_eigs(lambda w: linear(mesh, w), _sin3_seed(mesh),
                              10)
            precond = cheby_bounds = (lmax / 30.0, lmax)

        def jac_solve(u0, rhs, rtol):
            # J(u0) v = A v + M[f'(u0) ⊙ v], the frozen coefficient
            # evaluated once per Newton step: the same products as the
            # problem module's `jacobian_apply`
            coeff = fof_lin_coeff(mesh, u0, problem.dfof())

            def J(v):
                return (problem.linear_apply(mesh, v, bc)
                        + apply_mass_coeff(mesh, coeff, v))

            M, krylov = None, fcg_solve if ksp == "fcg" else cg_solve
            if pc_type == "multigrid":
                # Newton-MG: the frozen-u0 blocks Galerkin-restricted
                # through the hierarchy, then the bounds re-estimated with
                # them in the level operators
                set_matrix_operator(
                    hier, assemble_fof_blocks(mesh, u0, problem.dfof()))
                mg_setup(hier, linear, _sin3_seed)
                M = lambda r: v_cycle(hier, linear, r, torch.zeros_like(r))
                krylov = fcg_solve
            elif pc_type == "schwarz":
                M, krylov = schwarz_M, fcg_solve
            elif pc_type == "cheby":
                M = lambda r: cheby_smooth(
                    lambda v: linear(mesh, v), r, torch.zeros_like(r),
                    cheby_bounds[0], cheby_bounds[1], 8)
            res = krylov(J, rhs, M=M, atol=0.0, rtol=rtol,
                         max_iter=ksp_iters)
            krylov_its.append(res.iterations)
            return res.x

        _sync(device)
        t0 = time.perf_counter()
        res = newton_solve(lambda v: problem.residual(mesh, v, bc),
                           jac_solve, u, newton_params)
        _sync(device)
        u = res.u
        solves.append(NewtonInfo(
            iterations=res.iterations, residual_norm=res.residual_norm,
            history=list(res.history), krylov=krylov_its,
            seconds=time.perf_counter() - t0,
        ))

        row = {"newton_its": res.iterations, "F_norm": res.residual_norm}
        if problem.analytic is not None:
            u_a = mesh.init_field(problem.analytic)
            row["L_2"] = norm_L2(mesh, u - u_a)
            row["L_infty"] = norm_Linfty(u - u_a)
        norms.add(mesh, **row)

        F = problem.residual(mesh, u, bc)
        eta2 = estimate_bi(
            mesh, u, F, g=g_est, penalty_prefactor=prefactor,
            vol_h=vol_h_from_options(opts),
        ).cpu().numpy()
        eta2_hist.append(eta2)
        norms.rows[-1]["eta2_sum"] = float(eta2.sum())

        if it == n_amr or scheme == "none":
            break
        if scheme == "uniform_h":
            log = -deg_e.astype(np.int64)
        else:
            if sp_state is None or len(sp_state.predictor) != mesh.n_elements:
                sp_state = SmoothPredState.fresh(mesh.n_elements, sp_params)
            log, pred = smooth_pred_mark(eta2, deg_e, sp_state, sp_params,
                                         dim=mesh.dim)
        new_forest = refine_and_balance(forest, np.asarray(log) < 0)
        u = transfer_field(forest, new_forest, u, deg)
        if scheme == "smooth_pred":
            sp_state = SmoothPredState(transfer_predictor(
                forest, new_forest, pred, deg_e, sp_params, log))
        forest = new_forest

    return DriverResult(mesh=mesh, u=u, norms=norms, solves=solves,
                        eta2_history=eta2_hist, precond=precond)
