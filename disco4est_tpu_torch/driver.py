"""Driver: config → geometry → mesh → solve → norms → estimate → AMR.

Port of the linear Poisson path of `disco4est_tpu/driver.py`
(`geometry_from_options`, `run_poisson`) for `pc_type = none` on bricks
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
- mixed precision off: plain f64 CG or FCG (`ksp_type`).

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

from disco4est_tpu_torch.amr.amr import amr_step_hp, p_balance_log
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
from disco4est_tpu_torch.laplacian.sipg import (
    apply_sipg,
    build_rhs_with_strong_bc,
)
from disco4est_tpu_torch.mesh.builder import MeshData, build_mesh
from disco4est_tpu_torch.mesh.tree import Forest
from disco4est_tpu_torch.quadrature.quadrature import Quadrature
from disco4est_tpu_torch.solvers.cg import cg_solve
from disco4est_tpu_torch.solvers.fcg import fcg_solve
from disco4est_tpu_torch.solvers.mixed import mixed_refine_solve
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


@dataclasses.dataclass
class SolveInfo:
    """What one level's linear solve did."""

    path: str  # "mixed-structured" | "mixed-curved" | "mixed" | "cg" |
    #            "fcg" | "cg-hp"
    outer_iterations: int  # refinement steps (0 for a plain Krylov solve)
    iterations: int  # inner f32 iterations, or the plain solve's
    residual_norm: float
    rhs_norm: float  # ‖b‖, the scale of the fallback test 1e-10·(1 + ‖b‖)
    fallback: bool  # True when the f64 fallback solve ran
    seconds: float

    def line(self, level: int) -> str:
        return (
            f"solve level {level}: path={self.path} "
            f"outer={self.outer_iterations} iterations={self.iterations} "
            f"residual={self.residual_norm:.3e} "
            f"rhs_norm={self.rhs_norm:.3e} "
            f"fallback={'yes' if self.fallback else 'no'} "
            f"seconds={self.seconds:.3f}"
        )


@dataclasses.dataclass
class DriverResult:
    mesh: MeshData  # the last epoch's mesh
    u: torch.Tensor  # the last epoch's solution (padded own degrees)
    norms: NormLog
    solves: list  # [SolveInfo] per level
    eta2_history: list = dataclasses.field(default_factory=list)
    #                    [np.ndarray η² per element] per smooth_pred marking


def _refuse_unported(opts: Options):
    """Options of the JAX driver that this slice does not port."""
    pc_type = opts.get("d4est_solver_krylov_petsc", "pc_type", "none")
    if pc_type not in ("none", "schwarz", "multigrid", "cheby"):
        raise ValueError(f"unknown pc_type: {pc_type!r}")
    if pc_type != "none":
        raise NotImplementedError(
            f"pc_type = {pc_type}: preconditioners are not ported yet "
            "(ROADMAP A13)"
        )
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
        if mixed:
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
                        eta2_history=eta2_hist)


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
