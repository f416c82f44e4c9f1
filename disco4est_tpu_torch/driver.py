"""Driver: config → geometry → mesh → solve → norms → estimate → AMR.

Port of `disco4est_tpu/driver.py` (`geometry_from_options`,
`run_poisson`, and for the nonlinear problems `run_nonlinear` with
`CDSProblem`, `OkendonProblem` and `TwoPuncturesProblem`, below) for
every `pc_type` on bricks,
cubed spheres (7-tree and 13-tree, compactified shells included), the 2D
disk, trapezoid and pizza-half and the hole-in-a-box: the
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
  plugins) or one overlapping Schwarz apply (`fcg-schwarz`; the K-slot
  variant when `[d4est_solver_schwarz] subdomain_chunk` > 0), or f64 CG
  with 8 Chebyshev steps (`cg-cheby`).

`use_structured = auto` means "on when the device is CUDA" (the JAX
driver: "on when the backend is a TPU").  Everything runs on the device
the caller names; a missing CUDA device raises, it never drops to the CPU.
Forests, marking and logs stay host numpy between epochs.

IO and restart (JAX `driver.py:1225-1300`): `[checkpoint] prefix` writes
`<prefix>_level<k>.npz` after every level (`io/checkpoint.py`), and with
`checkpoint_every_n_krylov_its = n` also `<prefix>_level<k>_it<j>.npz`
every n Krylov iterations (the linear solve then runs in exactly resumed
chunks) or Newton iterates; `[initial_mesh] load_from_checkpoint = 1`
restarts from `checkpoint_prefix` by `checkpoint_type = structure` or
`history`; `[d4est_vtk] filename` writes `<filename>_<k>.vtu` per level;
`[driver] print_timings = 1` prints one `TIMINGS level k:` line per level
of `run_poisson`.

Tracing (`util/trace.py`): each call of `run_poisson` or `run_nonlinear`
keeps one record of its spans and counters, returned as
`DriverResult.trace`: the phases of `run_poisson` (`d4est.mesh`,
`d4est.solve`, `d4est.estimate`, `d4est.amr`, which the TIMINGS line
reads), the mesh build's parts, the mixed solve's f64 outer applies, the
Krylov loops' iterations, reads, enqueue and wait, and the B1 and B2
launches of the run.

Distributed execution (`[parallelism]`, JAX `driver.py:443-613`; the
reference's driver is the MPI program, `driver.c:13-313`): run under
torchrun (or N processes with its variables), one rank per process, each
rank builds every epoch's global mesh and takes its block of a
node-weighted SFC layout (`parallel/`); the unpreconditioned and
multigrid linear solves and the Newton–Krylov solve then apply through
the halo-exchange program with global dot products, and the solution is
gathered back for the norms, the estimator and the AMR step.  Rank 0's
estimate decides the marks, and only rank 0 writes files.  Where the JAX
driver drops to one device without a word (the Schwarz and Chebyshev
preconditioners, mid-solve checkpoints of a linear solve, Newton-MG;
ROADMAP C6) or runs Chebyshev for a Schwarz multigrid smoother (C2), the
port raises `NotImplementedError`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple

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
from disco4est_tpu_torch.geometry.disk import DiskGeometry
from disco4est_tpu_torch.geometry.misc import (
    HoleInABoxGeometry,
    PizzaHalfGeometry,
    TrapGeometry,
)
from disco4est_tpu_torch.io import checkpoint as ckpt_io
from disco4est_tpu_torch.io.norms import NormLog, norm_L2, norm_Linfty
from disco4est_tpu_torch.io.vtk import write_vtu
from disco4est_tpu_torch.laplacian import curved, fused, structured
from disco4est_tpu_torch.laplacian.hp import (
    adjoint_to_own,
    apply_sipg_hp,
    restrict_padded,
    to_max,
)
from disco4est_tpu_torch.laplacian.nonlinear import (
    apply_mass_coeff,
    apply_mass_fof,
    assemble_fof_blocks,
    fof_lin_coeff,
)
from disco4est_tpu_torch.laplacian.sipg import (
    apply_sipg,
    build_rhs_with_strong_bc,
)
from disco4est_tpu_torch.mesh.builder import MeshData, build_mesh
from disco4est_tpu_torch.mesh.tree import Forest
from disco4est_tpu_torch.parallel import comm as pcomm
from disco4est_tpu_torch.parallel.halo import (
    apply_sipg_halo,
    apply_sipg_hp_halo,
    build_halo_program,
)
from disco4est_tpu_torch.parallel.mg import (
    build_sharded_hierarchy,
    level_operator,
    mg_setup_sharded,
    smoother_refusal,
    v_cycle_sharded,
)
from disco4est_tpu_torch.parallel.repartition import (
    PaddedLayout,
    migrate_field,
    pad_mesh_to_layout,
    unmigrate_field,
)
from disco4est_tpu_torch.parallel.sharding import shard_field, shard_mesh_data
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
from disco4est_tpu_torch.solvers.newton import (
    NewtonParams,
    NewtonResult,
    newton_solve,
)
from disco4est_tpu_torch.solvers.schwarz_overlap import (
    build_overlapping_schwarz,
    build_overlapping_schwarz_kslot,
)
from disco4est_tpu_torch.util import trace
from disco4est_tpu_torch.util.config import Options

_ON = ("1", "true", "yes", "on")
_OFF = ("0", "false", "no", "off")


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
    `Geometry/d4est_geometry.c:127`): the brick, the cubed spheres, the
    5-tree disk, the trapezoid, the pizza-half and the hole-in-a-box."""
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
    if name in ("disk", "5treedisk"):
        return DiskGeometry(R0=g("r0", 0.5), R1=g("r1", 1.0))
    if name in ("trap", "trapezoid"):
        return TrapGeometry()
    if name == "pizza_half":
        return PizzaHalfGeometry(R0=g("r0", 0.5), R1=g("r1", 1.0))
    if name == "hole_in_a_box":
        return HoleInABoxGeometry(inner_radius=g("inner_radius", 1.0),
                                  box_length=g("box_length", 10.0))
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
    #            (preconditioned paths: "-hp" on mixed-degree epochs);
    #            under [parallelism] "mixed-halo" | "cg-halo" | "fcg-halo"
    #            | "cg-hp-halo" | "fcg-mg[-hp]-halo"
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
    solves: list  # [SolveInfo] per level this run went through (from the
    #               restart level on a restart)
    eta2_history: list = dataclasses.field(default_factory=list)
    #                    [np.ndarray η² per element] per smooth_pred marking
    precond: object = None  # the last epoch's preconditioner state
    #     (`MGHierarchy`, `OverlappingSchwarz`, `SchwarzKSlot` or the
    #     Chebyshev bounds)
    timings: list = dataclasses.field(default_factory=list)
    #     [{"level": k, phase: seconds}] per level with `[driver]
    #     print_timings = 1` (JAX `DriverResult.timings`), else empty
    first_level: int = 0  # the level of `solves[0]`: the restart level,
    #                       else 0
    rank: int = 0  # this process's rank under [parallelism], else 0
    parallel: str = ""  # under [parallelism]: the ranks and the backend
    trace: dict | None = None  # the run's record of spans and counters
    #                            (`util/trace.py`)


def _refuse_unported(opts: Options):
    """Options the port refuses before it starts."""
    pc_type = opts.get("d4est_solver_krylov_petsc", "pc_type", "none")
    if pc_type not in ("none", "schwarz", "multigrid", "cheby"):
        raise ValueError(f"unknown pc_type: {pc_type!r}")


class _PhaseTimer:
    """The phases of the linear AMR loop, each a tracer span `d4est.<phase>`
    (JAX `_PhaseTimer`, `driver.py:187-231`): with `[driver] print_timings
    = 1`, one line `TIMINGS level k: mesh=…s solve=…s estimate=…s amr=…s`
    per level, from the spans' seconds.

    With the option each span synchronizes the device at both ends, so
    that a phase is charged its own asynchronous launches and not the
    previous phase's.  The JAX timer prints a level's row before its amr
    phase runs, so its rows never show amr (ROADMAP C4); the port prints
    after it.  Off (the default) the spans read the host clock alone: no
    synchronize, no row."""

    def __init__(self, opts: Options, device, quiet=False):
        self.enabled = opts.get("driver", "print_timings", False, cast=bool)
        self.sync = (lambda: _sync(device)) if self.enabled else None
        self.quiet = quiet  # ranks other than 0 record and print nothing
        self.rows = []

    def level(self, it):
        if self.enabled:
            self.rows.append({"level": it})

    @contextlib.contextmanager
    def phase(self, name):
        with trace.span(f"d4est.{name}", sync=self.sync) as sp:
            yield
        if self.enabled:
            row = self.rows[-1]
            row[name] = row.get(name, 0.0) + sp.seconds

    def flush(self):
        if self.enabled and self.rows and not self.quiet:
            row = self.rows[-1]
            parts = " ".join(f"{k}={v:.3f}s" for k, v in row.items()
                             if k != "level")
            print(f"TIMINGS level {row['level']}: {parts}")


def _restart_state(opts: Options, geom, device):
    """[initial_mesh] load_from_checkpoint (JAX `_restart_state`; role of
    `driver.c:156-227`): (forest, level, fields, deg, history, extra) or
    None.

    `checkpoint_type = structure` trusts the stored forest (the P4EST_H5
    analog); `history` rebuilds the initial mesh and REPLAYS the stored
    refinement logs (`d4est_checkpoint_load_mesh_from_amr_history`), and
    the replayed forest must reproduce the stored checksum."""
    if not opts.get("initial_mesh", "load_from_checkpoint", False,
                    cast=bool):
        return None
    prefix = opts.get("initial_mesh", "checkpoint_prefix", required=True)
    ctype = opts.get("initial_mesh", "checkpoint_type", "structure")
    if ctype not in ("structure", "history"):
        raise ValueError(f"unknown checkpoint_type {ctype!r}")
    forest, fields, deg, history, extra = ckpt_io.load(prefix, geom.conn,
                                                       device=device)
    if ctype == "history":
        level0 = opts.get_int("initial_mesh", "min_level", required=True)
        replayed = ckpt_io.replay_amr_history(
            Forest.uniform(geom.conn, level0), history or [])
        if replayed.checksum() != forest.checksum():
            raise ValueError(
                "AMR-history replay does not reproduce the checkpointed "
                "forest (checksum mismatch)"
            )
        forest = replayed
    extra = extra or {}
    return (forest, int(extra.get("level", 0)), fields, deg, history or [],
            extra)


class _Checkpointer:
    """[checkpoint] section (JAX `_Checkpointer`): per-AMR-level
    checkpoints, plus mid-solve ones every n Krylov or Newton iterations
    (`d4est_solver_krylov_petsc.c:236-245`, `d4est_amr_smooth_pred.c:34`)."""

    def __init__(self, opts: Options):
        self.prefix = opts.get("checkpoint", "prefix", None)
        self.every_n = opts.get_int("checkpoint",
                                    "checkpoint_every_n_krylov_its", 0)

    @property
    def midsolve(self) -> bool:
        return bool(self.prefix) and self.every_n > 0

    def save_level(self, forest, it, fields, deg, history, extra):
        ckpt_io.save(f"{self.prefix}_level{it}", forest, fields, deg=deg,
                     amr_history=history, extra=extra)

    def save_midsolve(self, forest, it, k, u, deg):
        ckpt_io.save(f"{self.prefix}_level{it}_it{k}", forest, {"u": u},
                     deg=deg, extra={"mid_solve_iteration": int(k)})


def _predictor_json(sp_state):
    """The smooth_pred predictor as checkpoint JSON (float repr is exact)."""
    return None if sp_state is None else sp_state.predictor.tolist()


def _launches() -> dict:
    """B1 and B2 launches so far in this process, both precisions (the
    kernel modules' own counters), for the run record's deltas."""
    return {"launches.b1": (structured.KERNEL_LAUNCHES
                            + structured.KERNEL_LAUNCHES_BF16),
            "launches.b2": fused.KERNEL_LAUNCHES + fused.KERNEL_LAUNCHES_BF16}


@trace.traced_run(_launches)
def run_poisson(opts: Options, problem, *, device) -> DriverResult:
    """Linear Poisson AMR-solve loop on the configured geometry, on
    `device`.

    On a restart (`[initial_mesh] load_from_checkpoint`) the loop starts at
    the checkpoint's level with its forest, degrees, predictor and
    post-solve iterate, and skips that level's solve (JAX
    `driver.py:687-701`, `:843-855`): its `SolveInfo` has path `restart`,
    0 iterations and the residual ‖b − A u‖ of the restored iterate, and
    no preconditioner is built for it.  `solves` and `eta2_history` then
    start at the restart level."""
    device = resolve_device(device)
    # IEEE f32 products everywhere: reduced-precision (TF32) products make
    # the inner f32 CG diverge, as the JAX package found on the TPU.  The
    # SIPG kernels' bf16 mode runs only where a caller asks for
    # precision="bf16"; the driver's inner solves take the f32 default
    # (its bf16 inner CG diverges on the level-5 brick, ROADMAP C19)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _refuse_unported(opts)
    par = ParallelContext.from_options(
        opts, device, refuse=_parallel_refusals(opts, nonlinear=False))
    if par is not None:
        device = par.device
    rank0 = par is None or par.rank == 0

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
        # > 0 selects the K-slot variant: resident index tables instead of
        # the 27x replicated mesh
        chunk=opts.get_int("d4est_solver_schwarz", "subdomain_chunk", 0),
        eigs_iters=opts.get_int("mg_smoother_cheby", "cheby_eigs_cg_imax",
                                10),
        ratio=opts.get_float("mg_smoother_cheby",
                             "cheby_eigs_lmax_lmin_ratio", 30.0),
    )
    precond = None
    ckpt = _Checkpointer(opts)
    timer = _PhaseTimer(opts, device, quiet=not rank0)
    vtk_base = opts.get("d4est_vtk", "filename", None)

    forest = Forest.uniform(geom.conn, level)
    # hp state: per-element degrees and the storage degree (grows as
    # uniform_p or smooth_pred p-refines)
    deg_e = np.full(forest.n_elements, deg, np.int32)
    storage = deg
    norms = NormLog()
    solves, eta2_hist, amr_history = [], [], []
    u = None
    sp_state = None
    it0, resume_u, resume_own = 0, None, None
    rs = _restart_state(opts, geom, device)
    if rs is not None:
        # the checkpoint holds its level's post-solve iterate at the
        # storage degree, the degrees and the predictor before marking
        forest, it0, fields, storage, amr_history, extra = rs
        de = extra.get("deg_e")
        deg_e = (np.asarray(de, np.int32) if de is not None
                 else np.full(forest.n_elements, deg, np.int32))
        if extra.get("predictor") is not None:
            sp_state = SmoothPredState(np.asarray(extra["predictor"]))
        resume_u = fields["u"]
        resume_own = fields.get("u_own")
    for it in range(it0, n_amr + 1):
        timer.level(it)
        mixed = bool((deg_e != storage).any())
        with timer.phase("mesh"):
            mesh = build_mesh(
                geom, forest, deg=storage, quad=quad,
                deg_quad=storage + dq_inc, penalty_prefactor=prefactor,
                penalty_fcn=penalty_fcn, deg_e=deg_e,
                face_h_type=face_h_type, device=device,
            )
        g = mesh.boundary_values(problem.boundary)
        f = mesh.init_field(problem.rhs)
        rhs_max = build_rhs_with_strong_bc(mesh, f, g)
        rhs = adjoint_to_own(mesh, rhs_max) if mixed else rhs_max
        # the transferred field starts the solve when the shapes match
        x0 = torch.zeros_like(f) if u is None or u.shape != f.shape else u
        restart = it == it0 and resume_u is not None
        pc = None
        if pc_type != "none" and not restart:
            pc = (_build_pc(mesh, rhs, hp=mixed, **pc_opts) if par is None
                  else _build_pc_dist(par, mesh, hp=mixed, **pc_opts))
            precond = pc.state
        with timer.phase("solve"):
            if restart:
                info, u = _restored(mesh, rhs, resume_u, resume_own,
                                    hp=mixed)
            elif par is not None and pc is not None:
                info, u = _solve_pc_dist(par, pc, rhs, x0)
            elif par is not None:
                info, u = _solve_dist(par.distribute(mesh), rhs, x0,
                                      hp=mixed, use_mixed=use_mixed, ksp=ksp,
                                      mixed_opts=mixed_opts)
            elif ckpt.midsolve:
                info, u = _solve_chunked(
                    mesh, rhs, x0, hp=mixed, ksp=ksp, pc=pc,
                    every_n=ckpt.every_n,
                    save=lambda k, x: ckpt.save_midsolve(forest, it, k, x,
                                                         storage))
            elif pc is not None:
                info, u = _solve_pc(mesh, rhs, x0, hp=mixed, pc=pc)
            elif mixed:
                info, u = _solve_hp(mesh, rhs, x0)
            else:
                info, u = _solve(mesh, rhs, x0, use_mixed=use_mixed,
                                 structured_on=structured_on, ksp=ksp,
                                 mixed_opts=mixed_opts)
            solves.append(info)
            u_max = (resume_u if restart else
                     to_max(mesh, u) if mixed else u)

        u_a = mesh.init_field(problem.analytic)
        norms.add(mesh, L_2=norm_L2(mesh, u_max - u_a),
                  L_infty=norm_Linfty(u_max - u_a))
        if vtk_base and rank0:
            write_vtu(f"{vtk_base}_{it}.vtu", mesh,
                      point_fields={"u": u_max, "error": u_max - u_a},
                      cell_fields={"deg": deg_e})
        if ckpt.prefix and rank0:
            # a mixed-degree level also stores its own-degree iterate, which
            # restricting u back from the storage degree does not give bit
            # for bit (ROADMAP C16)
            ckpt.save_level(forest, it,
                            {"u": u_max, "u_own": u} if mixed else
                            {"u": u_max}, storage, amr_history,
                            extra={"level": it, "deg_e": deg_e.tolist(),
                                   "predictor": _predictor_json(sp_state)})
        if it == n_amr:
            timer.flush()
            break

        pred = None
        if scheme == "uniform_h":
            log = -deg_e.astype(np.int64)
        elif scheme == "uniform_p":
            # raise every element's degree by one per step
            log = np.minimum(deg_e + 1, max_degree).astype(np.int64)
        else:
            with timer.phase("estimate"):
                F = apply_sipg(mesh, u_max) - rhs_max
                eta2 = estimate_bi(
                    mesh, u_max, F, g=g, penalty_prefactor=prefactor,
                    vol_h=vol_h_from_options(opts),
                ).cpu().numpy()
                if par is not None:  # rank 0's estimate decides the marks
                    eta2 = par.comm.broadcast(eta2)
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
        amr_history.append(np.asarray(log))
        with timer.phase("amr"):
            new_forest, new_deg_e, fields, new_storage = amr_step_hp(
                forest, deg_e, log, {"u": u}, storage, max_degree
            )
            u = fields["u"]
            if sp_state is not None and pred is not None:
                sp_state = SmoothPredState(
                    transfer_predictor(forest, new_forest, pred, deg_e,
                                       sp_params, log)
                )
        timer.flush()
        forest, deg_e, storage = new_forest, new_deg_e, new_storage

    return DriverResult(mesh=mesh, u=u, norms=norms, solves=solves,
                        eta2_history=eta2_hist, precond=precond,
                        timings=timer.rows, first_level=it0,
                        rank=0 if par is None else par.rank,
                        parallel="" if par is None else par.note)


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


def _schwarz(mesh: MeshData, *, overlap, subdomain_iter, chunk, hp=False):
    """The overlapping Schwarz of one epoch: the K-slot variant when
    `[d4est_solver_schwarz] subdomain_chunk` > 0, else the materialized
    one (JAX `driver.py:731-750`, `:1405-1426`)."""
    if chunk > 0:
        return build_overlapping_schwarz_kslot(
            mesh, num_nodes_overlap=overlap, iterations=subdomain_iter,
            chunk=chunk, hp=hp)
    return build_overlapping_schwarz(
        mesh, num_nodes_overlap=overlap, iterations=subdomain_iter, hp=hp)


class _Precond(NamedTuple):
    """One epoch's preconditioner: the apply `M`, its state (returned as
    `DriverResult.precond`), the Krylov solver and path it pairs with, and
    its set-up seconds by step."""

    M: object
    state: object
    solver: object
    path: str
    setup: dict


def _build_pc(mesh: MeshData, rhs, *, hp, pc_type, mg_params, mesh_kwargs,
              overlap, subdomain_iter, chunk, eigs_iters, ratio) -> _Precond:
    """Set up the preconditioner of a preconditioned epoch (JAX
    `driver.py:704-795`) on this epoch's mesh, on the hp operator on
    mixed-degree epochs: multigrid and Schwarz pair with f64 FCG, Chebyshev
    (bounds from CG-Lanczos on the rhs, 8 steps an apply) with f64 CG."""
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
        state = M = step("schwarz", lambda: _schwarz(
            mesh, overlap=overlap, subdomain_iter=subdomain_iter,
            chunk=chunk, hp=hp))
        solver, path = fcg_solve, "fcg-schwarz"
    else:  # cheby
        lmax = step("eigs", lambda: cg_eigs(A, rhs, eigs_iters))[1]
        state = (lmax / ratio, lmax)
        M = lambda r: cheby_smooth(A, r, torch.zeros_like(r), state[0],
                                   state[1], 8)
        solver, path = cg_solve, "cg-cheby"
    return _Precond(M, state, solver, path, setup)


def _solve_pc(mesh: MeshData, rhs, x0, *, hp, pc: _Precond):
    """A preconditioned epoch (JAX `_linear_solve_fcg_mg(_hp)`,
    `_linear_solve_fcg_schwarz(_hp)`, `_linear_solve_cg_cheby(_hp)`): `pc`'s
    solver on the operator, the hp one on mixed-degree epochs."""
    op = apply_sipg_hp if hp else apply_sipg
    _sync(mesh.device)
    t0 = time.perf_counter()
    res = pc.solver(lambda v: op(mesh, v), rhs, x0=x0, M=pc.M, atol=5e-15,
                    rtol=1e-20, max_iter=10000)
    _sync(mesh.device)
    info = SolveInfo(
        path=pc.path + ("-hp" if hp else ""), outer_iterations=0,
        iterations=res.iterations, residual_norm=res.residual_norm,
        rhs_norm=float(torch.linalg.norm(rhs.reshape(-1))), fallback=False,
        seconds=time.perf_counter() - t0, setup=pc.setup,
    )
    return info, res.x


def _solve_chunked(mesh: MeshData, rhs, x0, *, hp, ksp, pc, every_n, save):
    """The mid-solve checkpoint path (JAX `driver.py:880-899`, role of
    `d4est_solver_krylov_petsc.c:236-245`): the f64 Krylov solve in chunks
    of `every_n` iterations, each resuming the previous chunk's exact state
    (`resume_state`), with `save(k, x)` after every chunk.  Preconditioned
    chunks run FCG with `pc.M`; without one, `ksp_type` picks CG or FCG.
    The f32 inner solves are not used on this path (as in JAX), so the
    result equals the same Krylov solve run in one piece, bit for bit.
    Path `<cg|fcg>[-<mg|schwarz|cheby>][-hp]-chunked`."""
    op = apply_sipg_hp if hp else apply_sipg
    M = pc.M if pc is not None else None
    solver = fcg_solve if (ksp == "fcg" or M is not None) else cg_solve
    parts = ["fcg" if solver is fcg_solve else "cg"]
    if pc is not None:
        parts.append(pc.path.split("-")[1])
    if hp:
        parts.append("hp")
    _sync(mesh.device)
    t0 = time.perf_counter()
    state, k_cap = None, every_n
    while True:
        res, state = solver(lambda v: op(mesh, v), rhs, x0=x0, M=M,
                            atol=5e-15, rtol=1e-20, max_iter=k_cap,
                            resume_state=state, return_state=True)
        save(res.iterations, res.x)
        if res.iterations < k_cap or res.residual_norm < 5e-15:
            break
        k_cap += every_n
    _sync(mesh.device)
    info = SolveInfo(
        path="-".join(parts + ["chunked"]), outer_iterations=0,
        iterations=res.iterations, residual_norm=res.residual_norm,
        rhs_norm=float(torch.linalg.norm(rhs.reshape(-1))), fallback=False,
        seconds=time.perf_counter() - t0,
        setup=pc.setup if pc is not None else {},
    )
    return info, res.x


def _restored(mesh: MeshData, rhs, u_max, u_own, *, hp):
    """The restart level's iterate, with no solve (JAX `driver.py:843-855`):
    the checkpoint's storage-degree `u_max`, and on a mixed-degree epoch
    its own-degree iterate `u_own` when the checkpoint has it, else
    `restrict_padded(u_max)` (a checkpoint of the JAX driver, which is
    exact only up to rounding, ROADMAP C16).  The info's residual is the
    true ‖b − A u‖ of the restored iterate."""
    u = u_max
    if hp:
        u = (u_own if u_own is not None
             else restrict_padded(u_max, mesh.deg_e, mesh.deg, mesh.dim))
    op = apply_sipg_hp if hp else apply_sipg
    info = SolveInfo(
        path="restart", outer_iterations=0, iterations=0,
        residual_norm=float(torch.linalg.norm((rhs - op(mesh, u))
                                              .reshape(-1))),
        rhs_norm=float(torch.linalg.norm(rhs.reshape(-1))), fallback=False,
        seconds=0.0,
    )
    return info, u


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
            # the inner rtol and outer cap of the JAX driver's curved
            # solve (`driver.py:347-349`; its call at `:963` passes none
            # of the mixed_* options, ROADMAP C3).  Its 400-iteration
            # inner cap is replaced by `mixed_inner_max_iter`: capped
            # inner solves contract the outer residual by less than the
            # stall test's 10 % on the 2D disk from level 6, and the solve
            # then stops above the f64 floor (ROADMAP C14).  Its
            # host-stepped outer loop (`:370-390`) exists for a TPU stall
            # and stops after 3 outer steps (ROADMAP C1): the port runs
            # `mixed_refine_solve`, whose stall test compares with the
            # previous residual.
            path = "mixed-curved"
            res = mixed_refine_solve(
                lambda v: apply_sipg(mesh, v), rhs, x0=x0,
                inner_solve=curved.make_inner_solve(
                    ts.astype(torch.float32),
                    curved.permute_mesh_lex(ts, mesh).astype(torch.float32),
                    rtol=1e-4, max_iter=mixed_opts["inner_max_iter"],
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
# Distributed execution ([parallelism])
# ---------------------------------------------------------------------------
#
# The reference's driver is the parallel program (`driver.c:13-313`:
# PetscInitialize → p4est partition → ghost → solve; every problem runs
# under mpirun).  Here each rank is a process (torchrun); `[parallelism]`
# routes a solve through the node-weighted SFC layout
# (`d4est_amr_load_balance`), the rank's block of the padded mesh and the
# halo-exchange apply (`Mesh/d4est_ghost_data.c` role): one all-to-all of
# halo volume values an apply and global dot products.


class ParallelContext:
    """The driver's distributed state (JAX `ParallelContext`,
    `driver.py:457-513`).  [parallelism] options:

        enable    = auto|1|0   (auto: on when WORLD_SIZE > 1)
        n_devices = <int>      (must equal the world size)
        backend   = auto|nccl|gloo  (auto: nccl when every rank on the
                                host has a card of its own, else gloo;
                                an explicit nccl that cannot be served
                                raises)
        multihost = 1          (accepted: the ranks always come from the
                                environment, `parallel/comm.py`)
    """

    def __init__(self, comm, note=""):
        self.comm = comm
        self.n_dev, self.rank, self.device = comm.size, comm.rank, comm.device
        # what the CLI prints of the run's ranks and backend
        self.note = note or f"{comm.size} ranks"

    @staticmethod
    def from_options(opts: Options, device, refuse=()):
        """The context of this run, or None when it runs on one rank.
        Every check runs before the process group is joined; `refuse`
        lists the messages of option combinations that cannot run
        distributed (the first raises `NotImplementedError`)."""
        enable = str(opts.get("parallelism", "enable", "auto")).lower()
        if enable in _OFF:
            return None
        world = pcomm.world_from_env()
        n = opts.get_int("parallelism", "n_devices", world.size)
        if n != world.size:
            raise ValueError(
                f"[parallelism] n_devices = {n} but the world has "
                f"{world.size} ranks (start one process per rank, e.g. "
                "`python -m torch.distributed.run --nproc_per_node=N`)")
        if world.size <= 1:
            if enable in _ON:
                raise ValueError(
                    "[parallelism] enable = 1 requires more than one rank "
                    "(WORLD_SIZE > 1)")
            return None
        dev = pcomm.rank_device(device, world)
        asked = opts.get("parallelism", "backend", "auto")
        backend = pcomm.resolve_backend(asked, dev, world)
        for msg in refuse:
            raise NotImplementedError(msg)
        note = f"{world.size} ranks, backend = {backend}" + (
            f" (auto: {world.local_size} ranks on this host, "
            f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
            "CUDA cards)" if asked == "auto" else "")
        return ParallelContext(pcomm.init_process_group(backend, world, dev),
                               note)

    def distribute(self, mesh: MeshData) -> "DistributedEpoch":
        """Node-weighted SFC layout, the rank's block of the padded mesh
        and its halo program for one mesh epoch (`p4est_partition_ext`
        with node weights + `d4est_ghost_init`)."""
        layout = PaddedLayout.build(
            (mesh.deg_e.cpu().numpy() + 1) ** mesh.dim, self.n_dev)
        mesh_p = pad_mesh_to_layout(mesh, layout)
        halo = build_halo_program(mesh_p, self.n_dev).local(self.rank,
                                                             self.device)
        mesh_l = shard_mesh_data(mesh_p, self.rank, self.n_dev, self.device)
        return DistributedEpoch(self.comm, layout, mesh_l, halo,
                                mesh.n_elements)


class DistributedEpoch:
    """One mesh epoch on this rank: the layout, the rank's mesh block and
    halo program, and field migration in and out of the layout (JAX
    `DistributedEpoch`)."""

    def __init__(self, comm, layout, mesh, halo, E):
        self.comm, self.layout, self.mesh, self.halo, self.E = (
            comm, layout, mesh, halo, E)
        rows = slice(comm.rank * layout.Bmax, (comm.rank + 1) * layout.Bmax)
        # the rank's real rows: pad rows are kept at exactly zero
        self.valid = torch.as_tensor(layout.src[rows] >= 0,
                                     device=comm.device)

    def to_dev(self, field):
        """A global-SFC field [E, ...] -> this rank's rows [Bmax, ...]."""
        return shard_field(migrate_field(field, self.layout), self.comm.rank,
                           self.comm.size, self.comm.device)

    def to_host(self, field_l):
        """Every rank's rows -> the global-SFC field (on every rank)."""
        return unmigrate_field(self.comm.all_gather_rows(field_l),
                               self.layout, self.E)

    def real_rows(self, v):
        """v with its pad rows set to zero."""
        return torch.where(self.valid.reshape((-1,) + (1,) * (v.ndim - 1)),
                           v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def _parallel_refusals(opts: Options, nonlinear: bool):
    """The option combinations that cannot run distributed: the JAX
    driver runs them on one device without a word (ROADMAP C6) or swaps
    the multigrid smoother (C2); the port refuses them."""
    pc_type = opts.get("d4est_solver_krylov_petsc", "pc_type", "none")
    out = []
    if nonlinear and pc_type != "none":
        out.append(
            f"[parallelism] with pc_type = {pc_type} in a nonlinear run: the "
            "distributed Newton–Krylov solve has no preconditioner (the JAX "
            "driver drops to one device, ROADMAP C6)")
    if not nonlinear and pc_type in ("schwarz", "cheby"):
        out.append(
            f"[parallelism] with pc_type = {pc_type}: no distributed "
            f"{pc_type} preconditioner (the JAX driver drops to one device, "
            "ROADMAP C6)")
    if not nonlinear and pc_type == "multigrid":
        msg = smoother_refusal(mg_plugin_names(opts)[0])
        if msg:
            out.append(msg)
    if not nonlinear and _Checkpointer(opts).midsolve:
        out.append(
            "[parallelism] with checkpoint_every_n_krylov_its: no "
            "distributed mid-solve checkpoints of a linear solve (the JAX "
            "driver drops to one device, ROADMAP C6)")
    return out


def _halo_op(epoch: DistributedEpoch, hp=False, robin_coeff=None):
    if hp:
        return lambda v: apply_sipg_hp_halo(epoch.mesh, epoch.halo, v,
                                            epoch.comm)
    return lambda v: apply_sipg_halo(epoch.mesh, epoch.halo, v, epoch.comm,
                                     robin_coeff)


def _solve_dist(epoch: DistributedEpoch, rhs, x0, *, hp, use_mixed, ksp,
                mixed_opts):
    """An unpreconditioned epoch on the halo program (JAX
    `_linear_solve_halo`, `_linear_solve_mixed_halo`, `driver.py:541-606`,
    routed as at `:829-879`): f64 CG on the hp operator on mixed-degree
    epochs (`cg-hp-halo`); mixed precision with the f32 inner CG through
    the f32 halo program (`mixed-halo`), falling back to f64 CG when the
    outer loop runs out (JAX `:870-873`) or stops above the one-rank
    path's floor 1e-10·(1 + ‖b‖); else f64 CG or FCG (`cg-halo`,
    `fcg-halo`).  Returns the info and the gathered global solution."""
    comm = epoch.comm
    dot = comm.dot
    _sync(comm.device)
    t0 = time.perf_counter()
    rhs_l, x0_l = epoch.to_dev(rhs), epoch.to_dev(x0)
    A = _halo_op(epoch, hp=hp)
    bnorm = float(torch.sqrt(dot(rhs_l, rhs_l)))

    def plain(flexible):
        return (fcg_solve if flexible else cg_solve)(
            A, rhs_l, x0=x0_l, atol=5e-15, rtol=1e-20, max_iter=100000,
            dot=dot)

    fallback, outer = False, 0
    if hp:
        path, res = "cg-hp-halo", plain(False)
        iters = res.iterations
    elif use_mixed:
        path = "mixed-halo"
        mesh32, halo32 = epoch.mesh.astype(torch.float32), epoch.halo.astype(
            torch.float32)
        res = mixed_refine_solve(
            A, rhs_l, x0=x0_l,
            A32=lambda v: apply_sipg_halo(mesh32, halo32, v, comm),
            atol=5e-15, rtol=1e-20, dot=dot, **mixed_opts)
        outer, iters = res.outer_iterations, res.inner_iterations
        if (res.outer_iterations >= mixed_opts["max_outer"]
                or res.residual_norm > 1e-10 * (1.0 + bnorm)):
            fallback = True
            res = plain(False)
            iters = res.iterations
    else:
        path = f"{'fcg' if ksp == 'fcg' else 'cg'}-halo"
        res = plain(ksp == "fcg")
        iters = res.iterations
    x = epoch.to_host(res.x)
    _sync(comm.device)
    info = SolveInfo(
        path=path, outer_iterations=outer, iterations=iters,
        residual_norm=float(res.residual_norm), rhs_norm=bnorm,
        fallback=fallback, seconds=time.perf_counter() - t0,
    )
    return info, x


def _build_pc_dist(par: ParallelContext, mesh: MeshData, *, hp, pc_type,
                   mg_params, mesh_kwargs, **_) -> _Precond:
    """The multigrid preconditioner of a distributed epoch (JAX
    `driver.py:787-799`): the global hierarchy, every level distributed
    (`parallel/mg.build_sharded_hierarchy`) and its Chebyshev bounds from
    Lanczos on the level halo operators; one shard-resident V-cycle an
    apply, with FCG.  Its state is the `ShardedHierarchy`."""
    setup = {}

    def step(name, fn):
        _sync(par.device)
        t = time.perf_counter()
        out = fn()
        _sync(par.device)
        setup[name] = time.perf_counter() - t
        return out

    assert pc_type == "multigrid", pc_type  # the others are refused (C6)
    sh = step("hierarchy", lambda: build_sharded_hierarchy(
        build_hierarchy(mesh, mg_params, mesh_kwargs=mesh_kwargs),
        par.comm))
    step("mg_setup", lambda: mg_setup_sharded(sh, _sin3_seed))
    return _Precond(lambda r: v_cycle_sharded(sh, r, torch.zeros_like(r)),
                    sh, fcg_solve, "fcg-mg" + ("-hp" if hp else "") + "-halo",
                    setup)


def _solve_pc_dist(par: ParallelContext, pc: _Precond, rhs, x0):
    """A distributed multigrid epoch (JAX `_linear_solve_fcg_mg_sharded`):
    FCG on the level-0 halo operator, one V-cycle an apply."""
    sh, comm = pc.state, par.comm
    _sync(par.device)
    t0 = time.perf_counter()
    lay = sh.layouts[0]
    rhs_l = shard_field(migrate_field(rhs, lay), comm.rank, comm.size,
                        comm.device)
    x0_l = shard_field(migrate_field(x0, lay), comm.rank, comm.size,
                       comm.device)
    res = pc.solver(level_operator(sh, 0), rhs_l, x0=x0_l, M=pc.M,
                    atol=5e-15, rtol=1e-20, max_iter=10000, dot=comm.dot)
    x = unmigrate_field(comm.all_gather_rows(res.x), lay, rhs.shape[0])
    _sync(par.device)
    info = SolveInfo(
        path=pc.path, outer_iterations=0, iterations=res.iterations,
        residual_norm=res.residual_norm,
        rhs_norm=float(torch.sqrt(comm.dot(rhs_l, rhs_l))), fallback=False,
        seconds=time.perf_counter() - t0, setup=pc.setup,
    )
    return info, x


def _newton_dist(epoch: DistributedEpoch, problem, mesh: MeshData, u, bc,
                 params, *, ksp, ksp_iters, krylov_its, callback=None):
    """The distributed Newton–Krylov solve of one level (JAX
    `driver.py:1494-1575`): the residual is the halo apply (with the Robin
    coefficient, or plus the migrated A(0; g) for Dirichlet data) and the
    rank-local nonlinear mass term; the Jacobian is the halo apply and the
    local frozen-u0 mass term; ‖F‖ and the Krylov dots are global.
    `callback(k, u, ‖F‖)` gets the gathered global iterate.  Returns the
    `NewtonResult` with the gathered global solution."""
    comm = epoch.comm
    robin = problem.bc_type == "robin"
    rc_l = epoch.to_dev(bc) if robin else None
    Lg_l = None if robin else epoch.to_dev(
        apply_sipg(mesh, torch.zeros_like(u), bc))
    A = _halo_op(epoch, robin_coeff=rc_l)
    fof, dfof = problem.fof(), problem.dfof()

    def residual(u_l):
        r = A(u_l) + apply_mass_fof(epoch.mesh, u_l, fof)
        if Lg_l is not None:
            r = r + Lg_l
        return epoch.real_rows(r)

    def jac_solve(u0_l, rhs_l, rtol):
        coeff = epoch.real_rows(fof_lin_coeff(epoch.mesh, u0_l, dfof))
        res = (fcg_solve if ksp == "fcg" else cg_solve)(
            lambda v: A(v) + apply_mass_coeff(epoch.mesh, coeff, v), rhs_l,
            atol=0.0, rtol=rtol, max_iter=ksp_iters, dot=comm.dot)
        krylov_its.append(res.iterations)
        return res.x

    res = newton_solve(
        residual, jac_solve, epoch.to_dev(u), params,
        callback=(None if callback is None else
                  lambda k, u_k, fn: callback(k, epoch.to_host(u_k), fn)),
        dot=comm.dot)
    return res._replace(u=epoch.to_host(res.u))


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
    name = "constant_density_star"

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

    def fof(self):
        return self.mod.fof(self.params)

    def dfof(self):
        return self.mod.dfof(self.params)

    def linear_apply(self, mesh, v, bc):
        """The Jacobian's linear part: A v with homogeneous data."""
        return apply_sipg(mesh, v)


class OkendonProblem:
    """Okendon power-law adapter (`Problems/Okendon/`)."""

    bc_type = "dirichlet"
    name = "okendon"

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

    def fof(self):
        return self.mod.fof(self.params)

    def dfof(self):
        return self.mod.dfof(self.params)

    def linear_apply(self, mesh, v, bc):
        return apply_sipg(mesh, v)


class TwoPuncturesProblem:
    """TwoPunctures adapter (`Problems/TwoPunctures/two_punctures_cactus.c`),
    Robin BC u/r + du/dn = 0 at the outer sphere."""

    bc_type = "robin"
    name = "two_punctures"
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

    def fof(self):
        return self.mod.fof(self.params)

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


@trace.traced_run(_launches)
def run_nonlinear(opts: Options, problem, *, device) -> DriverResult:
    """Nonlinear AMR loop on `device`: Newton–Krylov per level, the bi
    estimator on the residual, then uniform_h or h-only smooth_pred
    refinement.  `DriverResult.solves` holds one `NewtonInfo` a level.

    Checkpoints, restart and VTK as in `run_poisson` (JAX
    `driver.py:1369-1380`, `:1489-1492`, `:1551-1562`, `:1600-1617`);
    `checkpoint_every_n_krylov_its = n` saves every n-th Newton iterate.
    The restart level runs no Newton step: its `NewtonInfo` has 0
    iterations and ‖F‖ of the restored iterate.  `[driver] print_timings`
    is accepted and prints nothing: the JAX nonlinear driver has no phase
    timer, and `DriverResult.timings` stays empty."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _refuse_unported(opts)
    par = ParallelContext.from_options(
        opts, device, refuse=_parallel_refusals(opts, nonlinear=True))
    if par is not None:
        device = par.device
    rank0 = par is None or par.rank == 0

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
    ckpt = _Checkpointer(opts)
    vtk_base = opts.get("d4est_vtk", "filename", None)

    forest = Forest.uniform(geom.conn, level)
    norms = NormLog()
    solves, eta2_hist, amr_history = [], [], []
    u = None
    sp_state = None
    it0, resume_u = 0, None
    rs = _restart_state(opts, geom, device)
    if rs is not None:
        forest, it0, fields, _, amr_history, extra = rs
        if extra.get("predictor") is not None:
            sp_state = SmoothPredState(np.asarray(extra["predictor"]))
        resume_u = fields["u"]
    for it in range(it0, n_amr + 1):
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
        restart = it == it0 and resume_u is not None
        if restart:  # the checkpoint's post-solve iterate (JAX :1551-1562)
            u = resume_u
        elif u is None or u.shape[0] != mesh.n_elements:
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
        if restart:
            pass  # no Newton step on the restart level
        elif pc_type == "multigrid":
            hier = build_hierarchy(mesh, mg_params, mesh_kwargs=dict(
                penalty_prefactor=prefactor, penalty_fcn=penalty_fcn,
                face_h_type=face_h_type))
            linear = _level_operators(problem, hier, bc)
            precond = hier
        elif pc_type == "schwarz":
            precond = schwarz_M = _schwarz(
                mesh,
                overlap=opts.get_int("d4est_solver_schwarz",
                                     "num_nodes_overlap", 1),
                subdomain_iter=opts.get_int("d4est_solver_schwarz",
                                            "subdomain_iter", 15),
                chunk=opts.get_int("d4est_solver_schwarz",
                                   "subdomain_chunk", 0))
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

        def newton_cb(k, u_k, fnorm):
            if k % ckpt.every_n == 0 and rank0:
                ckpt.save_midsolve(forest, it, k, u_k, deg)

        _sync(device)
        t0 = time.perf_counter()
        if restart:
            F = problem.residual(mesh, u, bc)
            fnorm = float(torch.sqrt(torch.sum(F * F)))
            res = NewtonResult(u=u, iterations=0, residual_norm=fnorm,
                                history=[fnorm])
        elif par is not None:
            res = _newton_dist(par.distribute(mesh), problem, mesh, u, bc,
                               newton_params, ksp=ksp, ksp_iters=ksp_iters,
                               krylov_its=krylov_its,
                               callback=newton_cb if ckpt.midsolve else None)
        else:
            res = newton_solve(lambda v: problem.residual(mesh, v, bc),
                               jac_solve, u, newton_params,
                               callback=newton_cb if ckpt.midsolve else None)
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
        if par is not None:  # rank 0's estimate decides the marks
            eta2 = par.comm.broadcast(eta2)
        eta2_hist.append(eta2)
        norms.rows[-1]["eta2_sum"] = float(eta2.sum())

        if vtk_base and rank0:
            write_vtu(f"{vtk_base}_{it}.vtu", mesh, point_fields={"u": u},
                      cell_fields={"eta2": eta2})
        if ckpt.prefix and rank0:
            ckpt.save_level(forest, it, {"u": u}, deg, amr_history,
                            extra={"problem": problem.name, "level": it,
                                   "predictor": _predictor_json(sp_state)})

        if it == n_amr or scheme == "none":
            break
        if scheme == "uniform_h":
            log = -deg_e.astype(np.int64)
        else:
            if sp_state is None or len(sp_state.predictor) != mesh.n_elements:
                sp_state = SmoothPredState.fresh(mesh.n_elements, sp_params)
            log, pred = smooth_pred_mark(eta2, deg_e, sp_state, sp_params,
                                         dim=mesh.dim)
        amr_history.append(np.asarray(log))
        new_forest = refine_and_balance(forest, np.asarray(log) < 0)
        u = transfer_field(forest, new_forest, u, deg)
        if scheme == "smooth_pred":
            sp_state = SmoothPredState(transfer_predictor(
                forest, new_forest, pred, deg_e, sp_params, log))
        forest = new_forest

    return DriverResult(mesh=mesh, u=u, norms=norms, solves=solves,
                        eta2_history=eta2_hist, precond=precond,
                        first_level=it0, rank=0 if par is None else par.rank,
                        parallel="" if par is None else par.note)
