"""CLI: `python -m disco4est_tpu_torch options.input [--problem=sinx]
[--device=cuda|cpu] [--plot-checkpoint=ck [--output=out.vtu]]`.

Port of `disco4est_tpu/__main__.py`.  The problem comes from `--problem=`
or `[problem] name`; the device from `--device=` (default `cuda`; a
missing card raises).  Linear problems (sinx, lorentzian, stamm) run the
AMR-Krylov loop and print the reference-format norm line of each level,
one line per solve (path, iteration counts, whether the f64 fallback ran,
wall time) and the convergence fit when there are two or more levels.
Nonlinear problems (constant_density_star / cds, okendon, two_punctures)
run the Newton–Krylov loop and print the norm lines (L2 error, or ‖F‖
where the problem has no analytic solution), one Newton line per level
(iterations, ‖F‖, Krylov iterations, wall time, ‖F‖ history) and the fit.
`[logging] log_dir = <dir>` also routes the norm lines to the
`d4est_norms` category's files there (`util/logging.py`); the console
keeps stdout.  `--plot-checkpoint=ck` writes the checkpoint `ck` as a
`.vtu` (`--output=`, default `checkpoint.vtu`) and solves nothing.

Distributed (`[parallelism]`, `driver.ParallelContext`): run one process
per rank, e.g.

    python -m torch.distributed.run --nproc_per_node=N \
        -m disco4est_tpu_torch options.input [--device=cpu]

(or N processes with torchrun's variables RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT set); the ranks run the driver as one program
and only rank 0 prints, first a line `parallelism: N ranks, backend =
...` (`backend = auto`, the default, takes NCCL when every rank has a
card of its own, else gloo).  An error on any rank ends that rank with
a nonzero exit; the others then fail in their next collective (gloo sees
the closed connection, NCCL its timeout), so no run hangs.
"""

import sys

import numpy as np

from disco4est_tpu_torch.driver import (
    CDSProblem,
    OkendonProblem,
    TwoPuncturesProblem,
    geometry_from_options,
    resolve_device,
    run_nonlinear,
    run_poisson,
)
from disco4est_tpu_torch.io import checkpoint as ckpt
from disco4est_tpu_torch.io.vtk import write_vtu
from disco4est_tpu_torch.mesh.builder import build_mesh
from disco4est_tpu_torch.parallel.comm import shutdown
from disco4est_tpu_torch.problems.poisson import (
    LorentzianProblem,
    SinxProblem,
)
from disco4est_tpu_torch.problems.stamm import StammProblem
from disco4est_tpu_torch.util.config import Options
from disco4est_tpu_torch.util.logging import get_category, init_logging


def _stamm(opts):
    return StammProblem(
        c=(
            opts.get_float("problem", "c2x", 0.5),
            opts.get_float("problem", "c2y", 0.5),
            opts.get_float("problem", "c2z", 0.5),
        ),
        dim=3,
    )


LINEAR_PROBLEMS = {
    "sinx": lambda opts: SinxProblem,
    "lorentzian": lambda opts: LorentzianProblem,
    "stamm": _stamm,
}
NONLINEAR_PROBLEMS = {
    "constant_density_star": CDSProblem,
    "cds": CDSProblem,
    "okendon": OkendonProblem,
    "two_punctures": TwoPuncturesProblem,
}

USAGE = (
    "usage: python -m disco4est_tpu_torch options.input [--problem=sinx] "
    "[--device=cuda|cpu] [--plot-checkpoint=ck.npz [--output=out.vtu]]"
)


def plot_checkpoint(opts: Options, ck_path: str, out_path: str, *,
                    device) -> int:
    """Checkpoint-to-VTK plotter (JAX `plot_checkpoint`; the reference's
    CheckpointAMRPlotter problem family): rebuild the mesh of a checkpoint
    on `device` and write every stored nodal field, with `level` (and, when
    stored, `deg`) cell fields, to a `.vtu`; no solve."""
    device = resolve_device(device)
    geom = geometry_from_options(opts)
    forest, fields, deg, _, extra = ckpt.load(ck_path, geom.conn,
                                              device=device)
    mesh = build_mesh(geom, forest, deg=deg, device=device)
    cells = {"level": forest.level.astype(np.int32)}
    de = (extra or {}).get("deg_e")
    if de is not None:
        cells["deg"] = np.asarray(de, np.int32)
    write_vtu(out_path, mesh, point_fields=fields, cell_fields=cells)
    print(f"wrote {out_path}: {forest.n_elements} elements, "
          f"fields {sorted(fields)}")
    return 0


def main(argv):
    try:
        return _main(argv)
    finally:
        shutdown()  # leave the process group of a distributed run


def _main(argv):
    if not argv:
        print(USAGE)
        return 1
    opts = Options.load(argv[0])
    name = opts.get("problem", "name", "sinx")
    device = "cuda"
    ck, out = None, "checkpoint.vtu"
    for a in argv[1:]:
        if a.startswith("--problem="):
            name = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--plot-checkpoint="):
            ck = a.split("=", 1)[1]
        elif a.startswith("--output="):
            out = a.split("=", 1)[1]
        else:
            print(f"unknown argument {a!r}\n{USAGE}")
            return 1
    # [logging] log_dir routes per-category logs to files (zlog role,
    # reference `IO/logging.conf:20-31`); the console stays stdout
    log_dir = opts.get("logging", "log_dir", None)
    if log_dir:
        init_logging(log_dir, console=False)
    if ck is not None:
        return plot_checkpoint(opts, ck, out, device=device)
    if name in NONLINEAR_PROBLEMS:
        result = run_nonlinear(opts, NONLINEAR_PROBLEMS[name](opts),
                               device=device)
        key = "L_2" if "L_2" in result.norms.rows[-1] else "F_norm"
    elif name in LINEAR_PROBLEMS:
        result = run_poisson(opts, LINEAR_PROBLEMS[name](opts),
                             device=device)
        key = "L_2"
    else:
        known = sorted(set(LINEAR_PROBLEMS) | set(NONLINEAR_PROBLEMS))
        print(f"unknown problem {name!r}; known: {known}")
        return 1

    if result.rank != 0:  # rank 0 prints a distributed run's lines
        return 0
    if result.parallel:
        print(f"parallelism: {result.parallel}")
    if log_dir:
        nlog = get_category("d4est_norms")
        for line in result.norms.lines(key):
            nlog.info(line)
    for line in result.norms.lines(key):
        print(line)
    for level, info in enumerate(result.solves, result.first_level):
        print(info.line(level))
    fit = result.norms.convergence_fit(key)
    if fit:
        print(f"C1 = {fit['intercept']:.6f}, C2 = {fit['slope']:.15f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
