"""Readings that set a cell's check limits: the program's numbers on
every problem of the cell's set, and the control's.

    python3 benchmark/control.py --workload <cell> [--control 3]
        [--early 3] [--device cuda]

Every seed runs the same set of problems (`harness.TABLE_SEED`) in its
own order, so the program's readings are those of the set's problems:
one run of the cell's job on each, judged by the reference as the
benchmark judges it.  Then the control, on the first `--control`
problems: the reference itself put in the program's place and computed
in float32, one precision below the configuration's float64, judged the
same way; and the fault of a solve stopped one step short of the f64
floor (`stopped_early`), on the first `--early` problems.  One JSON
line per reading.  The limit of each
number lies above the largest reading of the program and below the
smallest of the control (PERF.md gives both).  The benchmark's own runs
do not run this.

A cell on N > 1 cards reads the program (and the early stop) as N ranks
through the benchmark's launcher (`ranks.launch`), every rank running the
same problems and rank 0 judging them; rank 0 then computes the control
on its card alone.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def stopped_early():
    """The fault of a solve stopped one step short of the f64 floor: the
    mixed solve run again with its last outer refinement step cut, a plain
    FCG solve stopped at 1000 times its tolerance (the gain of one outer
    step, whose inner rtol is 1e-3), the Newton solve run again with its
    last step cut."""
    import dataclasses

    from disco4est_tpu_torch import driver

    mixed, fcg, newton = (driver.mixed_refine_solve, driver.fcg_solve,
                          driver.newton_solve)

    def early_mixed(*a, **kw):
        k = mixed(*a, **kw).outer_iterations
        return mixed(*a, **dict(kw, max_outer=k - 1))

    def early_fcg(*a, **kw):
        return fcg(*a, **dict(kw, atol=1e3 * kw["atol"]))

    def early_newton(residual, jac, u0, params, **kw):
        k = newton(residual, jac, u0, params, **kw).iterations
        return newton(residual, jac, u0,
                      dataclasses.replace(params, max_iter=k - 1), **kw)

    driver.mixed_refine_solve = early_mixed
    driver.fcg_solve = early_fcg
    driver.newton_solve = early_newton
    try:
        yield
    finally:
        driver.mixed_refine_solve, driver.fcg_solve, driver.newton_solve = (
            mixed, fcg, newton)


def readings(name, control, device, cell=None, out=print, early=0,
             lead=True):
    """The readings' rows (each also passed to `out` as a JSON line);
    with `lead` False (a rank other than 0) the program's runs alone."""
    import torch

    from benchmark import harness
    from benchmark.reference.brick import Brick

    file_cell, config = harness.load_cell(name)
    cell = cell or file_cell
    job = harness.Job(cell, config, 0, device)
    job.order = list(range(int(cell["data"]["set"])))
    level, deg = harness.final_shape(job.sections)
    rows = []

    def judge(side, k):
        t0 = time.perf_counter()
        res = job(k + 1)
        wall = time.perf_counter() - t0
        if not lead:
            return
        s = harness.summary(res)
        last = res.solves[-1]
        # the program's own reading of its stopping test, and the one
        # before the last step (Newton's history; None for a linear solve)
        own = dict(own_residual=float(last.residual_norm),
                   steps=getattr(last, "outer_iterations", None)
                   or last.iterations,
                   own_previous=(float(last.history[-2])
                                 if len(getattr(last, "history", [])) > 1
                                 else None))
        u, ne = res.u, res.mesh.n_elements
        del res
        brick = Brick.build(level, deg, device=device)
        if ne != brick.N**3:
            raise ValueError(f"{ne} elements, not the level-{level} brick")
        nums = job.kind.reference(job.data(k + 1), job.sections).numbers(
            brick, u, s["l2"])
        rows.append(dict(side=side, problem=k, wall_s=wall,
                         krylov_iters=s["krylov_iters"], **own, **nums))
        out(json.dumps(rows[-1]))

    for k in range(len(job.order)):
        judge("program", k)
    with stopped_early():
        for k in range(early):
            judge("early", k)
    for k in range(control if lead else 0):
        ref = job.kind.reference(job.data(k + 1), job.sections)
        b32 = Brick.build(level, deg, dtype=torch.float32, device=device)
        u32, l2_32 = ref.solve(b32)
        brick = Brick.build(level, deg, device=device)
        rows.append(dict(side="control", problem=k,
                         **ref.numbers(brick, u32, l2_32)))
        out(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--early", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path
                   if pathlib.Path(p or ".").resolve() != ROOT / "benchmark"]
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, ranks

    n = int(harness.load_cell(args.workload)[0].get("chips", 1))
    if n > 1 and not ranks.is_rank():
        return ranks.launch(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--workload", args.workload, "--control", str(args.control),
             "--early", str(args.early), "--device", args.device], n,
            t_start=time.perf_counter())
    if n > 1:
        as_rank(args.workload, args.control, args.device, early=args.early)
    readings(args.workload, args.control, args.device, early=args.early)
    return 0


def as_rank(name, control, device, cell=None, early=0):
    """`readings` as one rank of a launched world; ends the process (as
    `ranks.run_rank` does)."""
    from benchmark import ranks

    rank, _, _ = ranks.enter(device)
    readings(name, control, device, cell=cell, early=early, lead=rank == 0,
             out=print if rank == 0 else (lambda s: None))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    raise SystemExit(main())
