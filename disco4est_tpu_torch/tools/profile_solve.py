"""Where the time of a sinx solve goes: solve wall, device busy, idle share.

From the root of a checkout:

    python -m disco4est_tpu_torch.tools.profile_solve [--geometry brick]
        [--level 5] [--deg 3] [--rounds 2] [--device cuda|cpu]

solves the reference sinx problem (the options of `chip_smoke.py`) on a
uniform mesh of that level and degree, through the fast inner apply of
the mesh (`use_structured = auto`: the structured kernel on the brick,
the tree-structured curved apply on the sphere) and through the generic
f32 apply (`use_structured = 0`), in alternating order.  `--geometry
sphere7` takes the 7-tree sphere of `chip_smoke.py` phase 10 (b) (R0 = 1,
R1 = 2, the pointwise penalty; default level 4, 1,835,008 DOF at deg 3);
the brick's default level is 5 (2,097,152 DOF).  Each (round, path): one
warm-up solve, three unprofiled solves (their solve wall,
`SolveInfo.seconds`), then one solve under `torch.profiler` with the solve
(`mixed_refine_solve`) wrapped in a `record_function("solve")` window.

Device busy is the union of the device intervals (kernels, copies) inside
that window, the annotation itself left out; idle share = 1 - device busy
/ median unprofiled solve wall, so the profiler's own host cost is not in
the denominator.  Each line also gives the device time, launch count and
mean of the fused SIPG kernel, and the five largest device-time rows by
name.  On the CPU there are no device intervals: the lines then say so.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from disco4est_tpu_torch import driver
from disco4est_tpu_torch.problems.poisson import SinxProblem
from disco4est_tpu_torch.util.config import Options

OPTIONS = """
[initial_mesh]
min_level = {level}
region0_deg = {deg}
region0_deg_quad_inc = 0
[mesh_parameters]
face_h_type = {face_h}
volume_h_type = VOL_H_EQ_CUBE_APPROX
max_degree = 7
[flux]
name = sipg
sipg_penalty_prefactor = 2.0
sipg_flux_h = H_EQ_VOLUME_DIV_AREA
sipg_penalty_fcn = maxp_sqr_over_minh
[amr]
scheme = uniform_p
num_of_amr_steps = 0
[geometry]
{geometry}
[d4est_solver_krylov_petsc]
ksp_type = fcg
ksp_atol = 5e-15
use_structured = {use_structured}
use_mixed_precision = 1
[quadrature]
name = legendre
"""
GEOMETRIES = {  # name: ([geometry] section, face_h_type, default level)
    "brick": ("name = brick", "FACE_H_EQ_VOLUME_DIV_AREA", 5),
    "sphere7": ("name = cubed_sphere_7tree\nr0 = 1.0\nr1 = 2.0",
                "FACE_H_EQ_J_DIV_SJ_QUAD", 4),
}
KERNEL = "sipg_gemm_kernel"
WINDOW = "solve"


@contextlib.contextmanager
def _solve_window():
    """Wrap the driver's solve in a `record_function` window."""
    inner = driver.mixed_refine_solve

    def wrapped(*args, **kwargs):
        with record_function(WINDOW):
            return inner(*args, **kwargs)

    driver.mixed_refine_solve = wrapped
    try:
        yield
    finally:
        driver.mixed_refine_solve = inner


def _union(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def device_summary(events):
    """(busy µs, {name: (µs, count)}) of the device events inside the
    solve window."""
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    marks = [e for e in dev if e.name == WINDOW] or [
        e for e in events if e.name == WINDOW]
    if not marks:
        return 0.0, {}
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    spans, by_name = [], collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        if e.name == WINDOW:
            continue
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b > a:
            spans.append((a, b))
            by_name[e.name][0] += b - a
            by_name[e.name][1] += 1
    return _union(spans), dict(by_name)


def _solve(opts, device):
    with contextlib.redirect_stdout(io.StringIO()):
        res = driver.run_poisson(opts, SinxProblem, device=device)
    return res.solves[0]


def run(geometry, level, deg, mode, device):
    section, face_h, _ = GEOMETRIES[geometry]
    opts = Options.load(OPTIONS.format(level=level, deg=deg,
                                        use_structured=mode,
                                        geometry=section, face_h=face_h))
    _solve(opts, device)  # warm-up
    walls = sorted(_solve(opts, device).seconds for _ in range(3))
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with _solve_window(), profile(activities=acts) as prof:
        info = _solve(opts, device)
    busy_us, by_name = device_summary(prof.events())
    wall = walls[1]
    kern_us, kern_n = (0.0, 0)
    for name, (us, n) in by_name.items():
        if KERNEL in name:
            kern_us, kern_n = kern_us + us, kern_n + n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    line = (f"use_structured={mode}: path={info.path} outer="
            f"{info.outer_iterations} iterations={info.iterations}; "
            f"unprofiled solve wall {', '.join(f'{w:.4f}' for w in walls)} s")
    if not by_name:
        return line + "; no device intervals (not a device run)"
    line += (f"; device busy {busy_us / 1e6:.4f} s, idle share "
             f"{1 - busy_us / 1e6 / wall:.3f}; fused SIPG kernel "
             f"{kern_us / 1e3:.2f} ms over {kern_n} launches")
    if kern_n:
        line += f" ({kern_us / kern_n:.1f} us each)"
    return line + "; top: " + "; ".join(
        f"{name[:60]} {us / 1e3:.2f} ms ({n})" for name, (us, n) in top)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES),
                    default="brick")
    ap.add_argument("--level", type=int, default=None,
                    help="default: 5 on the brick, 4 on the sphere")
    ap.add_argument("--deg", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    level = (GEOMETRIES[args.geometry][2] if args.level is None
             else args.level)
    device = driver.resolve_device(args.device).type
    name = (torch.cuda.get_device_name(0) if device == "cuda" else "cpu")
    print(f"profile_solve geometry={args.geometry} level={level} "
          f"deg={args.deg} device={name}")
    for r in range(args.rounds):
        modes = ("auto", "0") if r % 2 == 0 else ("0", "auto")
        for mode in modes:
            line = run(args.geometry, level, args.deg, mode, device)
            print(f"round {r}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
