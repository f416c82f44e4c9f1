#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`disco4est_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and `nvcc`.  Phases, one or more lines each; any failure exits non-zero:

1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
2. the build of the CUDA kernel from `disco4est_tpu_torch/csrc/`;
3. the kernel against its plain PyTorch version and against the f64
   GEMM-form apply, on bricks of several degrees and levels, the shapes
   of phases 4 and 5 among them (rel ≤ 5e-6), with the median time per
   apply of kernel and plain version at deg 7 / level 4;
4. the reference sinx regression through the port's CLI entry on the
   card: the printed line, the L2 error, a solve that went through the
   kernel and no f64 fallback;
5. sinx at deg 3 on a level-5 brick (32768 elements, 2,097,152 DOF),
   once through the kernel (`use_structured = auto`), once through the
   generic f32 apply (`use_structured = 0`) and once as a plain f64 FCG
   solve (`use_mixed_precision = 0`).  The kernel solve must not fall
   back to the f64 solver.  All three solve the same f64
   system to the residual floor (atol 5e-15), so their L2 errors must
   agree with each other to 1e-7 relative (solve-floor spread: a few
   1e-9), and each must match the JAX driver's value to 1e-5 relative.
   That value was computed with numpy 2.0.2, whose Gauss-Legendre
   weights differ by up to 2 ulp from those of numpy 2.3; the error here
   is only 4.5e-10, and those last bits alone move it by 1.1e-6
   relative.  An operator fault moves it by orders more.

Then one JSON line per kernel (`{"kernels": [...]}`) and, last, the
result line `{"ok": true, "device": {...}}`.  Without a CUDA device the
script fails before printing any result.
"""

import contextlib
import io
import json
import subprocess
import sys
import time

REL_TOL = 5e-6  # f32 kernel vs plain / f64, as `tests/test_structured.py`
SINX_LINE = "64 512 512 0.02441355792354"
SINX_L2 = 0.024413557923538  # JAX driver, `tests/test_driver.py:59`
LEVEL5_L2 = 4.483648876761e-10  # JAX CLI (CPU), deg 3, level 5
LEVEL5_REL = 1e-5  # against the JAX value: numpy's Gauss weights, phase 5
LEVEL5_SPREAD = 1e-7  # between the three solves on this machine
CASES = [  # (deg, level, x1): nblk 1 on cubes, 3 on the non-cubic brick;
    # (1, 2) and (3, 5) are the shapes phases 4 and 5 run, and (3, 5) has
    # the z-offset 1024 that the Pallas kernel's window cannot reach
    (1, 2, (1.0, 1.0, 1.0)), (2, 1, (1.0, 1.0, 1.0)),
    (7, 1, (1.0, 1.0, 1.0)), (3, 2, (1.0, 1.0, 1.0)),
    (7, 4, (1.0, 1.0, 1.0)), (3, 5, (1.0, 1.0, 1.0)),
    (2, 1, (1.0, 2.0, 4.0)),
]
TIMED_CASE = (7, 4)

SINX_OPTIONS = """
[initial_mesh]
min_level = {level}
region0_deg = {deg}
region0_deg_quad_inc = 0

[mesh_parameters]
face_h_type = FACE_H_EQ_VOLUME_DIV_AREA
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
name = brick
X0 = 0.0
X1 = 1.0
Y0 = 0.0
Y1 = 1.0
Z0 = 0.0
Z1 = 1.0

[d4est_solver_krylov_petsc]
ksp_type = fcg
ksp_atol = 5e-15
use_structured = {use_structured}
use_mixed_precision = {mixed}

[quadrature]
name = legendre
"""


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    print(f"[1] device: {name} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return name, card


def phase_build():
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.util import cuda_build

    t0 = time.perf_counter()
    S._load()
    secs = time.perf_counter() - t0
    lib = cuda_build.library_path(S.SOURCE)
    print(f"[2] built {lib.name} in {secs:.1f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())


def _time_ms(torch, fn, reps):
    """Median milliseconds of `fn()` over `reps` runs, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_kernel(torch, np, card):
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.laplacian.fast import _apply_orth
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    dev = torch.device("cuda")
    max_abs = 0.0
    timing = None
    for deg, level, x1 in CASES:
        geom = BrickGeometry(x1=x1, dim=3)
        mesh = build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                          device=dev)
        sb = S.build_structured(mesh)
        check(sb is not None, f"no structured view at deg {deg} level {level}")
        E = mesh.n_elements
        rng = np.random.default_rng(1000 * deg + level)
        u = torch.as_tensor(rng.standard_normal((E, sb.nv)),
                            dtype=torch.float32, device=dev)
        out = S.apply_structured(sb, u)
        ref = S.apply_structured_plain(sb, u)
        torch.cuda.synchronize()
        nl = deg + 1
        ref64 = S.to_lex(sb, _apply_orth(
            mesh, S.from_lex(sb, u.double()).reshape((E,) + (nl,) * 3)
        ).reshape(E, -1))
        abs_err = float((out - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        rel64 = float((out.double() - ref64).abs().max()
                      / ref64.abs().max())
        max_abs = max(max_abs, abs_err)
        print(f"[3] deg {deg} level {level} x1 {x1} E {E} nblk {sb.nblk} "
              f"offsets {sb.deltas}: "
              f"kernel vs plain rel {rel:.3e} (abs {abs_err:.3e}), "
              f"vs f64 rel {rel64:.3e}")
        check(np.isfinite(rel) and rel <= REL_TOL,
              f"kernel disagrees with plain: rel {rel}")
        check(np.isfinite(rel64) and rel64 <= REL_TOL,
              f"kernel disagrees with f64 apply: rel {rel64}")
        if (deg, level) == TIMED_CASE and x1 == (1.0, 1.0, 1.0):
            tr = S.compute_traces_lex(sb, u).contiguous()
            for _ in range(3):  # warm-up
                S.lex_apply_cuda(sb, u, tr)
                S.lex_apply_plain(sb, u, tr)
            torch.cuda.synchronize()
            kern, plain, kern_full, plain_full = [], [], [], []
            for _ in range(4):  # alternate plain and kernel
                plain.append(_time_ms(torch, lambda: S.lex_apply_plain(sb, u, tr), 10))
                kern.append(_time_ms(torch, lambda: S.lex_apply_cuda(sb, u, tr), 10))
                kern_full.append(_time_ms(torch, lambda: S.apply_structured(sb, u), 10))
                plain_full.append(_time_ms(torch, lambda: S.apply_structured_plain(sb, u), 10))
            med = lambda v: sorted(v)[len(v) // 2]
            flop = 2.0 * E * sb.nv * (sb.nblk * sb.nv + 12 * nl * nl)
            timing = dict(ms=med(kern), plain_ms=med(plain))
            print(f"[3] timing deg {deg} level {level} (E {E}) on {card}: "
                  f"fused pass kernel {timing['ms']:.4f} ms "
                  f"({flop / timing['ms'] / 1e9:.2f} TFLOP/s) vs plain "
                  f"{timing['plain_ms']:.4f} ms; whole apply (with the "
                  f"trace GEMM) kernel {med(kern_full):.4f} ms vs plain "
                  f"{med(plain_full):.4f} ms")
    check(timing is not None, "timed case missing")
    return max_abs, timing


def run_cli(opts_text, torch):
    """The port's CLI entry on the card; returns its stdout lines and the
    kernel launches it made."""
    from disco4est_tpu_torch import __main__ as cli
    from disco4est_tpu_torch.laplacian import structured as S

    S.KERNEL_LAUNCHES = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main([opts_text, "--problem=sinx", "--device=cuda"])
    torch.cuda.synchronize()
    launches = S.KERNEL_LAUNCHES
    check(code == 0, f"CLI exit code {code}")
    lines = buf.getvalue().splitlines()
    check(len(lines) >= 2 and lines[1].startswith("solve level 0:"),
          f"unexpected CLI output {lines}")
    fields = dict(kv.split("=", 1) for kv in lines[1].split()[3:])
    return lines, fields, launches


def phase_regression(torch):
    text = SINX_OPTIONS.format(level=2, deg=1, use_structured="auto",
                               mixed=1)
    lines, fields, launches = run_cli(text, torch)
    print(f"[4] {lines[0]}")
    print(f"[4] {lines[1]}; kernel launches {launches}")
    check(lines[0] == SINX_LINE, f"sinx line {lines[0]!r} != {SINX_LINE!r}")
    l2 = float(lines[0].split()[3])
    check(abs(l2 - SINX_L2) <= 1e-12, f"sinx L2 {l2} vs {SINX_L2}")
    check(fields["path"] == "mixed-structured",
          f"solve path {fields['path']}")
    check(launches > 0, "the sinx solve never launched the kernel")
    check(fields["fallback"] == "no", "the f64 fallback ran")


def phase_real_size(torch):
    runs = {}
    for mode, mixed in (("auto", 1), ("0", 1), ("0", 0)):
        text = SINX_OPTIONS.format(level=5, deg=3, use_structured=mode,
                                   mixed=mixed)
        tag = f"use_structured={mode} use_mixed_precision={mixed}"
        t0 = time.perf_counter()
        lines, fields, launches = run_cli(text, torch)
        wall = time.perf_counter() - t0
        l2 = float(lines[0].split()[3])
        rel = abs(l2 - LEVEL5_L2) / LEVEL5_L2
        print(f"[5] {tag}: {lines[0]} (rel to JAX {rel:.3e})")
        print(f"[5] {tag}: {lines[1]}; kernel launches {launches}; "
              f"CLI wall {wall:.2f} s")
        if fields["fallback"] != "no":
            print(f"[5] {tag}: the f64 fallback ran")
        check(rel <= LEVEL5_REL,
              f"level-5 L2 {l2} vs {LEVEL5_L2} (rel {rel})")
        runs[(mode, mixed)] = (fields, launches, l2)
    l2s = [r[2] for r in runs.values()]
    spread = (max(l2s) - min(l2s)) / LEVEL5_L2
    print(f"[5] spread of the three L2 errors: {spread:.3e} relative")
    check(spread <= LEVEL5_SPREAD, f"level-5 solves disagree: {l2s}")
    fields, launches, _ = runs[("auto", 1)]
    check(fields["path"] == "mixed-structured",
          f"level-5 auto path {fields['path']}")
    check(launches > 0, "the level-5 solve never launched the kernel")
    # a fallback would take the L2 from the plain f64 solve, not the kernel
    check(fields["fallback"] == "no",
          "the level-5 kernel solve fell back to the f64 solver")
    check(runs[("0", 1)][1] == 0 and runs[("0", 0)][1] == 0,
          "use_structured = 0 launched the kernel")
    return launches


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    # IEEE f32 products: TF32 makes the inner CG diverge
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import disco4est_tpu_torch  # noqa: F401  (fails outside a checkout)

    name, card = phase_device(torch)
    phase_build()
    max_abs, timing = phase_kernel(torch, np, card)
    phase_regression(torch)
    launches = phase_real_size(torch)

    print(json.dumps({"kernels": [{
        "name": "structured_apply",
        "route": "cuda",
        "source": "disco4est_tpu_torch/csrc/structured_apply.cu",
        "replaces": "disco4est_tpu/laplacian/structured.py:190",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
