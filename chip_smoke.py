#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`disco4est_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and `nvcc`.  Phases, one or more lines each; any failure exits non-zero:

1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
2. the build of the three CUDA kernels from `disco4est_tpu_torch/csrc/`
   (one `nvcc` each, all started together), with their register,
   shared-memory and spill lines, and the count of tensor-core
   instructions (HGMMA/HMMA) in each SIPG library's SASS, which must not
   be 0 (B1 and B2 run split-TF32 `wgmma` products);
3. B1, the structured kernel, against its plain PyTorch version and
   against the f64 GEMM-form apply, on bricks of several degrees and
   levels, the shapes of phases 4 and 5 among them (rel ≤ 5e-6), with the
   median time per apply of kernel and plain version at deg 7 / level 4
   and deg 3 / level 5, each against two bounds: f32 FFMA and split-TF32
   (three TF32 tensor-core products per f32 product);
4. the reference sinx regression through the port's CLI entry on the
   card: the printed line, the L2 error, a solve that went through the
   kernel and no f64 fallback;
5. sinx at deg 3 on a level-5 brick (32768 elements, 2,097,152 DOF),
   once through the kernel (`use_structured = auto`), once through the
   generic f32 apply (`use_structured = 0`) and once as a plain f64 FCG
   solve (`use_mixed_precision = 0`).  The kernel solve must not fall
   back to the f64 solver, and its inner iteration count must stay within
   2 % of the 1062 that the earlier IEEE-f32 FFMA tile code took (the
   split-TF32 products must not slow the inner CG).  All three solve the
   same f64 system to the residual floor (atol 5e-15), so their L2 errors must
   agree with each other to 1e-7 relative (solve-floor spread: a few
   1e-9), and each must match the JAX driver's value to 1e-6 relative.
   That value was computed with numpy 2.0.2.  The Gauss and
   Gauss-Lobatto rules numpy computes move by up to 33 ulp between
   versions, and the error here is only 4.5e-10, so the port reads its
   rules from a table written under numpy 2.0.2 (`ops/gauss_table.py`,
   ROADMAP C9); with numpy 2.3's own rules the digit moved by 1.1e-6
   relative.  An operator fault moves it by orders more;
6. B2, the gathered fused kernel, against its plain version and the f64
   apply (rel ≤ 5e-6) on the meshes of `tests/test_pallas_sipg.py`, deg 7
   / level 4, deg 3 / level 5, a multi-tree brick (not in lex order), a
   ragged one and an 18-tree one, then timed at both sizes of phase 3:
   fused pass (kernel, plain), the whole `apply_sipg_fused` and the f32
   GEMM-form apply;
7. B3, the three-axis kernel, against its plain version (rel ≤ 1e-5),
   timed with the plain version and one `torch.einsum` call at E 4096
   (the probe's size, L2-resident) and E 32768 (above the 50 MB L2);
8. the two kernel-timing tools end to end on the card
   (`tools.time_fused` in its three modes at deg 7 / level 4 and mode
   fused at deg 3 / level 5, `tools.exp_kernel_design`), their lines
   echoed; B1, B2 and B3 must each have launched there, the tools' own
   error lines must be within the tolerances above, and TF32 must be off
   again afterwards;
9. the AMR loop through the CLI entry (`run_poisson`'s epochs: mesh
   build, solve, estimate, mark, refine + balance, field transfer), one
   line per epoch with its elements, DOF, degree histogram, hanging
   faces, solve path and iterations, B1 launches, L2 error and the host
   seconds of mesh build (face tables), solve, estimator and AMR step
   (refine + balance), timed here around the driver's calls:
   (a) uniform_h from level 4 at deg 3 (4096 then 32768 elements), its
       level-4 L2 held to the JAX value and its level-5 L2 to `LEVEL5_L2`
       and to phase 5's, with B1's device time in it (launches times the
       batched time per launch);
   (b) uniform_p from level 4, deg 3 to 5 (4096 elements);
   (c) hp smooth_pred from level 3, deg 2, max_degree 4, three steps,
       whose forests, degree histograms and L2 errors must equal the JAX
       driver's (`refcheck/amr_smoke_pins.py`);
   (d) the same from level 4, two steps, at an adaptive size without a
       JAX pin: the error falls every level, degrees above 2 and hanging
       faces appear, no f64 fallback, every residual below
       1e-10·(1 + ‖b‖).
   Every epoch on a uniform brick at one degree must take the kernel
   path with B1 launches; (a) and (b) have only such epochs, (c) and (d)
   also hanging and mixed-degree ones;
10. the curved path (torch operations; no hand-written kernel runs on it,
   and the three kernels' counts, set to 0 before, must stay 0), one line
   per epoch as in phase 9 plus the seconds of the tree-structured view,
   with the JAX pins of `refcheck/curved_smoke_pins.py`:
   (a) the Lorentzian regression on the 13-tree sphere (R0 10, R1 20, R2
       1000, compactified outer shell; level 1, deg 1, the pointwise
       FACE_H_EQ_J_DIV_SJ_QUAD penalty) through the CLI entry: the JAX
       driver's norm line through the curved mixed solve, then plain f64
       CG at atol 1e-15 through the API: the reference digit
       2706.02899845 to 1e-10;
   (b) sinx on the 7-tree sphere (R0 1, R1 2, pointwise penalty) at deg
       3, uniform_h from level 3 to 4 (3584 -> 28672 elements, 229,376 ->
       1,835,008 DOF): both epochs through `mixed-curved` with no
       fallback, level 3's L2 within 1e-6 of JAX, level 4's within 1e-7
       of a plain f64 FCG solve of the same mesh and 8x below level 3's;
   (c) the compactified 13-tree sphere at level 3, deg 4 (6656 elements,
       832,000 DOF; the sphere row of `bench.py:350-417`): the
       tree-structured apply against the general apply to 1e-12 in f64,
       both within 1e-5 of it in f32, both timed in f32 against the bytes
       bound of `bench.py:398-405` (4 bytes a word over 3.35 TB/s);
   (d) hp smooth_pred on the 7-tree sphere from level 1, deg 2,
       max_degree 4, two steps: forest digests, degree histograms and L2
       equal to the JAX driver's (hanging faces across reoriented tree
       faces, the estimator's permutations, a mixed-degree epoch).

Then one JSON line of the kernels (`{"kernels": [...]}`; B1 and B2 once
per timed size, each with the launches of a run at that size: phase 5
for B1 at deg 3 / level 5, phase 8 for the rest) and, last, the result line
`{"ok": true, "device": {...}}`.  Without a CUDA device the script fails
before printing any result.
"""

import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys
import time

REL_TOL = 5e-6  # f32 kernel vs plain / f64, as `tests/test_structured.py`
SINX_LINE = "64 512 512 0.02441355792354"
SINX_L2 = 0.024413557923538  # JAX driver, `tests/test_driver.py:59`
LEVEL5_L2 = 4.483648876761e-10  # JAX CLI (CPU), deg 3, level 5
LEVEL5_REL = 1e-6  # against the JAX value (phase 5, ROADMAP C9)
LEVEL5_SPREAD = 1e-7  # between the three solves on this machine
LEVEL5_INNER = 1062  # inner CG iterations of the kernel solve, FFMA kernel
LEVEL5_INNER_REL = 0.02
# phase 9, the AMR runs: [initial_mesh] min_level, region0_deg,
# [mesh_parameters] max_degree, [amr] scheme, num_of_amr_steps
AMR_RUNS = {
    "a": dict(level=4, deg=3, max_degree=3, scheme="uniform_h", steps=1),
    "b": dict(level=4, deg=3, max_degree=5, scheme="uniform_p", steps=2),
    "c": dict(level=3, deg=2, max_degree=4, scheme="smooth_pred", steps=3),
    "d": dict(level=4, deg=2, max_degree=4, scheme="smooth_pred", steps=2),
}
# (elements, DOF, degree histogram, L2) per level from the JAX driver on
# the CPU with numpy 2.0.2 (`python refcheck/amr_smoke_pins.py`); run (a)'s
# level 5 is LEVEL5_L2, (d) has no pin
AMR_PINS = {
    "a": [(4096, 262144, {3: 4096}, 1.6362252134483867e-08)],
    "b": [(4096, 262144, {3: 4096}, 1.6362252134483867e-08),
          (4096, 512000, {4: 4096}, 1.064237334762837e-09),
          (4096, 884736, {5: 4096}, 7.425078891216997e-13)],
    "c": [(512, 13824, {2: 512}, 0.0002051858857341539),
          (1520, 41040, {2: 1520}, 0.00010726299926583374),
          (4040, 258560, {2: 4016, 3: 24}, 1.8071305443427726e-05),
          (4096, 262144, {2: 3064, 3: 1032}, 1.3531952590467783e-05)],
}
AMR_REL = 1e-5  # L2 against the JAX pins, as LEVEL5_REL
CASES = [  # (deg, level, x1): nblk 1 on cubes, 3 on the non-cubic brick;
    # (1, 2) and (3, 5) are the shapes phases 4 and 5 run, and (3, 5) has
    # the z-offset 1024 that the Pallas kernel's window cannot reach
    (1, 2, (1.0, 1.0, 1.0)), (2, 1, (1.0, 1.0, 1.0)),
    (7, 1, (1.0, 1.0, 1.0)), (3, 2, (1.0, 1.0, 1.0)),
    (7, 4, (1.0, 1.0, 1.0)), (3, 5, (1.0, 1.0, 1.0)),
    (2, 1, (1.0, 2.0, 4.0)),
]
# B1 and B2 are timed at both sizes: deg 7 / level 4 (the tools' size) and
# deg 3 / level 5 (the main path's solve, phase 5)
TIMED_CASES = ((7, 4), (3, 5))
# B2 (deg, level, x1, trees per axis): the cases of
# `tests/test_pallas_sipg.py:23,41`, the two timed sizes, a multi-tree
# brick (tree-major element order, not lex), a ragged brick (E = 24, below
# one 64-element tile) and an 18-tree brick (tree ids past 15, which the
# old packed leaf key wrapped)
FUSED_CASES = [
    (2, 1, (1.0, 1.0, 1.0), (1, 1, 1)), (3, 1, (1.0, 1.0, 1.0), (1, 1, 1)),
    (7, 1, (1.0, 1.0, 1.0), (1, 1, 1)), (3, 1, (2.0, 1.0, 0.5), (1, 1, 1)),
    (7, 4, (1.0, 1.0, 1.0), (1, 1, 1)), (3, 5, (1.0, 1.0, 1.0), (1, 1, 1)),
    (3, 3, (2.0, 2.0, 2.0), (2, 2, 2)), (7, 1, (3.0, 1.0, 1.0), (3, 1, 1)),
    (3, 1, (3.0, 3.0, 2.0), (3, 3, 2)),
]
AXIS_TOL = 1e-5  # B3 vs plain: three 8-term f32 sums in another order
# phase 10, the curved path (`refcheck/curved_smoke_pins.py` prints the JAX
# values, CPU, numpy 2.0.2)
LORENTZIAN_LINE = "104 832 832 2705.574132653"
LORENTZIAN_DIGIT = 2706.02899845001593  # reference harness, plain CG
#                 (`tests/test_regression_digits.py:28-62`)
LORENTZIAN_DIGIT_REL = 1e-10
SPHERE_L3_L2 = 0.0002801140152682737  # (b) level 3
SPHERE_L3_REL = 1e-6
SPHERE_L4_REL = 1e-7  # (b) level 4 against a plain f64 FCG solve
SPHERE_SMOOTH_PRED = [  # (d): elements, DOF, degrees, L2, forest digest
    (56, 1512, {2: 56}, 0.49036843372718597, "b5790d9fd145689c"),
    (224, 6048, {2: 224}, 0.07994182984006958, "7fb481aac21d5c90"),
    (224, 14336, {2: 152, 3: 72}, 0.09730795014269668, "7fb481aac21d5c90"),
]
SPHERE_SMOOTH_PRED_REL = 1e-9
CURVED_F64_TOL = 1e-12  # (c) tree-structured vs general apply
CURVED_F32_TOL = 1e-5
AXIS_SIZES = (4096, 32768)
# H100 SXM data sheet at 700 W: f32 FFMA peak, dense TF32 tensor-core
# peak and HBM3 rate
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
SPLIT_PRODUCTS = 3  # the split-TF32 scheme issues three TF32 products

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


# phase 10: the options of `refcheck/curved_smoke_pins.py`, with the solve
# settings of the CLI runs
CURVED_OPTIONS = """
[initial_mesh]
min_level = {level}
region0_deg = {deg}
region0_deg_quad_inc = 0

[mesh_parameters]
face_h_type = FACE_H_EQ_J_DIV_SJ_QUAD
volume_h_type = VOL_H_EQ_CUBE_APPROX
max_degree = {max_degree}

[flux]
name = sipg
sipg_penalty_prefactor = 2.0
sipg_penalty_fcn = maxp_sqr_over_minh

[amr]
scheme = {scheme}
num_of_amr_steps = {steps}
percentile = 25
gamma_h = 10.0
gamma_p = 0.1
gamma_n = 1.0

[geometry]
{geometry}

[d4est_solver_krylov_petsc]
ksp_type = fcg
ksp_atol = 5e-15
use_structured = auto
use_mixed_precision = {mixed}

[quadrature]
name = legendre
"""
SPHERE13 = """name = cubed_sphere
r0 = 10.0
r1 = 20.0
r2 = 1000.0
compactify_outer_shell = 1"""
SPHERE7 = """name = cubed_sphere_7tree
r0 = 1.0
r1 = 2.0"""
CURVED_RUNS = {
    "a": dict(level=1, deg=1, max_degree=1, scheme="uniform_p", steps=0,
              geometry=SPHERE13, mixed=1),
    "b": dict(level=3, deg=3, max_degree=3, scheme="uniform_h", steps=1,
              geometry=SPHERE7, mixed=1),
    "b64": dict(level=4, deg=3, max_degree=3, scheme="uniform_h", steps=0,
                geometry=SPHERE7, mixed=0),
    "d": dict(level=1, deg=2, max_degree=4, scheme="smooth_pred", steps=2,
              geometry=SPHERE7, mixed=1),
}


# the options of `refcheck/amr_smoke_pins.py`, with the solve settings
# above
AMR_OPTIONS = SINX_OPTIONS.replace(
    "max_degree = 7", "max_degree = {max_degree}").replace(
    "scheme = uniform_p\nnum_of_amr_steps = 0",
    "scheme = {scheme}\nnum_of_amr_steps = {steps}\npercentile = 25\n"
    "gamma_h = 10.0\ngamma_p = 0.1\ngamma_n = 1.0")
assert AMR_OPTIONS.count("{scheme}") == 1


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
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.tools import exp_kernel_design as X
    from disco4est_tpu_torch.util import cuda_build

    mods = (S, fused, X)
    secs = cuda_build.build_all([m.SOURCE for m in mods])
    for m in mods:
        m._load()
        lib = cuda_build.library_path(m.SOURCE)
        print(f"[2] built {lib.name} in {secs[m.SOURCE]:.1f} s")
        log = lib.with_suffix(".log").read_text().splitlines()
        seen = []
        for line in log:
            line = line.split(":", 1)[-1].strip()
            if ("registers" in line or "spill" in line) and line not in seen:
                seen.append(line)
        for line in seen:
            print("    ptxas:", line)
        if m is not X:  # the two SIPG libraries run on the tensor cores
            n = tensor_core_instructions(cuda_build, lib)
            print(f"[2] {lib.name}: {n} tensor-core instructions "
                  f"(HGMMA/HMMA) in cuobjdump -sass")
            check(n > 0, f"{lib.name} has no tensor-core instruction")


def tensor_core_instructions(cuda_build, lib):
    """The count of HGMMA and HMMA instructions in the library's SASS."""
    tool = pathlib.Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr[-2000:]}")
    return len(re.findall(r"\bH(?:GMMA|MMA)\.", proc.stdout))


def bound_ms(flop, nbytes, split=False):
    """The least time of the work on the card (data-sheet peaks): the
    larger of bytes over the memory rate and flop over the f32 FFMA peak
    or, with `split`, three times the flop over the dense TF32 peak (the
    split-TF32 products); returns (ms, what sets it)."""
    t_ops = (SPLIT_PRODUCTS * flop / PEAK_TF32 if split
             else flop / PEAK_F32)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sipg_timing(torch, label, card, fns, flop, nbytes):
    """Time the fused SIPG pass `fns["kernel"]` against the other entries
    of `fns` in alternating rounds, print both bounds and the share of
    each, and return the kernel line's numbers (share of record: the
    split-TF32 bound)."""
    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    t = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]) * 2:  # alternate rounds
        for k in order:
            t[k].append(_time_ms(torch, fns[k]))
    t = {k: _median(v) for k, v in t.items()}
    ms = t["kernel"]
    b_ffma, by_ffma = bound_ms(flop, nbytes)
    b_split, by_split = bound_ms(flop, nbytes, split=True)
    others = ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()
                       if k != "kernel")
    print(f"{label} on {card}: fused pass kernel {ms:.4f} ms "
          f"({flop / ms / 1e9:.2f} TFLOP/s); split-TF32 bound "
          f"{b_split:.4f} ms by {by_split} ({b_split / ms:.1%} of it), "
          f"FFMA bound {b_ffma:.4f} ms by {by_ffma} ({b_ffma / ms:.1%}); "
          f"{others}")
    return t, dict(ms=ms, plain_ms=t["plain"], bound_ms=b_split,
                   bound_by=by_split, bound_ffma_ms=b_ffma,
                   bound_ffma_by=by_ffma)


def sipg_pass_cost(E, nv, nblk, tw, extra_bytes=0):
    """Flop and bytes of the fused SIPG pass: the two GEMMs as one of depth
    nblk·nv + tw; u, traces, cw, scal and the weights read once, Au written
    once (f32), plus `extra_bytes` of tables."""
    flop = 2.0 * E * nv * (nblk * nv + tw)
    nbytes = 4 * (2 * E * nv + E * tw + E * nblk + E * 24
                  + nv * nblk * nv + tw * nv) + extra_bytes
    return flop, nbytes


def _median(v):
    return sorted(v)[len(v) // 2]


_SPIN = [1 << 20]  # cycles of the spin kernel ahead of each timed batch


def _time_ms(torch, fn, n=10, reps=3):
    """Median over `reps` of the mean device milliseconds of `n`
    back-to-back `fn()` calls, CUDA events.  A spin kernel
    (`torch.cuda._sleep`) holds the card while the host enqueues the n
    calls, so the events bracket device time only, not the host's launch
    path (0.03-0.25 ms per call on an H100 machine, more than a small
    kernel takes).  The spin doubles until it outlasts the enqueue."""
    times = []
    while len(times) < reps:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(_SPIN[0])
        ev[1].record()
        for _ in range(n):
            fn()
        ev[2].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].synchronize()
        spin_ms = ev[0].elapsed_time(ev[1])
        if spin_ms < host_ms:  # the card waited on us
            check(_SPIN[0] < 1 << 34, "the host cannot keep ahead of the "
                  f"card even behind a long spin ({spin_ms:.1f} ms spin, "
                  f"{host_ms:.1f} ms to enqueue {n} calls)")
            _SPIN[0] *= 2
            continue
        times.append(ev[1].elapsed_time(ev[2]) / n)
    return _median(times)


def phase_kernel(torch, np, card):
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.laplacian.fast import _apply_orth
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    dev = torch.device("cuda")
    max_abs = 0.0
    timing = {}
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
        if (deg, level) in TIMED_CASES and x1 == (1.0, 1.0, 1.0):
            tr = S.compute_traces_lex(sb, u).contiguous()
            fns = {
                "plain": lambda: S.lex_apply_plain(sb, u, tr),
                "kernel": lambda: S.lex_apply_cuda(sb, u, tr),
                "whole apply (with the trace GEMM)":
                    lambda: S.apply_structured(sb, u),
                "whole plain apply": lambda: S.apply_structured_plain(sb, u),
            }
            flop, nbytes = sipg_pass_cost(E, sb.nv, sb.nblk, 12 * nl * nl)
            _, timing[(deg, level)] = sipg_timing(
                torch, f"[3] timing deg {deg} level {level} (E {E})", card,
                fns, flop, nbytes)
    check(set(timing) == set(TIMED_CASES), "timed case missing")
    return max_abs, timing


def run_cli(opts_text, torch, problem="sinx"):
    """The port's CLI entry on the card.  Returns its norm lines and solve
    lines (one each per level), the key=value fields of each solve line
    and the B1 launches the run made; checks that the convergence fit
    follows when there are two or more levels."""
    from disco4est_tpu_torch import __main__ as cli
    from disco4est_tpu_torch.laplacian import structured as S

    S.KERNEL_LAUNCHES = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main([opts_text, f"--problem={problem}", "--device=cuda"])
    torch.cuda.synchronize()
    launches = S.KERNEL_LAUNCHES
    check(code == 0, f"CLI exit code {code}")
    lines = buf.getvalue().splitlines()
    n = sum(line.startswith("solve level ") for line in lines)
    norms, solves = lines[:n], lines[n:2 * n]
    check(n >= 1 and len(lines) == 2 * n + (n >= 2)
          and all(len(line.split()) == 4 for line in norms)
          and all(line.startswith(f"solve level {k}:")
                  for k, line in enumerate(solves))
          and (n < 2 or lines[-1].startswith("C1 = ")),
          f"unexpected CLI output {lines}")
    fields = [dict(kv.split("=", 1) for kv in line.split()[3:])
              for line in solves]
    return norms, solves, fields, launches


def phase_regression(torch):
    text = SINX_OPTIONS.format(level=2, deg=1, use_structured="auto",
                               mixed=1)
    (line,), (solve,), (fields,), launches = run_cli(text, torch)
    print(f"[4] {line}")
    print(f"[4] {solve}; kernel launches {launches}")
    check(line == SINX_LINE, f"sinx line {line!r} != {SINX_LINE!r}")
    l2 = float(line.split()[3])
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
        (line,), (solve,), (fields,), launches = run_cli(text, torch)
        wall = time.perf_counter() - t0
        l2 = float(line.split()[3])
        rel = abs(l2 - LEVEL5_L2) / LEVEL5_L2
        print(f"[5] {tag}: {line} (rel to JAX {rel:.3e})")
        print(f"[5] {tag}: {solve}; kernel launches {launches}; "
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
    inner = int(fields["iterations"])
    check(abs(inner - LEVEL5_INNER) <= LEVEL5_INNER_REL * LEVEL5_INNER,
          f"level-5 kernel solve took {inner} inner iterations, "
          f"{LEVEL5_INNER} +- {LEVEL5_INNER_REL:.0%} expected")
    check(runs[("0", 1)][1] == 0 and runs[("0", 0)][1] == 0,
          "use_structured = 0 launched the kernel")
    return launches, runs[("auto", 1)][2]


def phase_fused(torch, np, card):
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian.fast import _apply_orth
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    dev = torch.device("cuda")
    max_abs = 0.0
    timing = {}
    for deg, level, x1, trees in FUSED_CASES:
        geom = BrickGeometry(x1=x1, n_trees_per_dim=trees, dim=3)
        mesh = build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                          device=dev)
        check(fused.fused_path_available(mesh, None),
              f"no fused path at deg {deg} level {level} trees {trees}")
        fm = fused.build_fused(mesh)
        E, nl = mesh.n_elements, deg + 1
        rng = np.random.default_rng(1000 * deg + level)
        u = torch.as_tensor(rng.standard_normal((E,) + (nl,) * 3),
                            dtype=torch.float32, device=dev)
        u2 = u.reshape(E, -1)
        tr = fused.scaled_traces(u2, fm.W_tr, fm.drstn).contiguous()
        out = fused.fused_apply_cuda(fm, u2, tr)
        ref = fused.fused_apply_plain(fm, u2, tr)
        whole = fused.apply_sipg_fused(mesh, u).reshape(E, -1)
        ref64 = _apply_orth(mesh, u.double()).reshape(E, -1)
        torch.cuda.synchronize()
        abs_err = float((out - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        rel64 = float((whole.double() - ref64).abs().max()
                      / ref64.abs().max())
        max_abs = max(max_abs, abs_err)
        print(f"[6] deg {deg} level {level} x1 {x1} trees {trees} E {E} "
              f"nblk {fm.nblk}: kernel vs plain rel {rel:.3e} (abs "
              f"{abs_err:.3e}), apply_sipg_fused vs f64 rel {rel64:.3e}")
        check(np.isfinite(rel) and rel <= REL_TOL,
              f"fused kernel disagrees with plain: rel {rel}")
        check(np.isfinite(rel64) and rel64 <= REL_TOL,
              f"fused kernel disagrees with f64 apply: rel {rel64}")
        if (deg, level) not in TIMED_CASES or trees != (1, 1, 1):
            continue
        mesh32 = mesh.astype(torch.float32)
        fns = {
            "plain": lambda: fused.fused_apply_plain(fm, u2, tr),
            "kernel": lambda: fused.fused_apply_cuda(fm, u2, tr),
            "whole": lambda: fused.apply_fused(fm, u),
            "fast_f32": lambda: _apply_orth(mesh32, u),
        }
        tw = 12 * nl * nl
        flop, nbytes = sipg_pass_cost(E, fm.nv, fm.nblk, tw,
                                      extra_bytes=4 * E * 6)
        t, timing[(deg, level)] = sipg_timing(
            torch, f"[6] timing deg {deg} level {level} (E {E})", card, fns,
            flop, nbytes)
        whole_bms, _ = bound_ms(flop + 2.0 * E * fm.nv * tw, nbytes)
        print(f"[6] whole apply_sipg_fused {t['whole']:.4f} ms (FFMA bound "
              f"{whole_bms:.4f} ms, {whole_bms / t['whole']:.1%})")
    check(set(timing) == set(TIMED_CASES), "timed case missing")
    return max_abs, timing


def phase_axis(torch, np, card):
    from disco4est_tpu_torch.tools import exp_kernel_design as X

    dev = torch.device("cuda")
    result = None
    max_abs = 0.0
    for E in AXIS_SIZES:
        rng = np.random.default_rng(E)
        u = torch.as_tensor(rng.standard_normal((E, 8, 8, 8)),
                            dtype=torch.float32, device=dev)
        m = torch.as_tensor(rng.standard_normal((8, 8)),
                            dtype=torch.float32, device=dev)
        out = X.axis_apply_cuda(u, m)
        ref = X.axis_apply_plain(u, m)
        torch.cuda.synchronize()
        abs_err = float((out - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        max_abs = max(max_abs, abs_err)
        check(np.isfinite(rel) and rel <= AXIS_TOL,
              f"axis kernel disagrees with plain at E {E}: rel {rel}")
        fns = {
            "plain": lambda: X.axis_apply_plain(u, m),
            "kernel": lambda: X.axis_apply_cuda(u, m),
            "einsum": lambda: torch.einsum("eijk,ia,jb,kc->eabc",
                                           u, m, m, m),
        }
        lib_rel = float((fns["einsum"]() - ref).abs().max()
                        / ref.abs().max())
        check(lib_rel <= AXIS_TOL, f"einsum disagrees: rel {lib_rel}")
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        t = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]) * 2:
            for k in order:
                t[k].append(_time_ms(torch, fns[k], 20, 5))
        t = {k: _median(v) for k, v in t.items()}
        bms, by = bound_ms(3 * 2.0 * E * 8**4, 4 * (2 * E * 512 + 64))
        print(f"[7] E {E}: kernel vs plain rel {rel:.3e} (abs "
              f"{abs_err:.3e}); on {card}: kernel {t['kernel']:.4f} ms "
              f"(bound {bms:.4f} ms by {by}, {bms / t['kernel']:.1%} of "
              f"it), plain {t['plain']:.4f} ms, einsum {t['einsum']:.4f} ms")
        if result is None:  # the probe's size goes into the kernels line
            result = dict(ms=t["kernel"], plain_ms=t["plain"],
                          library_ms=t["einsum"], bound_ms=bms, bound_by=by)
    return max_abs, result


def _tool_lines(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = fn(argv)
    check(code == 0, f"tool {argv} exit code {code}")
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[8] {line}")
    return lines


def _rel_from(lines, pattern):
    for line in lines:
        found = re.search(pattern + r"\s*([0-9.eE+-]+)", line)
        if found:
            return float(found.group(1))
    fail(f"no line matching {pattern!r}")


def phase_tools(torch):
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.tools import exp_kernel_design as X
    from disco4est_tpu_torch.tools import time_fused

    rels, launches = {}, {}
    # (mode, deg, level): the default size, then B2 at the main path's
    # size, so that each size's row has its own launch count
    runs = [("fused", 7, 4), ("phases", 7, 4), ("structured", 7, 4),
            ("fused", 3, 5)]
    for mode, deg, level in runs:
        S.KERNEL_LAUNCHES = fused.KERNEL_LAUNCHES = 0
        lines = _tool_lines(time_fused.main, [
            "--mode", mode, "--deg", str(deg), "--level", str(level),
            "--device", "cuda"])
        torch.cuda.synchronize()
        if mode == "phases":
            continue
        rels[(mode, deg, level)] = _rel_from(lines, "rel err [^:]*:")
        launches[(mode, deg, level)] = (S.KERNEL_LAUNCHES
                                        + fused.KERNEL_LAUNCHES)
    X.KERNEL_LAUNCHES = 0
    lines = _tool_lines(X.main, ["--device", "cuda"])
    rels["axis"] = _rel_from(lines, r"rel err vs plain \(one apply\)")
    torch.cuda.synchronize()
    launches["axis"] = X.KERNEL_LAUNCHES
    print(f"[8] launches in the tools: {launches}; errors {rels}")
    for name, n in launches.items():
        check(n > 0, f"the tools never launched the {name} kernel")
    check(all(v <= REL_TOL for k, v in rels.items() if k != "axis"),
          f"tool errors above {REL_TOL}: {rels}")
    check(rels["axis"] <= AXIS_TOL, f"E4 error above {AXIS_TOL}: {rels}")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 was left on after the probe")
    return launches


def forest_digest(forest):
    """A short digest of a forest's leaves (tree, level, anchor), the same
    as `refcheck/curved_smoke_pins.py` prints for the JAX forests."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (forest.tree, forest.level, forest.anchor):
        h.update(np.ascontiguousarray(a, np.int64).tobytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def amr_probe(torch, np):
    """Per-epoch records of a driver run.  Wraps the driver's mesh build,
    estimator and AMR step, and inside them the face tables, the
    refine + balance and the tree-structured view of the curved solve,
    each with host clocks behind a device synchronize; one record per
    mesh build, that is per epoch, with its forest's digest."""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.amr import amr
    from disco4est_tpu_torch.laplacian import curved
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.mesh import builder

    sites = [(driver, "build_mesh", "mesh"),
             (builder, "build_face_tables", "faces"),
             (curved, "build_tree_structured", "ts"),
             (driver, "estimate_bi", "estimate"),
             (driver, "amr_step_hp", "amr"),
             (amr, "refine_and_balance", "balance")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    epochs = []

    def timed(fn, key):
        def wrapper(*args, **kw):
            if key == "mesh":
                forest = args[1]
                values, counts = np.unique(np.asarray(kw["deg_e"]),
                                           return_counts=True)
                epochs.append(dict(
                    launches=S.KERNEL_LAUNCHES, forest=forest_digest(forest),
                    hist={int(v): int(c) for v, c in zip(values, counts)},
                    uniform=len(values) == 1
                    and len(np.unique(forest.level)) == 1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec = epochs[-1]
            rec[key] = rec.get(key, 0.0) + time.perf_counter() - t0
            if key == "mesh":
                rec["hanging"] = int(out.hc_elem.shape[0])
                check(out.device.type == "cuda",
                      f"an epoch's mesh was built on {out.device}")
            return out
        return wrapper

    for mod, name, key in sites:
        setattr(mod, name, timed(getattr(mod, name), key))
    try:
        yield epochs
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def amr_run(torch, np, key):
    """One AMR run of phase 9 through the CLI entry: its per-epoch lines,
    records and the checks every run shares."""
    run = AMR_RUNS[key]
    text = AMR_OPTIONS.format(use_structured="auto", mixed=1, **run)
    t0 = time.perf_counter()
    with amr_probe(torch, np) as epochs:
        norms, _, fields, launches = run_cli(text, torch)
    wall = time.perf_counter() - t0
    n = run["steps"] + 1
    check(len(norms) == len(epochs) == n,
          f"({key}) {len(norms)} levels, {len(epochs)} epochs, {n} expected")
    ends = [e["launches"] for e in epochs[1:]] + [launches]
    for k, (rec, line, f, end) in enumerate(zip(epochs, norms, fields,
                                                ends)):
        E, dof, _, l2 = line.split()
        rec.update(E=int(E), dof=int(dof), l2=float(l2), fields=f,
                   b1=end - rec["launches"], solve=float(f["seconds"]))
        print(f"[9] ({key}) level {k}: E {E} DOF {dof} deg_e {rec['hist']} "
              f"hanging {rec['hanging']}; path={f['path']} outer="
              f"{f['outer']} iterations={f['iterations']} residual="
              f"{f['residual']} fallback={f['fallback']}; B1 launches "
              f"{rec['b1']}; L2 {l2}; seconds: "
              f"mesh {rec['mesh']:.3f} (face tables {rec['faces']:.3f}), "
              f"solve {rec['solve']:.3f}, estimate "
              f"{rec.get('estimate', 0.0):.3f}, amr {rec.get('amr', 0.0):.3f}"
              f" (refine + balance {rec.get('balance', 0.0):.3f})")
        if rec["uniform"]:  # a uniform brick at one degree: the kernel
            check(f["path"] == "mixed-structured" and rec["b1"] > 0,
                  f"({key}) uniform epoch {k} took {f['path']} with "
                  f"{rec['b1']} B1 launches")
        else:
            check(rec["b1"] == 0, f"({key}) B1 ran on an adapted mesh")
        check(np.isfinite(rec["l2"]), f"({key}) L2 {l2}")
    print(f"[9] ({key}) {run}: CLI wall {wall:.2f} s, B1 launches "
          f"{launches}, final elements {epochs[-1]['E']}")
    for k, (E, dof, hist, l2) in enumerate(AMR_PINS.get(key, [])):
        rec = epochs[k]
        rel = abs(rec["l2"] - l2) / l2
        print(f"[9] ({key}) level {k} against JAX: L2 rel {rel:.3e}")
        check((rec["E"], rec["dof"], rec["hist"]) == (E, dof, hist),
              f"({key}) level {k}: {rec['E']} {rec['dof']} {rec['hist']}, "
              f"JAX {E} {dof} {hist}")
        check(rel <= AMR_REL, f"({key}) level {k} L2 {rec['l2']} vs JAX "
              f"{l2} (rel {rel})")
    return epochs


def phase_amr(torch, np, card, level5_l2, b1_level5_ms):
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    print(f"[9] the AMR loop on {card}")
    a = amr_run(torch, np, "a")
    check([e["E"] for e in a] == [4096, 32768]
          and a[1]["dof"] == 2097152, "(a) sizes")
    l2 = a[1]["l2"]
    rel_jax = abs(l2 - LEVEL5_L2) / LEVEL5_L2
    rel_p5 = abs(l2 - level5_l2) / level5_l2
    print(f"[9] (a) level 5 L2 {l2!r}: rel to JAX {rel_jax:.3e}, to phase 5 "
          f"{rel_p5:.3e}")
    check(rel_jax <= LEVEL5_REL, f"(a) level-5 L2 {l2} vs {LEVEL5_L2}")
    check(rel_p5 <= LEVEL5_SPREAD, f"(a) level-5 L2 {l2} vs phase 5 "
          f"{level5_l2}")
    # B1's device time in (a): each epoch's launches times the batched
    # device time per launch at that epoch's shape (level 5: phase 3)
    geom = BrickGeometry(dim=3)
    sb = S.build_structured(build_mesh(geom, Forest.uniform(geom.conn, 4),
                                       deg=3, device="cuda"))
    u = torch.as_tensor(
        np.random.default_rng(9).standard_normal((sb.n_elements, sb.nv)),
        dtype=torch.float32, device="cuda")
    tr = S.compute_traces_lex(sb, u).contiguous()
    launches0 = S.KERNEL_LAUNCHES
    per = [_time_ms(torch, lambda: S.lex_apply_cuda(sb, u, tr)),
           b1_level5_ms]
    S.KERNEL_LAUNCHES = launches0  # timing launches are not the run's
    b1_ms = [e["b1"] * t for e, t in zip(a, per)]
    print(f"[9] (a) B1 device time on {card}: level 4 {a[0]['b1']} x "
          f"{per[0]:.4f} ms = {b1_ms[0]:.1f} ms of a {a[0]['solve']:.3f} s "
          f"solve; level 5 {a[1]['b1']} x {per[1]:.4f} ms = {b1_ms[1]:.1f} "
          f"ms of a {a[1]['solve']:.3f} s solve")

    b = amr_run(torch, np, "b")
    check([max(e["hist"]) for e in b] == [3, 4, 5], "(b) degrees")

    c = amr_run(torch, np, "c")
    check(any(e["hanging"] for e in c), "(c) no epoch with hanging faces")
    check(any(len(e["hist"]) > 1 for e in c), "(c) no mixed-degree epoch")
    check(c[0]["b1"] > 0, "(c) epoch 0 did not run B1")

    d = amr_run(torch, np, "d")
    l2s = [e["l2"] for e in d]
    check(all(x > y for x, y in zip(l2s, l2s[1:])),
          f"(d) the error did not fall every level: {l2s}")
    check(max(max(e["hist"]) for e in d) > 2, "(d) no degree above 2")
    check(any(e["hanging"] for e in d), "(d) no hanging faces")
    for k, e in enumerate(d):
        f = e["fields"]
        bound = 1e-10 * (1.0 + float(f["rhs_norm"]))
        check(f["fallback"] == "no", f"(d) level {k} fell back to f64")
        check(float(f["residual"]) <= bound,
              f"(d) level {k} residual {f['residual']} above {bound:.3e}")


def curved_run(torch, np, key, problem="sinx"):
    """One run of phase 10 through the CLI entry: one line per epoch with
    its norm line, degrees, hanging faces, solve path and iterations, and
    the host seconds of mesh build, tree-structured view, solve,
    estimator and AMR step.  B1 must not run on a sphere."""
    run = CURVED_RUNS[key]
    text = CURVED_OPTIONS.format(**run)
    t0 = time.perf_counter()
    with amr_probe(torch, np) as epochs:
        norms, _, fields, launches = run_cli(text, torch, problem)
    wall = time.perf_counter() - t0
    check(len(norms) == len(epochs) == run["steps"] + 1,
          f"({key}) {len(norms)} levels, {len(epochs)} epochs")
    for k, (rec, line, f) in enumerate(zip(epochs, norms, fields)):
        E, dof, _, l2 = line.split()
        rec.update(E=int(E), dof=int(dof), l2=float(l2), line=line,
                   fields=f, solve=float(f["seconds"]))
        print(f"[10] ({key}) level {k}: {line}; deg_e {rec['hist']} "
              f"hanging {rec['hanging']}; path={f['path']} outer="
              f"{f['outer']} iterations={f['iterations']} residual="
              f"{f['residual']} fallback={f['fallback']}; seconds: mesh "
              f"{rec['mesh']:.3f}, tree-structured view "
              f"{rec.get('ts', 0.0):.3f}, solve {rec['solve']:.3f}, "
              f"estimate {rec.get('estimate', 0.0):.3f}, amr "
              f"{rec.get('amr', 0.0):.3f}")
        check(np.isfinite(rec["l2"]), f"({key}) L2 {l2}")
    print(f"[10] ({key}) {problem} {run['geometry'].splitlines()[0]}: CLI "
          f"wall {wall:.2f} s, B1 launches {launches}")
    check(launches == 0, f"({key}) B1 ran on a sphere")
    return epochs


def lorentzian_digit(torch):
    """The reference digit of `tests/test_regression_digits.py:28-62` on
    the card: plain f64 CG at atol 1e-15, then the L2 of |u - u_a|."""
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
                      face_h_type="j_div_sj_quad", device="cuda")
    check(mesh.n_elements == 104 and mesh.local_nodes == 832, "(a) sizes")
    rhs = build_rhs_with_strong_bc(mesh, mesh.init_field(P.rhs),
                                   mesh.boundary_values(P.boundary))
    res = cg_solve(lambda v: apply_sipg(mesh, v), rhs, atol=1e-15, rtol=0.0,
                   max_iter=5000)
    err = torch.abs(res.x - mesh.init_field(P.analytic))
    return float(torch.sqrt(torch.sum(mesh.l2_norm_sqr(err)))), res


def curved_apply_timing(torch, np, card):
    """(c): the tree-structured apply against the general apply on the
    compactified 13-tree sphere at level 3, deg 4, j_div_sj_quad (the
    sphere row of `bench.py:350-417`), in f64 and f32, and both timed in
    f32 against the bytes bound of `bench.py:398-405` at 4 bytes a word."""
    from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
    from disco4est_tpu_torch.laplacian import curved
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    geom = CubedSphereGeometry("13tree", R0=10.0, R1=20.0, R2=1000.0,
                               compactify_outer_shell=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 3), deg=4,
                      face_h_type="j_div_sj_quad", device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ts = curved.build_tree_structured(mesh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    E, nl, nq = mesh.n_elements, mesh.nl, mesh.nq
    check(ts is not None and E == 6656 and mesh.local_nodes == 832000,
          "(c) sizes")
    mesh_lex = curved.permute_mesh_lex(ts, mesh)
    u = torch.as_tensor(np.random.default_rng(10).standard_normal(
        (E,) + (nl,) * 3), device="cuda")
    ref = apply_sipg(mesh, u)
    got = curved.from_lex(ts, curved.apply_tree_structured(
        ts, mesh_lex, curved.to_lex(ts, u)))
    scale = float(ref.abs().max())
    rel64 = float((got - ref).abs().max()) / scale
    mesh32, ts32 = mesh.astype(torch.float32), ts.astype(torch.float32)
    lex32 = mesh_lex.astype(torch.float32)
    u32 = u.float()
    u32_lex = curved.to_lex(ts, u32)
    fns = {
        "general": lambda: apply_sipg(mesh32, u32),
        "tree-structured": lambda: curved.apply_tree_structured(
            ts32, lex32, u32_lex),
    }
    rel32 = {
        "general": float((fns["general"]().double() - ref).abs().max())
        / scale,
        "tree-structured": float((curved.from_lex(
            ts, fns["tree-structured"]()).double() - ref).abs().max())
        / scale,
    }
    print(f"[10] (c) 13-tree compactified sphere, level 3, deg 4: E {E}, "
          f"{mesh.local_nodes} DOF, {ts.n_crossing} crossing-face rows; "
          f"mesh build {t1 - t0:.3f} s, tree-structured view {t2 - t1:.3f} "
          f"s; tree-structured vs general f64 rel {rel64:.3e}; f32 vs f64: "
          f"general {rel32['general']:.3e}, tree-structured "
          f"{rel32['tree-structured']:.3e}")
    check(rel64 <= CURVED_F64_TOL, f"(c) f64 applies disagree: {rel64}")
    check(max(rel32.values()) <= CURVED_F32_TOL,
          f"(c) f32 applies off f64: {rel32}")
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    t = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]) * 2:
        for k in order:
            # 4 calls of 100-150 launches each: the card's launch queue
            # (about a thousand kernels) must hold a batch behind the spin
            t[k].append(_time_ms(torch, fns[k], n=4))
    t = {k: _median(v) for k, v in t.items()}
    # `bench.py:398-405`: u in and out, traces and face data of both
    # sides, wjgg and the per-point face factors (drst, n, sj, σ)
    per_elem = (2 * nl**3 + 2 * 6 * (nl**2 + nq**2) + 9 * nq**3
                + 6 * (9 + 3 + 2) * nq**2)
    bound = 1e3 * 4 * E * per_elem / PEAK_BYTES
    for k, ms in t.items():
        print(f"[10] (c) f32 {k} apply on {card}: {ms:.4f} ms; bytes bound "
              f"{bound:.4f} ms ({bound / ms:.1%} of it)")
    return t, bound


def phase_curved(torch, np, card):
    """Phase 10: the curved path on the card (no hand-written kernel runs
    on it: the applies are torch operations, as in the JAX package)."""
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.tools import exp_kernel_design as X

    print(f"[10] the curved path on {card}")
    t_phase = time.perf_counter()
    S.KERNEL_LAUNCHES = fused.KERNEL_LAUNCHES = X.KERNEL_LAUNCHES = 0

    # (a) the reference regression: the norm line and the digit
    (a,) = curved_run(torch, np, "a", problem="lorentzian")
    check(a["line"] == LORENTZIAN_LINE,
          f"(a) line {a['line']!r} != {LORENTZIAN_LINE!r}")
    check(a["fields"]["path"] == "mixed-curved"
          and a["fields"]["fallback"] == "no", f"(a) solve {a['fields']}")
    digit, res = lorentzian_digit(torch)
    rel = abs(digit - LORENTZIAN_DIGIT) / LORENTZIAN_DIGIT
    print(f"[10] (a) plain f64 CG ({res.iterations} iterations, residual "
          f"{res.residual_norm:.3e}): L2 of |u - u_a| {digit!r}, rel to the "
          f"reference digit {rel:.3e}")
    check(rel <= LORENTZIAN_DIGIT_REL, f"(a) digit {digit}")

    # (b) the full width: uniform_h on the 7-tree sphere, level 3 -> 4
    b = curved_run(torch, np, "b")
    check([e["E"] for e in b] == [3584, 28672]
          and [e["dof"] for e in b] == [229376, 1835008], "(b) sizes")
    for k, e in enumerate(b):
        check(e["fields"]["path"] == "mixed-curved"
              and e["fields"]["fallback"] == "no",
              f"(b) level {k}: {e['fields']}")
    rel3 = abs(b[0]["l2"] - SPHERE_L3_L2) / SPHERE_L3_L2
    (b64,) = curved_run(torch, np, "b64")
    rel4 = abs(b[1]["l2"] - b64["l2"]) / b64["l2"]
    print(f"[10] (b) level 3 L2 rel to JAX {rel3:.3e}; level 4 L2 rel to the "
          f"plain f64 FCG solve {rel4:.3e}; level 3 / level 4 L2 "
          f"{b[0]['l2'] / b[1]['l2']:.2f}")
    check(rel3 <= SPHERE_L3_REL, f"(b) level-3 L2 {b[0]['l2']}")
    check(rel4 <= SPHERE_L4_REL, f"(b) level-4 L2 {b[1]['l2']} vs "
          f"{b64['l2']}")
    check(b[1]["l2"] * 8 <= b[0]["l2"], "(b) the error fell less than 8x")

    # (c) the bench-row size: both applies against each other and timed
    timing = curved_apply_timing(torch, np, card)

    # (d) hp smooth_pred on the 7-tree sphere, held to the JAX forests
    d = curved_run(torch, np, "d")
    for k, (E, dof, hist, l2, digest) in enumerate(SPHERE_SMOOTH_PRED):
        rec = d[k]
        rel = abs(rec["l2"] - l2) / l2
        print(f"[10] (d) level {k} against JAX: forest {rec['forest']} "
              f"(JAX {digest}), L2 rel {rel:.3e}")
        check((rec["E"], rec["dof"], rec["hist"], rec["forest"])
              == (E, dof, hist, digest),
              f"(d) level {k}: {rec['E']} {rec['dof']} {rec['hist']} "
              f"{rec['forest']}, JAX {E} {dof} {hist} {digest}")
        check(rel <= SPHERE_SMOOTH_PRED_REL, f"(d) level {k} L2 {rec['l2']}")
    check(any(e["hanging"] for e in d), "(d) no hanging faces")
    check(any(len(e["hist"]) > 1 for e in d), "(d) no mixed-degree epoch")
    launches = dict(B1=S.KERNEL_LAUNCHES, B2=fused.KERNEL_LAUNCHES,
                    B3=X.KERNEL_LAUNCHES)
    print(f"[10] kernel launches in phase 10: {launches} (the curved path "
          f"runs torch operations only); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return timing


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
    b1_abs, b1 = phase_kernel(torch, np, card)
    phase_regression(torch)
    b1_launches, level5_l2 = phase_real_size(torch)
    b2_abs, b2 = phase_fused(torch, np, card)
    b3_abs, b3 = phase_axis(torch, np, card)
    tool_launches = phase_tools(torch)
    phase_amr(torch, np, card, level5_l2, b1[(3, 5)]["ms"])
    phase_curved(torch, np, card)

    csrc = "disco4est_tpu_torch/csrc/"
    # B1 and B2 have one entry per timed size; each entry's launches are
    # those of a run at that size: B1 at deg 3 / level 5 is the main path's
    # solve (phase 5), the rest are the tools' runs (phase 8)
    b1_runs = {(7, 4): tool_launches[("structured", 7, 4)],
               (3, 5): b1_launches}
    kernels = []
    for deg, level in TIMED_CASES:
        size = f"deg {deg} / level {level}"
        kernels.append(dict(
            name=f"structured_apply ({size})", route="cuda",
            source=csrc + "structured_apply.cu",
            replaces="disco4est_tpu/laplacian/structured.py:190",
            launches=b1_runs[(deg, level)], max_abs_err=b1_abs,
            library_ms=None, **b1[(deg, level)]))
        kernels.append(dict(
            name=f"fused_apply ({size})", route="cuda",
            source=csrc + "fused_apply.cu",
            replaces="disco4est_tpu/laplacian/pallas_sipg.py:131",
            launches=tool_launches[("fused", deg, level)],
            max_abs_err=b2_abs, library_ms=None, **b2[(deg, level)]))
    kernels += [
        dict(name="axis_apply", route="cuda",
             source=csrc + "axis_apply.cu",
             replaces="tools/exp_kernel_design.py:176",
             launches=tool_launches["axis"], max_abs_err=b3_abs, **b3),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
