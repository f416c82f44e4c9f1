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
   The fixed-order sums (ROADMAP C10) on the card: two f32
   tree-structured applies of (c), two generic f32 applies and two
   estimates on (d)'s adapted epoch, each of one input, must be equal bit
   for bit, and (b)'s level-3 solve, run again, must take the same inner
   iteration count;
11. the nonlinear Newton–Krylov path (f64 torch operations; the three
   kernels' counts must stay 0), one line per level with the norm line,
   Newton iterations, ‖F‖ history, Krylov iterations per Newton step,
   Σ η², forest digest and the host seconds of mesh build, solve,
   estimator and AMR step, beside the JAX pins of
   `refcheck/nonlinear_smoke_pins.py` (CDS with ψ_analytic boundary
   data, ROADMAP C11):
   (a) the CDS regression through the CLI entry (brick, level 2, deg 2,
       FACE_H_EQ_TREE_H, one smooth_pred step, CG, snes_atol 1e-12):
       `64 1728 1728 9.6078621…e-06` and `288 7776 7776 3.7944365…e-06`,
       within 1e-8 of the reference digits, the forests JAX's;
   (b) CDS at deg 3, uniform_h from level 4 to 5 (2,097,152 DOF): each
       L2 within 2e-12 of JAX's, level 5's at least 4x below level 4's,
       ‖F‖ ≤ 1e-12, with the seconds per Newton step and per Krylov
       iteration at level 5;
   (c) TwoPunctures through the CLI entry (7-tree, R0 10, R1 1000,
       compactified inner shell, level 1, deg 2, FCG, snes_atol 1e-10):
       JAX's 5 Newton iterations, ‖F‖ ≤ 1e-10, Σ u within 1e-8 and Σ η²
       within 1e-6 of JAX's (the FCG counts are printed, not pinned);
   (d) the reference's TwoPunctures digit through the API (level 0, deg
       1, 56 DOF, dense Jacobian solves): u(10, 0, 0) within 1e-12 of
       0.0004250131568938;
12. the preconditioners (f64 torch operations; the three kernels' counts
   must stay 0), through the CLI entry, one line per level with the norm
   and solve lines, the Krylov counts beside the JAX pins of
   `refcheck/precond_smoke_pins.py` (within 25 % + 2: the solves stop at
   the f64 floor or a Newton forcing term, `PRECOND_COUNT_SLACK`), the
   forest digest, the CLI wall and the peak device memory:
   (a) sinx, `pc_type = multigrid` (Chebyshev smoother, CG bottom, FCG),
       deg 3, uniform_h from level 4 to 5 (2,097,152 DOF): the level-5 L2
       within `LEVEL5_REL` of JAX, the set-up seconds (hierarchy,
       mg_setup), the solve, the ms per V-cycle and the FCG count beside
       phase 5's unpreconditioned one;
   (b) `pc_type = cheby` and `schwarz` (num_nodes_overlap 1,
       subdomain_iter 15) at level 4 (the replicated Schwarz mesh holds
       110,592 elements; level 5's 884,736 would take the phase past its
       budget, ROADMAP A13b), the L2 against phase 9 (a)'s JAX pin (JAX
       gives no Schwarz count at this size: hours on the CPU), the ms
       per Schwarz apply; then the multigrid plugins schwarz_overlap /
       reuse_smoother, cheby / cheby, block Schwarz / cg (level 2, deg 2)
       and none / cheby (one element) against JAX's L2;
   (c) the reference's Schwarz regression trajectory through the API
       (13-tree, deg 4, num_nodes_overlap 4, 400 subdomain iterations):
       all 10 iterates within the bounds of
       `tests/test_regression_digits.py:193-266`, the digit 0.15228638;
   (d) hp smooth_pred with multigrid (phase 9 (c)'s configuration): JAX's
       forests and L2, the mixed-degree epochs on the hp V-cycle;
   (e) Newton-MG (the frozen-u0 blocks restricted through the hierarchy):
       CDS at deg 3, level 4 -> 5, L2 within 2e-12 of phase 11 (b)'s pins;
       TwoPunctures (phase 11 (c)'s options on the definite pointwise
       penalty: with volume/area h its Jacobian is indefinite) from level
       1 to 2, ||F|| <= 1e-10, Σ u within 1e-8 of the JAX driver's
       unpreconditioned Newton (its Newton-MG diverges, ROADMAP C13), the
       seconds beside phase 11 (c)'s;
   (f) repeatability: two level-5 V-cycles, two hp V-cycles and two
       Schwarz applies of one input are equal bit for bit (fixed-order
       sums, C10).

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
    # (b)'s first epoch again: the same inner iteration count (C10)
    "b3": dict(level=3, deg=3, max_degree=3, scheme="uniform_h", steps=0,
               geometry=SPHERE7, mixed=1),
    "d": dict(level=1, deg=2, max_degree=4, scheme="smooth_pred", steps=2,
              geometry=SPHERE7, mixed=1),
}


# phase 11, the nonlinear path: the options of
# `refcheck/nonlinear_smoke_pins.py`, which prints the JAX pins (CPU,
# numpy 2.0.2; CDS with ψ_analytic as its Dirichlet data, ROADMAP C11)
NONLINEAR_OPTIONS = """
[initial_mesh]
min_level = {level}
region0_deg = {deg}
region0_deg_quad_inc = {dq_inc}

[mesh_parameters]
face_h_type = {face_h}
volume_h_type = VOL_H_EQ_CUBE_APPROX

[flux]
name = sipg
sipg_penalty_prefactor = 2.0
sipg_penalty_fcn = maxp_sqr_over_minh

[amr]
scheme = {scheme}
num_of_amr_steps = {steps}
percentile = 25
gamma_h = 0.25
gamma_p = 0.1
gamma_n = 1.0

[geometry]
{geometry}

[d4est_solver_newton]
snes_atol = {snes_atol}
snes_max_it = 30

[d4est_solver_krylov_petsc]
ksp_type = {ksp}
ksp_max_it = 10000

[quadrature]
name = legendre
"""
TP_SPHERE7 = """name = cubed_sphere_7tree
r0 = 10.0
r1 = 1000.0
compactify_inner_shell = 1"""
NONLINEAR_RUNS = {
    "a": dict(level=2, deg=2, dq_inc=0, face_h="FACE_H_EQ_TREE_H",
              scheme="smooth_pred", steps=1, geometry="name = brick",
              snes_atol=1e-12, ksp="cg", problem="cds"),
    "b": dict(level=4, deg=3, dq_inc=0, face_h="FACE_H_EQ_TREE_H",
              scheme="uniform_h", steps=1, geometry="name = brick",
              snes_atol=1e-12, ksp="cg", problem="cds"),
    "c": dict(level=1, deg=2, dq_inc=1, face_h="FACE_H_EQ_VOLUME_DIV_AREA",
              scheme="uniform_h", steps=0, geometry=TP_SPHERE7,
              snes_atol=1e-10, ksp="fcg", problem="two_punctures"),
}
# per level: elements, DOF, L2 (TwoPunctures: ‖F‖), Newton iterations,
# ‖F‖ history, Krylov iterations per Newton step, Σ η², forest digest
NONLINEAR_PINS = {
    "a": [(64, 1728, 9.607862107719673e-06, 3,
           [6.81268929303232e-05, 3.8940890651101163e-07,
            3.5962227976652317e-10, 3.547678086056019e-13],
           [21, 36, 37], 3.2338214022128e-08, "8885996e5b8fc009"),
          (288, 7776, 3.794436580597212e-06, 3,
           [1.7121622401091096e-05, 6.805065777108538e-08,
            5.7649344704701606e-11, 4.803896979331402e-14],
           [56, 69, 71], 1.013509984181725e-09, "ca2e947d1cc819fc")],
    "b": [(4096, 262144, 2.6366481099608364e-07, 3,
           [8.897760365449851e-05, 7.671563549935214e-07,
            7.111525719662918e-10, 6.989868214587535e-13],
           [67, 129, 113], 2.4754219422011584e-11, "5998b6866d35963d"),
          (32768, 2097152, 5.290594304889033e-08, 2,
           [6.202972945650333e-07, 6.126882243820108e-10,
            5.784883797972237e-13],
           [237, 256], 4.0050242114901464e-12, "ae8908dee7501857")],
    "c": [(56, 1512, 3.6922062900999323e-11, 5,
           [0.043619579286959274, 0.008002791919654922,
            0.0006132093532751641, 1.3378094705885977e-05,
            4.5639365651741405e-08, 3.6922062900999323e-11],
           [416, 703, 1503, 1599, 3083], 0.0062773454869856455,
           "b5790d9fd145689c")],
}
# the reference's CDS digits (`tests/test_cds.py:86,119`): the level-2
# L2 of `d4est_test_mpi.sh` and the converged CDS-AMR ground truth
CDS_DIGITS = (9.607862111733e-06, 3.7944365819784e-06)
CDS_DIGIT_REL = 1e-8
CDS_L2_ABS = 2e-12  # (b): the Newton stop at ‖F‖ ≤ 1e-12 leaves ~1e-12 in u
TP_SUM_U = 2.6393399389629097  # (c): Σ u over the nodes, JAX
TP_SUM_U_REL = 1e-8
TP_ETA2_REL = 1e-6
# (d) u(10, 0, 0) of `d4est_test_twopunctures.sh:5` (refcheck ground
# truth, `tests/test_regression_digits.py:65-128`)
TP_DIGIT = 0.0004250131568938
TP_DIGIT_ABS = 1e-12


# phase 12, the preconditioners: the options of
# `refcheck/precond_smoke_pins.py`, which prints the JAX pins (CPU)
PRECOND_RUNS = {
    # run: [initial_mesh] min_level, region0_deg, [mesh_parameters]
    # max_degree, [amr] scheme, num_of_amr_steps, pc_type, [multigrid]
    # plugins
    "a": (4, 3, 3, "uniform_h", 1, "multigrid", "mg_smoother_cheby",
          "mg_bottom_solver_cg"),
    "cheby": (4, 3, 3, "uniform_h", 0, "cheby", "mg_smoother_cheby",
              "mg_bottom_solver_cg"),
    "schwarz": (4, 3, 3, "uniform_h", 0, "schwarz", "mg_smoother_cheby",
                "mg_bottom_solver_cg"),
    "mg_so_reuse": (2, 2, 2, "uniform_h", 0, "multigrid",
                    "mg_smoother_schwarz", "mg_bottom_solver_reuse_smoother"),
    "mg_none_cheby": (0, 3, 3, "uniform_h", 0, "multigrid",
                      "mg_smoother_none", "mg_bottom_solver_cheby"),
    "mg_cheby_cheby": (2, 2, 2, "uniform_h", 0, "multigrid",
                       "mg_smoother_cheby", "mg_bottom_solver_cheby"),
    "mg_block": (2, 2, 2, "uniform_h", 0, "multigrid", "schwarz",
                 "mg_bottom_solver_cg"),
    "d": (3, 2, 4, "smooth_pred", 3, "multigrid", "mg_smoother_cheby",
          "mg_bottom_solver_cg"),
}
PRECOND_NONLINEAR_RUNS = {
    "cds": dict(NONLINEAR_RUNS["b"], bottom="mg_bottom_solver_cg"),
    # phase 11 (c)'s TwoPunctures from level 1 to 2 on the pointwise
    # penalty FACE_H_EQ_J_DIV_SJ_QUAD.  With phase 11 (c)'s volume/area h
    # and prefactor 2 the 7-tree Jacobian is indefinite (40-step Lanczos
    # λmin −33 at level 1, −54 at level 2, CPU; +0.75 and +1.46 with the
    # pointwise penalty), and multigrid FCG hits any cap from the second
    # Newton step on (ROADMAP C13)
    "tp_jq": dict(NONLINEAR_RUNS["c"], steps=1,
                  face_h="FACE_H_EQ_J_DIV_SJ_QUAD",
                  bottom="mg_bottom_solver_cg"),
}
# Σ u of "tp_jq"'s levels 1 and 2 from the JAX driver's unpreconditioned
# Newton (`refcheck/precond_smoke_pins.py tp_jq`; its Newton-MG diverges,
# C13): the same discrete solutions, to snes_atol
TP_JQ_SUM_U = (2.638814952924732, 30.286447816946193)
# that JAX run's FCG iterations per Newton step, levels 1 and 2
TP_JQ_JAX_FCG = ([148, 162, 262, 311, 386], [834, 464, 961, 1234, 1297])
# per level: elements, DOF, L2 (TwoPunctures: ‖F‖), Krylov iterations (one
# per Newton step on the nonlinear runs), forest digest
PRECOND_PINS = {
    "a": [(4096, 262144, 1.6362252130761418e-08, [16], "5998b6866d35963d"),
          (32768, 2097152, 4.4836489567434693e-10, [10],
           "ae8908dee7501857")],
    "cheby": [(4096, 262144, 1.636225211304714e-08, [38],
               "5998b6866d35963d")],
    "mg_so_reuse": [(64, 1728, 0.0019464036376919606, [14],
                     "8885996e5b8fc009")],
    "mg_none_cheby": [(1, 64, 0.015802814670054347, [4],
                       "2c34ce1df23b838c")],
    "mg_cheby_cheby": [(64, 1728, 0.00194640363769212, [16],
                        "8885996e5b8fc009")],
    "mg_block": [(64, 1728, 0.0019464036376921168, [14],
                  "8885996e5b8fc009")],
    "d": [(512, 13824, 0.0002051858857341537, [133], "f7a6b09c773b2f8f"),
          (1520, 41040, 0.00010726299926582452, [17], "2079ff7c8709a510"),
          (4040, 258560, 1.807130544341783e-05, [45], "d8ca7162cc7144ae"),
          (4096, 262144, 1.3531952590494491e-05, [15], "5998b6866d35963d")],
    "cds": [(4096, 262144, 2.636641425114692e-07, [2, 4, 4],
             "5998b6866d35963d"),
            (32768, 2097152, 5.29062285606966e-08, [3, 4],
             "ae8908dee7501857")],
}
# the linear runs' L2 against JAX's: solves to the atol 5e-15 floor by
# different paths spread by ~1e-9 relative at level 4 (cheby against
# multigrid, JAX)
PRECOND_L2_REL = 1e-8
# Krylov counts against JAX's: the solves stop at the f64 floor or a
# Newton forcing term, and where the 10-step Lanczos λmax falls short of
# the true one (by 10 % on (d)'s level-3 brick at deg 2) the Chebyshev
# smoother amplifies the top modes and the count moves with rounding
# (JAX 133, the port on the CPU 114)
PRECOND_COUNT_SLACK = 0.25
TP_PHASE11_SECONDS = 26.45  # phase 11 (c)'s solve as PERF.md §5 records it
SCHWARZ_DIGIT_REF = [  # `tests/test_regression_digits.py:193-266`
    (11.029811440762897, 0.152286388792538),
    (8.478311301990601, 0.030824293450190),
    (2.004390543675700, 0.006973281993397),
    (0.389316550646736, 0.001661047758643),
    (0.076353915252118, 0.000406316495572),
    (0.015850377445150, 0.000101033279923),
    (0.003495337566975, 0.000025513862237),
    (0.000810831051224, 0.000006726003428),
    (0.000195525821702, 0.000002099298702),
    (0.000048528414143, 0.000000952418865),
]


# the options of `refcheck/amr_smoke_pins.py`, with the solve settings
# above
AMR_OPTIONS = SINX_OPTIONS.replace(
    "max_degree = 7", "max_degree = {max_degree}").replace(
    "scheme = uniform_p\nnum_of_amr_steps = 0",
    "scheme = {scheme}\nnum_of_amr_steps = {steps}\npercentile = 25\n"
    "gamma_h = 10.0\ngamma_p = 0.1\ngamma_n = 1.0")
assert AMR_OPTIONS.count("{scheme}") == 1
PRECOND_OPTIONS = AMR_OPTIONS.replace(
    "use_mixed_precision = {mixed}",
    "use_mixed_precision = {mixed}\npc_type = {pc}\n\n[multigrid]\n"
    "smoother_name = {smoother}\nbottom_solver_name = {bottom}\n\n"
    "[d4est_solver_schwarz]\nnum_nodes_overlap = 1\nsubdomain_iter = 15")
# a Krylov cap of 1000 a Jacobian solve: a working multigrid takes
# 2-40 FCG iterations there, and a diverging one ends inside the phase
PRECOND_NONLINEAR_OPTIONS = NONLINEAR_OPTIONS.replace(
    "ksp_max_it = 10000", "ksp_max_it = 1000\npc_type = multigrid\n\n"
    "[multigrid]\nbottom_solver_name = {bottom}")


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
    return (launches, runs[("auto", 1)][2],
            int(runs[("0", 0)][0]["iterations"]))


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
def amr_probe(torch, np, keep_mesh=False):
    """Per-epoch records of a driver run.  Wraps the driver's mesh build,
    estimator and AMR step (`amr_step_hp` in `run_poisson`; refine +
    balance and the field transfer in `run_nonlinear`), and inside them
    the face tables, the refine + balance and the tree-structured view of
    the curved solve, each with host clocks behind a device synchronize;
    one record per mesh build, that is per epoch, with its forest's
    digest (and, with `keep_mesh`, the mesh)."""
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
             (driver, "refine_and_balance", "amr"),
             (driver, "transfer_field", "amr"),
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
                if keep_mesh:
                    rec["built"] = out
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


def curved_run(torch, np, key, problem="sinx", keep_mesh=False):
    """One run of phase 10 through the CLI entry: one line per epoch with
    its norm line, degrees, hanging faces, solve path and iterations, and
    the host seconds of mesh build, tree-structured view, solve,
    estimator and AMR step.  B1 must not run on a sphere."""
    run = CURVED_RUNS[key]
    text = CURVED_OPTIONS.format(**run)
    t0 = time.perf_counter()
    with amr_probe(torch, np, keep_mesh) as epochs:
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
    # C10: the crossing faces sum in a fixed order, so two applies of one
    # input are equal bit for bit
    same = torch.equal(fns["tree-structured"](), fns["tree-structured"]())
    print(f"[10] (c) two f32 tree-structured applies of one input equal bit "
          f"for bit: {same}")
    check(same, "(c) the f32 tree-structured apply is not repeatable")
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


def repeat_on_adapted_sphere(torch, np, mesh):
    """C10 on (d)'s adapted epoch (hanging faces across reoriented tree
    faces): two generic f32 applies of one input, and two estimates, must
    be equal bit for bit (the mortar rows sum in a fixed order)."""
    from disco4est_tpu_torch.estimators.bi import estimate_bi
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg

    check(mesh.hc_elem.shape[0] > 0, "(d) epoch 1 has no hanging faces")
    mesh32 = mesh.astype(torch.float32)
    u = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (mesh.n_elements,) + (mesh.nl,) * 3), device="cuda")
    res = 1e-3 * u.flip(0)
    applies = torch.equal(apply_sipg(mesh32, u.float()),
                          apply_sipg(mesh32, u.float()))
    estimates = torch.equal(estimate_bi(mesh, u, res),
                            estimate_bi(mesh, u, res))
    print(f"[10] (d) adapted sphere ({mesh.n_elements} elements, "
          f"{mesh.hc_elem.shape[0]} mortars): two generic f32 applies equal "
          f"bit for bit: {applies}; two estimates: {estimates}")
    check(applies and estimates, "(d) the mortar sums are not repeatable")


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
    # C10: level 3 again, from the same start: the same inner count
    (b3,) = curved_run(torch, np, "b3")
    its = [b[0]["fields"]["iterations"], b3["fields"]["iterations"]]
    print(f"[10] (b) level-3 mixed-curved solve twice: inner iterations "
          f"{its[0]} and {its[1]} (outer {b[0]['fields']['outer']} and "
          f"{b3['fields']['outer']}), L2 {b[0]['l2']!r} and {b3['l2']!r}")
    check(its[0] == its[1] and b[0]["l2"] == b3["l2"],
          f"(b) the level-3 solve is not repeatable: {its}")

    # (c) the bench-row size: both applies against each other and timed
    timing = curved_apply_timing(torch, np, card)

    # (d) hp smooth_pred on the 7-tree sphere, held to the JAX forests
    d = curved_run(torch, np, "d", keep_mesh=True)
    repeat_on_adapted_sphere(torch, np, d[1].pop("built"))
    for e in d:
        e.pop("built", None)
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


def nonlinear_run(torch, np, key):
    """One run of phase 11 through the CLI entry: its per-level records
    (norm line, Newton iterations, ‖F‖ history, Krylov iterations per
    Newton step, Σ η², forest digest, host seconds of mesh build, solve,
    estimator and AMR step) printed beside the JAX pins, and the
    driver's result.  B1 must not run on this path."""
    from disco4est_tpu_torch import __main__ as cli
    from disco4est_tpu_torch.laplacian import structured as S

    run = dict(NONLINEAR_RUNS[key])
    problem = run.pop("problem")
    text = NONLINEAR_OPTIONS.format(**run)
    results = []
    run_nonlinear = cli.run_nonlinear

    def capture(*args, **kw):
        results.append(run_nonlinear(*args, **kw))
        return results[-1]

    S.KERNEL_LAUNCHES = 0
    buf = io.StringIO()
    cli.run_nonlinear = capture
    t0 = time.perf_counter()
    try:
        with amr_probe(torch, np) as epochs, contextlib.redirect_stdout(buf):
            code = cli.main([text, f"--problem={problem}", "--device=cuda"])
        torch.cuda.synchronize()
    finally:
        cli.run_nonlinear = run_nonlinear
    wall = time.perf_counter() - t0
    check(code == 0, f"({key}) CLI exit code {code}")
    lines = buf.getvalue().splitlines()
    n = run["steps"] + 1
    check(len(results) == 1 and len(epochs) == n
          and len(lines) == 2 * n + (n >= 2)
          and all(len(line.split()) == 4 for line in lines[:n])
          and all(line.startswith(f"newton level {k}:")
                  for k, line in enumerate(lines[n:2 * n])),
          f"({key}) unexpected CLI output {lines}")
    result = results[0]
    for k, (rec, line, info, row, pin) in enumerate(zip(
            epochs, lines[:n], result.solves, result.norms.rows,
            NONLINEAR_PINS[key])):
        E, dof, _, value = line.split()
        rec.update(E=int(E), dof=int(dof), value=float(value), line=line,
                   its=info.iterations, fnorm=info.residual_norm,
                   history=info.history, krylov=info.krylov,
                   solve=info.seconds, eta2=row["eta2_sum"])
        print(f"[11] ({key}) level {k}: {line}; Newton iterations "
              f"{info.iterations} (JAX {pin[3]}), ||F|| history "
              f"{['%.6e' % f for f in info.history]} (JAX "
              f"{['%.6e' % f for f in pin[4]]}); Krylov iterations "
              f"{info.krylov} (JAX {pin[5]}); sum eta2 {rec['eta2']!r} "
              f"(JAX {pin[6]!r}); forest {rec['forest']} (JAX {pin[7]}); "
              f"seconds: mesh {rec['mesh']:.3f}, solve {info.seconds:.3f}, "
              f"estimate {rec.get('estimate', 0.0):.3f}, amr "
              f"{rec.get('amr', 0.0):.3f}")
        check((rec["E"], rec["dof"], rec["forest"]) == (pin[0], pin[1],
                                                         pin[7]),
              f"({key}) level {k}: {rec['E']} {rec['dof']} {rec['forest']}"
              f", JAX {pin[0]} {pin[1]} {pin[7]}")
        check(np.isfinite(rec["value"]) and np.isfinite(rec["eta2"]),
              f"({key}) level {k}: {line}, eta2 {rec['eta2']}")
    print(f"[11] ({key}) {problem}: CLI wall {wall:.2f} s, B1 launches "
          f"{S.KERNEL_LAUNCHES}")
    check(S.KERNEL_LAUNCHES == 0, f"({key}) B1 ran on the nonlinear path")
    return epochs, result


def two_punctures_digit(torch):
    """(d) the reference's TwoPunctures point digit through the API on
    the card: 7-tree, R0 10, R1 1000, compactified inner shell, level 0,
    deg 1 (56 DOF), FACE_H_EQ_J_DIV_SJ_MIN_LOBATTO, Robin 1/r; the
    Jacobian solved dense, as `tests/test_regression_digits.py:65-128`
    does (the early Jacobian is indefinite)."""
    from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.probe import interpolate_at_point
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.problems import two_punctures as tp
    from disco4est_tpu_torch.solvers.newton import NewtonParams, newton_solve

    geom = CubedSphereGeometry("7tree", R0=10.0, R1=1000.0,
                               compactify_inner_shell=True)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 0), deg=1,
                      face_h_type="j_div_sj_min_lobatto", device="cuda")
    check(mesh.n_elements == 7 and mesh.local_nodes == 56, "(d) sizes")
    params = tp.TwoPuncturesParams()
    rc = mesh.boundary_values_quad(params.robin_coeff)
    n, shape = mesh.local_nodes, (7, 2, 2, 2)
    eye = torch.eye(n, dtype=torch.float64, device="cuda").reshape(
        (n,) + shape)

    def jac_solve(u0, rhs, rtol):
        A = torch.stack([tp.jacobian_apply(mesh, u0, eye[i], params, rc)
                         .reshape(-1) for i in range(n)], dim=1)
        return torch.linalg.solve(A, rhs.reshape(-1)).reshape(shape)

    res = newton_solve(
        lambda u: tp.residual(mesh, u, params, rc), jac_solve,
        mesh.init_field(params.initial_guess),
        NewtonParams(atol=1e-14, max_iter=50, inner_rtol=1e-12))
    check(res.residual_norm < 1e-13, f"(d) Newton stopped at "
          f"{res.residual_norm}: {res.history}")
    val, elem = interpolate_at_point(mesh, res.u, (10.0, 0.0, 0.0))
    return val, elem, res


def phase_nonlinear(torch, np, card):
    """Phase 11: the nonlinear Newton–Krylov path on the card (f64 torch
    operations; no hand-written kernel runs on it, and the three
    kernels' counts, set to 0 before, must stay 0)."""
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.tools import exp_kernel_design as X

    print(f"[11] the nonlinear path on {card}")
    t_phase = time.perf_counter()
    S.KERNEL_LAUNCHES = fused.KERNEL_LAUNCHES = X.KERNEL_LAUNCHES = 0
    launches = 0

    # (a) the CDS regression: the reference's digits and JAX's forest
    a, _ = nonlinear_run(torch, np, "a")
    launches += S.KERNEL_LAUNCHES
    for rec, digit, head in zip(a, CDS_DIGITS, ("64 1728 1728 9.6078621",
                                                "288 7776 7776 3.7944365")):
        rel = abs(rec["value"] - digit) / digit
        print(f"[11] (a) {rec['line']}: rel to the reference digit "
              f"{digit!r} {rel:.3e}")
        check(rec["line"].startswith(head) and rel <= CDS_DIGIT_REL,
              f"(a) line {rec['line']!r} vs the digit {digit!r}")
        check(rec["fnorm"] <= 1e-12, f"(a) ||F|| {rec['fnorm']}")

    # (b) the full width: CDS at deg 3 on the main path's brick
    b, _ = nonlinear_run(torch, np, "b")
    launches += S.KERNEL_LAUNCHES
    check([e["E"] for e in b] == [4096, 32768]
          and b[1]["dof"] == 2097152, "(b) sizes")
    for k, (rec, pin) in enumerate(zip(b, NONLINEAR_PINS["b"])):
        gap = abs(rec["value"] - pin[2])
        print(f"[11] (b) level {k}: L2 {rec['value']!r}, JAX {pin[2]!r}, "
              f"gap {gap:.3e} (bound {CDS_L2_ABS:.0e}); ||F|| "
              f"{rec['fnorm']:.3e}")
        check(gap <= CDS_L2_ABS, f"(b) level {k} L2 {rec['value']} vs JAX "
              f"{pin[2]}")
        check(rec["fnorm"] <= 1e-12, f"(b) level {k} ||F|| {rec['fnorm']}")
    ratio = b[0]["value"] / b[1]["value"]
    five = b[1]
    print(f"[11] (b) level 4 / level 5 L2 {ratio:.2f}; level 5 on {card}: "
          f"{five['solve'] / max(five['its'], 1):.4f} s per Newton step, "
          f"{five['solve'] / max(sum(five['krylov']), 1) * 1e3:.3f} ms per "
          f"Krylov iteration ({sum(five['krylov'])} iterations, "
          f"{five['solve']:.3f} s)")
    check(ratio >= 4.0, f"(b) the error fell {ratio:.2f}x, less than 4x")

    # (c) TwoPunctures through the CLI: FCG counts printed, not pinned
    (c,), res = nonlinear_run(torch, np, "c")
    launches += S.KERNEL_LAUNCHES
    pin = NONLINEAR_PINS["c"][0]
    sum_u = float(res.u.sum())
    rel_u = abs(sum_u - TP_SUM_U) / TP_SUM_U
    rel_eta = abs(c["eta2"] - pin[6]) / pin[6]
    print(f"[11] (c) Newton iterations {c['its']} (JAX {pin[3]}), ||F|| "
          f"{c['fnorm']:.3e}; sum u {sum_u!r} (JAX {TP_SUM_U!r}, rel "
          f"{rel_u:.3e}); sum eta2 rel to JAX {rel_eta:.3e}")
    check(c["its"] == pin[3], f"(c) {c['its']} Newton iterations")
    check(c["fnorm"] <= 1e-10, f"(c) ||F|| {c['fnorm']}")
    check(rel_u <= TP_SUM_U_REL, f"(c) sum u {sum_u}")
    check(rel_eta <= TP_ETA2_REL, f"(c) sum eta2 {c['eta2']}")

    # (d) the reference's TwoPunctures point digit through the API
    t0 = time.perf_counter()
    val, elem, res = two_punctures_digit(torch)
    gap = abs(val - TP_DIGIT)
    print(f"[11] (d) 56 DOF, {res.iterations} Newton steps (||F|| "
          f"{res.residual_norm:.3e}): u(10, 0, 0) = {val!r} from element "
          f"{elem}, reference {TP_DIGIT!r}, gap {gap:.3e}; "
          f"{time.perf_counter() - t0:.2f} s")
    check(gap <= TP_DIGIT_ABS, f"(d) u(10, 0, 0) = {val}")

    counts = dict(B1=launches, B2=fused.KERNEL_LAUNCHES,
                  B3=X.KERNEL_LAUNCHES)
    print(f"[11] kernel launches in phase 11: {counts} (the nonlinear path "
          f"runs f64 torch operations only); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(not any(counts.values()), f"a kernel ran in phase 11: {counts}")
    return c["krylov"], c["solve"]


def precond_run(torch, np, key, nonlinear=False):
    """One run of phase 12 through the CLI entry: its per-level records
    (norm line, solve or Newton line, Krylov iterations, forest digest,
    mesh seconds) printed beside the JAX pins of
    `refcheck/precond_smoke_pins.py`, the CLI wall and the peak device
    memory.  Returns the records, the driver's result and the Σ u of
    each level's solution."""
    from disco4est_tpu_torch import __main__ as cli
    from disco4est_tpu_torch import driver

    if nonlinear:
        run = dict(PRECOND_NONLINEAR_RUNS[key])
        problem = run.pop("problem")
        text = PRECOND_NONLINEAR_OPTIONS.format(**run)
        name = "run_nonlinear"
    else:
        level, deg, maxd, scheme, steps, pc, sm, bt = PRECOND_RUNS[key]
        text = PRECOND_OPTIONS.format(
            level=level, deg=deg, max_degree=maxd, scheme=scheme,
            steps=steps, pc=pc, smoother=sm, bottom=bt,
            use_structured="auto", mixed=1)
        problem, name = "sinx", "run_poisson"
    results, sums = [], []
    run_fn, newton = getattr(cli, name), driver.newton_solve

    def capture(*args, **kw):
        results.append(run_fn(*args, **kw))
        return results[-1]

    def summing_newton(*args, **kw):
        res = newton(*args, **kw)
        sums.append(float(res.u.sum()))
        return res

    buf = io.StringIO()
    setattr(cli, name, capture)
    driver.newton_solve = summing_newton
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with amr_probe(torch, np) as epochs, contextlib.redirect_stdout(buf):
            code = cli.main([text, f"--problem={problem}", "--device=cuda"])
        torch.cuda.synchronize()
    finally:
        setattr(cli, name, run_fn)
        driver.newton_solve = newton
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(code == 0, f"({key}) CLI exit code {code}")
    lines = buf.getvalue().splitlines()
    result = results[0]
    n = len(result.solves)
    check(len(epochs) == n and len(lines) == 2 * n + (n >= 2)
          and all(len(line.split()) == 4 for line in lines[:n]),
          f"({key}) unexpected CLI output {lines}")
    pins = PRECOND_PINS.get(key, [])
    for k, (rec, line, info) in enumerate(zip(epochs, lines[:n],
                                              result.solves)):
        E, dof, _, value = line.split()
        counts = info.krylov if nonlinear else [info.iterations]
        rec.update(E=int(E), dof=int(dof), value=float(value), line=line,
                   counts=counts, info=info)
        pin = pins[k] if k < len(pins) else None
        print(f"[12] ({key}) level {k}: {line}; {lines[n + k]}; Krylov "
              f"{counts} (JAX {pin[3] if pin else 'no pin'}); forest "
              f"{rec['forest']}; mesh {rec['mesh']:.3f} s")
        check(np.isfinite(rec["value"]), f"({key}) level {k}: {line}")
        if pin is not None:
            check((rec["E"], rec["dof"], rec["forest"])
                  == (pin[0], pin[1], pin[4]),
                  f"({key}) level {k}: {rec['E']} {rec['dof']} "
                  f"{rec['forest']}, JAX {pin[0]} {pin[1]} {pin[4]}")
            check(len(counts) == len(pin[3]) and all(
                abs(a - b) <= PRECOND_COUNT_SLACK * b + 2
                for a, b in zip(counts, pin[3])),
                f"({key}) level {k}: Krylov {counts}, JAX {pin[3]}")
        if not nonlinear:
            check(info.residual_norm <= 5e-15 and not info.fallback,
                  f"({key}) level {k}: {lines[n + k]}")
    print(f"[12] ({key}) CLI wall {wall:.2f} s, peak device memory "
          f"{peak:.2f} GiB")
    return epochs, result, sums


def schwarz_digit(torch):
    """(c) the reference's Schwarz trajectory through the API on the card:
    13-tree sphere R0 1/3, R1 2/3, R2 1, level 0, deg 4,
    FACE_H_EQ_J_DIV_SJ_QUAD, num_nodes_overlap 4, 400 subdomain CG
    iterations; 10 iterates u ← u + M(b − A u) held to the reference's
    ‖r‖² and L2 (`tests/test_regression_digits.py:193-266`)."""
    from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.solvers.schwarz_overlap import (
        build_overlapping_schwarz,
    )

    geom = CubedSphereGeometry("13tree", R0=1.0 / 3.0, R1=2.0 / 3.0, R2=1.0)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 0), deg=4, deg_quad=4,
                      face_h_type="j_div_sj_quad", device="cuda")
    poly = lambda x, y, z: torch.exp(x + y + z) * (x * x + y * y + z * z - 1)
    neglap = lambda x, y, z: -torch.exp(x + y + z) * (
        3.0 + x * (4.0 + 3.0 * x) + y * (4.0 + 3.0 * y) + z * (4.0 + 3.0 * z))
    rhs = build_rhs_with_strong_bc(mesh, mesh.init_field(neglap),
                                   mesh.boundary_values(poly))
    sol = mesh.init_field(poly)
    M = build_overlapping_schwarz(mesh, num_nodes_overlap=4, iterations=400)
    u = torch.zeros_like(rhs)
    out = []
    for i, (r2_ref, l2_ref) in enumerate(SCHWARZ_DIGIT_REF):
        r = rhs - apply_sipg(mesh, u)
        r2 = float(torch.sum(r * r))
        u = u + M(r)
        l2 = float(torch.sum(mesh.l2_norm_sqr(torch.abs(sol - u))))
        out.append((r2, l2))
        check(abs(r2 - r2_ref) < max(1e-11 * r2_ref, 2e-15)
              and abs(l2 - l2_ref) < max(1e-9 * l2_ref, 2e-15),
              f"(c) iterate {i}: |r|^2 {r2!r} (ref {r2_ref!r}), L2 {l2!r} "
              f"(ref {l2_ref!r})")
    return out


def _wall_ms(torch, fn, n):
    """Host wall milliseconds per call of `n` calls behind a device
    synchronize (a V-cycle is thousands of launches: host-bound)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_precond(torch, np, card, fcg5, tp11):
    """Phase 12: the preconditioners on the card through the CLI entry
    (f64 torch operations; B1, B2 and B3 must not launch)."""
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.laplacian.hp import apply_sipg_hp, own_mask
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.solvers import multigrid as mg
    from disco4est_tpu_torch.tools import exp_kernel_design as X

    print(f"[12] the preconditioners on {card}")
    t_phase = time.perf_counter()
    S.KERNEL_LAUNCHES = fused.KERNEL_LAUNCHES = X.KERNEL_LAUNCHES = 0

    # (a) sinx with multigrid, level 4 -> 5 at deg 3
    a, res_a, _ = precond_run(torch, np, "a")
    l2 = a[1]["value"]
    rel = abs(l2 - LEVEL5_L2) / LEVEL5_L2
    hier = res_a.precond
    info = a[1]["info"]
    r = hier.meshes[0].init_field(
        lambda *c: sum(torch.sin(3 * x) for x in c))
    zero = torch.zeros_like(r)
    vms = _wall_ms(torch, lambda: mg.v_cycle(hier, apply_sipg, r, zero), 5)
    print(f"[12] (a) level 5: L2 {l2!r} (rel to JAX {rel:.3e}); "
          f"{hier.n_levels} levels; set-up {info.setup}; solve "
          f"{info.seconds:.3f} s, {info.iterations} FCG iterations (phase 5's "
          f"unpreconditioned f64 FCG: {fcg5}); {vms:.2f} ms per V-cycle")
    check(rel <= LEVEL5_REL, f"(a) level-5 L2 {l2} vs JAX {LEVEL5_L2}")
    check(all(e["info"].path == "fcg-mg" for e in a), "(a) path")
    v1 = mg.v_cycle(hier, apply_sipg, r, zero)
    check(torch.equal(v1, mg.v_cycle(hier, apply_sipg, r, zero)),
          "(f) two level-5 V-cycles differ")

    # (b) Chebyshev and Schwarz at level 4, then the MG plugins
    b_cheby, _, _ = precond_run(torch, np, "cheby")
    b_sw, res_sw, _ = precond_run(torch, np, "schwarz")
    level4 = AMR_PINS["a"][0][3]
    for name, rec in (("cheby", b_cheby[0]), ("schwarz", b_sw[0])):
        rel = abs(rec["value"] - level4) / level4
        print(f"[12] (b) {name}: L2 rel to JAX {rel:.3e}, "
              f"{rec['counts']} iterations, solve {rec['info'].seconds:.3f} "
              f"s, set-up {rec['info'].setup}")
        check(rel <= AMR_REL, f"(b) {name} level-4 L2 {rec['value']}")
    M = res_sw.precond
    rr = torch.sin(torch.arange(M.shape[0] * 64, dtype=torch.float64,
                                device="cuda")).reshape(M.shape)
    sms = _wall_ms(torch, lambda: M(rr), 3)
    print(f"[12] (b) one Schwarz apply at level 4: {sms:.2f} ms "
          f"({M.rep_mesh.n_elements} replicated elements, "
          f"{M.iterations} subdomain CG iterations)")
    check(torch.equal(M(rr), M(rr)), "(f) two Schwarz applies differ")
    for key in ("mg_so_reuse", "mg_none_cheby", "mg_cheby_cheby",
                "mg_block"):
        (rec,), _, _ = precond_run(torch, np, key)
        pin = PRECOND_PINS[key][0]
        rel = abs(rec["value"] - pin[2]) / pin[2]
        check(rel <= PRECOND_L2_REL, f"({key}) L2 {rec['value']} vs JAX "
              f"{pin[2]} (rel {rel})")

    # (c) the Schwarz regression digit on the card
    t0 = time.perf_counter()
    traj = schwarz_digit(torch)
    print(f"[12] (c) Schwarz digit: first L2 {traj[0][1]:.15f} (reference "
          f"0.152286388792538), last |r|^2 {traj[-1][0]!r}; 10 iterates "
          f"within the bounds, {time.perf_counter() - t0:.2f} s")
    check("0.15228638" in f"{traj[0][1]:.15f}", "(c) the digit")

    # (d) hp smooth_pred with multigrid (phase 9 (c)'s configuration)
    d, res_d, _ = precond_run(torch, np, "d")
    check(any(e["info"].path == "fcg-mg-hp" for e in d),
          "(d) no mixed-degree epoch ran the hp V-cycle")
    for k, (rec, pin) in enumerate(zip(d, PRECOND_PINS["d"])):
        rel = abs(rec["value"] - pin[2]) / pin[2]
        check(rel <= PRECOND_L2_REL, f"(d) level {k} L2 {rec['value']} vs "
              f"JAX {pin[2]}")
    hh = res_d.precond
    check(hh.hp, "(d) the last hierarchy is not hp")
    m0 = hh.meshes[0]
    rh = m0.init_field(lambda *c: sum(torch.sin(3 * x) for x in c)) \
        * own_mask(m0)
    zh = torch.zeros_like(rh)
    check(torch.equal(mg.v_cycle(hh, apply_sipg_hp, rh, zh),
                      mg.v_cycle(hh, apply_sipg_hp, rh, zh)),
          "(f) two hp V-cycles differ")

    # (e) Newton-MG: CDS at deg 3, level 4 -> 5; TwoPunctures level 1 -> 2
    cds, _, _ = precond_run(torch, np, "cds", nonlinear=True)
    for k, (rec, pin) in enumerate(zip(cds, NONLINEAR_PINS["b"])):
        gap = abs(rec["value"] - pin[2])
        info = rec["info"]
        print(f"[12] (e) CDS level {k}: L2 gap to phase 11 (b)'s JAX pin "
              f"{gap:.3e} (bound {CDS_L2_ABS:.0e}); Newton {info.iterations} "
              f"(JAX {pin[3]}), FCG {info.krylov} (unpreconditioned CG in "
              f"phase 11: {pin[5]}), {info.seconds:.3f} s")
        check(gap <= CDS_L2_ABS, f"(e) CDS level {k} L2 {rec['value']}")
        check(info.residual_norm <= 1e-12, f"(e) CDS level {k} ||F||")
    tq, _, sums = precond_run(torch, np, "tp_jq", nonlinear=True)
    check(len(tq) == 2, "(e) TwoPunctures: two levels expected")
    for k, (rec, pin_u, jax_fcg) in enumerate(zip(tq, TP_JQ_SUM_U,
                                                  TP_JQ_JAX_FCG)):
        info = rec["info"]
        rel_u = abs(sums[k] - pin_u) / abs(pin_u)
        print(f"[12] (e) TwoPunctures, pointwise penalty, level {k + 1}: "
              f"{info.iterations} Newton steps, ||F|| "
              f"{info.residual_norm:.3e}, FCG {info.krylov} (JAX "
              f"unpreconditioned {jax_fcg}), sum u {sums[k]!r} (JAX "
              f"{pin_u!r}, rel {rel_u:.3e}), {info.seconds:.2f} s (phase "
              f"11 (c), volume/area h, level 1 unpreconditioned: FCG "
              f"{tp11[0]}, {tp11[1]:.2f} s; PERF.md: {TP_PHASE11_SECONDS} s)")
        check(info.residual_norm <= 1e-10, f"(e) TP level {k + 1} ||F|| "
              f"{info.residual_norm}")
        check(rel_u <= TP_SUM_U_REL,
              f"(e) TP level {k + 1} sum u {sums[k]} vs JAX {pin_u}")

    counts = dict(B1=S.KERNEL_LAUNCHES, B2=fused.KERNEL_LAUNCHES,
                  B3=X.KERNEL_LAUNCHES)
    print(f"[12] kernel launches in phase 12: {counts} (the preconditioned "
          f"paths run f64 torch operations only); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(not any(counts.values()), f"a kernel ran in phase 12: {counts}")


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
    b1_launches, level5_l2, fcg5 = phase_real_size(torch)
    b2_abs, b2 = phase_fused(torch, np, card)
    b3_abs, b3 = phase_axis(torch, np, card)
    tool_launches = phase_tools(torch)
    phase_amr(torch, np, card, level5_l2, b1[(3, 5)]["ms"])
    phase_curved(torch, np, card)
    tp11 = phase_nonlinear(torch, np, card)
    phase_precond(torch, np, card, fcg5, tp11)

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
