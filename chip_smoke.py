#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`disco4est_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and `nvcc`.  Phases, one or more lines each; any failure exits non-zero:

1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
2. the build of the four CUDA kernels from `disco4est_tpu_torch/csrc/`
   (one `nvcc` each, all started together; each SIPG library holds its
   f32 and its bf16 instances), with their build seconds, register,
   shared-memory and spill lines, and the count of tensor-core
   instructions (HGMMA/HMMA) in each SIPG library's SASS, which must not
   be 0 (B1 and B2 run split-TF32 and bf16 `wgmma` products); then each
   bf16 instance (nl, nblk) of each SIPG library on a line of its own,
   with its HGMMA count, which must not be 0 either, and its ptxas
   register and spill lines;
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
   echoed; B1, B2 and B3 must each have launched there, in f32 and (B1,
   B2) in bf16, the tools' own f32 error lines must be within the
   tolerances above, their bf16 error lines (the bf16 apply against the
   f32 GEMM form) above 5e-6 and at most 1e-2, and TF32 must be off again
   afterwards;
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
11. the nonlinear Newton–Krylov path (f64 torch operations and the mass
   kernel of phase 18, which must launch; the three SIPG and axis
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
       sums, C10);
13. the disk and misc geometries, the derivatives and the K-slot Schwarz
   (torch operations; the three kernels' counts must stay 0), through the
   CLI entry, one line per epoch with its norm line, solve path, outer and
   inner iterations, fallback, host seconds of mesh build and solve, ms
   per iteration and peak device memory, beside the JAX pins of
   `refcheck/geometry_smoke_pins.py`:
   (a) sinx on the 5-tree disk at full width (deg 3,
       FACE_H_EQ_J_DIV_SJ_QUAD), uniform_h from level 5 to 6 (5,120 ->
       20,480 elements, 81,920 -> 327,680 DOF; cut in depth from level 7,
       1,310,720 DOF: that epoch and a plain f64 FCG solve of it took 83 s
       of the phase's ~150 s budget on an H100): every epoch through
       `mixed-curved` with no fallback, both levels within `LEVEL5_REL`
       of JAX, the L2 falling at least 8x; level 6 as a plain f64 FCG
       solve, held to JAX too and printed with its true residual (the
       plain solve stops on its recursive residual, which drifts below
       the true one); level 6 once more with the JAX driver's
       400-iteration inner cap, printed (ROADMAP C14); then the JAX CLI's
       uniform_p disk (level 3, deg 3 -> 5) line by line;
   (b) the trapezoid and the pizza-half at level 4, uniform_p from deg 2
       to 4: JAX's counts and L2, the deg-4 error below 0.1x the deg-2 one;
   (c) the Lorentzian on the hole-in-a-box, deg 3, level 1 -> 3 (393,216
       DOF): every level within `LEVEL5_REL` of JAX, the L2 falling every
       level; level 3 as a plain f64 FCG solve, as in (a);
   (d) `gradient` and `hessian_trace` on the level-5 disk and a level-2
       7-tree sphere, equal to the port's CPU run to 1e-12 (the hessian to
       the larger of 1e-12 and its own rounding: the CPU's change under a
       2^-52 relative perturbation of u, 1.1e-11 on the level-5 disk, as
       the second differences amplify rounding ~1/h²); the hessian
       trace of sinx's deg-3 interpolant against −2π²u on the level-5 and
       level-6 disks, its error falling at least 3x;
   (e) the K-slot Schwarz: (i) phase 12 (b)'s run with `subdomain_chunk =
       1024`: its FCG count within 1 of phase 12 (b)'s, the L2 within
       `LEVEL5_REL`, the ms per apply and peak memory beside it; (ii) one
       K-slot apply (chunk 4096) against one materialized apply (884,736
       replicated elements) on the level-5 brick at deg 3, to 1e-12, with
       build seconds, apply ms and the peak memory of each, the K-slot one
       the lower; (iii) the CDS regression with `pc_type = schwarz`,
       materialized and K-slot (chunk 16), cut in depth to its level 2
       (the K-slot run of its adapted level 1, 288 elements in 18 chunks,
       took 161 s on an H100, launch-bound): equal norm lines, Newton and
       Krylov counts (both variants sum the subdomain dots as one
       pairwise tree and the corrections slot by slot in one order);
       (iv) two K-slot applies of one input bit-equal.
14. IO and checkpoint-restart through the drivers, with the seconds and
   bytes of every checkpoint save and load (behind synchronizes):
   (a) phase 9 (d)'s hp smooth_pred run with `[checkpoint] prefix`,
       bit-equal to the same run without it; restarted from its level 1
       by `structure` and by `history`: final u max |Δ| = 0.0, the last L2
       and the forest checksum equal, B1 0 times on the restarted level
       and as often as in the full run after it;
   (b) sinx deg 3 on the level-5 brick (2,097,152 DOF) as a plain f64 CG
       with `checkpoint_every_n_krylov_its = 50`: iterations and u
       bit-equal to the solve without checkpoints, one `_it<k>` file per
       50 iterations, the seconds a mid-solve save adds; then with
       `pc_type = cheby` (FCG chunks) against the same solve in one
       chunk;
   (c) phase 11 (b)'s CDS (deg 3, level 4 -> 5) with FCG-Chebyshev and
       `checkpoint_every_n_krylov_its = 1`: one file per Newton iterate;
       restarted from level 0 by history: u bit-equal, ‖F‖ equal;
   (d) `[d4est_vtk] filename` on the level-4 deg-3 brick (262,144 points,
       the header's counts checked, the write timed), and the CLI's
       `--plot-checkpoint` on (a)'s level-1 file in a subprocess, which
       must write a `.vtu` with u, deg and level;
   (e) `[driver] print_timings = 1` and `[logging] log_dir` on phase 9
       (a)'s run through the CLI entry: one row per level with mesh,
       solve and amr (C4), each row's phases within the level's wall, the
       norm lines in `d4est_norms.log`;
   (f) `ip_energy_norm_sqr` of (b)'s level-5 error and `penalty_report`
       of a hanging brick, scalar and pointwise penalty, on the card
       against the CPU to 1e-12 relative; B2 and B3 launch 0 times.

15. the distributed driver (`[parallelism]`, `parallel/`; torch
   operations and collectives, no kernel):
   (a) in this process, a real NCCL group of world size 1: which
       collectives gloo takes on CUDA tensors (all must be); the halo
       apply of the sinx brick at deg 3 / level 5 (2,097,152 DOF), the hp
       halo apply (degrees 2 and 3), both on a hanging brick, and the
       7-tree level-3 sphere with the pointwise penalty, each against the
       global apply to 1e-12 relative (f64), and the same applies on 4
       ranks driven in lockstep on the card; ms per halo apply beside the
       global one (device time where ten applies fit the launch queue,
       and wall) and the bytes an apply exchanges on 2 and 4 ranks; the
       sharded V-cycle at level 5 against the global one (1e-10) and its
       Lanczos bounds (1e-12); the driver's distributed CG at level 5
       against the one-process CG (the same count, true residuals) and
       C17's witness, the same CG in one process on the general form
       (`apply_sipg(..., volume_mode="dense")`): the L2 within 1e-10 of
       the witness's, the witness within `DIST_FORM_REL` of the
       GEMM-form CG's and JAX's;
   (b) the CLI on 2 and 4 ranks sharing the card (`backend = auto`, which
       takes gloo there and says so): `tests/test_driver_distributed.py`'s
       sinx hp smooth_pred against the one-process run and the JAX
       distributed driver (`refcheck/dist_smoke_pins.py`), and at full
       width sinx deg 3 level 4 -> 5 (mixed precision, phase 9 (a)), hp
       smooth_pred from level 4 (phase 9 (d)), FCG + multigrid deg 3
       level 4 -> 5 (phase 12 (a)) and CDS deg 3 level 4 -> 5 (phase 11
       (b)), each norm line against the same driver on a world of one
       rank in this process (1e-11 relative after an f64 CG, else
       1e-10), and against the one-process run and JAX's one-device pins
       within `DIST_FORM_REL`; the full-width sinx and multigrid runs
       also against ROADMAP C17's witness, the same driver in one process
       on the general form of the operator (`apply_sipg` off its
       GEMM-form fast path, as the halo program computes it), at 1e-10;
       every solve on the halo program, each run's wall and solve lines
       printed; B1, B2 and B3 launch 0 times in this process's runs of
       (a) and (b);
   (c) the errors: `backend = nccl` on 2 ranks of one card raises the
       port's error (in seconds, through the CLI), and the C6 and C2
       combinations raise `NotImplementedError` before any rank joins a
       group.

16. the bf16 mode of B1 and B2 (`precision="bf16"`, the TPU kernels'
   default; TF32 off for the plain versions):
   (a) both bf16 kernels against their plain bf16 versions (2e-4
       relative L2, 1e-3 relative max) and the f64 apply (an L2 error at
       most 1.25x the plain version's), at every degree, on nblk-3
       bricks, at ragged E and on phase 6's meshes;
   (b) both bf16 kernels timed at deg 7 / level 4 and deg 3 / level 5
       beside the f32 kernels and the plain bf16 versions, against their
       bf16 bound (bytes over 3.35 TB/s, flop over 989 TFLOP/s), with
       the CTAs, the K-split and the K chunks (steps) a CTA runs;
   (c) phase 9 (a)'s sinx mixed solve at deg 3 with the bf16 inner solve
       (`make_inner_solve(precision="bf16")`) at level 4 and at phase 5's
       level 5, then with the plain bf16 version as the inner apply: the
       outer and inner counts, outer residuals, true residual, wall,
       fallback flag and B1's launches per precision (bf16 > 0, f32 0);
       pinned (`BF16_SOLVES`): level 4 converges, level 5 diverges and
       the driver would fall back to f64 CG (ROADMAP C19), whose L2, or
       the bf16 solve's, is held to JAX's at `LEVEL5_REL`.

17. the reference oracles on the card (`disco4est_tpu_torch/tools/
   oracles.py`, the constructions of the JAX digit tests; the compiled
   reference's values and the JAX tests' tolerances in
   `refcheck/oracle_smoke_pins.py`):
   (a) the sinx regression's grep digit (the L2 of the interpolated
       nodal |e|) and true L2, the CDS + 1 AMR step L2 and energy
       estimator, the 13-tree TwoPunctures digit u(100, 0, 0) (104
       elements, 832 nodes, dense Jacobian solves) and the 4-level
       TwoPunctures smooth_pred trajectory (counts exact, Ση²);
   (b) the Stamm hp-AMR trajectory rows 0-7, rows 6-7 (1520 elements,
       141,872 and 224,864 nodes) at the JAX test's deep tolerances,
       each row's CG iterations and seconds printed;
   (c) the deg-7 level-5 brick built with `store_full=True` and with
       `store_full=False`, `torch.cuda.max_memory_allocated` and the
       memory each mesh holds printed; B1 (the structured inner apply),
       B2 (`apply_sipg_fused`) and the f64 GEMM-form apply on the compact
       mesh equal to their output on the full mesh bit for bit;
   (d) B1-B3 (f32 and bf16) launch 0 times in (a)-(b): f64 torch
       operations only.

18. the mass kernel of the Newton Jacobian (`csrc/mass_apply.cu`,
   y = Vᵀ (c ⊙ V v), replacing no TPU kernel): its ptxas lines; against
   the plain path (`apply_mass_coeff_plain`) at deg 1-7, nq = n to
   n + 2, dim 2 and 3, f64 (rel ≤ 1e-13) and f32 (rel ≤ 1e-5), E 32,768,
   a synchronize after each launch; timed at deg 2 / level 5 and deg 7 /
   level 4 (f64) beside the plain path, against its bytes bound (v and c
   read, y written once, over 3.35 TB/s), L2-warm (the same inputs back
   to back) and cold (inputs rotated through more than twice the 50 MB
   L2); and a CDS Newton run at level 3 on the card, whose
   `launches.mass` must equal its Jacobian applies, Σ (Krylov iterations
   + 1) over the Newton steps.

19. the multigrid cells' V-cycle (`sinx_brick_l5_deg3_mg`'s options,
   `driver._build_pc`) against the plain reference V-cycle
   (`benchmark/reference/vcycle.py`, f64, given the port's Chebyshev
   bounds) on a seeded random residual at level 5 and level 6 (deg 3, 6
   and 7 levels): relative max gap ≤ `MG_REF_TOL` (1e-11), the
   reference's bottom CG pinned to the port's step and its own test
   within one step of it; then level 5 with its finest level's operator
   in f32, a planted fault that must fail the tolerance.  Each line
   gives the bottom steps, the gaps with the bottom one step short and
   long, λmax, the port's V-cycle wall and the peak memory.  Alone:
   `python -c "import numpy as np, torch, chip_smoke as c; n, card =
   c.phase_device(torch); c.phase_mg_reference(torch, np, card)"`.
20. the V-cycle as a CUDA graph (`multigrid.MGPreconditioner`) at level
   5 and level 6 (deg 3; the meshes of `sinx_brick_l5_deg3_mg` and
   `sinx_brick_l5to6_deg3_mg`): (a) four preconditioner calls (eager,
   capture, two launches) on seeded residuals, each equal to an eager
   `v_cycle` bit for bit, with the wall of each call to a synchronize,
   the host's enqueue and the device time (CUDA events) of one launch,
   the wall of launches back to back and of eager cycles; (b) the FCG-MG
   solve of the sinx rhs through `driver._solve_pc` with the graph and
   with it forced off (`eager=True`): the same FCG steps and `x` bit for
   bit, the walls, the solves' peak memory and the memory left allocated
   after the graph is released; (c) one run of each cell's job (its
   warm-up run first) with the graph off, then on: the run's wall and
   `torch.cuda.max_memory_allocated` in each phase (mesh, `d4est.pc`,
   solve, AMR step, the rest), so the phase that sets each cell's peak
   is on record.  Alone: `python -c "import numpy as np, torch,
   chip_smoke as c; n, card = c.phase_device(torch); c.phase_mg_graph(
   torch, np, card)"`.

`python3 chip_smoke.py --nccl=N` on a machine with N cards runs phase 15
(b)'s CLI with one rank a card (`backend = auto` takes NCCL there) and
prints the result line.

Then the whole run's wall, one JSON line of the kernels
(`{"kernels": [...]}`; B1 and B2 in
f32 and in bf16 once per timed size, each with the launches of a run at
that size: phase 5 for B1 at deg 3 / level 5 in f32, phase 16 (c)'s
level-5 solve in bf16, phase 8 for the rest) and, last, the result line
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
import types

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
PEAK_F64 = 34e12  # f64 FMA outside the tensor cores, H100 SXM
SPLIT_PRODUCTS = 3  # the split-TF32 scheme issues three TF32 products
# phase 16, the bf16 mode of B1 and B2 (ROADMAP B4): each bf16 kernel
# against its plain bf16 version (the same rounding points: bf16(u),
# bf16 traces and weights, bf16(Z), f32 sums; only the order of the f32
# sums differs, and bf16(Z) may round the other way where the traces'
# f32 product runs in another order), and against the f64 apply: its L2
# error at most 1.25x the plain version's on the same input
BF16_REL_L2, BF16_REL_MAX = 2e-4, 1e-3
BF16_F64_RATIO = 1.25
PEAK_BF16 = 989e12  # dense bf16 tensor-core peak, H100 SXM at 700 W
# B1 (deg, level, x1): every degree at level 1 on the unit cube, nblk 3
# bricks (a power-of-two and a non-power-of-two cw; deg 5: two column
# sub-blocks, deg 6 and 7: two warpgroups split the columns), and the two
# timed sizes
BF16_CASES = ([(d, 1, (1.0, 1.0, 1.0)) for d in range(1, 8)]
              + [(2, 1, (1.0, 2.0, 4.0)), (3, 2, (1.0, 1.0, 3.0)),
                 (5, 1, (1.0, 2.0, 4.0)), (6, 1, (1.5, 1.0, 0.7)),
                 (7, 1, (1.0, 2.0, 4.0)), (7, 4, (1.0, 1.0, 1.0)),
                 (3, 5, (1.0, 1.0, 1.0))])
# B2: phase 6's meshes, every degree, and ragged element counts (E = 24 and
# 65: a ragged last tile; the 65-tree brick has tree ids past 15)
BF16_FUSED_CASES = (FUSED_CASES
                    + [(d, 1, (1.0, 1.0, 1.0), (1, 1, 1)) for d in
                       (1, 4, 5, 6)]
                    + [(d, lv, (float(t[0]), 1.0, 1.0), t)
                       for d in (2, 7) for lv, t in ((1, (3, 1, 1)),
                                                     (0, (65, 1, 1)))])
BF16_TOOL_MAX = 1e-2  # phase 8: the bf16 apply against the f32 GEMM form
# (c) the sinx mixed solve at deg 3 with the bf16 inner solve: per level,
# its outer steps, inner iterations (within BF16_INNER_REL), whether the
# driver would fall back to f64 CG (pinned from the first card run), and the
# JAX L2 that the solve, or its fallback, must meet at LEVEL5_REL
BF16_MAX_OUTER = 60  # the driver's mixed_max_outer default
BF16_INNER_REL = 0.02
BF16_SOLVES = {
    # (the inner counts follow the kernels' order of summation: the
    # per-chunk sums of an earlier design took 1063 and 363, PERF.md)
    4: dict(outer=11, inner=1104, fallback=False, l2=AMR_PINS["a"][0][3]),
    5: dict(outer=3, inner=342, fallback=True, l2=LEVEL5_L2),
}

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

# phase 13: the disk and misc geometries (the options of
# `refcheck/geometry_smoke_pins.py`, whose JAX runs print the pins: CPU,
# numpy 2.0.2)
GEOMETRY_OPTIONS = """
[initial_mesh]
min_level = {level}
region0_deg = {deg}
region0_deg_quad_inc = 0

[mesh_parameters]
face_h_type = {face_h}
max_degree = {max_degree}

[flux]
name = sipg
sipg_penalty_prefactor = 2.0
sipg_penalty_fcn = maxp_sqr_over_minh

[amr]
scheme = {scheme}
num_of_amr_steps = {steps}

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
DISK = "name = disk\nr0 = 0.5\nr1 = 1.0"
HOLE = "name = hole_in_a_box\ninner_radius = 1.0\nbox_length = 10.0"
QUAD_H = "FACE_H_EQ_J_DIV_SJ_QUAD"
GEOMETRY_RUNS = {
    # (a) the disk at full width, level 5 -> 6 (cut from 7: level 7 and
    # a plain f64 FCG solve of it took 83 s of the phase's ~150 s on an
    # H100); level 6 alone as a plain f64 FCG solve; the uniform_p run of
    # the JAX CLI
    "a": dict(level=5, deg=3, max_degree=3, scheme="uniform_h", steps=1,
              face_h=QUAD_H, geometry=DISK, mixed=1, problem="sinx"),
    "a6f": dict(level=6, deg=3, max_degree=3, scheme="uniform_h", steps=0,
                face_h=QUAD_H, geometry=DISK, mixed=0, problem="sinx"),
    "ap": dict(level=3, deg=3, max_degree=5, scheme="uniform_p", steps=2,
               face_h=QUAD_H, geometry=DISK, mixed=1, problem="sinx"),
    # (b) the single-tree 2D maps, uniform_p from deg 2 to 4
    "trap": dict(level=4, deg=2, max_degree=4, scheme="uniform_p", steps=2,
                 face_h=QUAD_H, geometry="name = trap", mixed=1,
                 problem="sinx"),
    "pizza": dict(level=4, deg=2, max_degree=4, scheme="uniform_p", steps=2,
                  face_h=QUAD_H, geometry="name = pizza_half\nr0 = 0.5\n"
                  "r1 = 1.0", mixed=1, problem="sinx"),
    # (c) the hole-in-a-box, level 1 -> 3; level 3 alone as a plain f64
    # FCG solve
    "c": dict(level=1, deg=3, max_degree=3, scheme="uniform_h", steps=2,
              face_h=QUAD_H, geometry=HOLE, mixed=1, problem="lorentzian"),
    "c3f": dict(level=3, deg=3, max_degree=3, scheme="uniform_h", steps=0,
                face_h=QUAD_H, geometry=HOLE, mixed=0, problem="lorentzian"),
}
# (elements, DOF, L2) per level from the JAX driver
# (`refcheck/geometry_smoke_pins.py a5 a6 ap trap pizza hole hole3`)
HOLE3_PIN = (6144, 393216, 1.5917169034568844e-05)
GEOMETRY_PINS = {
    "a": [(5120, 81920, 1.5197996707216392e-08),
          (20480, 327680, 5.026451928921405e-10)],
    "a6f": [(20480, 327680, 5.026451928921405e-10)],
    "ap": [(320, 5120, 9.676940229968944e-06),
           (320, 8000, 5.33376336457762e-07),
           (320, 11520, 6.726050331400483e-08)],
    "trap": [(256, 2304, 3.585223491629404e-05),
             (256, 4096, 2.2763103407103242e-07),
             (256, 6400, 4.37981713187347e-09)],
    "pizza": [(256, 2304, 2.780560611109229e-05),
              (256, 4096, 2.0469866256102782e-07),
              (256, 6400, 1.0193174770159288e-08)],
    "c": [(96, 6144, 0.007300673864398753),
          (768, 49152, 0.0003415714960187432),
          HOLE3_PIN],
    "c3f": [HOLE3_PIN],
}
DERIV_REL = 1e-12  # the derivatives on the card against the CPU's
KSLOT_REL = 1e-12  # the K-slot Schwarz apply against the materialized one


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
    from disco4est_tpu_torch.laplacian import nonlinear as NL
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.tools import exp_kernel_design as X
    from disco4est_tpu_torch.util import cuda_build

    mods = (S, fused, X, NL)
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
        if m in (S, fused):  # the SIPG libraries run on the tensor cores
            per_fn = tensor_core_instructions(cuda_build, lib)
            n = sum(per_fn.values())
            print(f"[2] {lib.name}: {n} tensor-core instructions "
                  f"(HGMMA/HMMA) in cuobjdump -sass")
            check(n > 0, f"{lib.name} has no tensor-core instruction")
            bf16_instances(lib.name, per_fn, log)


# the mangled name of an instance of the bf16 kernel: (nl, nblk)
BF16_INSTANCE = re.compile(r"sipg_bf16_kernelILi(\d)ELi(\d)E")


def tensor_core_instructions(cuda_build, lib):
    """The count of HGMMA and HMMA instructions in the library's SASS, per
    function (mangled name)."""
    tool = pathlib.Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr[-2000:]}")
    counts, fn = {}, ""
    for line in proc.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts.setdefault(fn, 0)
        counts[fn] = counts.get(fn, 0) + len(
            re.findall(r"\bH(?:GMMA|MMA)\.", line))
    return counts


def bf16_instances(lib_name, per_fn, log):
    """Phase 2's lines on the bf16 instances of one SIPG library: each
    (nl, nblk) instance's HGMMA count (which must not be 0) and its ptxas
    register and spill lines."""
    ptxas, fn = {}, None
    for line in log:
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            fn = entry.group(1)
        elif fn and ("registers" in line or "spill" in line):
            ptxas.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    seen = 0
    for fn, n in sorted(per_fn.items()):
        inst = BF16_INSTANCE.search(fn)
        if not inst:
            continue
        seen += 1
        nl, nblk = inst.groups()
        print(f"[2] {lib_name} bf16 nl {nl} nblk {nblk}: {n} HGMMA; "
              + "; ".join(ptxas.get(fn, ["no ptxas line"])))
        check(n > 0, f"{lib_name}: bf16 instance nl {nl} nblk {nblk} has "
              "no tensor-core instruction")
    check(seen == 14, f"{lib_name}: {seen} bf16 instances, expected 14")


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



# phase 18: the mass kernel against the plain path (f64 / f32: six
# one-axis sums of up to 10 terms, in another order than cuBLAS's)
MASS_TOL = {"f64": 1e-13, "f32": 1e-5}
MASS_TIMED = ((2, 5), (7, 4))  # (deg, level), f64, nq = n
CDS_SMALL = """
[initial_mesh]
min_level = 3
region0_deg = 2
[mesh_parameters]
face_h_type = FACE_H_EQ_TREE_H
[amr]
scheme = none
[geometry]
name = brick
[d4est_solver_newton]
snes_atol = 1e-12
[d4est_solver_krylov_petsc]
ksp_type = cg
"""


def _mass_mesh(dim, deg, nq):
    """What `apply_mass_coeff` reads of a mesh without a radial rule."""
    from disco4est_tpu_torch.quadrature.quadrature import Quadrature

    return types.SimpleNamespace(dim=dim, deg=deg, deg_quad=nq - 1,
                                 quad=Quadrature("legendre"),
                                 rad_interp=None)


def phase_mass(torch, np, card):
    """Phase 18: the mass kernel of the Newton Jacobian.  Returns its
    largest f64 |Δ| against the plain path and the kernels line's numbers
    at deg 2 / level 5."""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.laplacian import nonlinear as NL
    from disco4est_tpu_torch.util import cuda_build
    from disco4est_tpu_torch.util.config import Options

    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 must be off for the f32 plain path")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    NL._load()
    lib = cuda_build.library_path(NL.SOURCE)
    print(f"[18] {lib.name} loaded in {time.perf_counter() - t0:.1f} s "
          "(built here unless phase 2 built it)")
    log = lib.with_suffix(".log").read_text().splitlines()
    fn, per_fn = None, {}
    for line in log:
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            fn = entry.group(1)
        elif fn and ("registers" in line or "stack" in line):
            per_fn.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    stacks = [f for f, lines in per_fn.items()
              if any(re.search(r"[1-9]\d* bytes stack frame", x)
                     or re.search(r"[1-9]\d* bytes spill", x) for x in lines)]
    for f in sorted(per_fn)[:4] + [f for f in sorted(per_fn)
                                   if "Li3ELi3ELi3E" in f]:
        print(f"[18] ptxas {f}: " + "; ".join(per_fn[f]))
    print(f"[18] {len(per_fn)} instances; with a stack frame or spills: "
          f"{len(stacks)} {stacks[:4]}")
    check(len(per_fn) == 84, f"{len(per_fn)} mass kernel instances")

    # (a) every instance against the plain path
    max_abs = 0.0
    worst = {"f64": 0.0, "f32": 0.0}
    E = 32768
    for dim in (3, 2):
        for deg in range(1, 8):
            n = deg + 1
            for nq in range(n, n + 3):
                mesh = _mass_mesh(dim, deg, nq)
                for key, dtype in (("f64", torch.float64),
                                   ("f32", torch.float32)):
                    rng = np.random.default_rng(deg * 10 + nq)
                    v = torch.as_tensor(rng.standard_normal(
                        (E,) + (n,) * dim), dtype=dtype, device=dev)
                    c = torch.as_tensor(rng.standard_normal(
                        (E,) + (nq,) * dim), dtype=dtype, device=dev)
                    out = NL.mass_apply_cuda(mesh, c, v)
                    torch.cuda.synchronize()
                    ref = NL.apply_mass_coeff_plain(mesh, c, v)
                    abs_err = float((out - ref).abs().max())
                    rel = abs_err / float(ref.abs().max())
                    worst[key] = max(worst[key], rel)
                    if key == "f64":
                        max_abs = max(max_abs, abs_err)
                    check(np.isfinite(rel) and rel <= MASS_TOL[key],
                          f"mass kernel dim {dim} deg {deg} nq {nq} {key}: "
                          f"rel {rel}")
    print(f"[18] (a) 84 instances at E {E} against the plain path: "
          f"largest rel f64 {worst['f64']:.3e}, f32 {worst['f32']:.3e}")

    # (b) timed, f64, nq = n: warm (the same inputs) and cold (inputs
    # rotated through more than twice the L2)
    result = None
    for deg, level in MASS_TIMED:
        n, E = deg + 1, 8 ** level
        mesh = _mass_mesh(3, deg, n)
        nbytes = 8 * E * 3 * n ** 3
        sets = []  # v and c of each set: 16 E n^3 bytes
        for k in range(-(-100 * 2**20 // (16 * E * n ** 3)) + 1):
            rng = np.random.default_rng(k)
            sets.append(tuple(torch.as_tensor(
                rng.standard_normal((E, n, n, n)), dtype=torch.float64,
                device=dev) for _ in range(2)))
        turn = [0]

        def cold(fn):
            def call():
                turn[0] = (turn[0] + 1) % len(sets)
                v, c = sets[turn[0]]
                return fn(mesh, c, v)
            return call

        v, c = sets[0]
        fns = {"kernel": lambda: NL.mass_apply_cuda(mesh, c, v),
               "plain": lambda: NL.apply_mass_coeff_plain(mesh, c, v),
               "kernel_cold": cold(NL.mass_apply_cuda)}
        for f in fns.values():
            f()
        torch.cuda.synchronize()
        t = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]) * 2:
            for k in order:
                t[k].append(_time_ms(torch, fns[k], 20 if k != "plain"
                                     else 4, 5))
        t = {k: _median(x) for k, x in t.items()}
        flop = 2.0 * E * 6 * n ** 4  # six passes of n-term sums a point
        t_ops, t_bytes = flop / PEAK_F64, nbytes / PEAK_BYTES
        bms = 1e3 * max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[18] (b) deg {deg} / level {level} (E {E}, f64, "
              f"{nbytes / 1e6:.1f} MB) on {card}: kernel warm "
              f"{t['kernel'] * 1e3:.2f} us, cold "
              f"{t['kernel_cold'] * 1e3:.2f} us (bound {bms * 1e3:.2f} us "
              f"by {by}: {bms / t['kernel_cold']:.1%} of it cold, "
              f"{bms / t['kernel']:.1%} warm); plain "
              f"{t['plain'] * 1e3:.1f} us ({t['plain'] / t['kernel_cold']:.0f}x"
              " the cold kernel)")
        if result is None:
            result = dict(ms=t["kernel_cold"], warm_ms=t["kernel"],
                          plain_ms=t["plain"], library_ms=None, bound_ms=bms,
                          bound_by=by)
        del sets

    # (c) a CDS Newton run on the card goes through the kernel
    opts = Options.load(CDS_SMALL)
    before = NL.KERNEL_LAUNCHES
    t0 = time.perf_counter()
    res = driver.run_nonlinear(opts, driver.CDSProblem(opts), device="cuda")
    krylov = [k for s_ in res.solves for k in s_.krylov]
    counters = res.trace["counters"]
    applies = sum(k + 1 for k in krylov)
    print(f"[18] (c) CDS level 3 deg 2 on the card: Newton "
          f"{[s_.iterations for s_ in res.solves]}, Krylov {krylov}, "
          f"launches.mass {counters['launches.mass']} (Jacobian applies "
          f"{applies}), L2 {res.norms.rows[-1]['L_2']!r}, "
          f"{time.perf_counter() - t0:.2f} s")
    check(counters["launches.mass"] == applies
          == NL.KERNEL_LAUNCHES - before,
          f"(c) mass launches {counters['launches.mass']} vs {applies}")
    return max_abs, dict(result, launches=counters["launches.mass"])

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

    rels, launches, rels_bf16, launches_bf16 = {}, {}, {}, {}
    # (mode, deg, level): the default size, then B2 at the main path's
    # size, so that each size's row has its own launch count
    runs = [("fused", 7, 4), ("phases", 7, 4), ("structured", 7, 4),
            ("fused", 3, 5)]
    for mode, deg, level in runs:
        S.KERNEL_LAUNCHES = fused.KERNEL_LAUNCHES = 0
        S.KERNEL_LAUNCHES_BF16 = fused.KERNEL_LAUNCHES_BF16 = 0
        lines = _tool_lines(time_fused.main, [
            "--mode", mode, "--deg", str(deg), "--level", str(level),
            "--device", "cuda"])
        torch.cuda.synchronize()
        if mode == "phases":
            continue
        rels[(mode, deg, level)] = _rel_from(lines, "rel err [^:]*:")
        launches[(mode, deg, level)] = (S.KERNEL_LAUNCHES
                                        + fused.KERNEL_LAUNCHES)
        rels_bf16[(mode, deg, level)] = _rel_from(lines,
                                                  "bf16 rel err [^:]*:")
        launches_bf16[(mode, deg, level)] = (S.KERNEL_LAUNCHES_BF16
                                             + fused.KERNEL_LAUNCHES_BF16)
    X.KERNEL_LAUNCHES = 0
    lines = _tool_lines(X.main, ["--device", "cuda"])
    rels["axis"] = _rel_from(lines, r"rel err vs plain \(one apply\)")
    torch.cuda.synchronize()
    launches["axis"] = X.KERNEL_LAUNCHES
    print(f"[8] launches in the tools: {launches}; errors {rels}")
    print(f"[8] bf16 launches in the tools: {launches_bf16}; bf16 errors "
          f"against the f32 GEMM form {rels_bf16}")
    for name, n in list(launches.items()) + list(launches_bf16.items()):
        check(n > 0, f"the tools never launched the {name} kernel")
    check(all(v <= REL_TOL for k, v in rels.items() if k != "axis"),
          f"tool errors above {REL_TOL}: {rels}")
    # the bf16 applies sit at the bf16 rounding, 3e-3 to 4e-3 relative L2
    # from f32 in JAX's own kernels; far above the f32 bound
    check(all(REL_TOL < v <= BF16_TOOL_MAX for v in rels_bf16.values()),
          f"bf16 tool errors outside ({REL_TOL}, {BF16_TOOL_MAX}]: "
          f"{rels_bf16}")
    check(rels["axis"] <= AXIS_TOL, f"E4 error above {AXIS_TOL}: {rels}")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 was left on after the probe")
    return launches, launches_bf16


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
            elif not epochs:  # a restart's history replay, before epoch 0
                return fn(*args, **kw)
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
    operations and the mass kernel, which must launch; the three other
    kernels' counts, set to 0 before, must stay 0)."""
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import nonlinear as NL
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.tools import exp_kernel_design as X

    print(f"[11] the nonlinear path on {card}")
    t_phase = time.perf_counter()
    S.KERNEL_LAUNCHES = fused.KERNEL_LAUNCHES = X.KERNEL_LAUNCHES = 0
    mass_before = NL.KERNEL_LAUNCHES
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
    mass = NL.KERNEL_LAUNCHES - mass_before
    print(f"[11] kernel launches in phase 11: {counts}, mass kernel {mass} "
          f"(the Jacobian's mass term; the rest is f64 torch operations); "
          f"phase wall {time.perf_counter() - t_phase:.1f} s")
    check(not any(counts.values()), f"a kernel ran in phase 11: {counts}")
    check(mass > 0, "the mass kernel did not launch in phase 11")
    return c["krylov"], c["solve"]


def precond_run(torch, np, key, nonlinear=False, extra="", tag="12"):
    """One run of phase 12 through the CLI entry: its per-level records
    (norm line, solve or Newton line, Krylov iterations, forest digest,
    mesh seconds) printed beside the JAX pins of
    `refcheck/precond_smoke_pins.py`, the CLI wall and the peak device
    memory (kept in the first record as `wall` and `peak`).  `extra`
    options are appended to the run's; `tag` names the phase in the
    lines.  Returns the records, the driver's result and the Σ u of each
    level's solution."""
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
    text += extra
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
        print(f"[{tag}] ({key}) level {k}: {line}; {lines[n + k]}; Krylov "
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
    print(f"[{tag}] ({key}) CLI wall {wall:.2f} s, peak device memory "
          f"{peak:.2f} GiB")
    epochs[0].update(wall=wall, peak=peak)
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
    schwarz_b = dict(iterations=b_sw[0]["counts"][0], l2=b_sw[0]["value"],
                     ms=sms, peak=b_sw[0]["peak"])
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
    return schwarz_b


def geometry_run(torch, np, key):
    """One run of phase 13 through the CLI entry: one line per epoch with
    its norm line, solve path, outer and inner iterations, the solve's
    residual, fallback, the host seconds of mesh build and solve and the
    epoch's peak device memory, each L2 held to the JAX pin of
    `refcheck/geometry_smoke_pins.py` where there is one; then the true
    f64 residual ‖b − A u‖ of the last epoch's solution beside the one
    the solve reported.  B1 must not run on these meshes."""
    from disco4est_tpu_torch import __main__ as cli
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )

    run = dict(GEOMETRY_RUNS[key])
    problem = run.pop("problem")
    text = GEOMETRY_OPTIONS.format(**run)
    peaks, results = [], []
    run_poisson = cli.run_poisson

    def capture(*args, **kw):
        results.append(run_poisson(*args, **kw))
        return results[-1]

    t0 = time.perf_counter()
    with amr_probe(torch, np) as epochs:
        build = driver.build_mesh  # amr_probe's timed build

        def peak_build(*args, **kw):
            # the previous epoch's peak, then a fresh count for this one
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()
            return build(*args, **kw)

        driver.build_mesh, cli.run_poisson = peak_build, capture
        try:
            norms, _, fields, launches = run_cli(text, torch, problem)
        finally:
            driver.build_mesh, cli.run_poisson = build, run_poisson
    peaks = peaks[1:] + [torch.cuda.max_memory_allocated() / 2**30]
    wall = time.perf_counter() - t0
    check(len(norms) == len(epochs) == run["steps"] + 1,
          f"({key}) {len(norms)} levels, {len(epochs)} epochs")
    pins = GEOMETRY_PINS.get(key, [])
    for k, (rec, line, f, peak) in enumerate(zip(epochs, norms, fields,
                                                 peaks)):
        E, dof, _, l2 = line.split()
        its = int(f["iterations"])
        rec.update(E=int(E), dof=int(dof), l2=float(l2), line=line,
                   fields=f, solve=float(f["seconds"]), peak=peak)
        pin = pins[k] if k < len(pins) else None
        rel = abs(rec["l2"] - pin[2]) / pin[2] if pin else None
        print(f"[13] ({key}) level {k}: {line} (JAX "
              f"{pin[2] if pin else 'no pin'}"
              f"{f', rel {rel:.3e}' if pin else ''}); path={f['path']} "
              f"outer={f['outer']} iterations={its} residual="
              f"{f['residual']} fallback={f['fallback']}; seconds: mesh "
              f"{rec['mesh']:.3f}, solve {rec['solve']:.3f} "
              f"({rec['solve'] / max(its, 1) * 1e3:.3f} ms an iteration); "
              f"peak {peak:.2f} GiB")
        check(np.isfinite(rec["l2"]), f"({key}) L2 {l2}")
        check(f["fallback"] == "no", f"({key}) level {k} fell back: {f}")
        if pin is not None:
            check((rec["E"], rec["dof"]) == pin[:2],
                  f"({key}) level {k}: {E} {dof}, JAX {pin[0]} {pin[1]}")
            check(rel <= LEVEL5_REL, f"({key}) level {k} L2 {l2} vs JAX "
                  f"{pin[2]} (rel {rel:.3e})")
        if run["mixed"] and rec["uniform"]:
            check(f["path"] == "mixed-curved",
                  f"({key}) uniform epoch {k} took {f['path']}")
    res = results[0]
    mesh, prob = res.mesh, cli.LINEAR_PROBLEMS[problem](None)
    rhs = build_rhs_with_strong_bc(mesh, mesh.init_field(prob.rhs),
                                   mesh.boundary_values(prob.boundary))
    true = float(torch.linalg.norm((rhs - apply_sipg(mesh, res.u)
                                    ).reshape(-1)))
    epochs[-1]["true_residual"] = true
    print(f"[13] ({key}) {problem} on {run['geometry'].splitlines()[0]}: "
          f"CLI wall {wall:.2f} s, B1 launches {launches}; last epoch's "
          f"true residual {true:.3e} (reported {fields[-1]['residual']})")
    check(launches == 0, f"({key}) B1 ran")
    return epochs


def capped_inner_solve(torch):
    """ROADMAP C14: the level-6 disk once more with the JAX driver's
    400-iteration inner cap on the curved solve (`mixed_inner_max_iter =
    400`; the port's default is 20000).  Printed, not checked: the capped
    inner solves contract the outer residual by less than the stall
    test's 10 %, and the solve stops above the f64 floor."""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.util.config import Options

    run = dict(GEOMETRY_RUNS["a6f"], mixed=1)
    run.pop("problem")
    text = GEOMETRY_OPTIONS.format(**run).replace(
        "use_mixed_precision = 1",
        "use_mixed_precision = 1\nmixed_inner_max_iter = 400")
    res = driver.run_poisson(Options.load(text), SinxProblem, device="cuda")
    l2, pin = res.norms.rows[0]["L_2"], GEOMETRY_PINS["a"][1][2]
    print(f"[13] (a) C14, the level-6 disk with a 400-iteration inner cap: "
          f"{res.solves[0].line(0)}; L2 {l2!r}, {l2 / pin:.3f}x JAX's")


def _quad_l2(mesh, v):
    """sqrt(Σ w J v²) of a field at the volume quadrature points."""
    from disco4est_tpu_torch.mesh.builder import vol_weights

    w = vol_weights(mesh, v.dtype)
    return float((w * mesh.j_quad * v * v).sum().sqrt())


def derivatives_check(torch, np):
    """(d) `gradient` and `hessian_trace` on the card against the port's
    CPU run (the level-5 disk and a level-2 7-tree sphere, deg 3), then
    the hessian trace of the deg-3 interpolant of sinx on the level-5 and
    level-6 disks against −2π²u."""
    from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
    from disco4est_tpu_torch.geometry.disk import DiskGeometry
    from disco4est_tpu_torch.laplacian.derivatives import (
        gradient,
        hessian_trace,
    )
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    pi = np.pi
    sinx = lambda *c: torch.sin(pi * c[0]) * torch.sin(pi * c[1]) * (
        torch.sin(pi * c[2]) if len(c) == 3 else 1.0)
    disk = DiskGeometry(0.5, 1.0)
    errs = []
    for name, geom, level in (("disk", disk, 5),
                              ("7-tree sphere", CubedSphereGeometry(
                                  "7tree", R0=1.0, R1=2.0), 2),
                              ("disk", disk, 6)):
        forest = Forest.uniform(geom.conn, level)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh = build_mesh(geom, forest, deg=3, device="cuda")
        u = mesh.init_field(sinx)
        g, h = gradient(mesh, u), hessian_trace(mesh, u)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        line = (f"[13] (d) {name} level {level}: {mesh.n_elements} "
                f"elements, gradient {tuple(g.shape)}, hessian trace "
                f"{tuple(h.shape)}, card {secs:.3f} s (mesh build "
                f"included)")
        check(bool(torch.isfinite(g).all() and torch.isfinite(h).all()),
              f"(d) {name} level {level}: non-finite derivatives")
        if level <= 5:  # the port's CPU run of the same derivatives
            cpu = build_mesh(geom, forest, deg=3, device="cpu")
            uc = cpu.init_field(sinx)
            gc, hc = gradient(cpu, uc), hessian_trace(cpu, uc)
            rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
            rg, rh = rel(g.cpu(), gc), rel(h.cpu(), hc)
            # the hessian's own rounding: the CPU's response to a relative
            # 2^-52 perturbation of u (the second differences amplify it
            # ~1/h²: 2e-14 on the level-1 disk, 1.1e-11 on the level-5 one)
            noise = 1.0 + torch.rand(uc.shape, dtype=uc.dtype,
                                     generator=torch.Generator().manual_seed(
                                         0)) * 2.0**-52
            cond = rel(hessian_trace(cpu, uc * noise), hc)
            line += (f"; against the CPU: gradient {rg:.2e}, hessian "
                     f"{rh:.2e} (the CPU hessian moves {cond:.2e} under a "
                     f"2^-52 perturbation of u)")
            check(rg <= DERIV_REL and rh <= max(DERIV_REL, cond),
                  f"(d) {name} level {level}: card vs CPU {rg}, {rh}")
        if name == "disk":
            ref = -2.0 * pi**2 * mesh.init_field_on_quad(sinx)
            errs.append(_quad_l2(mesh, h - ref) / _quad_l2(mesh, ref))
            line += f"; |Δu_h + 2π²u| / |2π²u| {errs[-1]:.3e}"
        print(line)
    print(f"[13] (d) hessian-trace error level 5 / level 6: "
          f"{errs[0] / errs[1]:.2f}")
    check(errs[0] >= 3.0 * errs[1], f"(d) hessian error fell {errs}")


def _cds_schwarz(torch, chunk):
    """(e)(iii) the CDS regression (phase 11 (a)) with `pc_type = schwarz`
    through the CLI entry: its printed lines and the driver's result."""
    from disco4est_tpu_torch import __main__ as cli

    # level 2 alone: with the regression's smooth_pred step the K-slot run
    # of level 1 (288 elements, 18 chunks of 16) took 161 s on an H100,
    # launch-bound, the phase's whole budget
    run = dict(NONLINEAR_RUNS["a"], steps=0)
    problem = run.pop("problem")
    text = NONLINEAR_OPTIONS.format(**run).replace(
        "ksp_max_it = 10000", "ksp_max_it = 10000\npc_type = schwarz\n\n"
        f"[d4est_solver_schwarz]\nsubdomain_chunk = {chunk}")
    results, fn = [], cli.run_nonlinear

    def capture(*args, **kw):
        results.append(fn(*args, **kw))
        return results[-1]

    buf = io.StringIO()
    cli.run_nonlinear = capture
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            code = cli.main([text, f"--problem={problem}", "--device=cuda"])
        torch.cuda.synchronize()
    finally:
        cli.run_nonlinear = fn
    check(code == 0, f"(e)(iii) CLI exit code {code}")
    return buf.getvalue().splitlines(), results[0], time.perf_counter() - t0


def kslot_full_width(torch, np):
    """(e)(ii) one K-slot apply (chunk 4096) against one materialized
    apply of the same input on the level-5 brick at deg 3: build seconds,
    apply milliseconds and the peak device memory around build + apply;
    (e)(iv) two K-slot applies bit-equal."""
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.solvers import schwarz_overlap as so

    geom = BrickGeometry(dim=3)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 5), deg=3,
                      device="cuda")
    r = torch.sin(torch.arange(mesh.n_elements * 64, dtype=torch.float64,
                               device="cuda")).reshape(mesh.n_elements, 4,
                                                       4, 4)
    out, stats = {}, {}
    for kind in ("kslot", "materialized"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        M = (so.build_overlapping_schwarz_kslot(mesh, 1, 15, chunk=4096)
             if kind == "kslot" else so.build_overlapping_schwarz(mesh, 1,
                                                                  15))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out[kind] = M(r)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        ms = _wall_ms(torch, lambda: M(r), 2)
        if kind == "kslot":
            check(torch.equal(out[kind], M(r)),
                  "(e)(iv) two K-slot applies differ")
            resident = sum(t.numel() * t.element_size() for t in (
                [M.member, M.valid, M.codes, M.mask_table, M.weight_table,
                 M.nbr_slot, M.bnd, M.conf] + list(M.hc.values())
                + [t for pair in M.combine for t in pair])) / 2**30
            extra = (f"{M.shape[0] // M.chunk} chunks of "
                     f"{M.chunk * M.member.shape[1]} replicated elements, "
                     f"resident tables {resident:.3f} GiB")
        else:
            extra = f"{M.rep_mesh.n_elements} replicated elements"
        stats[kind] = dict(build=build_s, ms=ms, peak=peak)
        print(f"[13] (e)(ii) level 5 {kind}: build {build_s:.3f} s, first "
              f"apply {first_ms:.1f} ms, apply {ms:.1f} ms, peak device "
              f"memory over build + apply {peak:.2f} GiB ({extra})")
        del M
    a, b = out["kslot"], out["materialized"]
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"[13] (e)(ii) K-slot against materialized: rel {rel:.3e}, equal "
          f"bit for bit: {'yes' if torch.equal(a, b) else 'no'}")
    check(rel <= KSLOT_REL, f"(e)(ii) K-slot vs materialized rel {rel}")
    check(stats["kslot"]["peak"] < stats["materialized"]["peak"],
          f"(e)(ii) K-slot peak {stats['kslot']['peak']:.2f} GiB not below "
          f"the materialized {stats['materialized']['peak']:.2f} GiB")
    return stats


def phase_geometry(torch, np, card, schwarz_b):
    """Phase 13: the disk and misc geometries, the derivatives and the
    K-slot Schwarz on the card through the CLI entry (torch operations;
    B1, B2 and B3 must not launch)."""
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.solvers.schwarz_overlap import SchwarzKSlot
    from disco4est_tpu_torch.tools import exp_kernel_design as X

    print(f"[13] the disk and misc geometries, the derivatives and the "
          f"K-slot Schwarz on {card}")
    t_phase = time.perf_counter()
    S.KERNEL_LAUNCHES = fused.KERNEL_LAUNCHES = X.KERNEL_LAUNCHES = 0

    # (a) the disk at full width, level 5 -> 6, and the uniform_p run
    a = geometry_run(torch, np, "a")
    check([e["E"] for e in a] == [5120, 20480]
          and [e["dof"] for e in a] == [81920, 327680], "(a) sizes")
    fall = a[0]["l2"] / a[1]["l2"]
    (a6f,) = geometry_run(torch, np, "a6f")
    print(f"[13] (a) the L2 falls {fall:.2f}x; level 6 against JAX: "
          f"mixed-curved {abs(a[1]['l2'] / GEOMETRY_PINS['a'][1][2] - 1):.3e}"
          f", plain f64 FCG {abs(a6f['l2'] / GEOMETRY_PINS['a'][1][2] - 1):.3e}"
          f" (true residual {a6f['true_residual']:.3e}, reported "
          f"{a6f['fields']['residual']})")
    check(fall >= 8.0, f"(a) the error fell less than 8x: {fall}")
    capped_inner_solve(torch)
    geometry_run(torch, np, "ap")

    # (b) the trapezoid and the pizza-half, uniform_p from deg 2 to 4
    for key in ("trap", "pizza"):
        b = geometry_run(torch, np, key)
        check(b[2]["l2"] < 0.1 * b[0]["l2"], f"({key}) deg 4 vs deg 2: "
              f"{b[2]['l2']} {b[0]['l2']}")

    # (c) the hole-in-a-box, level 1 -> 3, and level 3 by plain f64 FCG
    c = geometry_run(torch, np, "c")
    (c3f,) = geometry_run(torch, np, "c3f")
    pin3 = GEOMETRY_PINS["c"][2][2]
    print(f"[13] (c) level 3 against JAX: mixed-curved "
          f"{abs(c[2]['l2'] / pin3 - 1):.3e}, plain f64 FCG "
          f"{abs(c3f['l2'] / pin3 - 1):.3e} (true residual "
          f"{c3f['true_residual']:.3e}, reported "
          f"{c3f['fields']['residual']})")
    check(c[0]["l2"] > c[1]["l2"] > c[2]["l2"], "(c) the L2 did not fall")

    # (d) the derivatives
    derivatives_check(torch, np)

    # (e)(i) phase 12 (b)'s Schwarz with the K-slot variant, chunk 1024
    (ks,), res, _ = precond_run(
        torch, np, "schwarz", tag="13",
        extra="\n[d4est_solver_schwarz]\nsubdomain_chunk = 1024\n")
    M = res.precond
    check(isinstance(M, SchwarzKSlot) and M.chunk == 1024,
          f"(e)(i) the preconditioner is {type(M).__name__}")
    rr = torch.sin(torch.arange(int(np.prod(M.shape)), dtype=torch.float64,
                                device="cuda")).reshape(M.shape)
    kms = _wall_ms(torch, lambda: M(rr), 3)
    its, rel = ks["counts"][0], abs(ks["value"] - schwarz_b["l2"]) / \
        schwarz_b["l2"]
    print(f"[13] (e)(i) K-slot Schwarz at level 4 ({M.shape[0] // M.chunk} "
          f"chunks of {M.chunk * M.member.shape[1]} replicated elements): "
          f"FCG {its} (materialized, phase 12 (b): "
          f"{schwarz_b['iterations']}), L2 rel to it {rel:.3e}; "
          f"{kms:.2f} ms an apply (materialized {schwarz_b['ms']:.2f}); "
          f"peak {ks['peak']:.2f} GiB (materialized "
          f"{schwarz_b['peak']:.2f})")
    check(abs(its - schwarz_b["iterations"]) <= 1,
          f"(e)(i) FCG {its} vs {schwarz_b['iterations']}")
    check(rel <= LEVEL5_REL, f"(e)(i) L2 {ks['value']} vs "
          f"{schwarz_b['l2']}")
    check(torch.equal(M(rr), M(rr)), "(e)(iv) two K-slot applies differ")
    del M, res

    # (e)(ii) and (iv) at full width
    kslot_full_width(torch, np)

    # (e)(iii) the CDS regression with Schwarz, materialized and K-slot
    runs = {chunk: _cds_schwarz(torch, chunk) for chunk in (0, 16)}
    (lm, rm, wm), (lk, rk, wk) = runs[0], runs[16]
    n = len(rm.solves)
    check(len(rk.solves) == n, "(e)(iii) the runs' level counts differ")
    for k in range(n):
        print(f"[13] (e)(iii) CDS level {k}: materialized {lm[k]}, Newton "
              f"{rm.solves[k].iterations}, FCG {rm.solves[k].krylov}; "
              f"K-slot {lk[k]}, Newton {rk.solves[k].iterations}, FCG "
              f"{rk.solves[k].krylov}")
        check(lm[k] == lk[k]
              and rm.solves[k].iterations == rk.solves[k].iterations
              and rm.solves[k].krylov == rk.solves[k].krylov,
              f"(e)(iii) CDS level {k} differs")
    check(isinstance(rk.precond, SchwarzKSlot), "(e)(iii) not K-slot")
    print(f"[13] (e)(iii) CLI wall: materialized {wm:.2f} s, K-slot "
          f"{wk:.2f} s")

    counts = dict(B1=S.KERNEL_LAUNCHES, B2=fused.KERNEL_LAUNCHES,
                  B3=X.KERNEL_LAUNCHES)
    print(f"[13] kernel launches in phase 13: {counts} (these paths run "
          f"torch operations only); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(not any(counts.values()), f"a kernel ran in phase 13: {counts}")


# phase 14, IO and checkpoint-restart: the runs reuse the options of
# phases 5 (sinx at deg 3), 9 and 11 at their full widths
MIDSOLVE_EVERY = 50  # (b) Krylov iterations a checkpoint
IO_REL = 1e-12  # (f) card against CPU


@contextlib.contextmanager
def timed_checkpoints(torch):
    """Wrap `io/checkpoint.py`'s `save` and `load` (the drivers call them
    through the module): (kind, path, seconds behind a device synchronize,
    bytes) of every call."""
    import os

    from disco4est_tpu_torch.io import checkpoint as C

    calls = []
    saved = (C.save, C.load)

    def timed(kind, fn):
        def wrapper(path, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(path, *args, **kw)
            torch.cuda.synchronize()
            f = path if path.endswith(".npz") else path + ".npz"
            calls.append((kind, f, time.perf_counter() - t0,
                          os.path.getsize(f)))
            return out
        return wrapper

    C.save, C.load = timed("save", saved[0]), timed("load", saved[1])
    try:
        yield calls
    finally:
        C.save, C.load = saved


def io_run(torch, np, text, problem):
    """One driver run on the card (`run_poisson` for sinx, `run_nonlinear`
    for `problem = "cds"`) under `amr_probe`: its result, the B1 launches
    of each level and its wall behind a synchronize."""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.util.config import Options

    opts = Options.load(text)
    S.KERNEL_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with amr_probe(torch, np) as epochs:
        if problem == "cds":
            res = driver.run_nonlinear(opts, driver.CDSProblem(opts),
                                       device="cuda")
        else:
            from disco4est_tpu_torch.problems.poisson import SinxProblem

            res = driver.run_poisson(opts, SinxProblem, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ends = [e["launches"] for e in epochs[1:]] + [S.KERNEL_LAUNCHES]
    return res, [end - e["launches"] for e, end in zip(epochs, ends)], wall


def _restart_opts(ck, ctype):
    return (f"\n[initial_mesh]\nload_from_checkpoint = 1\n"
            f"checkpoint_prefix = {ck}\ncheckpoint_type = {ctype}\n")


def _io_lines(calls, tag):
    for kind, f, s, size in calls:
        print(f"[14] {tag} {kind} {pathlib.Path(f).name}: {size / 2**20:.2f} "
              f"MiB in {s:.4f} s")


def io_restart(torch, np, tmp):
    """(a) phase 9 (d)'s hp smooth_pred run with per-level checkpoints,
    then restarted from its level 1 by structure and by history."""
    text = AMR_OPTIONS.format(use_structured="auto", mixed=1,
                              **AMR_RUNS["d"])
    plain, b1_plain, w_plain = io_run(torch, np, text, "sinx")
    ck = f"{tmp}/d"
    with timed_checkpoints(torch) as calls:
        full, b1_full, w_full = io_run(
            torch, np, text + f"\n[checkpoint]\nprefix = {ck}\n", "sinx")
    print(f"[14] (a) phase 9 (d): elements "
          f"{[r['num_quadrants'] for r in full.norms.rows]}, paths "
          f"{[s.path for s in full.solves]}, B1 launches {b1_full}; wall "
          f"{w_plain:.2f} s without checkpoints, {w_full:.2f} s with")
    _io_lines(calls, "(a)")
    check(torch.equal(full.u, plain.u) and b1_full == b1_plain
          and full.norms.rows == plain.norms.rows,
          "(a) the checkpointed run differs from the plain one")
    check(b1_full[0] > 0, "(a) level 0 did not run B1")
    last = full.norms.rows[-1]["L_2"]
    for ctype in ("structure", "history"):
        with timed_checkpoints(torch) as calls:
            res, b1, wall = io_run(
                torch, np, text + _restart_opts(f"{ck}_level1", ctype),
                "sinx")
        du = float(torch.max(torch.abs(res.u - full.u)))
        print(f"[14] (a) restart from level 1 by {ctype}: paths "
              f"{[s.path for s in res.solves]}, B1 launches {b1} (full run "
              f"{b1_full[1:]}), max |du| {du!r}, last L2 "
              f"{res.norms.rows[-1]['L_2']!r} (full {last!r}), forest "
              f"checksum {res.mesh.forest.checksum()}, wall {wall:.2f} s")
        _io_lines(calls, "(a)")
        check(du == 0.0 and res.norms.rows[-1]["L_2"] == last
              and res.mesh.forest.checksum() == full.mesh.forest.checksum(),
              f"(a) the {ctype} restart is not bit-equal to the full run")
        check(res.solves[0].path == "restart" and b1[0] == 0
              and b1[1:] == b1_full[2:],
              f"(a) {ctype} restart: B1 launches {b1}, full {b1_full}")
    return full


def io_midsolve(torch, np, tmp):
    """(b) sinx deg 3 level 5 as a plain f64 CG, checkpointed every
    `MIDSOLVE_EVERY` iterations, against the same solve without
    checkpoints; then with `pc_type = cheby` (FCG chunks) against one
    chunk."""
    import os

    base = SINX_OPTIONS.format(level=5, deg=3, use_structured="auto",
                               mixed=0).replace("ksp_type = fcg",
                                                "ksp_type = cg")
    out = {}
    for pc in ("none", "cheby"):
        text = base.replace("use_mixed_precision = 0",
                            f"use_mixed_precision = 0\npc_type = {pc}")
        if pc == "none":
            ref, _, w_ref = io_run(torch, np, text, "sinx")
        else:  # the same FCG-Chebyshev solve in one chunk
            ck1 = f"{tmp}/b1"
            ref, _, w_ref = io_run(
                torch, np, text + f"\n[checkpoint]\nprefix = {ck1}\n"
                "checkpoint_every_n_krylov_its = 100000\n", "sinx")
        ck = f"{tmp}/b_{pc}"
        with timed_checkpoints(torch) as calls:
            res, b1, wall = io_run(
                torch, np, text + f"\n[checkpoint]\nprefix = {ck}\n"
                f"checkpoint_every_n_krylov_its = {MIDSOLVE_EVERY}\n",
                "sinx")
        info, rinfo = res.solves[0], ref.solves[0]
        k = info.iterations
        files = sorted(f for f in os.listdir(tmp)
                       if f.startswith(f"b_{pc}_level0_it"))
        saves = [c for c in calls if "_it" in c[1]]
        per = sum(c[2] for c in saves) / len(saves)
        print(f"[14] (b) pc_type={pc}: {info.line(0)}; reference "
              f"{rinfo.path} {rinfo.iterations} iterations, "
              f"{rinfo.seconds:.3f} s; {len(files)} mid-solve files; "
              f"{per:.4f} s a mid-solve save ({saves[0][3] / 1e6:.1f} MB: "
              f"device-to-host copy and write), solve "
              f"{info.seconds - rinfo.seconds:+.3f} s against the "
              f"reference; B1 launches {b1}")
        check(k == rinfo.iterations and torch.equal(res.u, ref.u),
              f"(b) {pc}: the chunked solve differs from the reference")
        check(len(files) == -(-k // MIDSOLVE_EVERY) and len(saves) ==
              len(files) + (k % MIDSOLVE_EVERY == 0 and
                            info.residual_norm >= 5e-15),
              f"(b) {pc}: {len(files)} files, {len(saves)} saves for {k} "
              "iterations")
        check(info.path == ("cg-chunked" if pc == "none"
                            else "fcg-cheby-chunked")
              and (pc == "cheby" or rinfo.path == "cg"),
              f"(b) {pc}: paths {info.path}, {rinfo.path}")
        out[pc] = (res, per)
    return out


def io_nonlinear(torch, np, tmp):
    """(c) phase 11 (b)'s CDS with FCG-Chebyshev and per-level plus
    per-Newton-iterate checkpoints, then restarted from level 0 by
    history."""
    import os

    run = dict(NONLINEAR_RUNS["b"], ksp="fcg")
    run.pop("problem")
    text = NONLINEAR_OPTIONS.format(**run).replace(
        "ksp_max_it = 10000", "ksp_max_it = 10000\npc_type = cheby")
    ck = f"{tmp}/c"
    with timed_checkpoints(torch) as calls:
        full, _, w_full = io_run(
            torch, np, text + f"\n[checkpoint]\nprefix = {ck}\n"
            "checkpoint_every_n_krylov_its = 1\n", "cds")
    saves = [c for c in calls if "_it" in c[1]]
    print(f"[14] (c) CDS deg 3, level 4 -> 5, FCG-Chebyshev: Newton "
          f"{[s.iterations for s in full.solves]}, Krylov "
          f"{[s.krylov for s in full.solves]}, F_norm "
          f"{[r['F_norm'] for r in full.norms.rows]}, {len(saves)} "
          f"Newton-iterate checkpoints, wall {w_full:.2f} s")
    for level, info in enumerate(full.solves):
        its = sorted(int(f.split("_it")[1][:-4]) for f in os.listdir(tmp)
                     if f.startswith(f"c_level{level}_it"))
        check(its == list(range(1, info.iterations + 1)),
              f"(c) level {level}: iterate files {its}")
    with timed_checkpoints(torch) as calls:
        res, _, wall = io_run(
            torch, np, text + _restart_opts(f"{ck}_level0", "history"),
            "cds")
    du = float(torch.max(torch.abs(res.u - full.u)))
    print(f"[14] (c) restart from level 0 by history: max |du| {du!r}, "
          f"F_norm {res.norms.rows[-1]['F_norm']!r} (full "
          f"{full.norms.rows[-1]['F_norm']!r}), wall {wall:.2f} s")
    _io_lines(calls, "(c)")
    check(du == 0.0 and res.norms.rows[-1]["F_norm"]
          == full.norms.rows[-1]["F_norm"],
          "(c) the nonlinear restart is not bit-equal to the full run")


def io_vtk(torch, np, tmp, ck_level1):
    """(d) `[d4est_vtk] filename` on the level-4 deg-3 brick, and the
    checkpoint plotter of the CLI in a subprocess on (a)'s level-1
    checkpoint."""
    import os

    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.io import vtk

    text = SINX_OPTIONS.format(level=4, deg=3, use_structured="auto",
                               mixed=1)
    writes = []
    write_vtu = vtk.write_vtu

    def timed(path, mesh, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write_vtu(path, mesh, *args, **kw)
        writes.append((path, time.perf_counter() - t0, mesh.n_elements,
                       mesh.nl))

    driver.write_vtu = timed
    try:
        io_run(torch, np, text + f"\n[d4est_vtk]\nfilename = {tmp}/v\n",
               "sinx")
    finally:
        driver.write_vtu = write_vtu
    (path, secs, E, nl), = writes
    with open(path) as f:
        head = f.read(400)
    pts, cells = E * nl**3, E * (nl - 1)**3
    print(f"[14] (d) VTK of the level-4 deg-3 brick: {pts} points, {cells} "
          f"cells, {os.path.getsize(path) / 2**20:.1f} MiB written in "
          f"{secs:.3f} s")
    check(pts == 262144 and f'NumberOfPoints="{pts}" NumberOfCells='
          f'"{cells}"' in head, f"(d) VTK header {head!r}")
    opts_path = f"{tmp}/plot.input"
    with open(opts_path, "w") as f:
        f.write(AMR_OPTIONS.format(use_structured="auto", mixed=1,
                                   **AMR_RUNS["d"]))
    out = f"{tmp}/plot.vtu"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "disco4est_tpu_torch", opts_path,
         f"--plot-checkpoint={ck_level1}", f"--output={out}"],
        capture_output=True, text=True, timeout=300,
        cwd=pathlib.Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    print(f"[14] (d) plotter: exit {r.returncode}, {r.stdout.strip()!r}, "
          f"{os.path.getsize(out) / 2**20 if os.path.exists(out) else 0:.1f}"
          f" MiB, subprocess wall {wall:.2f} s")
    check(r.returncode == 0, f"(d) plotter failed: {r.stderr[-2000:]}")
    with open(out) as f:
        txt = f.read()
    check('Name="u"' in txt and 'Name="deg"' in txt and 'Name="level"'
          in txt, "(d) the plotter's .vtu lacks u, deg or level")


def io_timings(torch, np, tmp):
    """(e) `[driver] print_timings = 1` and `[logging] log_dir` on phase
    9 (a)'s run through the CLI entry: one TIMINGS row per level, amr
    included where an AMR step follows (C4), each row's phases within the
    level's own wall (from the timer's start of one level to the next's,
    behind synchronizes)."""
    from disco4est_tpu_torch import __main__ as cli
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.util import logging as dlog

    text = AMR_OPTIONS.format(use_structured="auto", mixed=1,
                              **AMR_RUNS["a"]) + (
        f"\n[driver]\nprint_timings = 1\n[logging]\nlog_dir = {tmp}/logs\n")
    starts = []
    level = driver._PhaseTimer.level

    def marked(self, it):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return level(self, it)

    results = []
    run_poisson = cli.run_poisson

    def capture(*args, **kw):
        results.append(run_poisson(*args, **kw))
        return results[-1]

    buf = io.StringIO()
    driver._PhaseTimer.level = marked
    cli.run_poisson = capture
    try:
        with contextlib.redirect_stdout(buf):
            code = cli.main([text, "--problem=sinx", "--device=cuda"])
        torch.cuda.synchronize()
        end = time.perf_counter()
    finally:
        driver._PhaseTimer.level = level
        cli.run_poisson = run_poisson
        dlog.init_logging(None, console=False)
    check(code == 0, f"(e) CLI exit code {code}")
    lines = buf.getvalue().splitlines()
    rows = [x for x in lines if x.startswith("TIMINGS")]
    norms = [x for x in lines if len(x.split()) == 4
             and not x.startswith(("TIMINGS", "solve", "C1"))]
    walls = [b - a for a, b in zip(starts, starts[1:] + [end])]
    timings = results[0].timings
    for row, phases, wall in zip(rows, timings, walls):
        total = sum(v for k, v in phases.items() if k != "level")
        print(f"[14] (e) {row} (sum {total:.4f} s; the level's wall "
              f"{wall:.4f} s)")
        check(total <= wall, f"(e) phases {total} > wall {wall}")
    check(len(rows) == len(timings) == 2
          and set(timings[0]) == {"level", "mesh", "solve", "amr"}
          and set(timings[1]) == {"level", "mesh", "solve"},
          f"(e) TIMINGS rows {rows}")
    with open(f"{tmp}/logs/d4est_norms.log") as f:
        logged = f.read()
    print(f"[14] (e) d4est_norms.log: {len(logged.splitlines())} lines")
    check(len(norms) == 2 and all(x in logged for x in norms),
          f"(e) norm lines {norms} not all in d4est_norms.log")


def io_diagnostics(torch, np, mid):
    """(f) `ip_energy_norm_sqr` of (b)'s level-5 error on the card against
    the CPU, and `penalty_report` of a hanging brick and of a
    pointwise-penalty mesh against the CPU's."""
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.io.ip_energy_norm import ip_energy_norm_sqr
    from disco4est_tpu_torch.laplacian.penalty_debug import penalty_report
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.problems.poisson import SinxProblem

    res = mid["none"][0]
    mesh = res.mesh
    e = res.u - mesh.init_field(SinxProblem.analytic)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = {k: float(v) for k, v in ip_energy_norm_sqr(mesh, e).items()}
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = {k: float(v) for k, v in
           ip_energy_norm_sqr(mesh.to("cpu"), e.cpu()).items()}
    t_cpu = time.perf_counter() - t0
    rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in cpu}
    print(f"[14] (f) IP energy norm of the level-5 error: {card} "
          f"(card {t_card:.3f} s, CPU {t_cpu:.3f} s; rel {rel})")
    check(all(r <= IO_REL for r in rel.values()), f"(f) IP norm rel {rel}")

    geom = BrickGeometry(dim=3)
    forest = Forest.uniform(geom.conn, 3)
    flags = np.zeros(forest.n_elements, bool)
    flags[::7] = True
    forest = forest.refine(flags).balance()
    for face_h in ("volume_div_area", "j_div_sj_quad"):
        reps = [penalty_report(build_mesh(geom, forest, deg=3,
                                          face_h_type=face_h, device=dev))
                for dev in ("cuda", "cpu")]
        print(f"[14] (f) penalty report, {forest.n_elements} elements, "
              f"{face_h}: {reps[0]}")
        for cls in ("interior", "boundary", "mortar"):
            a, b = reps[0][cls], reps[1][cls]
            check(a["count"] == b["count"] > 0 and all(
                abs(a[s] - b[s]) <= IO_REL * abs(b[s])
                for s in ("min", "max", "mean")),
                f"(f) {face_h} {cls}: card {a}, CPU {b}")


def phase_io(torch, np, card):
    """Phase 14: checkpoints, restart, VTK, the plotter, timings, logging
    and the diagnostics on the card."""
    import tempfile

    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.tools import exp_kernel_design as X

    print(f"[14] IO and checkpoint-restart on {card}")
    t_phase = time.perf_counter()
    fused.KERNEL_LAUNCHES = X.KERNEL_LAUNCHES = 0
    with tempfile.TemporaryDirectory() as tmp:
        io_restart(torch, np, tmp)
        mid = io_midsolve(torch, np, tmp)
        io_nonlinear(torch, np, tmp)
        io_vtk(torch, np, tmp, f"{tmp}/d_level1")
        io_timings(torch, np, tmp)
        io_diagnostics(torch, np, mid)
    counts = dict(B2=fused.KERNEL_LAUNCHES, B3=X.KERNEL_LAUNCHES)
    print(f"[14] B2 and B3 launches in phase 14: {counts}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(not any(counts.values()), f"B2 or B3 ran in phase 14: {counts}")


# phase 15, the distributed driver: `tests/test_driver_distributed.py`'s
# sinx hp smooth_pred (`refcheck/dist_smoke_pins.py`, whose JAX values, 8
# virtual CPU devices, it prints) and four runs at full width: phase 9
# (a)'s sinx (deg 3, level 4 -> 5, mixed precision: the outer loop
# converges the true residual, where a plain f64 CG stops on its recursive
# one, ROADMAP C15), phase 9 (d)'s hp smooth_pred from level 4 (mixed,
# then f64 CG on the hp operator; no JAX pin), phase 12 (a)'s FCG +
# multigrid (deg 3, level 4 -> 5) and phase 11 (b)'s CDS (deg 3, level 4
# -> 5)
DIST_JAX_L2 = {
    "sinx_hp": [0.015208529424303185, 0.0019464036376921176,
                0.0009024578431378494],
}
DIST_FULL = ("sinx_l5", "hp_l4", "mg_l5", "cds_l5")
# (name, ranks) of the CLI runs
DIST_RUNS = [("sinx_hp", 4), ("sinx_l5", 4), ("mg_l5", 2), ("hp_l4", 2),
             ("cds_l5", 2)]
# a norm line against its one-process reference, relative: after an f64
# CG (`cg-halo`, `cg-hp-halo`) and otherwise (mixed precision, multigrid,
# Newton), the bounds of `tests/test_driver_distributed.py`.  At full
# width the reference is the driver itself on a world of one rank (the
# halo apply and the global dots, nothing exchanged).  Against the
# one-process run (the GEMM form of the apply) and JAX's one-device pins
# the bound is DIST_FORM_REL: the two f64 forms of one operator (the halo
# apply's quadrature-point face terms, the GEMM form) give discrete
# solutions ~4e-13 apart (max norm, relative; (a) prints it), which moves
# a level-5 L2 error of 4.5e-10 by ~2e-6 relative, more than LEVEL5_REL.
# ROADMAP C17's witness shows it: a one-process CG on the general form
# ends on the distributed CG's L2 bit for bit, and 2.14e-6 from the
# GEMM-form CG's and from JAX's (measured on an H100)
DIST_CG_REL, DIST_REL = 1e-11, 1e-10
DIST_FORM_REL = 1e-5
# ROADMAP C17: (a)'s distributed CG against its witness, a one-process f64
# CG on the general form (`c17_witness`), and every line of (b)'s
# full-width sinx runs against theirs, the same driver in one process on
# the general form (`_witness_run`)
DIST_WITNESS_REL = 1e-10
DIST_WITNESS_RUNS = ("sinx_l5", "mg_l5")
DIST_APPLY_REL = 1e-12  # (a) a halo apply against the global one, f64
DIST_VCYCLE_REL = 1e-10  # (a) the sharded V-cycle against the global one
DIST_RANK_TIMEOUT = 300  # seconds a CLI rank may take


def _dist_options(name, n, backend=None):
    """The options text of a phase-15 run on n ranks (`backend` None:
    auto, the default)."""
    line = f"backend = {backend}\n" if backend else ""
    par = f"\n[parallelism]\nenable = auto\nn_devices = {n}\n" + line
    if name in ("sinx_l5", "hp_l4"):
        return AMR_OPTIONS.format(
            use_structured="auto", mixed=1,
            **AMR_RUNS["a" if name == "sinx_l5" else "d"]) + par
    if name == "mg_l5":
        level, deg, maxd, scheme, steps, pc, sm, bt = PRECOND_RUNS["a"]
        return PRECOND_OPTIONS.format(
            level=level, deg=deg, max_degree=maxd, scheme=scheme,
            steps=steps, pc=pc, smoother=sm, bottom=bt,
            use_structured="auto", mixed=1) + par
    if name == "cds_l5":
        run = dict(NONLINEAR_RUNS["b"])
        run.pop("problem")
        return NONLINEAR_OPTIONS.format(**run) + par
    return _dist_pins().options(name, n) + line


def _dist_pins():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "refcheck"))
    import dist_smoke_pins

    return dist_smoke_pins


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n, text, problem, tmp, timeout=DIST_RANK_TIMEOUT):
    """n rank processes of the CLI on the card (torchrun's variables on
    127.0.0.1); returns [(exit code, stdout, stderr)] by rank and the
    wall.  Every process is killed if it outlives `timeout`."""
    import os

    path = pathlib.Path(tmp) / f"dist_{n}_{time.monotonic_ns()}.input"
    path.write_text(text)
    port, procs, out = _free_port(), [], []
    t0 = time.perf_counter()
    try:
        for r in range(n):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "disco4est_tpu_torch", str(path),
                 f"--problem={problem}", "--device=cuda"],
                cwd=pathlib.Path(__file__).resolve().parent, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out, time.perf_counter() - t0


def _one_process(torch, name):
    """The one-process port run of a phase-15 configuration on the card
    (the kernels kept out: use_structured = 0); its L2 per level."""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.util.config import Options

    text = _dist_options(name, 1).replace("enable = auto", "enable = 0")
    text = text.replace("use_mixed_precision = 1",
                        "use_mixed_precision = 1\nuse_structured = 0")
    opts = Options.load(text)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if name.startswith("cds"):
        res = driver.run_nonlinear(opts, driver.CDSProblem(opts),
                                   device="cuda")
    else:
        res = driver.run_poisson(opts, SinxProblem, device="cuda")
    torch.cuda.synchronize()
    return [r["L_2"] for r in res.norms.rows], time.perf_counter() - t0


def _world1_run(torch, ctx, name):
    """The one-process run of a full-width configuration on the
    distributed path: the driver on this process's world of one rank
    (`ctx`), so every solve runs the halo apply and the global dots as
    the ranks do, with nothing to exchange.  Its L2 per level, its solve
    paths (Poisson runs) and its wall."""
    from unittest import mock

    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.util.config import Options

    opts = Options.load(_dist_options(name, 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(driver.ParallelContext, "from_options",
                           staticmethod(lambda *a, **k: ctx)):
        if name.startswith("cds"):
            res = driver.run_nonlinear(opts, driver.CDSProblem(opts),
                                       device="cuda")
        else:
            res = driver.run_poisson(opts, SinxProblem, device="cuda")
    torch.cuda.synchronize()
    paths = [getattr(s, "path", "newton") for s in res.solves]
    return ([r["L_2"] for r in res.norms.rows], paths,
            time.perf_counter() - t0)


def _dist_pin(name):
    """The JAX values of a phase-15 run: the distributed driver's for
    sinx hp smooth_pred (`refcheck/dist_smoke_pins.py`), the one-device
    pins of phases 9 (a), 12 (a) and 11 (b) for the full-width ones;
    None for phase 9 (d)'s, which has no pin."""
    if name == "sinx_l5":
        return [AMR_PINS["a"][0][3], LEVEL5_L2]
    if name == "mg_l5":
        return [p[2] for p in PRECOND_PINS["a"]]
    if name == "cds_l5":
        return [p[2] for p in NONLINEAR_PINS["b"]]
    return DIST_JAX_L2.get(name)


def _path_rel(step):
    """The bound of a level against its one-process reference: f64 CG
    1e-11, else 1e-10."""
    path = step.split("path=")[1].split()[0] if "path=" in step else ""
    return DIST_CG_REL if path in ("cg-halo", "cg-hp-halo") else DIST_REL


def _halo_bytes(mesh, n):
    """(halo elements received over all ranks, their f64 bytes, the bytes
    of the padded all-to-all blocks sent to other ranks) of one apply on
    n ranks of `mesh`'s node-weighted layout."""
    from disco4est_tpu_torch.parallel import halo as H
    from disco4est_tpu_torch.parallel import repartition as R

    lay = R.PaddedLayout.build((mesh.deg_e.cpu().numpy() + 1) ** 3, n)
    prog = H.build_halo_program(R.pad_mesh_to_layout(mesh, lay), n)
    recv = int((prog.recv_pos < prog.H).sum())
    node = mesh.nl ** mesh.dim * 8
    return recv, recv * node, n * (n - 1) * prog.K * node


def _lockstep(torch, mesh, u, n, hp=False):
    """The halo apply on n ranks in lockstep on the card (pack, the
    exchange by hand, compute); the result in global order."""
    from disco4est_tpu_torch.laplacian.hp import adjoint_to_own, to_max
    from disco4est_tpu_torch.parallel import halo as H
    from disco4est_tpu_torch.parallel import repartition as R
    from disco4est_tpu_torch.parallel.sharding import (
        shard_field,
        shard_mesh_data,
    )

    lay = R.PaddedLayout.build((mesh.deg_e.cpu().numpy() + 1) ** 3, n)
    mp = R.pad_mesh_to_layout(mesh, lay)
    prog = H.build_halo_program(mp, n)
    ms = [shard_mesh_data(mp, r, n) for r in range(n)]
    hs = [prog.local(r) for r in range(n)]
    ul = [shard_field(R.migrate_field(u, lay), r, n) for r in range(n)]
    if hp:
        ul = [to_max(m, v) for m, v in zip(ms, ul)]
    sends = [H.halo_pack(h, v) for h, v in zip(hs, ul)]
    outs = [H.halo_compute(ms[r], hs[r], ul[r],
                           torch.stack([sends[s][r] for s in range(n)]))
            for r in range(n)]
    if hp:
        outs = [adjoint_to_own(m, v) for m, v in zip(ms, outs)]
    return R.unmigrate_field(torch.cat(outs), lay, mesh.n_elements)


def _rel_t(torch, a, b):
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def _gloo_cuda_probe(torch):
    """Which collectives gloo takes on CUDA tensors (a gloo group beside
    the NCCL one): `parallel/comm.py` hands gloo the rank's CUDA tensors,
    so every one of them must be accepted."""
    import torch.distributed as dist

    g = dist.new_group(backend="gloo")
    x = torch.ones(4, dtype=torch.float64, device="cuda")
    ops = {
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x, group=g),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x)], x,
                                              group=g),
        "broadcast": lambda: dist.broadcast(x, 0, group=g),
        "all_reduce": lambda: dist.all_reduce(x, group=g),
    }
    out = {}
    for name, fn in ops.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "accepted"
        except Exception as e:  # noqa: BLE001 (the probe's answer)
            out[name] = f"refused ({type(e).__name__}: {str(e)[:80]})"
    dist.destroy_process_group(g)
    return out


def _world1_context(torch):
    """A real NCCL group of world size 1 in this process, as the driver's
    `ParallelContext`."""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.parallel import comm as C

    return driver.ParallelContext(C.init_process_group("nccl", C.World(
        0, 1, 0, 1, f"tcp://127.0.0.1:{_free_port()}"),
        torch.device("cuda", 0)))


def dist_in_process(torch, np, card, ctx):
    """(a) On the world of one rank `ctx`: the halo applies, the lockstep
    4-rank apply, the sharded V-cycle and the distributed CG at full width
    against the global operators."""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
    from disco4est_tpu_torch.io.norms import norm_L2
    from disco4est_tpu_torch.laplacian.hp import apply_sipg_hp, own_mask
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.parallel import mg as PMG
    from disco4est_tpu_torch.parallel.halo import (
        apply_sipg_halo,
        apply_sipg_hp_halo,
    )
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.solvers import multigrid as tmg
    from disco4est_tpu_torch.solvers.cg import cg_solve

    comm = ctx.comm
    probe = _gloo_cuda_probe(torch)
    print(f"[15] (a) NCCL group of world size 1; gloo on CUDA tensors: "
          f"{probe}")
    check(all(v == "accepted" for v in probe.values()),
          f"(a) gloo refuses CUDA tensors: {probe}")
    rng = np.random.default_rng(15)
    dev = "cuda"

    def field(mesh, own=False):
        u = torch.as_tensor(rng.standard_normal(
            (mesh.n_elements,) + (mesh.nl,) * mesh.dim), device=dev)
        return u * own_mask(mesh, u.dtype) if own else u

    def halo_check(label, mesh, hp=False, device_ms=True):
        ep = ctx.distribute(mesh)
        u = field(mesh, own=hp)
        glob = (lambda: apply_sipg_hp(mesh, u)) if hp else (
            lambda: apply_sipg(mesh, u))
        u_l = ep.to_dev(u)
        fn = apply_sipg_hp_halo if hp else apply_sipg_halo
        halo = lambda: fn(ep.mesh, ep.halo, u_l, comm)  # noqa: E731
        ref = glob()
        rel = _rel_t(torch, ep.to_host(halo()), ref)
        rel4 = _rel_t(torch, _lockstep(torch, mesh, u, 4, hp=hp), ref)
        # device time in batches of two behind a spin: ten uniform halo
        # applies (~140 launches each) would fill the card's launch queue
        # and block the host; on hanging meshes (the mortar passes) one
        # apply does, so there the wall alone is printed
        wall = {k: _wall_ms(torch, f, 10) for k, f in (("halo", halo),
                                                       ("global", glob))}
        dev_ms = (f"device ms per apply halo {_time_ms(torch, halo, n=2):.4f}"
                  f", global {_time_ms(torch, glob, n=2):.4f}; "
                  if device_ms else "")
        print(f"[15] (a) {label}: {mesh.n_elements} elements; "
              f"{'hp ' if hp else ''}halo apply rel {rel:.2e}, lockstep 4 "
              f"ranks rel {rel4:.2e}; {dev_ms}wall ms per apply halo "
              f"{wall['halo']:.3f}, global {wall['global']:.3f}")
        check(rel <= DIST_APPLY_REL and rel4 <= DIST_APPLY_REL,
              f"(a) {label}: halo apply rel {rel}, lockstep {rel4}")
        return ep

    geom = BrickGeometry(dim=3)
    mesh5 = build_mesh(geom, Forest.uniform(geom.conn, 5), deg=3, device=dev)
    ep5 = halo_check("sinx brick deg 3 level 5 (2,097,152 DOF)", mesh5)
    for n in (2, 4):
        recv, nbytes, padded = _halo_bytes(mesh5, n)
        print(f"[15] (a) level 5 on {n} ranks: {recv} halo elements "
              f"received an apply, {nbytes / 2**20:.2f} MiB (f64), "
              f"{padded / 2**20:.2f} MiB in the padded all-to-all blocks")
    deg_e = np.where(rng.random(mesh5.n_elements) < 0.5, 2, 3).astype(
        np.int32)
    halo_check("hp brick level 5, degrees 2 and 3",
               build_mesh(geom, mesh5.forest, deg=3, deg_e=deg_e,
                          device=dev), hp=True)
    # epoch 2 of phase 9 (c)'s hp smooth_pred run (4040 elements: hanging
    # faces, degrees 2 and 3; the kernels kept out: use_structured = 0)
    sp = driver.run_poisson(driver.Options.load(AMR_OPTIONS.format(
        use_structured=0, mixed=1, **dict(AMR_RUNS["c"], steps=2))),
        SinxProblem, device=dev).mesh
    check(sp.hc_elem.shape[0] > 0 and len(set(sp.deg_e.tolist())) > 1,
          "(a) the smooth_pred mesh has no hanging face or one degree")
    halo_check("smooth_pred mesh (phase 9 (c), storage degree "
               f"{sp.deg})", build_mesh(geom, sp.forest, deg=sp.deg,
                                        device=dev), device_ms=False)
    halo_check("the same, hp (its own degrees)", sp, hp=True,
               device_ms=False)
    sph = CubedSphereGeometry("7tree", R0=1.0, R1=2.0)
    halo_check("7-tree sphere level 3, deg 3, pointwise sigma",
               build_mesh(sph, Forest.uniform(sph.conn, 3), deg=3,
                          face_h_type="j_div_sj_quad", device=dev))

    # the sharded V-cycle at level 5 against the global one (same bounds)
    params = driver.mg_params_from_options(driver.Options.load("[x]\n"))
    hier = tmg.build_hierarchy(mesh5, params)
    tmg.mg_setup(hier, apply_sipg, driver._sin3_seed)
    sh = PMG.build_sharded_hierarchy(hier, comm)
    bounds = PMG.mg_setup_sharded(sh, driver._sin3_seed)
    brel = max(abs(a[1] - b[1]) / b[1] for a, b in zip(bounds, hier.bounds))
    sh.bounds = hier.bounds
    b = field(mesh5)
    b_l = ep5.to_dev(b)
    vg = lambda: tmg.v_cycle(hier, apply_sipg, b, torch.zeros_like(b))  # noqa
    vs = lambda: PMG.v_cycle_sharded(sh, b_l, torch.zeros_like(b_l))  # noqa
    vrel = _rel_t(torch, ep5.to_host(vs()), vg())
    print(f"[15] (a) level-5 V-cycle ({hier.n_levels} levels): sharded rel "
          f"{vrel:.2e}, lmax rel {brel:.2e}; wall ms per V-cycle sharded "
          f"{_wall_ms(torch, vs, 3):.1f}, global {_wall_ms(torch, vg, 3):.1f}")
    check(vrel <= DIST_VCYCLE_REL and brel <= DIST_APPLY_REL,
          f"(a) sharded V-cycle rel {vrel}, bounds rel {brel}")

    # the distributed CG of the driver against the one-process CG
    g = mesh5.boundary_values(SinxProblem.boundary)
    rhs = build_rhs_with_strong_bc(mesh5, mesh5.init_field(SinxProblem.rhs), g)
    x0 = torch.zeros_like(rhs)
    u_a = mesh5.init_field(SinxProblem.analytic)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = cg_solve(lambda v: apply_sipg(mesh5, v), rhs, x0=x0, atol=5e-15,
                   rtol=1e-20, max_iter=100000)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    info, x = driver._solve_dist(ep5, rhs, x0, hp=False, use_mixed=False,
                                 ksp="cg", mixed_opts={})
    l2 = [float(norm_L2(mesh5, v - u_a)) for v in (one.x, x)]
    true = [float(torch.linalg.norm((rhs - apply_sipg(mesh5, v)).reshape(-1)))
            for v in (one.x, x)]
    bnorm = float(torch.linalg.norm(rhs.reshape(-1)))
    print(f"[15] (a) level-5 CG: distributed {info.line(0)}; one process "
          f"{one.iterations} iterations, {t_one:.3f} s; L2 {l2[1]!r} / "
          f"{l2[0]!r} (rel {abs(l2[1] - l2[0]) / l2[0]:.2e}; JAX's mixed "
          f"solve {LEVEL5_L2!r}); true residuals ||b - A x|| {true[1]:.3e} "
          f"/ {true[0]:.3e}; max |x_dist - x_one| / max |x_one| "
          f"{_rel_t(torch, x, one.x):.2e}")
    l2w, wit, t_wit = c17_witness(torch, mesh5, rhs)
    rel_w = abs(l2[1] - l2w) / l2w
    rel_form = abs(l2[0] - l2w) / l2w
    rel_jax = abs(l2w - LEVEL5_L2) / LEVEL5_L2
    print(f"[15] (a) C17 witness, one-process f64 CG on the general form "
          f"(volume_mode = dense): {wit.iterations} iterations, "
          f"{t_wit:.3f} s; L2 {l2w!r}; the distributed CG's L2 rel "
          f"{rel_w:.2e} (bound {DIST_WITNESS_REL:.0e}), max |x_dist - "
          f"x_wit| / max |x_wit| {_rel_t(torch, x, wit.x):.2e}; the "
          f"GEMM-form one-process CG's rel {rel_form:.2e} and JAX's "
          f"{rel_jax:.2e} (bound {DIST_FORM_REL:.0e})")
    # both stop on their recursive residual (ROADMAP C15): the same
    # count, true residuals under the mixed solve's fallback floor, the L2
    # on the witness's; the witness within DIST_FORM_REL of the GEMM form
    # and JAX (the operator's two f64 forms)
    check(info.path == "cg-halo" and info.iterations == one.iterations
          and max(true) <= 1e-10 * (1.0 + bnorm) and rel_w <= DIST_WITNESS_REL
          and rel_form <= DIST_FORM_REL and rel_jax <= DIST_FORM_REL,
          f"(a) distributed CG: {info.line(0)}, L2 {l2}, witness {l2w}, "
          f"true {true}")


def _witness_run(torch, name):
    """C17's witness of a full-width run: `_one_process` with the general
    form of the operator (`apply_sipg` off its GEMM-form fast path, the
    form the halo program computes) on every apply; its L2 per level and
    its seconds."""
    from unittest import mock

    with mock.patch("disco4est_tpu_torch.laplacian.sipg.fast_path_available",
                    lambda *a, **k: False):
        return _one_process(torch, name)


def c17_witness(torch, mesh, rhs):
    """ROADMAP C17's witness: the distributed CG's solve in one process on
    the general form of the operator (`apply_sipg(..., volume_mode =
    "dense")`: quadrature-point face terms, as the halo program has them,
    off the GEMM-form fast path).  Returns its sinx L2 error, the solve's
    result and its seconds."""
    from disco4est_tpu_torch.io.norms import norm_L2
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.solvers.cg import cg_solve

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wit = cg_solve(lambda v: apply_sipg(mesh, v, volume_mode="dense"), rhs,
                   x0=torch.zeros_like(rhs), atol=5e-15, rtol=1e-20,
                   max_iter=100000)
    torch.cuda.synchronize()
    l2 = float(norm_L2(mesh, wit.x - mesh.init_field(SinxProblem.analytic)))
    return l2, wit, time.perf_counter() - t0


def dist_cli(torch, tmp, ctx, runs=DIST_RUNS):
    """(b) The CLI on n ranks (`backend = auto`: gloo when they share the
    card, NCCL on a card each), each norm line against its one-process
    reference: the driver on the world of one rank `ctx` at full width,
    the one-process run otherwise; the full-width sinx runs also against
    C17's witness, the same driver in one process on the general form of
    the operator (`_witness_run`)."""
    world1, witness = {}, {}
    for name, n in runs:
        problem = "cds" if name.startswith("cds") else "sinx"
        one, t_one = _one_process(torch, name)
        if name in DIST_FULL and name not in world1:
            world1[name] = _world1_run(torch, ctx, name)
        ref, ref_paths, t_ref = world1.get(name, (one, None, t_one))
        out, wall = run_ranks(n, _dist_options(name, n), problem, tmp)
        for r, (code, so, se) in enumerate(out):
            check(code == 0, f"(b) {name} on {n} ranks: rank {r} exit "
                  f"{code}: {se[-3000:]}")
            check(r == 0 or so == "", f"(b) rank {r} printed {so!r}")
        lines = out[0][1].splitlines()
        backend = "gloo" if n > torch.cuda.device_count() else "nccl"
        check(lines[0].startswith(f"parallelism: {n} ranks, backend = "
                                  f"{backend} (auto"),
              f"(b) {name}: rank 0's first line {lines[0]!r}")
        norms = [x for x in lines if len(x.split()) == 4
                 and x.split()[0].isdigit()]
        step = "newton level" if problem == "cds" else "solve level"
        steps = [x for x in lines if x.startswith(step)]
        got = [float(x.split()[3]) for x in norms]
        pins = _dist_pin(name)
        full = name in DIST_FULL
        print(f"[15] (b) {name} on {n} ranks ({lines[0]}): wall {wall:.2f} "
              f"s (one process in this process {t_one:.2f} s"
              + (f", on a world of one rank {t_ref:.2f} s, paths "
                 f"{ref_paths}" if full else "") + ")")
        for k, (line, st) in enumerate(zip(norms, steps)):
            jax = (f"{abs(got[k] - pins[k]) / abs(pins[k]):.2e}" if pins
                   else "no pin")
            print(f"[15] (b)   {line} | {st}")
            print(f"[15] (b)   level {k}: rel to "
                  + (f"the world of one rank {abs(got[k] - ref[k]) / abs(ref[k]):.2e}"
                     f" (bound {_path_rel(st):.0e}), to " if full else "")
                  + f"one process {abs(got[k] - one[k]) / abs(one[k]):.2e}"
                  f", to JAX {jax}")
        check(len(got) == len(ref) == len(one) == len(steps)
              and (pins is None or len(pins) == len(got)),
              f"(b) {name}: {len(got)} norm lines, {len(ref)} levels")
        check(all(abs(a - b) <= _path_rel(st) * abs(b)
                  for a, b, st in zip(got, ref, steps)),
              f"(b) {name} on {n} ranks: {got} against {ref}")
        if name in DIST_WITNESS_RUNS:
            if name not in witness:
                witness[name] = _witness_run(torch, name)
            wit, t_wit = witness[name]
            rel_w = [abs(a - b) / abs(b) for a, b in zip(got, wit)]
            print(f"[15] (b)   C17's witness (one process, general form, "
                  f"{t_wit:.2f} s): L2 {wit}; rel {rel_w} (bound "
                  f"{DIST_WITNESS_REL:.0e})")
            check(len(wit) == len(got)
                  and max(rel_w) <= DIST_WITNESS_REL,
                  f"(b) {name} on {n} ranks: {got} against the witness's "
                  f"{wit}")
        far = DIST_FORM_REL if full else None
        for other in (one, pins or []):
            check(all(abs(a - b) <= (far or _path_rel(st)) * abs(b)
                      for a, b, st in zip(got, other, steps)),
                  f"(b) {name} on {n} ranks: {got} against {other}")
        check(problem == "cds" or all("-halo " in x for x in steps),
              f"(b) {name}: a solve off the halo program: {steps}")
        check(ref_paths is None or all(
            x == "newton" or x.endswith("-halo") for x in ref_paths),
            f"(b) {name}: the world of one rank left the halo program: "
            f"{ref_paths}")


def dist_errors(torch, tmp):
    """(c) The errors that must be raised: NCCL with two ranks on one
    card, and the C6 and C2 combinations (in process, in a world of 2:
    they raise before any rank joins a group)."""
    import os

    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.util.config import Options

    text = _dist_options("sinx_hp", 2, backend="nccl")
    out, wall = run_ranks(2, text, "sinx", tmp, timeout=120)
    print(f"[15] (c) backend = nccl on 2 ranks of one card: exit codes "
          f"{[o[0] for o in out]} in {wall:.1f} s: "
          f"{out[0][2].strip().splitlines()[-1]!r}")
    check(all(o[0] != 0 and "backend = gloo" in o[2] for o in out),
          "(c) nccl with 2 ranks on one card did not raise the port's error")
    base = _dist_options("sinx_hp", 2)
    cases = {
        "pc_type = schwarz (C6)": base.replace(
            "use_mixed_precision = 0", "use_mixed_precision = 0\n"
            "pc_type = schwarz"),
        "pc_type = cheby (C6)": base.replace(
            "use_mixed_precision = 0", "use_mixed_precision = 0\n"
            "pc_type = cheby"),
        "mid-solve checkpoints (C6)": base + (
            f"\n[checkpoint]\nprefix = {tmp}/ck\n"
            "checkpoint_every_n_krylov_its = 5\n"),
        "a Schwarz multigrid smoother (C2)": _dist_options("mg", 2)
        + "\n[multigrid]\nsmoother_name = mg_smoother_schwarz\n",
        "Newton-MG (C6)": _dist_options("cds", 2).replace(
            "ksp_type = cg", "ksp_type = fcg\npc_type = multigrid"),
    }
    env = dict(WORLD_SIZE="2", RANK="0", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for label, text in cases.items():
            opts = Options.load(text)
            try:
                if "Newton" in label:
                    driver.run_nonlinear(opts, driver.CDSProblem(opts),
                                         device="cuda")
                else:
                    driver.run_poisson(opts, SinxProblem, device="cuda")
            except NotImplementedError as e:
                print(f"[15] (c) {label}: NotImplementedError: {e}")
                check(label[-3:-1] in str(e), f"(c) {label}: {e}")
                continue
            fail(f"(c) {label} ran under [parallelism]")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_dist(torch, np, card):
    """Phase 15: the distributed driver on the card (torch operations and
    collectives; B1, B2 and B3 must not launch in (a))."""
    import tempfile

    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.parallel import comm as C
    from disco4est_tpu_torch.tools import exp_kernel_design as X

    print(f"[15] the distributed driver on {card}")
    t_phase = time.perf_counter()
    S.KERNEL_LAUNCHES = fused.KERNEL_LAUNCHES = X.KERNEL_LAUNCHES = 0
    ctx = _world1_context(torch)
    try:
        dist_in_process(torch, np, card, ctx)
        print(f"[15] (a) {time.perf_counter() - t_phase:.1f} s")
        with tempfile.TemporaryDirectory() as tmp:
            dist_cli(torch, tmp, ctx)
            counts = dict(B1=S.KERNEL_LAUNCHES, B2=fused.KERNEL_LAUNCHES,
                          B3=X.KERNEL_LAUNCHES)
            print(f"[15] (a), (b) kernel launches in this process's "
                  f"distributed and one-process runs: {counts}")
            check(not any(counts.values()),
                  f"a kernel ran in (a) or (b): {counts}")
            dist_errors(torch, tmp)
    finally:
        C.shutdown()
    print(f"[15] phase wall {time.perf_counter() - t_phase:.1f} s")


def _rel_l2_max(torch, a, ref):
    d = (a.double() - ref.double())
    r = ref.double()
    return (float(torch.linalg.norm(d.reshape(-1))
                  / torch.linalg.norm(r.reshape(-1))),
            float(d.abs().max() / r.abs().max()))


def sipg_pass_cost_bf16(E, nv, nblk, tw, extra_bytes=0):
    """Flop and bytes of the bf16 fused pass: the flop of `sipg_pass_cost`;
    u, cw and scal read (f32), the bf16 traces and weights read once, Au
    written once (f32), plus `extra_bytes` of tables."""
    flop = 2.0 * E * nv * (nblk * nv + tw)
    nbytes = (4 * (2 * E * nv + E * nblk + E * 24)
              + 2 * (E * tw + nv * nblk * nv + tw * nv) + extra_bytes)
    return flop, nbytes


def bound_ms_bf16(flop, nbytes):
    """The least time of the bf16 pass on the card: the larger of the
    bytes over the memory rate and the flop over the dense bf16 peak."""
    t_ops, t_bytes = flop / PEAK_BF16, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _bf16_check(torch, np, tag, kernel, plain, f64):
    """(a) One bf16 kernel against its plain version and the f64 apply;
    returns the max abs error against the plain version."""
    out = kernel()
    ref = plain()
    ref64 = f64()
    torch.cuda.synchronize()
    l2, rmax = _rel_l2_max(torch, out, ref)
    e_k = _rel_l2_max(torch, out, ref64)[0]
    e_p = _rel_l2_max(torch, ref, ref64)[0]
    abs_err = float((out - ref).abs().max())
    print(f"[16] (a) {tag}: kernel vs plain bf16 rel L2 {l2:.3e}, rel max "
          f"{rmax:.3e} (abs {abs_err:.3e}); vs f64 rel L2 kernel {e_k:.3e}, "
          f"plain {e_p:.3e} (ratio {e_k / e_p:.3f})")
    check(np.isfinite(l2) and l2 <= BF16_REL_L2 and rmax <= BF16_REL_MAX,
          f"(a) {tag}: bf16 kernel vs plain rel L2 {l2}, max {rmax}")
    check(np.isfinite(e_k) and e_k <= BF16_F64_RATIO * e_p,
          f"(a) {tag}: bf16 kernel's f64 error {e_k} above "
          f"{BF16_F64_RATIO} x the plain version's {e_p}")
    return abs_err


def bf16_kernels(torch, np, card):
    """(a) and (b): both bf16 kernels against their plain versions and the
    f64 apply, then timed at the two sizes beside the f32 kernels."""
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.laplacian.fast import _apply_orth
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    dev = torch.device("cuda")
    max_abs = {"B1": 0.0, "B2": 0.0}
    timing = {}
    for deg, level, x1 in BF16_CASES:
        geom = BrickGeometry(x1=x1, dim=3)
        mesh = build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                          device=dev)
        sb = S.build_structured(mesh)
        E, nl = mesh.n_elements, deg + 1
        u = torch.as_tensor(
            np.random.default_rng(1600 + 10 * deg + level).standard_normal(
                (E, sb.nv)), dtype=torch.float32, device=dev)
        tr = S.compute_traces_lex(sb, u, "bf16").contiguous()
        f64 = lambda: S.to_lex(sb, _apply_orth(  # noqa: E731
            mesh, S.from_lex(sb, u.double()).reshape((E,) + (nl,) * 3)
        ).reshape(E, -1))
        max_abs["B1"] = max(max_abs["B1"], _bf16_check(
            torch, np, f"B1 deg {deg} level {level} x1 {x1} E {E} nblk "
            f"{sb.nblk}", lambda: S.lex_apply_cuda_bf16(sb, u, tr),
            lambda: S.lex_apply_plain(sb, u, tr, "bf16"), f64))
        if (deg, level) not in TIMED_CASES or x1 != (1.0, 1.0, 1.0):
            continue
        tr32 = S.compute_traces_lex(sb, u).contiguous()
        fm = fused.build_fused(mesh)
        u2 = S.from_lex(sb, u).contiguous()
        trf = fused.scaled_traces(u2, fm.W_tr, fm.drstn, "bf16").contiguous()
        trf32 = fused.scaled_traces(u2, fm.W_tr, fm.drstn).contiguous()
        plans = {"B1": S.lex_bf16_plan(sb), "B2": fused.fused_bf16_plan(fm)}
        timing[(deg, level)] = bf16_timing(torch, card, deg, level, E, sb.nv,
                                           sb.nblk, 12 * nl * nl, plans, {
            "B1 bf16": lambda: S.lex_apply_cuda_bf16(sb, u, tr),
            "B1 f32": lambda: S.lex_apply_cuda(sb, u, tr32),
            "B1 plain bf16": lambda: S.lex_apply_plain(sb, u, tr, "bf16"),
            "B2 bf16": lambda: fused.fused_apply_cuda_bf16(fm, u2, trf),
            "B2 f32": lambda: fused.fused_apply_cuda(fm, u2, trf32),
            "B2 plain bf16": lambda: fused.fused_apply_plain(fm, u2, trf,
                                                             "bf16"),
        })
    for deg, level, x1, trees in BF16_FUSED_CASES:
        geom = BrickGeometry(x1=x1, n_trees_per_dim=trees, dim=3)
        mesh = build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                          device=dev)
        fm = fused.build_fused(mesh)
        E, nl = mesh.n_elements, deg + 1
        u = torch.as_tensor(
            np.random.default_rng(1700 + 10 * deg + level).standard_normal(
                (E, fm.nv)), dtype=torch.float32, device=dev)
        tr = fused.scaled_traces(u, fm.W_tr, fm.drstn, "bf16").contiguous()
        max_abs["B2"] = max(max_abs["B2"], _bf16_check(
            torch, np, f"B2 deg {deg} level {level} x1 {x1} trees {trees} "
            f"E {E} nblk {fm.nblk}",
            lambda: fused.fused_apply_cuda_bf16(fm, u, tr),
            lambda: fused.fused_apply_plain(fm, u, tr, "bf16"),
            lambda: _apply_orth(mesh, u.double().reshape(
                (E,) + (nl,) * 3)).reshape(E, -1)))
    check(set(timing) == set(TIMED_CASES), "(b) timed case missing")
    return max_abs, timing


def bf16_timing(torch, card, deg, level, E, nv, nblk, tw, plans, fns):
    """(b) The bf16 and f32 kernels and the plain bf16 versions of B1 and
    B2 at one size, in alternating rounds; the bf16 kernels against their
    bf16 bound, with their launch plans (`fused.bf16_plan`: CTAs, splits
    and the K chunks a CTA runs).  Returns each bf16 kernel's numbers for
    the kernels line."""
    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    t = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]) * 2:
        for k in order:
            t[k].append(_time_ms(torch, fns[k]))
    t = {k: _median(v) for k, v in t.items()}
    out = {}
    for name, extra in (("B1", 0), ("B2", 4 * E * 6)):
        flop, nbytes = sipg_pass_cost_bf16(E, nv, nblk, tw, extra)
        bms, by = bound_ms_bf16(flop, nbytes)
        ms = t[f"{name} bf16"]
        plan = plans[name]
        print(f"[16] (b) {name} deg {deg} level {level} (E {E}) on {card}: "
              f"bf16 kernel {ms:.4f} ms, f32 kernel {t[f'{name} f32']:.4f} ms"
              f", plain bf16 {t[f'{name} plain bf16']:.4f} ms; bf16 bound "
              f"{bms:.4f} ms by {by} ({flop / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB; {bms / ms:.1%} of it); {plan['grid']}"
              f" CTAs, splits {plan['splits']}, {plan['steps']} K chunks "
              f"a CTA ({1e3 * ms / plan['steps']:.3f} us a chunk)")
        out[name] = dict(ms=ms, plain_ms=t[f"{name} plain bf16"],
                         bound_ms=bms, bound_by=by,
                         f32_ms=t[f"{name} f32"])
    return out


def _bf16_inner(S, sb, apply32):
    """`structured.make_inner_solve(sb, precision="bf16")`'s closure with
    the inner apply `apply32` (the kernel's, or its plain version's)."""
    from disco4est_tpu_torch.solvers.cg import cg_solve

    def inner(r32):
        b_lex = S.to_lex(sb, r32.reshape(sb.n_elements, -1))
        res = cg_solve(apply32, b_lex, atol=0.0, rtol=1e-3, max_iter=400)
        return S.from_lex(sb, res.x).reshape(r32.shape), res.iterations

    return inner


def bf16_mixed_solve(torch, card, level):
    """(c) Phase 9 (a)'s sinx mixed solve at deg 3 on the level-`level`
    brick (phase 5's at level 5) with the bf16 inner solve:
    `mixed_refine_solve` with `structured.make_inner_solve(sb,
    precision="bf16")`, the call of the driver's structured path (which
    passes the f32 default); then the same solve with the plain bf16
    version as the inner apply, and, where the driver would fall back, its
    f64 CG.  Prints the outer and inner counts, the outer residuals, the
    true residual, the wall, the fallback flag and B1's launches per
    precision; returns the kernel solve's bf16 launches."""
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.io.norms import norm_L2
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.solvers.cg import cg_solve
    from disco4est_tpu_torch.solvers.mixed import mixed_refine_solve

    geom = BrickGeometry(dim=3)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, level), deg=3,
                      device="cuda")
    sb = S.build_structured(mesh)
    rhs = build_rhs_with_strong_bc(
        mesh, mesh.init_field(SinxProblem.rhs),
        mesh.boundary_values(SinxProblem.boundary))
    u_a = mesh.init_field(SinxProblem.analytic)
    bnorm = float(torch.linalg.norm(rhs.reshape(-1)))
    pin = BF16_SOLVES[level]

    def solve(tag, inner):
        its, hist = [], []

        def inner_rec(r32):
            d, it = inner(r32)
            its.append(int(it))
            return d, it

        def A(v):
            out = apply_sipg(mesh, v)
            hist.append(float(torch.linalg.norm((rhs - out).reshape(-1))))
            return out

        S.KERNEL_LAUNCHES = S.KERNEL_LAUNCHES_BF16 = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mixed_refine_solve(A, rhs, x0=torch.zeros_like(rhs),
                                 inner_solve=inner_rec, atol=5e-15,
                                 rtol=1e-20, max_outer=BF16_MAX_OUTER)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(bf16=S.KERNEL_LAUNCHES_BF16, f32=S.KERNEL_LAUNCHES)
        true = float(torch.linalg.norm((rhs - apply_sipg(mesh, res.x))
                                       .reshape(-1)))
        fallback = (res.outer_iterations >= BF16_MAX_OUTER
                    or res.residual_norm > 1e-10 * (1.0 + bnorm))
        print(f"[16] (c) level {level}, {tag}: {res.outer_iterations} outer "
              f"steps, inner iterations {its} (total {res.inner_iterations})"
              "; outer residuals (each trial step's) "
              + ", ".join(f"{h:.3e}" for h in hist)
              + f"; true ||b - A u|| {true:.3e} (rhs norm {bnorm:.3e}); "
              f"wall {wall:.3f} s; fallback {'yes' if fallback else 'no'}; "
              f"B1 launches {launches}")
        return res, fallback, launches

    res, fallback, launches = solve(
        f"bf16 kernel inner CG on {card}",
        S.make_inner_solve(sb, rtol=1e-3, max_iter=400, precision="bf16"))
    _, fallback_p, launches_p = solve(
        "plain bf16 inner CG", _bf16_inner(
            S, sb, lambda v: S.apply_structured_plain(sb, v, "bf16")))
    check(launches["bf16"] > 0 and launches["f32"] == 0
          and not any(launches_p.values()),
          f"(c) level {level}: B1 launches {launches}, plain {launches_p}")
    inner = res.inner_iterations
    check(res.outer_iterations == pin["outer"]
          and abs(inner - pin["inner"]) <= BF16_INNER_REL * pin["inner"]
          and fallback == fallback_p == pin["fallback"],
          f"(c) level {level}: {res.outer_iterations} outer steps, {inner} "
          f"inner iterations, fallback {fallback} (plain {fallback_p}); "
          f"pinned {pin}")
    x, how = res.x, "the bf16 mixed solve"
    if fallback:
        # what the driver does then (`driver._solve`'s f64 fallback)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cg = cg_solve(lambda v: apply_sipg(mesh, v), rhs,
                      x0=torch.zeros_like(rhs), atol=5e-15, rtol=1e-20,
                      max_iter=100000)
        torch.cuda.synchronize()
        x, how = cg.x, (f"the f64 CG fallback ({cg.iterations} iterations, "
                        f"{time.perf_counter() - t0:.3f} s)")
    l2 = float(norm_L2(mesh, x - u_a))
    rel = abs(l2 - pin["l2"]) / pin["l2"]
    print(f"[16] (c) level {level}: L2 of {how} {l2!r} (rel to JAX "
          f"{rel:.3e})")
    check(rel <= LEVEL5_REL, f"(c) level {level}: L2 {l2} vs {pin['l2']}")
    return launches["bf16"]


def phase_bf16(torch, np, card):
    """Phase 16: the bf16 mode of B1 and B2 on the card."""
    t0 = time.perf_counter()
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "the plain versions need TF32 off")
    max_abs, timing = bf16_kernels(torch, np, card)
    launches = {level: bf16_mixed_solve(torch, card, level)
                for level in sorted(BF16_SOLVES)}
    print(f"[16] phase wall {time.perf_counter() - t0:.1f} s")
    return max_abs, timing, launches[5]


ORACLE_STAMM_ROWS = 8  # (b): rows 0-7, the deep rows 6-7 included
COMPACT_SIZE = (7, 5)  # (c): deg 7 on the level-5 brick, 32768 elements


def _oracle_pins():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "refcheck"))
    import oracle_smoke_pins

    return oracle_smoke_pins


def oracles_on_card(P):
    """Phase 17 (a): the sinx digit, the CDS estimator, the 13-tree
    TwoPunctures digit and the TwoPunctures trajectory on the card, each
    at its JAX test's tolerance."""
    from disco4est_tpu_torch.tools import oracles as O

    r = O.sinx_regression("cuda")
    pin = P.SINX
    gaps = (abs(r["l2_interp_abs"] - pin["l2_interp_abs"]),
            abs(r["l2"] - pin["l2"]))
    print(f"[17] (a) sinx: {r['n_elements']} {r['local_nodes']}, interp |e| "
          f"{r['l2_interp_abs']!r} (gap {gaps[0]:.3e}), L2 {r['l2']!r} (gap "
          f"{gaps[1]:.3e}; bound {pin['abs_tol']:.0e}), {r['iterations']} CG "
          f"iterations, {r['seconds']:.2f} s")
    check((r["n_elements"], r["local_nodes"]) == (pin["n_elements"],
                                                  pin["local_nodes"])
          and max(gaps) < pin["abs_tol"], f"(a) sinx {r}")

    r = O.cds_amr("cuda")
    pin = P.CDS
    gap_l2 = abs(r["l2"][1] - pin["l2_1"])
    gap_est = abs(r["estimator"] - pin["estimator"])
    lo, hi = pin["l2_0_range"]
    print(f"[17] (a) CDS + 1 AMR step: {r['n_elements']} elements, "
          f"{r['marked']} marked, L2 {r['l2'][0]!r} -> {r['l2'][1]!r} (gap "
          f"{gap_l2:.3e}, bound {pin['l2_1_abs']:.0e}), estimator "
          f"{r['estimator']!r} (gap {gap_est:.3e}, bound "
          f"{pin['estimator_abs']:.0e}), Newton {r['newton_iterations']}, "
          f"{r['seconds']:.2f} s")
    check(r["n_elements"] == pin["n_elements"]
          and r["local_nodes"] == pin["local_nodes"]
          and r["marked"] == pin["marked"], f"(a) CDS sizes {r}")
    check(max(r["residual_norm"]) < pin["residual_norm"]
          and lo <= r["l2"][0] < hi and gap_l2 < pin["l2_1_abs"]
          and gap_est < pin["estimator_abs"], f"(a) CDS {r}")

    r = O.two_punctures_13tree("cuda")
    pin = P.TP13
    gap = abs(r["u_100"] - pin["u_100"])
    print(f"[17] (a) 13-tree TwoPunctures: {r['n_elements']} elements, "
          f"{r['local_nodes']} nodes, {r['newton_iterations']} Newton steps "
          f"(||F|| {r['residual_norm']:.3e}), u(100, 0, 0) = {r['u_100']!r} "
          f"(gap {gap:.3e}, bound {pin['abs_tol']:.0e}), "
          f"{r['seconds']:.2f} s")
    check((r["n_elements"], r["local_nodes"]) == (pin["n_elements"],
                                                  pin["local_nodes"])
          and r["residual_norm"] < pin["residual_norm"]
          and gap < pin["abs_tol"], f"(a) 13-tree digit {r}")

    rows = O.two_punctures_trajectory("cuda", levels=len(P.TP_TRAJECTORY))
    for k, (row, (E, nodes, eta2, tol)) in enumerate(
            zip(rows, P.TP_TRAJECTORY)):
        rel = abs(row["eta2_sum"] - eta2) / eta2
        print(f"[17] (a) TwoPunctures trajectory level {k}: {row['n_elements']}"
              f" elements, {row['nodes']} nodes, sum eta2 "
              f"{row['eta2_sum']!r} (rel {rel:.3e}, bound {tol:.0e}), "
              f"||F|| {row['residual_norm']:.3e}, {row['seconds']:.2f} s")
        check((row["n_elements"], row["nodes"]) == (E, nodes)
              and row["residual_norm"] < P.TP_TRAJECTORY_RESIDUAL
              and rel <= tol, f"(a) TwoPunctures level {k}: {row}")


def stamm_on_card(P):
    """Phase 17 (b): the Stamm trajectory rows 0-7 on the card, rows 6-7
    at the JAX test's deep tolerances; each row's CG iterations and
    seconds printed as it is ready."""
    from disco4est_tpu_torch.tools import oracles as O

    def on_row(row):
        pin = P.STAMM[row["level"]]
        l2_rel, est_rel, counts = P.stamm_row_errors(row, pin)
        solve = ("the initial 0.5" if row["cg_iterations"] is None else
                 f"{row['cg_iterations']} CG iterations, "
                 f"{row['solve_seconds']:.2f} s")
        print(f"[17] (b) Stamm row {row['level']}: {row['n_elements']} "
              f"elements, {row['nodes']} nodes (degrees up to "
              f"{row['max_degree']}), L2 {row['l2']!r} (rel {l2_rel:.3e}, "
              f"bound {pin[4]:.0e}), estimate {row['estimator']!r} (rel "
              f"{est_rel:.3e}, bound {pin[5]:.0e}); {solve}", flush=True)
        check(counts, f"(b) Stamm row {row['level']} counts {row}")
        check(l2_rel < pin[4] and est_rel < pin[5],
              f"(b) Stamm row {row['level']}: {row}")

    t0 = time.perf_counter()
    O.stamm_trajectory("cuda", rows=ORACLE_STAMM_ROWS, on_row=on_row)
    print(f"[17] (b) Stamm rows 0-{ORACLE_STAMM_ROWS - 1}: "
          f"{time.perf_counter() - t0:.1f} s")


def compact_on_card(torch, card):
    """Phase 17 (c): the deg-7 level-5 brick built with store_full=True
    and False, the device memory of each build, and B1 (the structured
    inner apply), B2 (`apply_sipg_fused`) and the f64 GEMM-form apply on
    the compact mesh against the full mesh, bit for bit."""
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.laplacian.fast import _apply_orth
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    deg, level = COMPACT_SIZE
    geom = BrickGeometry(dim=3)
    forest = Forest.uniform(geom.conn, level)
    meshes = {}
    for store_full in (False, True):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        meshes[store_full] = build_mesh(geom, forest, deg=deg,
                                        store_full=store_full, device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        held = torch.cuda.memory_allocated() - start
        print(f"[17] (c) deg {deg} / level {level} ({forest.n_elements} "
              f"elements), store_full={store_full}: max_memory_allocated "
              f"{peak / 2**20:.1f} MiB ({(peak - start) / 2**20:.1f} MiB "
              f"above the start of the build), the mesh holds "
              f"{held / 2**20:.1f} MiB, build {sec:.2f} s on {card}")
    comp, full = meshes[False], meshes[True]
    check(comp.j_quad is None and comp.face_drst is None
          and full.j_quad is not None, "(c) storage modes")
    for name in ("volume", "area", "face_h", "sigma"):
        check(torch.equal(getattr(comp, name), getattr(full, name)),
              f"(c) {name} differs between the storage modes")
    gen = torch.Generator(device="cuda").manual_seed(17)
    u = torch.randn((forest.n_elements,) + (deg + 1,) * 3,
                    dtype=torch.float64, device="cuda", generator=gen)
    u32 = u.float()
    out = {}
    for store_full, mesh in meshes.items():
        sb = S.build_structured(mesh)
        out[store_full] = dict(
            B1=S.apply_structured(sb, S.to_lex(sb, u32)),
            B2=fused.apply_sipg_fused(mesh, u32),
            orth=_apply_orth(mesh, u),
        )
    torch.cuda.synchronize()
    for name in ("B1", "B2", "orth"):
        same = torch.equal(out[False][name], out[True][name])
        print(f"[17] (c) {name} on the compact mesh equals the full mesh's "
              f"bit for bit: {same}")
        check(same, f"(c) {name} differs on the compact mesh")


def phase_oracles(torch, np, card):
    """Phase 17: the reference oracles on the card, and the compact
    mesh."""
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.tools import exp_kernel_design as X

    print(f"[17] the reference oracles on {card}")
    t_phase = time.perf_counter()
    P = _oracle_pins()
    S.KERNEL_LAUNCHES = fused.KERNEL_LAUNCHES = X.KERNEL_LAUNCHES = 0
    S.KERNEL_LAUNCHES_BF16 = fused.KERNEL_LAUNCHES_BF16 = 0
    t0 = time.perf_counter()
    oracles_on_card(P)
    print(f"[17] (a) {time.perf_counter() - t0:.1f} s")
    stamm_on_card(P)
    counts = dict(B1=S.KERNEL_LAUNCHES, B2=fused.KERNEL_LAUNCHES,
                  B3=X.KERNEL_LAUNCHES, B1_bf16=S.KERNEL_LAUNCHES_BF16,
                  B2_bf16=fused.KERNEL_LAUNCHES_BF16)
    print(f"[17] (d) kernel launches in (a)-(b): {counts} (f64 torch "
          f"operations only)")
    check(not any(counts.values()), f"(d) a kernel ran in (a)-(b): {counts}")
    t0 = time.perf_counter()
    compact_on_card(torch, card)
    print(f"[17] (c) {time.perf_counter() - t0:.1f} s; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")


MG_REF_TOL = 1e-11  # 19: relative max |port - reference| of one V-cycle
MG_REF_SIZES = ((5, 3, 1905), (6, 3, 1906))  # (level, deg, seed)


def mg_epoch(level, deg):
    """(mesh, preconditioner) of the multigrid cells' configuration on
    the level-`level` brick at `deg`, on the card: the mesh and
    `driver._build_pc` as `run_poisson` makes them."""
    from benchmark import harness
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.util.config import Options

    _, config = harness.load_cell("sinx_brick_l5_deg3_mg")
    opts = Options.load(harness.options_text(harness.merge(
        config["options"],
        {"initial_mesh": {"min_level": level, "region0_deg": deg}})))
    geom = driver.geometry_from_options(opts)
    kw = dict(penalty_prefactor=2.0, penalty_fcn="maxp_sqr_over_minh",
              face_h_type=driver.face_h_from_options(opts))
    mesh = build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                      device="cuda", **kw)
    pc = driver._build_pc(
        mesh, None, hp=False, pc_type="multigrid",
        mg_params=driver.mg_params_from_options(opts), mesh_kwargs=kw,
        overlap=1, subdomain_iter=15, chunk=0, eigs_iters=10, ratio=30.0)
    return mesh, pc


def mg_reference_compare(torch, level, deg, seed, f32_level=None):
    """Phase 19's comparison: one V-cycle of the port (the multigrid
    configuration's preconditioner, set up by `driver._build_pc` on the
    level-`level` brick) and one of the plain reference
    (`benchmark/reference/vcycle.py`, given the port's Chebyshev bounds)
    on the same seeded random residual, the reference's bottom CG pinned
    to the step at which the port's stopped (`tests/
    test_torch_mg_reference.py` gives the reason).  `f32_level` plants
    the fault of that level's operator applied to and returning f32
    values.  Returns a dict of the gap and the counts and times."""
    from benchmark.reference.vcycle import VCycle
    from disco4est_tpu_torch.solvers import multigrid as MG
    from disco4est_tpu_torch.solvers.cg import cg_solve

    t0 = time.perf_counter()
    mesh, pc = mg_epoch(level, deg)
    setup_s = time.perf_counter() - t0
    steps = []
    saved = MG.bottom_cg, MG.level_operator

    def recorded(A, b, x, rtol, iters):
        steps.append(cg_solve(A, b, x0=x, atol=0.0, rtol=rtol,
                              max_iter=iters).iterations)
        return saved[0](A, b, x, rtol, iters)

    def f32(v):
        return v.float().double()

    def level_operator(hier, A, k):
        op = saved[1](hier, A, k)
        return (lambda v: f32(op(f32(v)))) if k == f32_level else op

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = torch.randn((mesh.n_elements,) + (deg + 1,) * 3, dtype=torch.float64,
                    device="cuda", generator=gen)
    MG.bottom_cg, MG.level_operator = recorded, level_operator
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = pc.M(r)
        torch.cuda.synchronize()
        port_ms = (time.perf_counter() - t0) * 1e3
    finally:
        MG.bottom_cg, MG.level_operator = saved
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    ref = VCycle(level, deg, pc.state.bounds, device="cuda")
    ref(r)
    own = ref.last_bottom_steps
    ref.bottom_steps = steps[0]
    e_ref = ref(r)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    gap = float((e - e_ref).abs().max() / e_ref.abs().max())
    # the gaps were the reference's bottom one step short or long
    flips = {}
    for k in (steps[0] - 1, steps[0] + 1):
        ref.bottom_steps = k
        flips[k] = float((e - ref(r)).abs().max() / e_ref.abs().max())
    return dict(gap=gap, levels=pc.state.n_levels, steps=steps[0], own=own,
                flips=flips, port_ms=port_ms, ref_s=ref_s, setup_s=setup_s,
                peak_gib=peak, lmax=pc.state.bounds[0][1])


def phase_mg_reference(torch, np, card):
    """Phase 19: the multigrid cells' V-cycle against the plain reference
    V-cycle at levels 5 and 6 (deg 3), and the finest level in f32, a
    planted fault, which must fail the same tolerance."""
    print(f"[19] the V-cycle against the plain reference on {card}")
    t_phase = time.perf_counter()
    cases = [(level, deg, seed, None) for level, deg, seed in MG_REF_SIZES]
    cases.append(MG_REF_SIZES[0] + (0,))
    for level, deg, seed, f32_level in cases:
        out = mg_reference_compare(torch, level, deg, seed, f32_level)
        what = "sound" if f32_level is None else f"level {f32_level} in f32"
        flips = ", ".join(f"{k} steps {v:.3e}"
                          for k, v in out["flips"].items())
        print(f"[19] level {level}, deg {deg}, seed {seed}, {what}: "
              f"{out['levels']} levels, rel {out['gap']:.3e} (tolerance "
              f"{MG_REF_TOL:.0e}); bottom CG {out['steps']} steps (the "
              f"reference's own test: {out['own']}; pinned to {flips}); "
              f"lmax {out['lmax']:.6g}; port V-cycle {out['port_ms']:.2f} "
              f"ms (host wall to a synchronize), reference "
              f"{out['ref_s']:.2f} s (two cycles), mesh + set-up "
              f"{out['setup_s']:.2f} s, max_memory_allocated "
              f"{out['peak_gib']:.2f} GiB", flush=True)
        if f32_level is None:
            check(out["gap"] < MG_REF_TOL and abs(out["own"] - out["steps"])
                  <= 1 and out["steps"] < 100,
                  f"19: the V-cycle at level {level} misses the reference: "
                  f"{out}")
        else:
            check(out["gap"] > MG_REF_TOL,
                  f"19: the planted f32 level passed the tolerance: {out}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    print(f"[19] phase wall {time.perf_counter() - t_phase:.1f} s")


MG_GRAPH_LEVELS = (5, 6)  # 20 (a), (b): the multigrid cells' levels, deg 3
MG_GRAPH_LAUNCHES = 10  # 20 (a): graph launches timed back to back
MG_GRAPH_CELLS = ("sinx_brick_l5_deg3_mg", "sinx_brick_l5to6_deg3_mg")
MG_GRAPH_SEED = 2147483020  # 20 (c): the cells' job seed
# 20 (c): the driver calls whose peaks are read, by phase
MG_GRAPH_PHASES = (("mesh", "build_mesh"), ("pc", "_build_pc"),
                   ("solve", "_solve_pc"), ("amr", "amr_step_hp"))


def _gib(n):
    return n / 2**30


def _event_ms(torch, fn):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def mg_graph_calls(torch, level):
    """20 (a): the preconditioner's calls at `level`, each against an
    eager cycle; returns the numbers of the line."""
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.solvers import multigrid as MG

    mesh, pc = mg_epoch(level, 3)
    hier = pc.state
    gen = torch.Generator(device="cuda").manual_seed(2000 + level)
    rs = [torch.randn((mesh.n_elements, 4, 4, 4), dtype=torch.float64,
                      device="cuda", generator=gen) for _ in range(4)]

    def eager(r):
        return MG.v_cycle(hier, apply_sipg, r, torch.zeros_like(r))

    M = MG.mg_preconditioner(hier, apply_sipg)
    walls, outs = [], []
    for r in rs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(M(r))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    check(M.graph is not None, f"20 (a): no graph at level {level}")
    gap = max(float((o - eager(r)).abs().max()) for o, r in zip(outs, rs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M(rs[0])
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    device = _event_ms(torch, lambda: M(rs[1]))
    launches = _wall_ms(torch, lambda: M(rs[2]), MG_GRAPH_LAUNCHES)
    eager_ms = _wall_ms(torch, lambda: eager(rs[3]), 3)
    M.release()
    return dict(levels=hier.n_levels, walls=walls, gap=gap, enqueue=enqueue,
                device=device, launches=launches, eager=eager_ms)


def mg_graph_solve(torch, level):
    """20 (b): the FCG-MG solve of the sinx rhs at `level`, graph off
    then on; returns {mode: (info, x, peak bytes, bytes left allocated
    by the solve beside its answer)}."""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.solvers import multigrid as MG

    mesh, pc = mg_epoch(level, 3)
    rhs = driver.build_rhs_with_strong_bc(
        mesh, mesh.init_field(SinxProblem.rhs),
        mesh.boundary_values(SinxProblem.boundary))
    out = {}
    for mode in ("eager", "graph"):
        M = MG.mg_preconditioner(pc.state, apply_sipg,
                                 eager=mode == "eager")
        x0 = torch.zeros_like(rhs)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        info, x = driver._solve_pc(mesh, rhs, x0, hp=False,
                                   pc=pc._replace(M=M))
        check(M.graph is None and M.b is None,
              f"20 (b): the graph outlived the solve at level {level}")
        left = torch.cuda.memory_allocated() - before - x.numel() * 8
        out[mode] = (info, x, torch.cuda.max_memory_allocated(), left)
    return out


def mg_graph_cell(torch, name, eager):
    """20 (c): one run of cell `name`'s job after its warm-up run, graph
    off (`eager`) or on: (wall s, {phase: peak bytes}, bytes allocated
    before the run)."""
    import functools

    from benchmark import harness
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.solvers import multigrid as MG

    cell, config = harness.load_cell(name)
    job = harness.Job(cell, config, MG_GRAPH_SEED, "cuda")
    saved = {attr: getattr(driver, attr)
             for attr in [a for _, a in MG_GRAPH_PHASES]
             + ["mg_preconditioner"]}
    peaks = dict.fromkeys([p for p, _ in MG_GRAPH_PHASES] + ["rest"], 0)

    def rest():
        torch.cuda.synchronize()
        peaks["rest"] = max(peaks["rest"], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def wrapped(phase, fn):
        def call(*args, **kwargs):
            rest()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                peaks[phase] = max(peaks[phase],
                                   torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
        return call

    driver.mg_preconditioner = functools.partial(MG.mg_preconditioner,
                                                 eager=eager)
    try:
        job(0)
        for phase, attr in MG_GRAPH_PHASES:
            setattr(driver, attr, wrapped(phase, saved[attr]))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        job(1)
        wall = time.perf_counter() - t0
        rest()
    finally:
        for attr, fn in saved.items():
            setattr(driver, attr, fn)
    return wall, peaks, base


def phase_mg_graph(torch, np, card):
    """Phase 20: the V-cycle as a CUDA graph against the eager cycle, its
    walls, and the peak memory by phase of the multigrid cells' runs."""
    print(f"[20] the V-cycle as a CUDA graph on {card}")
    t_phase = time.perf_counter()
    for level in MG_GRAPH_LEVELS:
        a = mg_graph_calls(torch, level)
        walls = ", ".join(f"{w:.2f}" for w in a["walls"])
        print(f"[20] (a) level {level} ({a['levels']} levels): calls "
              f"eager, capture, launch, launch {walls} ms (wall to a "
              f"synchronize); max |graph - eager| {a['gap']:.3e}; a "
              f"launch's enqueue {a['enqueue']:.3f} ms, device "
              f"{a['device']:.3f} ms (CUDA events); {MG_GRAPH_LAUNCHES} "
              f"launches back to back {a['launches']:.3f} ms each; eager "
              f"cycles {a['eager']:.3f} ms each", flush=True)
        check(a["gap"] == 0.0,
              f"20 (a): the graph's cycle differs at level {level}: {a}")
        b = mg_graph_solve(torch, level)
        (ie, xe, pe, le), (ig, xg, pg, lg) = b["eager"], b["graph"]
        gap = float((xg - xe).abs().max())
        print(f"[20] (b) level {level} FCG-MG: steps eager {ie.iterations}, "
              f"graph {ig.iterations}; max |x_graph - x_eager| {gap:.3e}; "
              f"solve {ie.seconds:.3f} s eager, {ig.seconds:.3f} s graph; "
              f"peak {_gib(pe):.4f} / {_gib(pg):.4f} GiB, bytes left "
              f"allocated beside the answer {le} / {lg}", flush=True)
        check(ie.iterations == ig.iterations and gap == 0.0,
              f"20 (b): the graphed solve differs at level {level}")
        check(lg <= max(le, 0),
              f"20 (b): the graphed solve left {lg} bytes at level {level}")
        torch.cuda.empty_cache()
    for name in MG_GRAPH_CELLS:
        for eager in (True, False):
            wall, peaks, base = mg_graph_cell(torch, name, eager)
            parts = ", ".join(f"{k} {_gib(v):.4f}" for k, v in peaks.items())
            print(f"[20] (c) {name}, graph {'off' if eager else 'on'}: run "
                  f"{wall:.3f} s; peak GiB by phase: {parts}; allocated "
                  f"before the run {_gib(base):.4f} GiB", flush=True)
            torch.cuda.empty_cache()
    print(f"[20] phase wall {time.perf_counter() - t_phase:.1f} s")


def main():
    import numpy as np
    import torch

    t_smoke = time.perf_counter()

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
    mass_abs, mass = phase_mass(torch, np, card)
    tool_launches, tool_launches_bf16 = phase_tools(torch)
    phase_amr(torch, np, card, level5_l2, b1[(3, 5)]["ms"])
    phase_curved(torch, np, card)
    tp11 = phase_nonlinear(torch, np, card)
    schwarz_b = phase_precond(torch, np, card, fcg5, tp11)
    phase_geometry(torch, np, card, schwarz_b)
    phase_io(torch, np, card)
    phase_dist(torch, np, card)
    bf16_abs, bf16, bf16_launches = phase_bf16(torch, np, card)
    phase_oracles(torch, np, card)
    phase_mg_reference(torch, np, card)
    phase_mg_graph(torch, np, card)

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
    # the bf16 kernels: B1's launches at deg 3 / level 5 are those of the
    # bf16 mixed solve (phase 16 (c)), the rest the tools' (phase 8); the
    # f32 kernels' times of the same run beside them (`f32_ms`)
    b1_bf16_runs = {(7, 4): tool_launches_bf16[("structured", 7, 4)],
                    (3, 5): bf16_launches}
    for deg, level in TIMED_CASES:
        size = f"deg {deg} / level {level}"
        kernels.append(dict(
            name=f"structured_apply bf16 ({size})", route="cuda",
            source=csrc + "structured_apply.cu",
            replaces="disco4est_tpu/laplacian/structured.py:190",
            launches=b1_bf16_runs[(deg, level)], max_abs_err=bf16_abs["B1"],
            library_ms=None, **bf16[(deg, level)]["B1"]))
        kernels.append(dict(
            name=f"fused_apply bf16 ({size})", route="cuda",
            source=csrc + "fused_apply.cu",
            replaces="disco4est_tpu/laplacian/pallas_sipg.py:131",
            launches=tool_launches_bf16[("fused", deg, level)],
            max_abs_err=bf16_abs["B2"], library_ms=None,
            **bf16[(deg, level)]["B2"]))
    kernels += [
        dict(name="axis_apply", route="cuda",
             source=csrc + "axis_apply.cu",
             replaces="tools/exp_kernel_design.py:176",
             launches=tool_launches["axis"], max_abs_err=b3_abs, **b3),
        dict(name="mass_apply (deg 2 / level 5, f64, L2-cold)",
             route="cuda", source=csrc + "mass_apply.cu",
             replaces="none (disco4est_tpu/laplacian/nonlinear.py:47 is "
             "plain jnp)", max_abs_err=mass_abs, **mass),
    ]
    print(f"smoke wall {time.perf_counter() - t_smoke:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


def main_nccl(n):
    """`python3 chip_smoke.py --nccl=N` on a machine with N cards: phase
    15 (b)'s CLI runs on N ranks, one a card (`backend = auto` takes
    NCCL), against the one-process runs and the JAX pins; the last line as
    `main`'s."""
    import tempfile

    import torch

    from disco4est_tpu_torch.parallel import comm as C

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    check(torch.cuda.device_count() >= n,
          f"--nccl={n} needs {n} cards, {torch.cuda.device_count()} visible")
    name, card = phase_device(torch)
    ctx = _world1_context(torch)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            dist_cli(torch, tmp, ctx, runs=[(x, n) for x, _ in DIST_RUNS])
    finally:
        C.shutdown()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1].startswith("--nccl="):
        main_nccl(int(sys.argv[1].split("=", 1)[1]))
    else:
        main()
