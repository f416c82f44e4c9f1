"""The port's CUDA kernels against their plain PyTorch versions, on a card.

- B1, the structured apply (`csrc/structured_apply.cu`), and B2, the
  gathered fused apply (`csrc/fused_apply.cu`), split-TF32 products on the
  tensor cores: against the plain version and the f64 apply, to 5e-6
  relative (max |Δ| / max |ref|), the f32 bound of
  `tests/test_structured.py` and `tests/test_pallas_sipg.py`, at every
  degree 1-7, on nblk-3 bricks and at ragged element counts (24, 65);
  and they leave the TF32 flag of `torch.matmul` as they found it;
- B3, the three-axis apply (`csrc/axis_apply.cu`): against its plain
  version to 1e-5 relative (f32 rounding over three 8-term sums, summed
  in another order);
- the AMR loop on the card: a one-step uniform_h sinx run from level 3 at
  deg 3 launches B1 in both epochs, and its L2 errors equal the same
  run's on the CPU to 1e-9 relative (both solves reach the f64 floor; the
  L2 is 6.2e-7 and 1.6e-8).
- the curved path on the card: the mixed-curved solve of a 7-tree sphere
  at level 2 equals the CPU run's L2 to 1e-9 relative, and the f32
  tree-structured apply of a compactified 13-tree sphere equals the f64
  general apply to 1e-5 relative;
- C10 on the card: two f32 tree-structured applies, two generic f32
  applies on an adapted sphere and two estimates of one input are equal
  bit for bit;
- the nonlinear path on the card: the CDS regression's level-2 Newton
  solve equals the CPU run's counts and L2;
- the preconditioners on the card (fixed-order sums, no `index_add`): two
  V-cycles (h and hp hierarchies) and two overlapping Schwarz applies of
  one input are equal bit for bit, and a `pc_type = multigrid` sinx solve
  equals the CPU run's L2 to 1e-9 relative;
- the 2D disk and the K-slot Schwarz on the card: a level-3 disk solve
  (`mixed-curved` on the card) equals the CPU run's L2 to 1e-9 relative,
  and a K-slot apply equals the CPU's to 1e-12 relative and the
  materialized one bit for bit, and is bit-equal when repeated.

Needs a CUDA device and `nvcc`; every test skips without a device (the
kernels have no CPU mode).  This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernel.py --noconftest -q

"""

import dataclasses

import numpy as np
import pytest
import torch

from disco4est_tpu_torch.geometry.brick import BrickGeometry
from disco4est_tpu_torch.laplacian import fused
from disco4est_tpu_torch.laplacian import structured as S
from disco4est_tpu_torch.laplacian.fast import _apply_orth
from disco4est_tpu_torch.mesh.builder import build_mesh
from disco4est_tpu_torch.mesh.tree import Forest
from disco4est_tpu_torch.tools import exp_kernel_design as X

REL_TOL = 5e-6
AXIS_TOL = 1e-5
CASES = [(1, 2, (1.0, 1.0, 1.0)), (2, 1, (1.0, 1.0, 1.0)),
         (3, 2, (1.0, 1.0, 1.0)), (5, 2, (1.0, 1.0, 1.0)),
         (7, 2, (1.0, 1.0, 1.0)), (2, 1, (1.0, 2.0, 4.0)),
         (4, 2, (2.0, 1.0, 1.0)), (3, 5, (1.0, 1.0, 1.0)),
         # nblk 3 where a warpgroup's columns come in two sub-blocks (deg
         # 5) and where two warpgroups split the columns (deg 6, 7)
         (5, 1, (1.0, 2.0, 4.0)), (6, 1, (2.0, 1.0, 1.0)),
         (7, 1, (1.0, 2.0, 4.0))]
# B2: (deg, level, x1, trees per axis); multi-tree bricks are not in lex
# order, and E = 24 and 72 leave a ragged last tile of 64 elements
FUSED_CASES = [(2, 1, (1.0, 1.0, 1.0), (1, 1, 1)),
               (3, 1, (1.0, 1.0, 1.0), (1, 1, 1)),
               (7, 1, (1.0, 1.0, 1.0), (1, 1, 1)),
               (3, 1, (2.0, 1.0, 0.5), (1, 1, 1)),
               (7, 2, (1.0, 1.0, 1.0), (1, 1, 1)),
               (2, 2, (2.0, 2.0, 2.0), (2, 2, 2)),
               (3, 1, (3.0, 1.0, 1.0), (3, 1, 1)),
               (2, 1, (3.0, 3.0, 1.0), (3, 3, 1)),
               (7, 1, (1.0, 2.0, 4.0), (1, 1, 1))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mesh(deg, level, x1, device, trees=(1, 1, 1)):
    geom = BrickGeometry(x1=x1, n_trees_per_dim=trees, dim=3)
    return build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                      device=device)


def _brick(deg, level, x1, device):
    mesh = _mesh(deg, level, x1, device)
    return mesh, S.build_structured(mesh)


def _rel(a, ref):
    return float((a.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("deg,level,x1", CASES)
def test_kernel_matches_plain_and_f64(cuda_device, deg, level, x1):
    mesh, sb = _brick(deg, level, x1, cuda_device)
    E = mesh.n_elements
    u = torch.as_tensor(
        np.random.default_rng(deg).standard_normal((E, sb.nv)),
        dtype=torch.float32, device=cuda_device,
    )
    before = S.KERNEL_LAUNCHES
    out = S.apply_structured(sb, u)
    torch.cuda.synchronize()
    assert S.KERNEL_LAUNCHES == before + 1
    assert _rel(out, S.apply_structured_plain(sb, u)) <= REL_TOL
    ref64 = S.to_lex(sb, _apply_orth(
        mesh, S.from_lex(sb, u.double()).reshape((E,) + (deg + 1,) * 3)
    ).reshape(E, -1))
    assert _rel(out, ref64) <= REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("deg", range(1, 8))
def test_both_kernels_every_degree(cuda_device, deg):
    """Each (nl, nblk = 1) instance of the shared tile code, through both
    neighbor policies, on the unit cube at level 1 (E = 8)."""
    mesh = _mesh(deg, 1, (1.0, 1.0, 1.0), cuda_device)
    _check_both(mesh, deg)


def _check_both(mesh, deg, structured=True):
    E = mesh.n_elements
    shape = (E,) + (deg + 1,) * 3
    u = torch.as_tensor(np.random.default_rng(E + deg).standard_normal(shape),
                        dtype=torch.float32, device=mesh.device)
    ref64 = _apply_orth(mesh, u.double())
    fm = fused.build_fused(mesh)
    u2 = u.reshape(E, -1)
    tr = fused.scaled_traces(u2, fm.W_tr, fm.drstn).contiguous()
    out = fused.fused_apply_cuda(fm, u2, tr)
    assert _rel(out, fused.fused_apply_plain(fm, u2, tr)) <= REL_TOL
    assert _rel(fused.apply_sipg_fused(mesh, u), ref64) <= REL_TOL
    if structured:
        sb = S.build_structured(mesh)
        u_lex = S.to_lex(sb, u2)
        out = S.apply_structured(sb, u_lex)
        assert _rel(out, S.apply_structured_plain(sb, u_lex)) <= REL_TOL
        assert _rel(S.from_lex(sb, out), ref64.reshape(E, -1)) <= REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("deg", [2, 7])
@pytest.mark.parametrize("trees", [(3, 1, 1), (65, 1, 1)])
def test_both_kernels_ragged_element_count(cuda_device, deg, trees):
    """E = 24 and E = 65: a ragged last element tile (64 or 128 elements a
    tile); the 65-tree brick also has tree ids past 15."""
    level = 1 if trees == (3, 1, 1) else 0
    mesh = _mesh(deg, level, tuple(float(t) for t in trees), cuda_device,
                 trees)
    assert mesh.n_elements in (24, 65)
    _check_both(mesh, deg)


@pytest.mark.gpu
def test_kernels_leave_the_tf32_flag_alone(cuda_device):
    """The split-TF32 products are the kernels' own: neither wrapper reads
    or sets `torch.backends.cuda.matmul.allow_tf32`."""
    mesh = _mesh(3, 1, (1.0, 1.0, 1.0), cuda_device)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (False, True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            fm = fused.build_fused(mesh)
            u = torch.ones((mesh.n_elements, fm.nv), device=cuda_device)
            fused.apply_fused(fm, u)
            sb = S.build_structured(mesh)
            S.apply_structured(sb, u)
            torch.cuda.synchronize()
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
def test_kernel_wrapper_checks_its_inputs(cuda_device):
    _, sb = _brick(2, 1, (1.0, 1.0, 1.0), cuda_device)
    u = torch.zeros((sb.n_elements, sb.nv), device=cuda_device)
    tr = S.compute_traces_lex(sb, u)
    with pytest.raises(ValueError, match="float32"):
        S.lex_apply_cuda(sb, u.double(), tr)
    with pytest.raises(ValueError, match="contiguous"):
        S.lex_apply_cuda(sb, u, tr.t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        S.lex_apply_cuda(sb, u[:-1].contiguous(), tr)


@pytest.mark.gpu
@pytest.mark.parametrize("deg,level,x1,trees", FUSED_CASES)
def test_fused_kernel_matches_plain_and_f64(cuda_device, deg, level, x1,
                                            trees):
    mesh = _mesh(deg, level, x1, cuda_device, trees)
    fm = fused.build_fused(mesh)
    E = mesh.n_elements
    u = torch.as_tensor(
        np.random.default_rng(deg).standard_normal((E,) + (deg + 1,) * 3),
        dtype=torch.float32, device=cuda_device,
    )
    before = fused.KERNEL_LAUNCHES
    out = fused.apply_sipg_fused(mesh, u)
    torch.cuda.synchronize()
    assert fused.KERNEL_LAUNCHES == before + 1
    assert out.shape == u.shape and out.dtype == torch.float32
    u2 = u.reshape(E, -1)
    plain = fused.fused_apply_plain(
        fm, u2, fused.scaled_traces(u2, fm.W_tr, fm.drstn))
    assert _rel(out.reshape(E, -1), plain) <= REL_TOL
    assert _rel(out, _apply_orth(mesh, u.double())) <= REL_TOL


@pytest.mark.gpu
def test_fused_wrapper_checks_its_inputs(cuda_device):
    fm = fused.build_fused(_mesh(2, 1, (1.0, 1.0, 1.0), cuda_device))
    u = torch.zeros((fm.n_elements, fm.nv), device=cuda_device)
    tr = fused.scaled_traces(u, fm.W_tr, fm.drstn)
    with pytest.raises(ValueError, match="float32"):
        fused.fused_apply_cuda(fm, u.double(), tr)
    with pytest.raises(ValueError, match="shape"):
        fused.fused_apply_cuda(fm, u[:-1].contiguous(), tr)
    with pytest.raises(ValueError, match="int32"):
        fused.fused_apply_cuda(
            dataclasses.replace(fm, nbr_row=fm.nbr_row.long()), u, tr)


@pytest.mark.gpu
@pytest.mark.parametrize("E", [1, 5, 4096])
def test_axis_kernel_matches_plain(cuda_device, E):
    rng = np.random.default_rng(E)
    u = torch.as_tensor(rng.standard_normal((E, 8, 8, 8)),
                        dtype=torch.float32, device=cuda_device)
    m = torch.as_tensor(rng.standard_normal((8, 8)), dtype=torch.float32,
                        device=cuda_device)
    before = X.KERNEL_LAUNCHES
    out = X.axis_apply(u, m)
    torch.cuda.synchronize()
    assert X.KERNEL_LAUNCHES == before + 1
    assert _rel(out, X.axis_apply_plain(u, m)) <= AXIS_TOL
    with pytest.raises(ValueError, match="shape"):
        X.axis_apply_cuda(u[..., :4].contiguous(), m)


AMR_OPTIONS = """
[initial_mesh]
min_level = 3
region0_deg = 3
[amr]
scheme = uniform_h
num_of_amr_steps = 1
[geometry]
name = brick
[d4est_solver_krylov_petsc]
ksp_type = fcg
"""


@pytest.mark.gpu
def test_uniform_h_amr_launches_b1_every_epoch(cuda_device):
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.util.config import Options

    starts = []
    build = driver.build_mesh

    def counting(*args, **kw):
        starts.append(S.KERNEL_LAUNCHES)
        return build(*args, **kw)

    driver.build_mesh = counting
    try:
        card = driver.run_poisson(Options.load(AMR_OPTIONS), SinxProblem,
                                  device="cuda")
        launches = S.KERNEL_LAUNCHES
    finally:
        driver.build_mesh = build
    cpu = driver.run_poisson(Options.load(AMR_OPTIONS), SinxProblem,
                             device="cpu")
    per_epoch = np.diff(starts + [launches])
    assert len(per_epoch) == 2 and (per_epoch > 0).all(), per_epoch
    assert [s.path for s in card.solves] == ["mixed-structured"] * 2
    assert [r["num_quadrants"] for r in card.norms.rows] == [512, 4096]
    for a, b in zip(card.norms.rows, cpu.norms.rows):
        assert abs(a["L_2"] - b["L_2"]) <= 1e-9 * b["L_2"], (a, b)


# the curved path on the card (torch operations, no hand-written kernel):
# a one-level sinx run on the 7-tree sphere at level 2, deg 2, with the
# pointwise penalty of the reference's sphere configurations
SPHERE_OPTIONS = """
[initial_mesh]
min_level = 2
region0_deg = 2
[mesh_parameters]
face_h_type = FACE_H_EQ_J_DIV_SJ_QUAD
[amr]
scheme = uniform_h
num_of_amr_steps = 0
[geometry]
name = cubed_sphere_7tree
r0 = 1.0
r1 = 2.0
[d4est_solver_krylov_petsc]
ksp_type = fcg
use_structured = 1
"""


@pytest.mark.gpu
def test_curved_mixed_solve_on_the_card_matches_the_cpu(cuda_device):
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.util.config import Options

    opts = Options.load(SPHERE_OPTIONS)
    card = driver.run_poisson(opts, SinxProblem, device="cuda")
    cpu = driver.run_poisson(opts, SinxProblem, device="cpu")
    for res in (card, cpu):
        assert [s.path for s in res.solves] == ["mixed-curved"]
        assert not res.solves[0].fallback
    assert card.norms.rows[0]["num_quadrants"] == 448
    a, b = card.norms.rows[0]["L_2"], cpu.norms.rows[0]["L_2"]
    assert abs(a - b) <= 1e-9 * b, (a, b)


@pytest.mark.gpu
def test_tree_structured_apply_on_the_card_matches_general(cuda_device):
    from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
    from disco4est_tpu_torch.laplacian import curved
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg

    geom = CubedSphereGeometry("13tree", R0=10.0, R1=20.0, R2=1000.0,
                               compactify_outer_shell=True)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 2), deg=3,
                      face_h_type="j_div_sj_quad", device=cuda_device)
    ts = curved.build_tree_structured(mesh)
    lex32 = curved.permute_mesh_lex(ts, mesh).astype(torch.float32)
    u = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (mesh.n_elements, 4, 4, 4)), device=cuda_device)
    ref = apply_sipg(mesh, u)
    got = curved.from_lex(ts, curved.apply_tree_structured(
        ts.astype(torch.float32), lex32, curved.to_lex(ts, u.float())))
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-5


@pytest.mark.gpu
def test_curved_sums_are_repeatable_on_the_card(cuda_device):
    """ROADMAP C10: the crossing faces of the tree-structured apply, the
    mortar rows of the general apply and the estimator's mortar terms sum
    in a fixed order, so two calls on one input are equal bit for bit."""
    from disco4est_tpu_torch.estimators.bi import estimate_bi
    from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
    from disco4est_tpu_torch.laplacian import curved
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg

    geom = CubedSphereGeometry("7tree", R0=1.0, R1=2.0)
    forest = Forest.uniform(geom.conn, 2)
    mesh = build_mesh(geom, forest, deg=3, face_h_type="j_div_sj_quad",
                      device=cuda_device)
    ts = curved.build_tree_structured(mesh)
    ts32 = ts.astype(torch.float32)
    lex32 = curved.permute_mesh_lex(ts, mesh).astype(torch.float32)
    u = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (mesh.n_elements, 4, 4, 4)), dtype=torch.float32,
        device=cuda_device)
    assert torch.equal(curved.apply_tree_structured(ts32, lex32, u),
                       curved.apply_tree_structured(ts32, lex32, u))

    flags = np.zeros(forest.n_elements, bool)
    flags[::7] = True
    mesh = build_mesh(geom, forest.refine(flags).balance(), deg=2,
                      face_h_type="j_div_sj_quad", device=cuda_device)
    assert mesh.hc_elem.shape[0] > 0
    mesh32 = mesh.astype(torch.float32)
    u = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (mesh.n_elements, 3, 3, 3)), device=cuda_device)
    assert torch.equal(apply_sipg(mesh32, u.float()),
                       apply_sipg(mesh32, u.float()))
    res = 1e-3 * u.flip(0)
    assert torch.equal(estimate_bi(mesh, u, res), estimate_bi(mesh, u, res))


@pytest.mark.gpu
def test_nonlinear_cds_on_the_card_matches_the_cpu(cuda_device):
    """The CDS regression's first level (brick, level 2, deg 2, Newton
    with CG) on the card equals the CPU run: the same Newton and Krylov
    counts, L2 to 1e-9 relative."""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.util.config import Options

    text = """
[initial_mesh]
min_level = 2
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
    runs = [driver.run_nonlinear(Options.load(text),
                                 driver.CDSProblem(Options.load(text)),
                                 device=d) for d in ("cuda", "cpu")]
    card, cpu = runs
    assert card.solves[0].iterations == cpu.solves[0].iterations == 3
    assert card.solves[0].krylov == cpu.solves[0].krylov
    a, b = card.norms.rows[0]["L_2"], cpu.norms.rows[0]["L_2"]
    assert abs(a - b) <= 1e-9 * b, (a, b)
    assert abs(a - 9.607862111733e-06) <= 1e-8 * 9.607862111733e-06


def _sin_seed(m):
    return m.init_field(lambda *c: sum(torch.sin(3 * x) for x in c))


@pytest.mark.gpu
def test_preconditioners_repeat_bit_for_bit_on_the_card(cuda_device):
    """Two V-cycles (an h and an hp hierarchy) and two overlapping Schwarz
    applies of one input are equal bit for bit on the card: the coarse
    sums and the Schwarz combine run in a fixed slot order."""
    from disco4est_tpu_torch.laplacian.hp import apply_sipg_hp, own_mask
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.solvers import multigrid as mg
    from disco4est_tpu_torch.solvers.schwarz_overlap import (
        build_overlapping_schwarz,
    )

    geom = BrickGeometry(dim=3)
    forest = Forest.uniform(geom.conn, 2)
    flags = np.zeros(forest.n_elements, bool)
    flags[:8] = True
    hanging = forest.refine(flags).balance()
    deg_e = np.where(np.arange(hanging.n_elements) % 3 == 0, 3, 2)
    for mesh, op in (
        (build_mesh(geom, forest, deg=3, device="cuda"), apply_sipg),
        (build_mesh(geom, hanging, deg=3, deg_e=deg_e, device="cuda"),
         apply_sipg_hp),
    ):
        h = mg.build_hierarchy(mesh)
        mg.mg_setup(h, op, _sin_seed)
        r = torch.randn((mesh.n_elements, 4, 4, 4), dtype=torch.float64,
                        device="cuda", generator=torch.Generator(
                            "cuda").manual_seed(0)) * own_mask(mesh)
        zero = torch.zeros_like(r)
        assert torch.equal(mg.v_cycle(h, op, r, zero),
                           mg.v_cycle(h, op, r, zero))
    M = build_overlapping_schwarz(mesh, num_nodes_overlap=1, iterations=15)
    assert torch.equal(M(r), M(r))


@pytest.mark.gpu
def test_multigrid_solve_on_the_card_matches_the_cpu(cuda_device):
    """sinx at level 3, deg 3, `pc_type = multigrid` (FCG with one V-cycle)
    on the card equals the CPU run: the same FCG count, L2 to 1e-9.  (At
    deg 2 from level 3 the 10-step Lanczos λmax falls 10 % short, the
    Chebyshev smoother amplifies the top modes and the count moves with
    rounding: 131 on the card against 114 on the CPU.)"""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.util.config import Options

    text = """
[initial_mesh]
min_level = 3
region0_deg = 3
[amr]
scheme = uniform_h
[geometry]
name = brick
[d4est_solver_krylov_petsc]
ksp_type = fcg
pc_type = multigrid
"""
    card, cpu = (driver.run_poisson(Options.load(text), SinxProblem,
                                    device=d) for d in ("cuda", "cpu"))
    assert card.solves[0].path == cpu.solves[0].path == "fcg-mg"
    assert card.solves[0].iterations == cpu.solves[0].iterations
    a, b = card.norms.rows[0]["L_2"], cpu.norms.rows[0]["L_2"]
    assert abs(a - b) <= 1e-9 * b, (a, b)


DISK_OPTIONS = """
[initial_mesh]
min_level = 3
region0_deg = 3
[mesh_parameters]
face_h_type = FACE_H_EQ_J_DIV_SJ_QUAD
[amr]
scheme = uniform_h
num_of_amr_steps = 0
[geometry]
name = disk
[d4est_solver_krylov_petsc]
ksp_type = fcg
"""


@pytest.mark.gpu
def test_disk_solve_on_the_card_matches_the_cpu(cuda_device):
    """sinx on the level-3 disk (2D, 320 elements, deg 3): on the card the
    uniform epoch takes the tree-structured `mixed-curved` solve
    (`use_structured = auto`), on the CPU the generic `mixed` one; both
    reach the f64 floor and their L2 errors agree to 1e-9 relative."""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.util.config import Options

    opts = Options.load(DISK_OPTIONS)
    card = driver.run_poisson(opts, SinxProblem, device="cuda")
    cpu = driver.run_poisson(opts, SinxProblem, device="cpu")
    assert card.solves[0].path == "mixed-curved"
    assert cpu.solves[0].path == "mixed"
    assert not card.solves[0].fallback and not cpu.solves[0].fallback
    assert card.norms.rows[0]["num_quadrants"] == 320
    a, b = card.norms.rows[0]["L_2"], cpu.norms.rows[0]["L_2"]
    assert abs(a - b) <= 1e-9 * b, (a, b)


@pytest.mark.gpu
def test_kslot_schwarz_on_the_card_matches_the_cpu(cuda_device):
    """The K-slot Schwarz on a hanging brick (mortar rows across
    chunk-local slots): the card's apply equals the CPU's to 1e-12
    relative and the materialized apply on the card bit for bit (both
    sum the subdomain dots as one pairwise tree and the corrections slot
    by slot in one order); two applies on the card are equal bit for
    bit."""
    from disco4est_tpu_torch.solvers.schwarz_overlap import (
        build_overlapping_schwarz,
        build_overlapping_schwarz_kslot,
    )

    geom = BrickGeometry(dim=3)
    forest = Forest.uniform(geom.conn, 2)
    flags = np.zeros(forest.n_elements, bool)
    flags[:8] = True
    forest = forest.refine(flags).balance()
    r = np.random.default_rng(5).standard_normal(
        (forest.n_elements, 4, 4, 4))
    out = {}
    for dev in ("cpu", "cuda"):
        mesh = build_mesh(geom, forest, deg=3, device=dev)
        M = build_overlapping_schwarz_kslot(mesh, num_nodes_overlap=1,
                                            iterations=8, chunk=16)
        rt = torch.as_tensor(r, device=dev)
        out[dev] = M(rt)
        if dev == "cuda":
            assert torch.equal(out[dev], M(rt))
            mat = build_overlapping_schwarz(mesh, num_nodes_overlap=1,
                                            iterations=8)(rt)
            assert torch.equal(mat, out[dev])
    a, b = out["cuda"].cpu(), out["cpu"]
    assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
