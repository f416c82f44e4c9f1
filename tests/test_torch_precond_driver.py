"""The port's preconditioned driver paths == the JAX driver's (f64, CPU).

The pins are the JAX driver's on the CPU, printed by
`refcheck/precond_smoke_pins.py` (its `t_*` runs; the JAX package is not
rerun here): the norm line's L2, the Krylov iterations of each solve and
the forest digest of each level.

- `run_poisson` through the CLI with `pc_type = multigrid | cheby |
  schwarz` on a level-2 brick at deg 2: the L2 to 1e-10 relative, the
  FCG / CG iteration counts within 1 of JAX's (each solve ends as ‖r‖
  crosses the absolute floor 5e-15; the port's bottom solve runs on the
  assembled coarsest operator, whose rounding moved one crossing: 11
  against JAX's 12 on the hp run's first level);
- the `[multigrid]` plugins in the reference's vocabulary:
  schwarz_overlap / reuse_smoother, cheby / cheby, the block Schwarz
  smoother / cg, and none / cheby on one element;
- hp smooth_pred from level 1 with multigrid: the forests, L2 errors and
  counts of every level, the mixed-degree epochs on the hp V-cycle;
- `run_nonlinear` on the CDS regression's level 2 with each `pc_type`
  (Newton-MG: the frozen-u0 blocks restricted through the hierarchy):
  L2 to 2e-12 absolute (the Newton stop at ‖F‖ ≤ 1e-12 leaves ~1e-12 in
  u), the Newton and Krylov counts of every step equal to JAX's (CDS with
  ψ_analytic boundary data, ROADMAP C11), but for the last step under the
  Chebyshev preconditioner, which stops on the forcing term and moves
  with rounding (within 2 iterations, the test says why);
- the refusals: `[parallelism]` with a preconditioner names A15, an
  unknown smoother or bottom solver raises the JAX driver's `ValueError`
  (`subdomain_chunk > 0`, the K-slot variant, runs since ROADMAP A13b:
  `tests/test_torch_kslot.py`).
"""

import contextlib
import io
import sys
import pathlib

import pytest
import torch

from disco4est_tpu_torch import __main__ as cli
from disco4est_tpu_torch import driver
from disco4est_tpu_torch.problems.poisson import SinxProblem
from disco4est_tpu_torch.util.config import Options

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "refcheck"))
import precond_smoke_pins as pins  # noqa: E402  (the options' one source)

REL = 1e-10  # linear: both solves reach the f64 residual floor
CDS_L2_ABS = 2e-12  # Newton stops at ‖F‖ ≤ 1e-12, leaving ~1e-12 in u
#                     (`chip_smoke.py` phase 11's bound)
# `python refcheck/precond_smoke_pins.py t_mg ...` (JAX, CPU): per level
# (elements, DOF, L2, Krylov iterations, forest digest)
PINS = {
    "t_mg": [(64, 1728, 0.0019464036376921129, [17], "8885996e5b8fc009")],
    "t_cheby": [(64, 1728, 0.001946403637692116, [28], "8885996e5b8fc009")],
    "t_schwarz": [(64, 1728, 0.0019464036376921087, [59],
                   "8885996e5b8fc009")],
    "mg_so_reuse": [(64, 1728, 0.0019464036376919606, [14],
                     "8885996e5b8fc009")],
    "mg_none_cheby": [(1, 64, 0.015802814670054347, [4],
                       "2c34ce1df23b838c")],
    "mg_cheby_cheby": [(64, 1728, 0.00194640363769212, [16],
                        "8885996e5b8fc009")],
    "mg_block": [(64, 1728, 0.0019464036376921168, [14],
                  "8885996e5b8fc009")],
    "t_hp": [(8, 216, 0.015208529424303232, [12], "5a2b755557e762e5"),
             (64, 1728, 0.0019464036376921228, [17], "8885996e5b8fc009"),
             (64, 4096, 0.0009024578431378963, [16], "8885996e5b8fc009"),
             (64, 4096, 0.00022956125480725245, [18], "8885996e5b8fc009")],
    "t_cds_mg": [(64, 1728, 9.607862114538983e-06, [2, 4, 5],
                  "8885996e5b8fc009")],
    "t_cds_cheby": [(64, 1728, 9.607862112258612e-06, [4, 7, 10],
                     "8885996e5b8fc009")],
    "t_cds_schwarz": [(64, 1728, 9.607862107099042e-06, [6, 14, 13],
                       "8885996e5b8fc009")],
}
PATHS = {"t_mg": "fcg-mg", "t_cheby": "cg-cheby", "t_schwarz": "fcg-schwarz",
         "mg_so_reuse": "fcg-mg", "mg_none_cheby": "fcg-mg",
         "mg_cheby_cheby": "fcg-mg", "mg_block": "fcg-mg"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(forest):
    return pins.forest_digest(forest)


def _run_cli(key, problem):
    """The CLI on the run's options; returns its lines and the driver's
    result (captured from `run_poisson` / `run_nonlinear`)."""
    text, _ = pins.options(key)
    results, forests = [], []
    name = "run_nonlinear" if problem != "sinx" else "run_poisson"
    run = getattr(cli, name)
    build = driver.build_mesh

    def capture(*a, **kw):
        results.append(run(*a, **kw))
        return results[-1]

    def recording_build(geom, forest, *a, **kw):
        forests.append(_digest(forest))
        return build(geom, forest, *a, **kw)

    setattr(cli, name, capture)
    driver.build_mesh = recording_build
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            code = cli.main([text, f"--problem={problem}", "--device=cpu"])
    finally:
        setattr(cli, name, run)
        driver.build_mesh = build
    assert code == 0
    return buf.getvalue().splitlines(), results[0], forests


def _check_levels(key, result, forests, counts, tol, slack=0):
    pin = PINS[key]
    assert len(result.norms.rows) == len(pin) == len(forests)
    for k, (row, p, digest) in enumerate(zip(result.norms.rows, pin,
                                             forests)):
        assert (row["num_quadrants"], row["num_nodes"], digest) == (
            p[0], p[1], p[4]), k
        assert abs(row["L_2"] - p[2]) <= tol(p[2]), (k, row["L_2"], p[2])
        assert len(counts[k]) == len(p[3]) and all(
            abs(a - b) <= slack for a, b in zip(counts[k], p[3])), (
            k, counts[k], p[3])


@pytest.mark.parametrize("key", ["t_mg", "t_cheby", "t_schwarz",
                                 "mg_so_reuse", "mg_none_cheby",
                                 "mg_cheby_cheby", "mg_block"])
def test_linear_pc_types_match_jax(key):
    lines, result, forests = _run_cli(key, "sinx")
    info = result.solves[0]
    assert info.path == PATHS[key] and not info.fallback
    assert info.residual_norm <= 5e-15
    assert f"path={PATHS[key]} " in lines[1] and " setup=" in lines[1]
    _check_levels(key, result, forests, [[s.iterations]
                                         for s in result.solves],
                  lambda v: REL * v, slack=1)


def test_hp_smooth_pred_with_multigrid_matches_jax():
    """The mixed-degree epochs take the hp V-cycle (`fcg-mg-hp`, levels on
    the min-degree rule) and JAX's counts."""
    from disco4est_tpu_torch.solvers.multigrid import MGHierarchy

    lines, result, forests = _run_cli("t_hp", "sinx")
    assert [s.path for s in result.solves] == ["fcg-mg", "fcg-mg",
                                               "fcg-mg-hp", "fcg-mg-hp"]
    assert isinstance(result.precond, MGHierarchy) and result.precond.hp
    _check_levels("t_hp", result, forests, [[s.iterations]
                                            for s in result.solves],
                  lambda v: REL * v, slack=1)


@pytest.mark.parametrize("key", ["t_cds_mg", "t_cds_cheby",
                                 "t_cds_schwarz"])
def test_nonlinear_pc_types_match_jax(key):
    """Each Jacobian solve stops on the Newton forcing term (rtol 1e-3 in
    the last step, at ‖F‖ ~ 4e-10), so rounding can move its count: with
    the Chebyshev polynomial preconditioner (10 Lanczos steps may
    underestimate λmax, and the polynomial then loses definiteness above
    it) the last step took 8 CG iterations against JAX's 10; its first
    two steps and every other run match JAX's counts."""
    lines, result, forests = _run_cli(key, "cds")
    info = result.solves[0]
    assert info.iterations == 3 and info.residual_norm <= 1e-12
    counts = [s.krylov for s in result.solves]
    if key == "t_cds_cheby":
        assert counts[0][:2] == PINS[key][0][3][:2]
        assert abs(counts[0][2] - PINS[key][0][3][2]) <= 2
        counts = [PINS[key][0][3]]
    _check_levels(key, result, forests, counts, lambda v: CDS_L2_ABS)


def _linear_opts(edit):
    text, _ = pins.options("t_mg")
    return Options.load(text.replace(*edit))


@pytest.mark.parametrize("pc", ["multigrid", "schwarz", "cheby"])
def test_parallelism_with_a_preconditioner_names_a15(pc):
    """No silent drop to one device (ROADMAP C6)."""
    opts = _linear_opts(("pc_type = multigrid",
                         f"pc_type = {pc}\n[parallelism]\nenable = 1"))
    with pytest.raises(NotImplementedError, match="A15"):
        driver.run_poisson(opts, SinxProblem, device="cpu")


@pytest.mark.parametrize("edit,what", [
    (("smoother_name = mg_smoother_cheby", "smoother_name = jacobi"),
     "smoother 'jacobi'"),
    (("bottom_solver_name = mg_bottom_solver_cg",
      "bottom_solver_name = mg_bottom_solver_lu"),
     "bottom solver 'mg_bottom_solver_lu'"),
])
def test_unknown_plugin_raises_like_jax(edit, what):
    from disco4est_tpu.driver import mg_plugin_names as jax_names
    from disco4est_tpu.util.config import Options as JOptions

    text, _ = pins.options("t_mg")
    with pytest.raises(ValueError, match=what) as jerr:
        jax_names(JOptions.load(text.replace(*edit)))
    with pytest.raises(ValueError) as terr:
        driver.run_poisson(_linear_opts(edit), SinxProblem, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_newton_mg_level_operators_carry_the_robin_data():
    """ROADMAP C13: the JAX driver's Newton-MG V-cycle runs `apply_sipg`
    (Dirichlet penalty on the outer sphere) on every level while the
    TwoPunctures Jacobian has Robin data there; its FCG then diverges
    (‖r‖ 0.044 → 0.095 in 400 iterations of the first Jacobian solve,
    JAX on the CPU, level 1).  The port's levels take the problem's
    linear part with each level's Robin coefficient: with the same
    Chebyshev bottom the solve reaches the Newton forcing term (rtol 0.2)
    in 19 iterations, against 58 on Dirichlet levels.  The 7-element
    coarsest level is indefinite with the Robin data (hence the Chebyshev
    bottom here and in `chip_smoke.py` phase 12)."""
    from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
    from disco4est_tpu_torch.laplacian.nonlinear import assemble_fof_blocks
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.problems import two_punctures as tp
    from disco4est_tpu_torch.solvers import multigrid as mg
    from disco4est_tpu_torch.solvers.fcg import fcg_solve

    geom = CubedSphereGeometry("7tree", R0=10.0, R1=1000.0,
                               compactify_inner_shell=True)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 1), deg=2,
                      deg_quad=3, device="cpu")
    problem = driver.TwoPuncturesProblem()
    rc = problem.robin_coeff_values(mesh)
    u0 = mesh.init_field(problem.initial_guess)
    F = problem.residual(mesh, u0, rc)
    J = lambda v: tp.jacobian_apply(mesh, u0, v, problem.params, rc)
    iters = {}
    for robin in (True, False):
        h = mg.build_hierarchy(mesh, mg.MGParams(bottom="cheby"))
        mg.set_matrix_operator(h, assemble_fof_blocks(mesh, u0,
                                                      problem.dfof()))
        op = (driver._level_operators(problem, h, rc) if robin
              else apply_sipg)
        mg.mg_setup(h, op, driver._sin3_seed)
        res = fcg_solve(J, -F, M=mg.mg_preconditioner(h, op), atol=0.0,
                        rtol=0.2, max_iter=100)
        iters[robin] = res.iterations
    assert iters[True] < 30 and iters[False] > 2 * iters[True], iters
