"""Port driver and CLI == the JAX driver on the reference's sinx options.

The L2 error of the solved field is compared with the JAX driver's to
1e-12 absolute, the bound `tests/test_driver.py:59` uses: both solves run
to the f64 residual floor (atol 5e-15), far below that bound.  The AMR
loops are held to the JAX driver level by level: uniform_h and uniform_p
to the same element counts, DOF and norm lines and the L2 to 1e-12;
smooth_pred to identical forests and per-element degrees, the L2 and the
estimator to 1e-10 relative (ROADMAP A7, A9).
"""

import ast
import contextlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from disco4est_tpu_torch import __main__ as cli
from disco4est_tpu_torch.driver import run_poisson
from disco4est_tpu_torch.problems.poisson import LorentzianProblem, SinxProblem
from disco4est_tpu_torch.util.config import Options

ROOT = pathlib.Path(__file__).resolve().parents[1]
SINX_LINE = "64 512 512 0.02441355792354"
SINX_L2 = 0.024413557923538  # JAX driver, `tests/test_driver.py:59`
DEG7_L2 = 4.952468593343e-09  # JAX CLI on the CPU, deg 7, level 1

SINX_OPTIONS = """
[initial_mesh]
min_level = 2
region0_deg = 1
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

[quadrature]
name = legendre
"""


def _with(extra_solver="", text=SINX_OPTIONS):
    return text.replace("ksp_atol = 5e-15",
                        "ksp_atol = 5e-15\n" + extra_solver)


@pytest.fixture(scope="module")
def jax_sinx_l2():
    from disco4est_tpu.driver import run_poisson as jrun
    from disco4est_tpu.problems.poisson import SinxProblem as JSinx
    from disco4est_tpu.util.config import Options as JOptions

    return jrun(JOptions.load(SINX_OPTIONS), JSinx).norms.rows[0]["L_2"]


@pytest.mark.parametrize("use_structured,path", [
    ("auto", "mixed"), ("1", "mixed-structured"),
])
def test_sinx_matches_jax_driver(jax_sinx_l2, use_structured, path):
    opts = Options.load(_with(f"use_structured = {use_structured}"))
    result = run_poisson(opts, SinxProblem, device="cpu")
    assert result.norms.lines("L_2") == [SINX_LINE]
    err = result.norms.rows[0]["L_2"]
    assert abs(err - jax_sinx_l2) < 1e-12, (err, jax_sinx_l2)
    assert abs(err - SINX_L2) < 1e-12
    info = result.solves[0]
    assert info.path == path and not info.fallback
    assert info.residual_norm < 5e-15
    assert result.u.dtype == torch.float64


@pytest.mark.parametrize("ksp", ["cg", "fcg"])
def test_sinx_plain_f64_solvers(ksp):
    text = _with("use_mixed_precision = 0").replace(
        "ksp_type = fcg", f"ksp_type = {ksp}")
    result = run_poisson(Options.load(text), SinxProblem, device="cpu")
    assert result.solves[0].path == ksp
    assert abs(result.norms.rows[0]["L_2"] - SINX_L2) < 1e-12


def test_sinx_deg7_level1_matches_jax():
    text = SINX_OPTIONS.replace("min_level = 2", "min_level = 1").replace(
        "region0_deg = 1", "region0_deg = 7")
    result = run_poisson(Options.load(text), SinxProblem, device="cpu")
    assert result.norms.lines("L_2")[0].startswith("8 4096 4096 ")
    assert abs(result.norms.rows[0]["L_2"] - DEG7_L2) < 1e-12


def test_lorentzian_on_brick_matches_jax():
    from disco4est_tpu.driver import run_poisson as jrun
    from disco4est_tpu.problems.poisson import LorentzianProblem as JLor
    from disco4est_tpu.util.config import Options as JOptions

    text = SINX_OPTIONS.replace("min_level = 2", "min_level = 1").replace(
        "region0_deg = 1", "region0_deg = 2").replace("X0 = 0.0", "X0 = 0.5")
    ref = jrun(JOptions.load(text), JLor).norms.rows[0]["L_2"]
    got = run_poisson(Options.load(text), LorentzianProblem, device="cpu")
    assert abs(got.norms.rows[0]["L_2"] - ref) < 1e-12


def test_cli_module_subprocess(tmp_path):
    path = tmp_path / "options.input"
    path.write_text(SINX_OPTIONS)
    proc = subprocess.run(
        [sys.executable, "-m", "disco4est_tpu_torch", str(path),
         "--problem=sinx", "--device=cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == SINX_LINE
    assert lines[1].startswith("solve level 0: path=mixed ")
    assert "fallback=no" in lines[1]


UNIFORM_H = SINX_OPTIONS.replace("scheme = uniform_p", "scheme = uniform_h") \
    .replace("num_of_amr_steps = 0", "num_of_amr_steps = 2") \
    .replace("min_level = 2", "min_level = 0") \
    .replace("region0_deg = 1", "region0_deg = 2")
UNIFORM_P = SINX_OPTIONS.replace("num_of_amr_steps = 0",
                                 "num_of_amr_steps = 2") \
    .replace("min_level = 2", "min_level = 1") \
    .replace("max_degree = 7", "max_degree = 3")
# `tests/test_driver.py:62-84`
SMOOTH_PRED = """
[initial_mesh]
min_level = 1
region0_deg = 2

[flux]
sipg_penalty_prefactor = 2.0
sipg_penalty_fcn = maxp_sqr_over_minh

[amr]
scheme = smooth_pred
num_of_amr_steps = 2
gamma_h = 10.0
gamma_p = 0.1
gamma_n = 1.
percentile = 25

[geometry]
name = brick

[quadrature]
name = legendre
"""
# `tests/test_hp.py:189-206`: p-refinement, mixed degrees, hanging faces
SMOOTH_PRED_HP = """
[geometry]
name = brick
[initial_mesh]
min_level = 1
region0_deg = 2
[mesh_parameters]
max_degree = 4
[amr]
scheme = smooth_pred
num_of_amr_steps = 3
percentile = 25.0
gamma_h = 10.0
gamma_p = 0.1
gamma_n = 1.0
[flux]
sipg_penalty_prefactor = 2.0
"""
AMR_RUNS = {"uniform_h": UNIFORM_H, "uniform_p": UNIFORM_P,
            "smooth_pred": SMOOTH_PRED, "smooth_pred_hp": SMOOTH_PRED_HP}


@contextlib.contextmanager
def _recording_epochs(driver_module):
    """Record (tree, level, anchor, deg_e) of every epoch the driver builds
    a mesh for."""
    epochs = []
    build = driver_module.build_mesh

    def recording(geom, forest, **kw):
        epochs.append((forest.tree.copy(), forest.level.copy(),
                       forest.anchor.copy(), np.asarray(kw["deg_e"]).copy()))
        return build(geom, forest, **kw)

    driver_module.build_mesh = recording
    try:
        yield epochs
    finally:
        driver_module.build_mesh = build


def _port_run(text, **kw):
    from disco4est_tpu_torch import driver

    with _recording_epochs(driver) as epochs:
        result = run_poisson(Options.load(text), SinxProblem, device="cpu",
                             **kw)
    return result, epochs


@pytest.fixture(scope="module")
def jax_amr_runs():
    from disco4est_tpu import driver as jdriver
    from disco4est_tpu.problems.poisson import SinxProblem as JSinx
    from disco4est_tpu.util.config import Options as JOptions

    out = {}
    for name, text in AMR_RUNS.items():
        with _recording_epochs(jdriver) as epochs:
            out[name] = (jdriver.run_poisson(JOptions.load(text), JSinx),
                         epochs)
    return out


@pytest.mark.parametrize("use_structured", ["0", "1"])
@pytest.mark.parametrize("scheme", ["uniform_h", "uniform_p"])
def test_uniform_amr_matches_jax_driver(jax_amr_runs, scheme,
                                        use_structured):
    ref, _ = jax_amr_runs[scheme]
    text = _with(f"use_structured = {use_structured}", AMR_RUNS[scheme])
    result, epochs = _port_run(text)
    assert len(result.norms.rows) == 3 == len(ref.norms.rows)
    assert result.norms.lines("L_2") == ref.norms.lines("L_2")
    for a, b in zip(result.norms.rows, ref.norms.rows):
        assert a["num_quadrants"] == b["num_quadrants"]
        assert a["num_nodes"] == b["num_nodes"]
        assert abs(a["L_2"] - b["L_2"]) < 1e-12, (a["L_2"], b["L_2"])
    assert len(result.solves) == 3
    path = "mixed-structured" if use_structured == "1" else "mixed"
    assert all(s.path == path and not s.fallback for s in result.solves)
    if scheme == "uniform_p":
        assert [e[3].max() for e in epochs] == [1, 2, 3]
    else:
        assert [len(e[0]) for e in epochs] == [1, 8, 64]


@pytest.mark.parametrize("name", ["smooth_pred", "smooth_pred_hp"])
def test_smooth_pred_matches_jax_driver(jax_amr_runs, name):
    ref, ref_epochs = jax_amr_runs[name]
    result, epochs = _port_run(AMR_RUNS[name])
    assert len(epochs) == len(ref_epochs)
    for got, want in zip(epochs, ref_epochs):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(result.norms.rows, ref.norms.rows):
        assert a["num_nodes"] == b["num_nodes"]
        assert abs(a["L_2"] - b["L_2"]) <= 1e-10 * b["L_2"]
    assert len(result.eta2_history) == len(ref.eta2_history)
    for a, b in zip(result.eta2_history, ref.eta2_history):
        assert np.max(np.abs(a - np.asarray(b))) <= 1e-10 * np.max(b)
    if name == "smooth_pred_hp":
        # p-refinement happened: the last epochs solve on mixed degrees
        assert epochs[-1][3].max() > 2
        assert result.solves[-1].path == "cg-hp"


def test_unknown_scheme_raises():
    text = SINX_OPTIONS.replace("scheme = uniform_p", "scheme = bogus")
    with pytest.raises(ValueError, match="bogus"):
        run_poisson(Options.load(text), SinxProblem, device="cpu")


def test_cli_amr_subprocess(tmp_path):
    path = tmp_path / "options.input"
    path.write_text(SMOOTH_PRED_HP.replace("num_of_amr_steps = 3",
                                           "num_of_amr_steps = 2"))
    proc = subprocess.run(
        [sys.executable, "-m", "disco4est_tpu_torch", str(path),
         "--problem=sinx", "--device=cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 7, lines
    assert [len(line.split()) for line in lines[:3]] == [4, 4, 4]
    for level in range(3):
        assert lines[3 + level].startswith(f"solve level {level}: path=")
    assert lines[6].startswith("C1 = ") and ", C2 = -" in lines[6]


def test_cli_cuda_without_card_raises(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([SINX_OPTIONS, "--device=cuda"])
    assert capsys.readouterr().out == ""


# The cubed spheres and the pointwise J_DIV_SJ_QUAD penalty (ROADMAP A11),
# the preconditioners (A13), the disk and misc geometries (A11b) and the
# K-slot Schwarz variant (A13b), which the first three cases refused in
# turn, now run: they are held to the JAX driver in
# `tests/test_torch_curved_driver.py`, `test_torch_precond_driver.py`,
# `test_torch_geometry2d.py` and `test_torch_kslot.py`.  Those cases now
# refuse options still left for A14 and A15.
@pytest.mark.parametrize("edit,item", [
    (("[quadrature]", "[initial_mesh]\nload_from_checkpoint = ck\n"
      "[quadrature]"), "A14"),
    (("[quadrature]", "[d4est_vtk]\nfilename = out\n[quadrature]"), "A14"),
    (("[quadrature]", "[parallelism]\nn_devices = 2\n[quadrature]"),
     "A15"),
    (("[quadrature]", "[parallelism]\nenable = 1\n[quadrature]"), "A15"),
    (("[quadrature]", "[checkpoint]\nprefix = ck\n[quadrature]"), "A14"),
])
def test_unported_options_raise(edit, item):
    opts = Options.load(SINX_OPTIONS.replace(*edit))
    with pytest.raises(NotImplementedError, match=item):
        run_poisson(opts, SinxProblem, device="cpu")


def test_cli_unported_problem_raises(capsys):
    """Every problem of the JAX CLI is ported now (the nonlinear ones and
    Stamm came with ROADMAP A12; `tests/test_torch_nonlinear_driver.py`
    runs them): a name outside them is refused with the list."""
    assert cli.main([SINX_OPTIONS, "--problem=bogus", "--device=cpu"]) == 1
    out = capsys.readouterr().out
    assert "unknown problem 'bogus'" in out
    for name in ("cds", "constant_density_star", "lorentzian", "okendon",
                 "sinx", "stamm", "two_punctures"):
        assert repr(name) in out


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    """Nor the repo's top-level `bench` and `tools`, which import JAX."""
    files = sorted((ROOT / "disco4est_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for part in (("tools", "time_fused.py"), ("amr", "amr.py"),
                 ("amr", "smooth_pred.py"), ("estimators", "bi.py"),
                 ("estimators", "stats.py"), ("laplacian", "hp.py"),
                 ("laplacian", "curved.py"), ("geometry", "cubed_sphere.py"),
                 ("geometry", "p8est_conn.py"),
                 ("quadrature", "compactified.py"),
                 ("laplacian", "nonlinear.py"), ("solvers", "newton.py"),
                 ("mesh", "probe.py"), ("ops", "rows.py"),
                 ("solvers", "eigs.py"), ("solvers", "cheby.py"),
                 ("solvers", "schwarz.py"), ("solvers", "multigrid.py"),
                 ("solvers", "schwarz_overlap.py"), ("solvers", "gmres.py"),
                 ("solvers", "diagnostics.py"), ("geometry", "disk.py"),
                 ("geometry", "misc.py"), ("laplacian", "derivatives.py"),
                 ("problems", "constant_density_star.py"),
                 ("problems", "okendon.py"), ("problems", "two_punctures.py"),
                 ("problems", "multi_puncture.py"),
                 ("problems", "boyen_york.py"), ("problems", "stamm.py")):
        assert ROOT.joinpath("disco4est_tpu_torch", *part) in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "disco4est_tpu", "bench",
                               "tools"), (path, mod)
