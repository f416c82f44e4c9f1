"""Checkpoint-restart, mid-solve checkpoints, VTK and timings through the
port's drivers (f64, CPU, one intra-op thread).

- `tests/test_restart.py`'s three kill-and-resume cases through the port:
  the resumed run's final u equal to the uninterrupted run's bit for bit
  (max |Δ| == 0.0), the last L2 or ‖F‖ equal, for both restore formats;
  and a restart from a mixed-degree level, which the JAX driver does not
  resume bit for bit (ROADMAP C16);
- a restart from a level checkpoint the JAX driver wrote
  (`refcheck/io_restart_pins.py`): the port's final u within 1e-10 of the
  JAX driver's;
- `tests/test_driver.py:193` (chunked CG) through the port, and chunked
  FCG with and without a preconditioner: equal to the uninterrupted solve
  bit for bit; the driver's mid-solve path (`pc_type` none and cheby)
  bit-equal to the same Krylov solve in one chunk, with one `_it<k>` file
  per chunk; the nonlinear one saves every n-th Newton iterate;
- `tests/test_driver.py:130`'s Okendon multigrid run with VTK and
  checkpoints;
- `[driver] print_timings`: one `TIMINGS` row per level, whose phases
  include amr (the JAX rows do not, ROADMAP C4); the nonlinear driver
  accepts the option and prints nothing, as JAX's.
"""

import os
import pathlib

import numpy as np
import pytest
import torch

from disco4est_tpu_torch.driver import CDSProblem, run_nonlinear, run_poisson
from disco4est_tpu_torch.io import checkpoint as tckpt
from disco4est_tpu_torch.laplacian.hp import restrict_padded
from disco4est_tpu_torch.problems.poisson import SinxProblem
from disco4est_tpu_torch.solvers.cg import cg_solve
from disco4est_tpu_torch.solvers.fcg import fcg_solve
from disco4est_tpu_torch.util.config import Options

from torch_threads import torch_worker_threads  # noqa: F401

# the options of `tests/test_restart.py` (`BASE_LINEAR`, `RESTART_EXTRA`,
# `BASE_NONLINEAR`, `NONLINEAR_RESTART`), with the step count a parameter
LINEAR = """
[initial_mesh]
min_level = 1
region0_deg = 2
{restart}
[mesh_parameters]
max_degree = 3

[flux]
sipg_penalty_prefactor = 2.0

[amr]
scheme = smooth_pred
num_of_amr_steps = {steps}
percentile = 25.0

[geometry]
name = brick
{extra}
"""
RESTART = """load_from_checkpoint = 1
checkpoint_prefix = {ck}
checkpoint_type = {ctype}
"""
NONLINEAR = """
[initial_mesh]
min_level = 1
region0_deg = 2
{restart}
[flux]
sipg_penalty_prefactor = 2.0

[amr]
scheme = smooth_pred
num_of_amr_steps = 2
percentile = 25.0
gamma_h = 0.25

[geometry]
name = brick

[d4est_solver_newton]
snes_atol = 1e-12

[d4est_solver_krylov_petsc]
ksp_type = fcg
pc_type = cheby
{extra}
"""


def _linear(steps=2, restart="", extra=""):
    return Options.load(LINEAR.format(steps=steps, restart=restart,
                                      extra=extra))


@pytest.fixture(scope="module")
def full_runs(tmp_path_factory):
    """The uninterrupted linear runs (2 and 3 smooth_pred steps) and the
    nonlinear one, with per-level checkpoints."""
    d = tmp_path_factory.mktemp("full")
    out = {}
    for steps in (2, 3):
        ck = str(d / f"lin{steps}")
        out[steps] = (ck, run_poisson(
            _linear(steps, extra=f"[checkpoint]\nprefix = {ck}"),
            SinxProblem, device="cpu"))
    ck = str(d / "cds")
    opts = Options.load(NONLINEAR.format(
        restart="", extra=f"[checkpoint]\nprefix = {ck}"))
    out["cds"] = (ck, run_nonlinear(opts, CDSProblem(opts), device="cpu"))
    return out


def _restart(ck, ctype):
    return RESTART.format(ck=ck, ctype=ctype)


@pytest.mark.parametrize("ctype", ["structure", "history"])
def test_linear_restart_bitwise(full_runs, ctype):
    """`tests/test_restart.py:65` through the port."""
    ck, full = full_runs[2]
    resumed = run_poisson(_linear(2, _restart(f"{ck}_level1", ctype)),
                          SinxProblem, device="cpu")
    assert np.array_equal(resumed.mesh.forest.tree, full.mesh.forest.tree)
    assert resumed.mesh.forest.checksum() == full.mesh.forest.checksum()
    assert float(torch.max(torch.abs(resumed.u - full.u))) == 0.0
    assert resumed.norms.rows[-1]["L_2"] == full.norms.rows[-1]["L_2"]
    # the restart level skips its solve and its restored iterate is the
    # solved one
    assert [s.path for s in resumed.solves] == ["restart", "cg-hp"]
    assert resumed.first_level == 1 and full.first_level == 0
    assert resumed.solves[0].iterations == 0
    assert resumed.solves[0].residual_norm < 1e-13
    assert resumed.norms.rows[0] == full.norms.rows[1]


@pytest.mark.parametrize("ctype", ["structure", "history"])
def test_linear_restart_from_mixed_degree_level(full_runs, ctype):
    """Restart from level 2 of the 3-step run, a mixed-degree level: the
    port resumes bit for bit because the checkpoint also holds the
    own-degree iterate `u_own`.  Restricting the storage-degree u back, as
    the JAX driver does (`driver.py:843-855`), does not give it bit for bit
    (ROADMAP C16: the JAX driver's resumed u there differs by ~2e-15)."""
    ck, full = full_runs[3]
    forest, fields, deg, _, extra = tckpt.load(f"{ck}_level2",
                                               full.mesh.forest.conn,
                                               device="cpu")
    deg_e = np.asarray(extra["deg_e"])
    assert len(set(deg_e)) > 1 and set(fields) == {"u", "u_own"}
    assert not torch.equal(restrict_padded(fields["u"], deg_e, deg, 3),
                           fields["u_own"])
    resumed = run_poisson(_linear(3, _restart(f"{ck}_level2", ctype)),
                          SinxProblem, device="cpu")
    assert float(torch.max(torch.abs(resumed.u - full.u))) == 0.0
    assert resumed.norms.rows[-1]["L_2"] == full.norms.rows[-1]["L_2"]


def test_nonlinear_preconditioned_restart_bitwise(full_runs):
    """`tests/test_restart.py:145` through the port: Newton–Krylov CDS with
    Chebyshev-preconditioned FCG, restarted by history replay."""
    ck, full = full_runs["cds"]
    opts = Options.load(NONLINEAR.format(
        restart=_restart(f"{ck}_level1", "history"), extra=""))
    resumed = run_nonlinear(opts, CDSProblem(opts), device="cpu")
    assert resumed.mesh.n_elements == full.mesh.n_elements
    assert float(torch.max(torch.abs(resumed.u - full.u))) == 0.0
    assert resumed.norms.rows[-1]["F_norm"] == full.norms.rows[-1]["F_norm"]
    assert resumed.solves[0].iterations == 0
    assert resumed.solves[0].residual_norm == full.solves[1].residual_norm


def test_restart_refuses_a_wrong_history(full_runs, tmp_path):
    ck, _ = full_runs[2]
    with pytest.raises(ValueError, match="unknown checkpoint_type"):
        run_poisson(_linear(2, _restart(f"{ck}_level1", "bogus")),
                    SinxProblem, device="cpu")
    # a replay from another initial level cannot reproduce the forest
    text = LINEAR.format(steps=2, restart=_restart(f"{ck}_level1", "history"),
                         extra="").replace("min_level = 1", "min_level = 0")
    with pytest.raises(ValueError, match="history"):
        run_poisson(Options.load(text), SinxProblem, device="cpu")


# `python refcheck/io_restart_pins.py`: the JAX driver's run of the linear
# options above (two steps) wrote `tests/data/jax_restart_level1.npz`, its
# own level-1 checkpoint, and `jax_restart_final_u.npy`, its final u
DATA = pathlib.Path(__file__).resolve().parent / "data"
JAX_FINAL_L2 = 0.0009024578431378167


def test_restart_from_a_jax_checkpoint():
    """The port resumes the JAX driver's checkpoint (forest by history
    replay, degrees and predictor from its JSON) and ends within 1e-10 of
    the JAX driver's final u."""
    resumed = run_poisson(
        _linear(2, _restart(str(DATA / "jax_restart_level1"), "history")),
        SinxProblem, device="cpu")
    ju = np.load(DATA / "jax_restart_final_u.npy")
    assert resumed.u.shape == ju.shape
    assert np.max(np.abs(resumed.u.numpy() - ju)) <= 1e-10
    assert abs(resumed.norms.rows[-1]["L_2"] - JAX_FINAL_L2) \
        <= 1e-10 * JAX_FINAL_L2
    assert [s.path for s in resumed.solves] == ["restart", "cg-hp"]


def _brick_system(level=1, deg=2):
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    geom = BrickGeometry(dim=3)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                      device="cpu")
    g = mesh.boundary_values(lambda *c: c[0] * c[1])
    f = mesh.init_field(lambda *c: 0.0 * c[0])
    return mesh, build_rhs_with_strong_bc(mesh, f, g), \
        (lambda v: apply_sipg(mesh, v))


def test_midsolve_cg_exact_resume():
    """`tests/test_driver.py:193` through the port."""
    _, rhs, A = _brick_system()
    ref = cg_solve(A, rhs, atol=1e-13, rtol=0.0, max_iter=64)
    state = None
    for cap in (16, 32, 48, 64):
        res, state = cg_solve(A, rhs, atol=1e-13, rtol=0.0, max_iter=cap,
                              resume_state=state, return_state=True)
    assert res.iterations == ref.iterations
    assert float(torch.max(torch.abs(res.x - ref.x))) == 0.0
    assert res.residual_norm == ref.residual_norm


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_midsolve_fcg_exact_resume(precond):
    """FCG's state carries the previous direction and its product: chunks
    of 7 equal the uninterrupted solve, with and without `M`."""
    mesh, rhs, A = _brick_system()
    M = None
    if precond == "jacobi":
        d = 1.0 + mesh.init_field(lambda *c: c[0] ** 2 + c[2])
        M = lambda r: r / d
    ref = fcg_solve(A, rhs, M=M, atol=1e-13, rtol=0.0, max_iter=200)
    state, cap = None, 7
    while True:
        res, state = fcg_solve(A, rhs, M=M, atol=1e-13, rtol=0.0,
                               max_iter=cap, resume_state=state,
                               return_state=True)
        if res.iterations < cap:
            break
        cap += 7
    assert res.iterations == ref.iterations > 7
    assert float(torch.max(torch.abs(res.x - ref.x))) == 0.0


@pytest.mark.parametrize("pc_type", ["none", "cheby"])
def test_driver_midsolve_bitwise(tmp_path, pc_type):
    """The driver's mid-solve path (JAX `driver.py:880-899`): every 10
    Krylov iterations a `_level<k>_it<j>` file; the u, count and L2 equal
    to the same Krylov solve run in one chunk (every_n far above the
    count); with `pc_type = cheby` the chunks run FCG."""
    base = """
[initial_mesh]
min_level = 1
region0_deg = 3
[amr]
scheme = uniform_h
num_of_amr_steps = 0
[geometry]
name = brick
[d4est_solver_krylov_petsc]
ksp_type = cg
use_mixed_precision = 0
pc_type = {pc}
[checkpoint]
prefix = {ck}
checkpoint_every_n_krylov_its = {n}
"""
    runs = {}
    for n in (10, 100000):
        ck = str(tmp_path / f"n{n}")
        runs[n] = run_poisson(Options.load(base.format(pc=pc_type, ck=ck,
                                                       n=n)),
                              SinxProblem, device="cpu")
    chunked, whole = runs[10], runs[100000]
    info = chunked.solves[0]
    assert info.path == ("cg-chunked" if pc_type == "none"
                         else "fcg-cheby-chunked")
    assert info.iterations == whole.solves[0].iterations > 20
    assert float(torch.max(torch.abs(chunked.u - whole.u))) == 0.0
    assert chunked.norms.rows[0]["L_2"] == whole.norms.rows[0]["L_2"]
    k = info.iterations
    files = sorted(f for f in os.listdir(tmp_path) if f.startswith("n10_"))
    expect = sorted({f"n10_level0_it{j}.npz"
                     for j in list(range(10, k + 1, 10)) + [k]}
                    | {"n10_level0.npz"})
    assert files == expect
    _, fields, _, _, extra = tckpt.load(str(tmp_path / f"n10_level0_it{k}"),
                                        chunked.mesh.forest.conn,
                                        device="cpu")
    assert torch.equal(fields["u"], chunked.u)
    assert extra == {"mid_solve_iteration": k}
    # the uninterrupted solve through the driver's plain path gives the
    # same digits (pc_type none: plain f64 CG)
    if pc_type == "none":
        plain = run_poisson(Options.load(
            base.format(pc="none", ck="", n=0).replace("prefix = \n", "")),
            SinxProblem, device="cpu")
        assert plain.solves[0].path == "cg"
        assert float(torch.max(torch.abs(plain.u - chunked.u))) == 0.0


def test_nonlinear_midsolve_and_newton_checkpoints(full_runs, tmp_path):
    """`checkpoint_every_n_krylov_its = 1` in the nonlinear driver: one
    `_it<k>` file per Newton iterate, and the run bit-equal to the one
    without mid-solve checkpoints."""
    _, full = full_runs["cds"]
    ck = str(tmp_path / "m")
    opts = Options.load(NONLINEAR.format(restart="", extra=(
        f"[checkpoint]\nprefix = {ck}\ncheckpoint_every_n_krylov_its = 1")))
    res = run_nonlinear(opts, CDSProblem(opts), device="cpu")
    assert float(torch.max(torch.abs(res.u - full.u))) == 0.0
    for level, info in enumerate(res.solves):
        its = sorted(int(f.split("_it")[1][:-4]) for f in os.listdir(tmp_path)
                     if f.startswith(f"m_level{level}_it"))
        assert its == list(range(1, info.iterations + 1))


OKENDON = """
[initial_mesh]
min_level = 1
region0_deg = 2

[flux]
sipg_penalty_prefactor = 2.0

[amr]
scheme = uniform_h
num_of_amr_steps = 1

[geometry]
name = brick
x0 = 0.2
y0 = 0.2
z0 = 0.2

[problem]
name = okendon
p = 0.5

[d4est_solver_krylov_petsc]
ksp_type = fcg
pc_type = multigrid

[d4est_solver_newton]
snes_atol = 1e-11
"""


def test_nonlinear_okendon_mg_vtk_and_checkpoints(tmp_path):
    """`tests/test_driver.py:130` through the port."""
    from disco4est_tpu_torch.driver import OkendonProblem
    from disco4est_tpu_torch.geometry.brick import BrickGeometry

    opts = Options.load(OKENDON + f"\n[d4est_vtk]\nfilename = {tmp_path}/ok\n"
                        + f"[checkpoint]\nprefix = {tmp_path}/ok_ckpt\n")
    result = run_nonlinear(opts, OkendonProblem(opts), device="cpu")
    errs = [r["L_2"] for r in result.norms.rows]
    assert len(errs) == 2 and errs[1] < errs[0], errs
    assert all(r["F_norm"] < 1e-10 for r in result.norms.rows)
    for name in ("ok_0.vtu", "ok_1.vtu", "ok_ckpt_level0.npz",
                 "ok_ckpt_level1.npz"):
        assert os.path.exists(tmp_path / name), name
    assert 'Name="eta2"' in (tmp_path / "ok_1.vtu").read_text()
    geom = BrickGeometry(x0=(0.2, 0.2, 0.2), dim=3)
    forest, fields, deg, hist, extra = tckpt.load(
        str(tmp_path / "ok_ckpt_level1"), geom.conn, device="cpu")
    assert fields["u"].shape[0] == forest.n_elements
    assert extra["problem"] == "okendon" and extra["level"] == 1
    assert len(hist) == 1


def test_poisson_vtk_per_level(tmp_path):
    """`[d4est_vtk] filename`: one `.vtu` per level with u, the error and
    the per-element degrees."""
    res = run_poisson(_linear(1, extra=f"[d4est_vtk]\nfilename = "
                                       f"{tmp_path}/s"),
                      SinxProblem, device="cpu")
    for k in range(2):
        text = (tmp_path / f"s_{k}.vtu").read_text()
        for name in ("u", "error", "deg", "tree", "level"):
            assert f'Name="{name}"' in text
    n_cells = res.mesh.n_elements * (res.mesh.nl - 1) ** 3
    assert f'NumberOfCells="{n_cells}"' in (tmp_path / "s_1.vtu").read_text()


def test_print_timings_rows_include_amr(capsys):
    """One `TIMINGS level k:` row per level with mesh, solve, estimate and
    amr (JAX prints its row before the amr phase, ROADMAP C4); the last
    level has no amr phase.  Timing changes no digit."""
    plain = run_poisson(_linear(2), SinxProblem, device="cpu")
    capsys.readouterr()
    timed = run_poisson(_linear(2, extra="[driver]\nprint_timings = 1"),
                        SinxProblem, device="cpu")
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("TIMINGS")]
    assert len(lines) == 3 and len(timed.timings) == 3
    for k, (line, row) in enumerate(zip(lines, timed.timings)):
        assert line.startswith(f"TIMINGS level {k}: mesh=")
        phases = {"mesh", "solve", "estimate", "amr"} if k < 2 else \
            {"mesh", "solve"}
        assert set(row) - {"level"} == phases
        assert all(f"{p}=" in line for p in phases)
    assert plain.timings == []
    assert float(torch.max(torch.abs(plain.u - timed.u))) == 0.0


def test_nonlinear_print_timings_is_silent(capsys):
    """The JAX nonlinear driver has no phase timer: the port's accepts the
    option and prints no row."""
    opts = Options.load(NONLINEAR.format(restart="", extra="").replace(
        "num_of_amr_steps = 2", "num_of_amr_steps = 0")
        + "\n[driver]\nprint_timings = 1\n")
    res = run_nonlinear(opts, CDSProblem(opts), device="cpu")
    assert "TIMINGS" not in capsys.readouterr().out
    assert res.timings == []
