"""The port's IO modules == the JAX package's (f64, CPU, one intra-op
thread):

- `Forest.checksum` (`mesh/tree.py`): equal to JAX's on a uniform brick, a
  refined-and-balanced brick, a 2D brick and the 7-tree sphere;
- `io/checkpoint.py`: `tests/test_io.py`'s round trip and corruption cases
  through the port, and the file format shared both ways: a checkpoint
  the JAX package writes loads in the port (forest, fields, history, extra
  and checksum equal) and one the port writes loads in the JAX package;
- `io/vtk.py`: `tests/test_io.py`'s writer case, and the port's text equal
  to the JAX writer's for the same mesh and fields (brick, hanging brick,
  2D);
- `io/ip_energy_norm.py`: each term within 1e-12 relative of JAX's on
  `tests/test_diagnostics.py:71`'s hanging mesh and on a pointwise-penalty
  mesh, plus that test's own checks;
- `laplacian/penalty_debug.py`: `penalty_report` equal to JAX's, scalar and
  pointwise (`tests/test_disk_and_tools.py:53`), with that test's checks;
- `util/logging.py` (`tests/test_disk_and_tools.py:119`), the CLI's
  `[logging] log_dir` and the checkpoint plotter (`:86`) through the
  port's CLI with `--device=cpu`;
- `elliptic/problem.py`.

Every test leaves the `disco4est` loggers as it found them.
"""

import contextlib
import io
import logging
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.geometry.brick import BrickGeometry as JBrick
from disco4est_tpu.io import checkpoint as jckpt
from disco4est_tpu.io.vtk import write_vtu as jwrite
from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch import __main__ as cli
from disco4est_tpu_torch.amr.amr import refine_and_balance
from disco4est_tpu_torch.geometry.brick import BrickGeometry as TBrick
from disco4est_tpu_torch.io import checkpoint as tckpt
from disco4est_tpu_torch.io.ip_energy_norm import ip_energy_norm_sqr
from disco4est_tpu_torch.io.vtk import write_vtu as twrite
from disco4est_tpu_torch.laplacian.penalty_debug import (
    penalty_report,
    print_penalty_report,
)
from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest
from disco4est_tpu_torch.util import logging as tlog

from torch_threads import torch_worker_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-12


@contextlib.contextmanager
def _loggers_restored():
    """Put every `disco4est` logger's handlers, level and propagation and
    the port module's state back as they were."""
    names = ["disco4est"] + [n for n in logging.Logger.manager.loggerDict
                             if n.startswith("disco4est.")]
    saved = {n: (list(logging.getLogger(n).handlers),
                 logging.getLogger(n).level, logging.getLogger(n).propagate)
             for n in names}
    state = (tlog._CONFIGURED, tlog._LOG_DIR)
    try:
        yield
    finally:
        for n, log in list(logging.Logger.manager.loggerDict.items()):
            if (n == "disco4est" or n.startswith("disco4est.")) and \
                    isinstance(log, logging.Logger):
                for h in list(log.handlers):
                    if h not in saved.get(n, ([], 0, True))[0]:
                        log.removeHandler(h)
                        h.close()
        for n, (handlers, level, prop) in saved.items():
            log = logging.getLogger(n)
            log.handlers[:] = handlers
            log.setLevel(level)
            log.propagate = prop
        tlog._CONFIGURED, tlog._LOG_DIR = state


def _forests(name):
    """The same leaves as a JAX and a port forest."""
    if name == "sphere7":
        from disco4est_tpu.geometry.cubed_sphere import (
            CubedSphereGeometry as JSphere,
        )
        from disco4est_tpu_torch.geometry.cubed_sphere import (
            CubedSphereGeometry as TSphere,
        )

        jg, tg = JSphere("7tree", R0=1.0, R1=2.0), TSphere("7tree", R0=1.0,
                                                             R1=2.0)
        return JForest.uniform(jg.conn, 1), TForest.uniform(tg.conn, 1)
    dim = 2 if name == "brick2d" else 3
    jg, tg = JBrick(dim=dim), TBrick(dim=dim)
    level = 2 if name == "brick2d" else 1
    jf, tf = JForest.uniform(jg.conn, level), TForest.uniform(tg.conn, level)
    if name == "refined":
        flags = np.zeros(tf.n_elements, bool)
        flags[[0, 5]] = True
        tf = refine_and_balance(tf, flags)
        # refine one level-2 leaf again: balance then splits the level-1
        # leaves around it
        flags = np.zeros(tf.n_elements, bool)
        flags[7] = True
        tf = refine_and_balance(tf, flags)
        jf = JForest(jg.conn, tf.tree.copy(), tf.level.copy(),
                     tf.anchor.copy())
    return jf, tf


@pytest.mark.parametrize("name", ["uniform", "refined", "brick2d",
                                  "sphere7"])
def test_checksum_equals_jax(name):
    jf, tf = _forests(name)
    assert np.array_equal(jf.tree, tf.tree)
    assert np.array_equal(jf.level, tf.level)
    assert np.array_equal(jf.anchor, tf.anchor)
    assert tf.checksum() == jf.checksum()
    if name == "refined":
        assert set(np.unique(tf.level)) == {2, 3}


def test_checkpoint_roundtrip(tmp_path):
    """`tests/test_io.py:19` through the port: save, load, checksum and
    history replay."""
    geom = TBrick(dim=3)
    forest = TForest.uniform(geom.conn, 1)
    flags = np.zeros(forest.n_elements, bool)
    flags[0] = True
    forest2 = refine_and_balance(forest, flags)
    mesh = tbuild(geom, forest2, deg=2, device="cpu")
    u = mesh.init_field(lambda x, y, z: x * y + z)

    path = str(tmp_path / "chk")
    history = [np.where(flags, -2, 2)]
    tckpt.save(path, forest2, {"u": u}, deg=2, amr_history=history,
               extra={"amr_step": 1})
    f2, fields, deg, hist, extra = tckpt.load(path, geom.conn, device="cpu")
    assert f2.n_elements == forest2.n_elements
    assert f2.checksum() == forest2.checksum()
    assert deg == 2
    assert fields["u"].dtype == torch.float64
    assert torch.equal(fields["u"], u)
    assert extra["amr_step"] == 1
    replayed = tckpt.replay_amr_history(forest, hist)
    assert replayed.checksum() == forest2.checksum()
    with pytest.raises(ValueError, match="history entry length"):
        tckpt.replay_amr_history(forest2, hist)


def test_checkpoint_detects_corruption(tmp_path):
    """`tests/test_io.py:45` through the port."""
    geom = TBrick(dim=2)
    forest = TForest.uniform(geom.conn, 1)
    path = str(tmp_path / "chk")
    tckpt.save(path, forest, {}, deg=1)
    data = dict(np.load(path + ".npz"))
    data["level"] = data["level"].copy()
    data["level"][0] += 1
    np.savez(path + ".npz", **data)
    with pytest.raises(ValueError, match="checksum"):
        tckpt.load(path, geom.conn, device="cpu")


def _payload(tf, rng):
    u = rng.standard_normal((tf.n_elements, 3, 3, 3))
    hist = [rng.integers(-3, 4, 8), rng.integers(-3, 4, 15)]
    extra = {"level": 2, "deg_e": [2] * tf.n_elements,
             "predictor": rng.standard_normal(tf.n_elements).tolist()}
    return u, hist, extra


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """The `.npz` format is shared: the keys, dtypes, history, extra and
    checksum of a file written by one package load equal in the other."""
    jf, tf = _forests("refined")
    u, hist, extra = _payload(tf, np.random.default_rng(3))
    path = str(tmp_path / "ck")
    if writer == "jax":
        jckpt.save(path, jf, {"u": u}, deg=2, amr_history=hist, extra=extra)
    else:
        tckpt.save(path, tf, {"u": torch.as_tensor(u)}, deg=2,
                   amr_history=hist, extra=extra)
    data = np.load(path + ".npz")
    assert {k: data[k].dtype.str for k in data.files} == {
        "tree": "<i4", "level": "|i1", "anchor": "<i4", "deg": "<i8",
        "checksum": "<i8", "n_elements": "<i8", "field_u": "<f8",
        "amr_history_lens": "<i8", "amr_history": "<i8",
        "extra_json": "|u1"}
    jout = jckpt.load(path, jf.conn)
    tout = tckpt.load(path, tf.conn, device="cpu")
    assert jout[0].checksum() == tout[0].checksum() == jf.checksum()
    assert np.array_equal(jout[0].anchor, tout[0].anchor)
    assert np.array_equal(jout[1]["u"], u)
    assert np.array_equal(tout[1]["u"].numpy(), u)
    assert jout[2] == tout[2] == 2
    assert len(jout[3]) == len(tout[3]) == 2
    for a, b, h in zip(jout[3], tout[3], hist):
        assert np.array_equal(a, h) and np.array_equal(b, h)
    assert jout[4] == tout[4] == extra


def test_vtk_writer(tmp_path):
    """`tests/test_io.py:59` through the port."""
    geom = TBrick(dim=3)
    mesh = tbuild(geom, TForest.uniform(geom.conn, 1), deg=2, device="cpu")
    u = mesh.init_field(lambda x, y, z: x + y + z)
    path = str(tmp_path / "out.vtu")
    twrite(path, mesh, point_fields={"u": u},
           cell_fields={"eta2": np.arange(mesh.n_elements)})
    text = open(path).read()
    assert "UnstructuredGrid" in text
    assert 'Name="u"' in text
    assert 'Name="eta2"' in text
    assert text.count("VTKFile") == 2
    assert f'NumberOfCells="{mesh.n_elements * 8}"' in text


def _hanging(pkg, dim=3, deg=2, **kw):
    geom = (JBrick if pkg == "jax" else TBrick)(dim=dim)
    forest = (JForest if pkg == "jax" else TForest).uniform(geom.conn, 1)
    flags = np.zeros(forest.n_elements, bool)
    flags[0] = True
    forest = forest.refine(flags).balance()
    if pkg == "jax":
        return jbuild(geom, forest, deg=deg, **kw)
    return tbuild(geom, forest, deg=deg, device="cpu", **kw)


@pytest.fixture(scope="module")
def mesh_pairs():
    """(JAX mesh, port mesh) of the same leaves and options."""
    out = {}
    for key, dim, deg, kw in (
        ("hanging3", 3, 3, {}),
        ("hanging2", 3, 2, dict(penalty_prefactor=2.0)),
        ("pointwise2", 3, 2, dict(penalty_prefactor=2.0,
                                  face_h_type="j_div_sj_quad")),
        ("hanging2d", 2, 3, {}),
    ):
        out[key] = (_hanging("jax", dim, deg, **kw),
                    _hanging("port", dim, deg, **kw))
    jg, tg = JBrick(dim=3), TBrick(dim=3)
    out["brick"] = (jbuild(jg, JForest.uniform(jg.conn, 1), deg=2),
                    tbuild(tg, TForest.uniform(tg.conn, 1), deg=2,
                           device="cpu"))
    return out


@pytest.mark.parametrize("key", ["brick", "hanging3", "hanging2d"])
def test_vtu_text_equals_jax(tmp_path, mesh_pairs, key):
    jm, tm = mesh_pairs[key]
    rng = np.random.default_rng(7)
    u = rng.standard_normal((tm.n_elements,) + (tm.nl,) * tm.dim)
    eta = rng.random(tm.n_elements)
    jwrite(str(tmp_path / "j.vtu"), jm, point_fields={"u": u},
           cell_fields={"eta2": eta})
    twrite(str(tmp_path / "t.vtu"), tm,
           point_fields={"u": torch.as_tensor(u)}, cell_fields={"eta2": eta})
    jt = (tmp_path / "j.vtu").read_text()
    tt = (tmp_path / "t.vtu").read_text()
    n_cells = tm.n_elements * (tm.nl - 1) ** tm.dim
    assert f'NumberOfCells="{n_cells}"' in tt
    assert tt == jt


@pytest.mark.parametrize("key", ["hanging3", "pointwise2"])
def test_ip_energy_norm_matches_jax(mesh_pairs, key):
    from disco4est_tpu.io.ip_energy_norm import ip_energy_norm_sqr as jip

    jm, tm = mesh_pairs[key]
    rng = np.random.default_rng(11)
    w = rng.standard_normal((tm.n_elements,) + (tm.nl,) * 3)
    g = rng.standard_normal((tm.n_elements, 6) + (tm.nl,) * 2)
    if key == "pointwise2":
        assert tm.sigma_q is not None and tm.hc_sigma_q is not None
    assert tm.hc_elem.shape[0] > 0
    ref = jip(jm, jnp.asarray(w), jnp.asarray(g))
    got = ip_energy_norm_sqr(tm, torch.as_tensor(w), torch.as_tensor(g))
    for term in ("volume", "interface", "boundary", "total"):
        r = float(ref[term])
        assert abs(float(got[term]) - r) <= TOL * abs(r), (term, r)


def test_ip_energy_norm_checks(mesh_pairs):
    """`tests/test_diagnostics.py:71`'s checks through the port."""
    tm = mesh_pairs["hanging3"][1]
    pi = np.pi
    u = tm.init_field(lambda x, y, z: torch.sin(pi * x) * torch.sin(pi * y)
                      * torch.sin(pi * z))
    r = ip_energy_norm_sqr(tm, u)
    exact = 3 * pi**2 / 8
    assert abs(float(r["volume"]) - exact) < 2e-3 * exact
    assert float(r["interface"]) < 1e-3 * float(r["volume"])
    assert float(r["total"]) >= float(r["volume"])
    w = torch.as_tensor(np.random.default_rng(1).standard_normal(u.shape))
    r2 = ip_energy_norm_sqr(tm, w)
    assert float(r2["interface"]) > 1e-2
    assert float(r2["boundary"]) > 1e-2


@pytest.mark.parametrize("key", ["hanging2", "pointwise2"])
def test_penalty_report_matches_jax(mesh_pairs, key, capsys):
    """`tests/test_disk_and_tools.py:53` through the port, each statistic
    within 1e-12 relative of JAX's `penalty_report`."""
    from disco4est_tpu.laplacian.penalty_debug import penalty_report as jrep

    jm, tm = mesh_pairs[key]
    ref = jrep(jm)
    rep = print_penalty_report(tm) if key == "hanging2" else \
        penalty_report(tm)
    assert rep["pointwise"] == ref["pointwise"] == (key == "pointwise2")
    for cls in ("interior", "boundary", "mortar"):
        assert rep[cls]["count"] == ref[cls]["count"] > 0
        for stat in ("min", "max", "mean"):
            assert abs(rep[cls][stat] - ref[cls][stat]) <= \
                TOL * abs(ref[cls][stat]), (cls, stat)
    if key == "hanging2":
        assert 15.9 < rep["interior"]["min"] < rep["mortar"]["max"] < 32.1
        assert capsys.readouterr().out.count("[PENALTY_DEBUGGER]") == 3


def test_category_logging(tmp_path):
    """`tests/test_disk_and_tools.py:119` through the port."""
    with _loggers_restored():
        tlog.init_logging(log_dir=str(tmp_path), console=False)
        tlog.get_category("d4est_solver_cg").info("iter %d r2 %.3e", 3,
                                                  1.5e-9)
        tlog.get_category("d4est_amr").warning("marked %d elements", 42)
        tlog.get_category("custom_cat").info("on-demand category")
        for h in logging.getLogger("disco4est").handlers:
            h.flush()
        combined = (tmp_path / "run.log").read_text()
        assert "iter 3 r2 1.500e-09" in combined
        assert "marked 42 elements" in combined
        assert "iter 3" in (tmp_path / "d4est_solver_cg.log").read_text()
        assert "marked 42" in (tmp_path / "d4est_amr.log").read_text()
        assert "on-demand" in (tmp_path / "custom_cat.log").read_text()
        # reconfigure without a log_dir: console only, and the category
        # file handlers of the old directory are gone
        tlog.init_logging(None, console=False)
        tlog.get_category("d4est_norms").info("no file handlers now")
        assert not any(logging.getLogger(f"disco4est.{c}").handlers
                       for c in tlog.CATEGORIES + ("custom_cat",))
        assert "no file handlers" not in (
            tmp_path / "d4est_norms.log").read_text()


CLI_OPTIONS = """[geometry]
name = brick
[initial_mesh]
min_level = 1
region0_deg = 2
[amr]
scheme = smooth_pred
num_of_amr_steps = 1
[mesh_parameters]
max_degree = 3
"""


def test_cli_log_dir_routes_norm_lines(tmp_path):
    """`[logging] log_dir` (JAX `__main__.py:100-106`, `:133-137`): the
    norm lines land in `d4est_norms.log` and on stdout."""
    text = CLI_OPTIONS + f"[logging]\nlog_dir = {tmp_path / 'logs'}\n"
    buf = io.StringIO()
    with _loggers_restored(), contextlib.redirect_stdout(buf):
        assert cli.main([text, "--problem=sinx", "--device=cpu"]) == 0
        for h in logging.getLogger("disco4est.d4est_norms").handlers:
            h.flush()
    lines = buf.getvalue().splitlines()[:2]
    norms = (tmp_path / "logs" / "d4est_norms.log").read_text()
    assert len(lines) == 2 and all(len(x.split()) == 4 for x in lines)
    for line in lines:
        assert line in norms
    assert (tmp_path / "logs" / "run.log").exists()


def test_checkpoint_plotter_cli(tmp_path):
    """`tests/test_disk_and_tools.py:86` through the port's CLI with
    `--device=cpu`: a run with checkpoints, then the plotter."""
    opts_path = tmp_path / "opts.input"
    ck = tmp_path / "ck"
    opts_path.write_text(CLI_OPTIONS + f"[checkpoint]\nprefix = {ck}\n")
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
    r = subprocess.run(
        [sys.executable, "-m", "disco4est_tpu_torch", str(opts_path),
         "--problem=sinx", "--device=cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    out = tmp_path / "plot.vtu"
    r2 = subprocess.run(
        [sys.executable, "-m", "disco4est_tpu_torch", str(opts_path),
         f"--plot-checkpoint={ck}_level1", f"--output={out}",
         "--device=cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    txt = out.read_text()
    assert "<VTKFile" in txt and 'Name="u"' in txt
    assert 'Name="level"' in txt and 'Name="deg"' in txt
    assert "fields ['u'" in r2.stdout


def test_elliptic_problem_interface():
    from disco4est_tpu_torch.elliptic import EllipticProblem
    from disco4est_tpu_torch.elliptic.problem import LinearProblem

    A = lambda v: 2.0 * v
    rhs = torch.ones(3)
    p = LinearProblem(A, rhs)
    assert isinstance(p, EllipticProblem)
    u = torch.tensor([1.0, 2.0, 3.0])
    assert torch.equal(p.apply_lhs(None, u), 2.0 * u)
    assert torch.equal(p.build_residual(None, u), 2.0 * u - rhs)
    with pytest.raises(NotImplementedError):
        EllipticProblem().apply_lhs(None, u)
