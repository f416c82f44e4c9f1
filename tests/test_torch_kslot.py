"""The port's K-slot overlapping Schwarz (`solvers/schwarz_overlap.py`,
`build_overlapping_schwarz_kslot`) == the JAX package's (f64, CPU, one
intra-op thread).

- The tables `member`, `valid`, `codes`, `mask_table`, `weight_table`,
  `nbr_slot`, `bnd` and `conf` exactly equal to JAX's on a brick, a
  hanging brick and the 13-tree sphere; the hanging mortar rows grouped
  per chunk: the chunk-local slots exactly equal, and the mortar data the
  apply gathers per chunk equal to the JAX module's stored rows (index
  rows exactly, factors to 1e-13: the two builders' meshes differ in the
  last bits).
- The apply against JAX's K-slot apply to 1e-11 relative at ≤ 8
  subdomain CG iterations (past convergence the fixed-count CG drifts on
  rounding noise, `tests/test_torch_schwarz.py`), and against the port's
  materialized variant to 1e-12 (both sum each subdomain's dots as a
  fixed pairwise tree and the corrections slot by slot in one order, so
  where the library's products round alike, as on the card, they are
  equal bit for bit: `tests/test_torch_kernel.py`).
- The three `test_kslot_*` cases of `tests/test_schwarz_overlap.py:144-224`
  through the port: K-slot == materialized on a brick, a hanging brick
  and the pointwise-σ 13-tree to 1e-12, and the resident footprint below
  0.5x the base mesh's.
- On an hp mesh (mixed degrees, the hp operator) the K-slot variant
  equals the materialized one to 1e-12; repeated applies bit for bit.
- Through the driver: sinx on the level-2 brick (the CLI line
  `64 1728 1728 0.001946403637692`) and the CDS regression's level 2, each
  with `subdomain_chunk = 16`: the materialized run's Krylov counts and
  an L2 within 1e-8 relative of it (pins of
  `refcheck/precond_smoke_pins.py t_schwarz t_cds_schwarz`, the JAX
  driver's materialized runs, which the port's materialized runs match in
  `tests/test_torch_precond_driver.py`).
"""

import contextlib
import io
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu.solvers import schwarz_overlap as jso
from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest
from disco4est_tpu_torch.solvers import schwarz_overlap as tso

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "refcheck"))
import precond_smoke_pins as pins  # noqa: E402  (the options' one source)
from torch_threads import torch_worker_threads  # noqa: E402, F401

# `python refcheck/precond_smoke_pins.py t_schwarz t_cds_schwarz` (JAX,
# CPU, the materialized variant): (elements, DOF, L2, Krylov counts)
MATERIALIZED = {
    "t_schwarz": (64, 1728, 0.0019464036376921087, [59]),
    "t_cds_schwarz": (64, 1728, 9.607862107099042e-06, [6, 14, 13]),
}
TABLES = ("member", "valid", "codes", "mask_table", "weight_table",
          "nbr_slot", "bnd", "conf")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _pair(case):
    """(JAX mesh, port mesh) of a case."""
    from disco4est_tpu.geometry.brick import BrickGeometry as JB
    from disco4est_tpu.geometry.cubed_sphere import CubedSphereGeometry as JS
    from disco4est_tpu_torch.geometry.brick import BrickGeometry as TB
    from disco4est_tpu_torch.geometry.cubed_sphere import (
        CubedSphereGeometry as TS,
    )

    if case == "sphere13":
        jg = JS("13tree", R0=1.0, R1=2.0, R2=3.0)
        tg = TS("13tree", R0=1.0, R1=2.0, R2=3.0)
        kw = dict(deg=2, face_h_type="j_div_sj_quad")
        return (jbuild(jg, JForest.uniform(jg.conn, 0), **kw),
                tbuild(tg, TForest.uniform(tg.conn, 0), device="cpu", **kw))
    jg, tg = JB(dim=3), TB(dim=3)
    jf, tf = JForest.uniform(jg.conn, 1), TForest.uniform(tg.conn, 1)
    deg = 3
    if case == "hanging":
        flags = np.zeros(8, bool)
        flags[0] = True
        jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
        deg = 2
    return jbuild(jg, jf, deg=deg), tbuild(tg, tf, deg=deg, device="cpu")


def _r(mesh, seed):
    return np.random.default_rng(seed).standard_normal(
        (mesh.n_elements,) + (mesh.nl,) * mesh.dim)


# (overlap, subdomain iterations, chunk) of the three JAX `test_kslot_*`
# meshes
CASES = {"brick": (2, 5, 3), "hanging": (1, 4, 4), "sphere13": (2, 6, 5)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_and_apply_match_jax(case):
    ov, iters, chunk = CASES[case]
    jm, tm = _pair(case)
    js = jso.build_overlapping_schwarz_kslot(
        jm, num_nodes_overlap=ov, iterations=iters, chunk=chunk)
    ts = tso.build_overlapping_schwarz_kslot(
        tm, num_nodes_overlap=ov, iterations=iters, chunk=chunk)
    assert ts.chunk == js.chunk and ts.shape == js.shape
    for name in TABLES:
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if case == "hanging":
        assert set(js.hc) >= {"hc_elem", "hc_fine"}
        for name in ("hc_elem", "hc_fine"):
            np.testing.assert_array_equal(ts.hc[name].numpy(),
                                          np.asarray(js.hc[name]), name)
        for c in range(ts.hc["hc_m"].shape[0]):
            m = ts.hc["hc_m"][c]
            rows = tso._gather_hanging(tm, m.clamp(min=0), m >= 0)
            for name, t in rows.items():
                if t is None:
                    assert name not in js.hc, name
                    continue
                ref = np.asarray(js.hc[name][c])
                if t.is_floating_point():
                    assert _rel(t.numpy(), ref) <= 1e-13, (name, c)
                else:
                    np.testing.assert_array_equal(t.numpy(), ref, name)
    else:
        assert not ts.hc and not js.hc
    r = _r(tm, 7)
    got = ts(torch.as_tensor(r)).numpy()
    assert _rel(got, js(jnp.asarray(r))) <= 1e-11
    mat = tso.build_overlapping_schwarz(tm, num_nodes_overlap=ov,
                                        iterations=iters)
    assert _rel(got, mat(torch.as_tensor(r)).numpy()) <= 1e-12


def test_kslot_matches_materialized_conforming():
    """`tests/test_schwarz_overlap.py:test_kslot_matches_materialized_
    conforming` through the port."""
    from disco4est_tpu_torch.geometry.brick import BrickGeometry

    geom = BrickGeometry(dim=3)
    mesh = tbuild(geom, TForest.uniform(geom.conn, 1), deg=3, device="cpu")
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (8, 4, 4, 4)))
    M1 = tso.build_overlapping_schwarz(mesh, num_nodes_overlap=2,
                                       iterations=5)
    M2 = tso.build_overlapping_schwarz_kslot(mesh, num_nodes_overlap=2,
                                             iterations=5, chunk=3)
    assert float((M1(r) - M2(r)).abs().max()) < 1e-12


def test_kslot_matches_materialized_hanging_and_sphere():
    """`tests/test_schwarz_overlap.py:test_kslot_matches_materialized_
    hanging_and_sphere` through the port: mortar rows across chunk-local
    slots, and the curved 13-tree with the pointwise σ."""
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.geometry.cubed_sphere import (
        CubedSphereGeometry,
    )

    geom = BrickGeometry(dim=3)
    forest = TForest.uniform(geom.conn, 1)
    flags = np.zeros(8, bool)
    flags[0] = True
    mesh = tbuild(geom, forest.refine(flags).balance(), deg=2, device="cpu")
    rng = np.random.default_rng(1)
    r = torch.as_tensor(rng.standard_normal((mesh.n_elements, 3, 3, 3)))
    M1 = tso.build_overlapping_schwarz(mesh, num_nodes_overlap=1,
                                       iterations=4)
    M2 = tso.build_overlapping_schwarz_kslot(mesh, num_nodes_overlap=1,
                                             iterations=4, chunk=4)
    assert float((M1(r) - M2(r)).abs().max()) < 1e-12

    geom_s = CubedSphereGeometry("13tree", R0=1.0, R1=2.0, R2=3.0)
    mesh_s = tbuild(geom_s, TForest.uniform(geom_s.conn, 0), deg=2,
                    face_h_type="j_div_sj_quad", device="cpu")
    r_s = torch.as_tensor(rng.standard_normal((mesh_s.n_elements, 3, 3, 3)))
    M1s = tso.build_overlapping_schwarz(mesh_s, num_nodes_overlap=2,
                                        iterations=6)
    M2s = tso.build_overlapping_schwarz_kslot(mesh_s, num_nodes_overlap=2,
                                              iterations=6, chunk=5)
    assert float((M1s(r_s) - M2s(r_s)).abs().max()) < 1e-12


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def test_kslot_memory_footprint():
    """Resident K-slot state (its tables, the per-chunk mortar and combine
    tables) is a small fraction of the base mesh (the materialized
    variant replicates the fields its apply reads ~27x)."""
    from disco4est_tpu_torch.geometry.brick import BrickGeometry

    geom = BrickGeometry(dim=3)
    mesh = tbuild(geom, TForest.uniform(geom.conn, 2), deg=2, device="cpu")
    ks = tso.build_overlapping_schwarz_kslot(mesh, num_nodes_overlap=2,
                                             iterations=1, chunk=16)
    own = [getattr(ks, n) for n in TABLES] + list(ks.hc.values())
    own += [t for pair in ks.combine for t in pair]
    mesh_bytes = _nbytes(vars(mesh).values())
    assert _nbytes(own) < 0.5 * mesh_bytes, (_nbytes(own), mesh_bytes)


def test_kslot_hp_and_repeatable():
    """Mixed degrees (deg_e 2 or 3 at storage 3, the hp operator): K-slot
    == materialized to 1e-12; two applies are bit-equal."""
    from disco4est_tpu_torch.geometry.brick import BrickGeometry

    geom = BrickGeometry(dim=3)
    forest = TForest.uniform(geom.conn, 1)
    deg_e = np.array([3, 2, 2, 3, 2, 3, 3, 2], np.int32)
    mesh = tbuild(geom, forest, deg=3, deg_e=deg_e, device="cpu")
    r = torch.as_tensor(_r(mesh, 4))
    M1 = tso.build_overlapping_schwarz(mesh, num_nodes_overlap=2,
                                       iterations=6, hp=True)
    M2 = tso.build_overlapping_schwarz_kslot(mesh, num_nodes_overlap=2,
                                             iterations=6, chunk=3, hp=True)
    a = M2(r)
    assert _rel(a.numpy(), M1(r).numpy()) <= 1e-12
    assert torch.equal(a, M2(r))
    # the hp operator differs from the storage-degree one here
    M3 = tso.build_overlapping_schwarz_kslot(mesh, num_nodes_overlap=2,
                                             iterations=6, chunk=3)
    assert _rel(M3(r).numpy(), a.numpy()) > 1e-6


@pytest.mark.parametrize("key", ["t_schwarz", "t_cds_schwarz"])
def test_kslot_through_the_driver(key):
    from disco4est_tpu_torch import __main__ as cli

    text, problem = pins.options(key)
    text += "\n[d4est_solver_schwarz]\nsubdomain_chunk = 16\n"
    name = "run_nonlinear" if problem else "run_poisson"
    run, results = getattr(cli, name), []

    def capture(*a, **kw):
        results.append(run(*a, **kw))
        return results[-1]

    setattr(cli, name, capture)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            code = cli.main([text, f"--problem={problem or 'sinx'}",
                             "--device=cpu"])
    finally:
        setattr(cli, name, run)
    assert code == 0
    res = results[0]
    assert isinstance(res.precond, tso.SchwarzKSlot)
    assert res.precond.chunk == 16
    E, dof, l2, counts = MATERIALIZED[key]
    row = res.norms.rows[0]
    assert (row["num_quadrants"], row["num_nodes"]) == (E, dof)
    assert _rel(row["L_2"], l2) <= 1e-8, (row["L_2"], l2)
    if problem:
        assert res.solves[0].krylov == counts
    else:
        info = res.solves[0]
        assert info.path == "fcg-schwarz" and [info.iterations] == counts
        line = buf.getvalue().splitlines()[0]
        assert line.startswith("64 1728 1728 0.00194640363769")
