"""The port's 2D meshes, the disk and misc geometries and the derivatives
== the JAX package's (f64, CPU, one intra-op thread).

- 2D parity on a 2D brick, conforming and with two refined elements: every
  `MeshData` field (index tables equal, floats to 1e-12 relative),
  `apply_sipg`, `_apply_orth`, and the mortar pass (the dense orth tables
  and the legacy [M, K] row pass) to 1e-12.
- The geometries (`geometry/disk.py`, `geometry/misc.py`): the disk's
  p4est connectivity converted exactly as JAX's; `x` and the autodiff
  `dx` of the disk, the trapezoid, the pizza-half and the hole-in-a-box
  at seeded points on every tree to 1e-13; the checks of
  `tests/test_geometry.py:126-171` (face continuity through the
  connectivity, the trapezoid corners, the pizza-half surfaces, the
  hole-in-a-box surfaces and orientation) through the port, and the face
  continuity of the disk.
- Every `MeshData` field of the level-1 disk and the level-0
  hole-in-a-box to 1e-12, the general apply on them to 1e-12, and the 2D
  tree-structured apply on the level-2 disk and trapezoid against JAX's
  `apply_tree_structured` and the port's general apply to 1e-13.
- `test_disk_poisson_p_convergence` and
  `test_trap_and_pizza_poisson_p_convergence`
  (`tests/test_disk_and_tools.py:19,141`) through the port, each error
  within 1e-8 relative of JAX's (pinned: `refcheck/geometry_smoke_pins.py
  conv`).
- The CLI with `--device=cpu` prints the JAX CLI's norm lines (pinned:
  `refcheck/geometry_smoke_pins.py t_disk ap t_hole`): equal element and
  node counts, each L2 within 1e-6 relative.  The level-2 disk takes the
  default generic mixed solve, as the JAX CLI on the CPU; the uniform_p
  disk and the hole-in-a-box force `use_structured = 1`, so their
  epochs take the tree-structured `mixed-curved` solve that a card's run
  takes (and it is faster on the CPU).
- `gradient` and `hessian_trace` (`laplacian/derivatives.py`) against
  JAX on a brick, a level-1 7-tree and the level-1 disk to 1e-12.
"""

import contextlib
import dataclasses
import io
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch.mesh.builder import MeshData, build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "refcheck"))
import geometry_smoke_pins as pins  # noqa: E402  (the options' one source)

# `python refcheck/geometry_smoke_pins.py t_disk ap t_hole conv` (JAX, CPU)
CLI_PINS = {
    "t_disk": [(80, 720, 0.001870921427536103),
               (320, 2880, 0.0003591959004768694)],
    "ap": [(320, 5120, 9.676940229968944e-06),
           (320, 8000, 5.33376336457762e-07),
           (320, 11520, 6.726050331400483e-08)],
    "t_hole": [(12, 324, 1.0526851988277761),
               (96, 2592, 0.1644774908015242),
               (768, 20736, 0.010674197440757918)],
}
CONVERGENCE = {
    ("disk", 2): 0.010938980267413315, ("disk", 3): 0.0015061725194140954,
    ("trap", 2): 0.027688184719026284, ("trap", 4): 0.00025838514203374346,
    ("pizza", 2): 0.006636383432693189, ("pizza", 4): 0.0003699658282377164,
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _geoms(name):
    """(JAX geometry, port geometry)."""
    from disco4est_tpu.geometry import brick as jb, disk as jd, misc as jm
    from disco4est_tpu_torch.geometry import (
        brick as tb,
        disk as td,
        misc as tmisc,
    )

    if name == "brick2":
        return jb.BrickGeometry(dim=2), tb.BrickGeometry(dim=2)
    if name == "disk":
        return jd.DiskGeometry(0.5, 1.0), td.DiskGeometry(0.5, 1.0)
    if name == "trap":
        return jm.TrapGeometry(), tmisc.TrapGeometry()
    if name == "pizza":
        return jm.PizzaHalfGeometry(0.5, 1.3), tmisc.PizzaHalfGeometry(0.5,
                                                                      1.3)
    if name == "hole":
        return (jm.HoleInABoxGeometry(1.0, 10.0),
                tmisc.HoleInABoxGeometry(1.0, 10.0))
    if name == "sphere7":
        from disco4est_tpu.geometry.cubed_sphere import CubedSphereGeometry
        from disco4est_tpu_torch.geometry.cubed_sphere import (
            CubedSphereGeometry as TS,
        )

        return CubedSphereGeometry("7tree"), TS("7tree")
    raise KeyError(name)


def _pair(name, level, refine=(), **kw):
    """(JAX mesh, port mesh) on the same forest."""
    jg, tg = _geoms(name)
    jf, tf = JForest.uniform(jg.conn, level), TForest.uniform(tg.conn, level)
    if refine:
        flags = np.zeros(jf.n_elements, bool)
        flags[list(refine)] = True
        jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
    return jbuild(jg, jf, **kw), tbuild(tg, tf, device="cpu", **kw)


MESHES = {
    "brick2": ("brick2", 2, (), dict(deg=3)),
    "brick2_hanging": ("brick2", 2, (0, 5), dict(deg=3)),
    "disk1": ("disk", 1, (), dict(deg=2, face_h_type="j_div_sj_quad")),
    "hole0": ("hole", 0, (), dict(deg=2, face_h_type="j_div_sj_quad")),
    "disk2": ("disk", 2, (), dict(deg=3)),
    "trap2": ("trap", 2, (), dict(deg=2, face_h_type="j_div_sj_quad")),
}


@pytest.fixture(scope="module")
def meshes():
    """Each (JAX mesh, port mesh) pair, built once for the module."""
    cache = {}

    def get(key):
        if key not in cache:
            name, level, refine, kw = MESHES[key]
            cache[key] = _pair(name, level, refine, **kw)
        return cache[key]

    return get


def _assert_fields_match(jm, tm, tol=1e-12):
    for f in dataclasses.fields(MeshData):
        a = getattr(tm, f.name)
        if not (a is None or isinstance(a, torch.Tensor)):
            continue
        b = getattr(jm, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        if a.is_floating_point():
            assert a.dtype == torch.float64, f.name
            assert _rel(a.numpy(), b) <= tol, (f.name, _rel(a.numpy(), b))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)
    for name in ("orient_codes", "affine", "orth", "iso", "n_elements",
                 "dim"):
        assert getattr(tm, name) == getattr(jm, name), name


def _field(tm, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((tm.n_elements,) + (tm.nl,) * tm.dim)


# ---------------------------------------------------------------------------
# 2D parity of the builder and the applies on a 2D brick
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["brick2", "brick2_hanging"])
def test_2d_brick_matches_jax(meshes, key):
    from disco4est_tpu.laplacian.sipg import apply_sipg as japply
    from disco4est_tpu_torch.laplacian import fast
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg

    jm, tm = meshes(key)
    assert tm.dim == 2 and tm.orth and tm.affine
    _assert_fields_match(jm, tm)
    u = _field(tm, 0)
    ref = np.asarray(japply(jm, jnp.asarray(u)))
    ut = torch.as_tensor(u)
    assert _rel(apply_sipg(tm, ut).numpy(), ref) <= 1e-12
    assert _rel(fast._apply_orth(tm, ut).numpy(), ref) <= 1e-12
    # the general (tensor) apply, whose mortar pass is the [M, K] row pass
    assert _rel(apply_sipg(tm, ut, volume_mode="tensor").numpy(),
                ref) <= 1e-12
    if key == "brick2_hanging":
        assert tm.hc_elem.shape[0] > 0 and tm.hang_code is not None
        legacy = dataclasses.replace(tm, hang_code=None, hang_sigma=None)
        assert _rel(fast.apply_sipg_fast(legacy, ut).numpy(), ref) <= 1e-12


# ---------------------------------------------------------------------------
# the geometries
# ---------------------------------------------------------------------------


def test_disk_connectivity_matches_jax():
    from disco4est_tpu.geometry import disk as jd
    from disco4est_tpu_torch.geometry import disk as td

    for name in ("_T2V", "_T2T", "_T2F"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    jc = jd.connectivity_from_p4est_2d(jd._T2V, jd._T2T, jd._T2F)
    tc = td.connectivity_from_p4est_2d(td._T2V, td._T2T, td._T2F)
    for f in ("nbr_tree", "nbr_face", "axis_map", "axis_flip"):
        a, b = getattr(tc, f), getattr(jc, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
        np.testing.assert_array_equal(getattr(td.DiskGeometry().conn, f), b)
    assert tc.dim == 2


@pytest.mark.parametrize("name", ["disk", "trap", "pizza", "hole"])
def test_maps_match_jax_on_every_tree(name):
    jg, tg = _geoms(name)
    for f in ("nbr_tree", "nbr_face", "axis_map", "axis_flip"):
        np.testing.assert_array_equal(getattr(tg.conn, f),
                                      getattr(jg.conn, f), err_msg=f)
    assert tg.dim == jg.dim and tg == _geoms(name)[1]
    T, dim = jg.conn.n_trees, jg.dim
    rng = np.random.default_rng(T)
    rst = rng.random((T, 6, dim))
    tree = np.repeat(np.arange(T)[:, None], 6, axis=1)
    xj = jg.x(jnp.asarray(tree), jnp.asarray(rst))
    xt = tg.x(torch.as_tensor(tree), torch.as_tensor(rst))
    assert _rel(xt.numpy(), xj) <= 1e-13
    dj = jg.dx(jnp.asarray(tree), jnp.asarray(rst))
    dt = tg.dx(torch.as_tensor(tree), torch.as_tensor(rst))
    assert dt.shape == (T, 6, dim, dim)
    for t in range(T):  # each tree's map, not a neighbor's
        assert _rel(dt[t].numpy(), dj[t]) <= 1e-13, t


def _face_points(face, dim, n=5):
    rng = np.random.default_rng(0)
    a0, side = divmod(face, 2)
    pts = rng.uniform(0.05, 0.95, size=(n, dim))
    pts[:, a0] = float(side)
    return pts


def _check_continuity(geom, atol=1e-11):
    """`tests/test_geometry.py:_check_geometry` through the port: points on
    every connected tree face land on the same physical points through
    both trees' maps."""
    conn, dim = geom.conn, geom.dim
    for t in range(conn.n_trees):
        for f in range(2 * dim):
            nt = int(conn.nbr_tree[t, f])
            if nt < 0:
                continue
            pts = _face_points(f, dim)
            a0, side = divmod(f, 2)
            p = pts.copy()
            p[:, a0] += -1.0 if side == 1 else 1.0
            out = np.empty_like(p)
            for a in range(dim):
                v = p[:, a]
                out[:, int(conn.axis_map[t, f][a])] = np.where(
                    conn.axis_flip[t, f][a] == 1, 1.0 - v, v)
            assert out.min() > -1e-12 and out.max() < 1 + 1e-12, (t, f)
            xa = geom.x(torch.full((len(pts),), t), torch.as_tensor(pts))
            xb = geom.x(torch.full((len(pts),), nt), torch.as_tensor(out))
            assert float((xa - xb).abs().max()) < atol, (t, f, nt)


def test_disk_faces_and_boundary():
    _, geom = _geoms("disk")
    _check_continuity(geom)
    # the outer edges of the four wedges lie on the circle r = R1
    for t in (0, 1, 3, 4):
        for f in range(4):
            if geom.conn.nbr_tree[t, f] >= 0:
                continue
            x = geom.x(torch.full((5,), t),
                       torch.as_tensor(_face_points(f, 2)))
            assert torch.allclose(x.norm(dim=1),
                                  torch.ones(5, dtype=torch.float64),
                                  atol=1e-14), (t, f)


def test_trap_and_pizza_maps():
    """`tests/test_geometry.py:test_trap_and_pizza_maps` through the port."""
    _, trap = _geoms("trap")
    corners = torch.as_tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0],
                               [1.0, 1.0]], dtype=torch.float64)
    assert np.allclose(trap.x(0, corners).numpy(), trap.VERTS, atol=1e-14)
    mid = trap.x(0, torch.as_tensor([[0.5, 0.5]],
                                    dtype=torch.float64))[0].numpy()
    assert np.allclose(mid, [0.5, -0.25 + 0.5 + 0.25], atol=1e-14)

    R0, R1 = 0.5, 1.3
    _, pz = _geoms("pizza")
    ys = torch.linspace(0.0, 1.0, 7, dtype=torch.float64)
    inner = pz.x(0, torch.stack([0 * ys, ys], dim=-1)).numpy()
    assert np.allclose(inner[:, 0], 0.0, atol=1e-14)  # chord x = 0
    outer = pz.x(0, torch.stack([0 * ys + 1, ys], dim=-1)).numpy()
    r = np.hypot(outer[:, 0] + R0 / np.sqrt(2.0), outer[:, 1])
    assert np.allclose(r, R1, atol=1e-12)  # arc centred at (-R0/√2, 0)


def test_hole_in_a_box():
    """`tests/test_geometry.py:test_hole_in_a_box` through the port."""
    _, geom = _geoms("hole")
    _check_continuity(geom)
    pts = torch.as_tensor(_face_points(4, 3))
    x = geom.x(torch.full((5,), 7), pts).numpy()
    assert np.allclose(np.linalg.norm(x, axis=1), 1.0 / np.sqrt(3.0),
                       atol=1e-12)
    x = geom.x(torch.full((5,), 3), torch.as_tensor(_face_points(5, 3)))
    assert np.allclose(np.abs(x.numpy()).max(axis=1), 5.0, atol=1e-12)
    rng = np.random.default_rng(2)
    for t in range(12):
        p = torch.as_tensor(rng.uniform(0.05, 0.95, (8, 3)))
        det = torch.linalg.det(geom.dx(torch.full((8,), t), p))
        assert (det > 0).all(), (t, det)


# ---------------------------------------------------------------------------
# meshes and applies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["disk1", "hole0"])
def test_mesh_and_general_apply_match_jax(meshes, key):
    from disco4est_tpu.laplacian.sipg import apply_sipg as japply
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg

    jm, tm = meshes(key)
    assert not tm.affine and tm.sigma_q is not None
    _assert_fields_match(jm, tm)
    u = _field(tm, 1)
    ref = np.asarray(japply(jm, jnp.asarray(u)))
    assert _rel(apply_sipg(tm, torch.as_tensor(u)).numpy(), ref) <= 1e-12


@pytest.mark.parametrize("key", ["disk2", "trap2"])
def test_2d_tree_structured_apply_matches_jax(meshes, key):
    from disco4est_tpu.laplacian import curved as jc
    from disco4est_tpu_torch.laplacian import curved
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg

    jm, tm = meshes(key)
    jts, ts = jc.build_tree_structured(jm), curved.build_tree_structured(tm)
    assert ts is not None and ts.dim == 2
    np.testing.assert_array_equal(ts.tmask.numpy(), np.asarray(jts.tmask))
    for f in ("perm", "inv_perm", "it_elem", "it_face", "it_nbr_row",
              "it_code"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(jts, f)), f)
    assert ts.it_codes == jts.it_codes and ts.deltas == jts.deltas
    u = _field(tm, 2)
    ref = apply_sipg(tm, torch.as_tensor(u)).numpy()
    out = curved.from_lex(ts, curved.apply_tree_structured(
        ts, curved.permute_mesh_lex(ts, tm),
        curved.to_lex(ts, torch.as_tensor(u)))).numpy()
    jout = jc.from_lex(jts, jc.apply_tree_structured(
        jts, jc.permute_mesh_lex(jts, jm), jc.to_lex(jts, jnp.asarray(u))))
    assert _rel(out, jout) <= 1e-13
    assert _rel(out, ref) <= 1e-13


# ---------------------------------------------------------------------------
# p-convergence (`tests/test_disk_and_tools.py:19,141`) through the port
# ---------------------------------------------------------------------------


def _p_errors(geom, level, degs, check_boundary=False):
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.solvers.cg import cg_solve

    pi = np.pi
    u_fcn = lambda x, y: torch.sin(pi * x) * torch.sin(pi * y)
    f_fcn = lambda x, y: 2 * pi**2 * u_fcn(x, y)
    forest = TForest.uniform(geom.conn, level)
    errs = {}
    for deg in degs:
        mesh = tbuild(geom, forest, deg=deg, deg_quad=deg + 1,
                      face_h_type="j_div_sj_quad", device="cpu")
        if check_boundary:
            assert mesh.n_elements == 20
            r = mesh.face_xyz_lobatto.norm(dim=2)
            assert float((r[mesh.bnd_mask] - 1.0).abs().max()) < 1e-12
        rhs = build_rhs_with_strong_bc(mesh, mesh.init_field(f_fcn),
                                       mesh.boundary_values(u_fcn))
        res = cg_solve(lambda v: apply_sipg(mesh, v), rhs, atol=1e-14,
                       rtol=0.0, max_iter=20000)
        err = res.x - mesh.init_field(u_fcn)
        errs[deg] = float(torch.sqrt(mesh.l2_norm_sqr(err).sum()))
    return errs


def test_disk_poisson_p_convergence():
    errs = _p_errors(_geoms("disk")[1], 1, (2, 3), check_boundary=True)
    assert errs[3] < 0.25 * errs[2], errs
    for deg, e in errs.items():
        assert _rel(e, CONVERGENCE[("disk", deg)]) <= 1e-8, (deg, e)


def test_trap_and_pizza_poisson_p_convergence():
    from disco4est_tpu_torch.geometry.misc import (
        PizzaHalfGeometry,
        TrapGeometry,
    )

    for name, geom in (("trap", TrapGeometry()),
                       ("pizza", PizzaHalfGeometry(0.5, 1.0))):
        errs = _p_errors(geom, 1, (2, 4))
        assert errs[4] < 0.1 * errs[2], (name, errs)
        for deg, e in errs.items():
            assert _rel(e, CONVERGENCE[(name, deg)]) <= 1e-8, (name, deg, e)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,use_structured,path", [
    ("t_disk", "0", "mixed"),
    ("ap", "1", "mixed-curved"),
    ("t_hole", "1", "mixed-curved"),
])
def test_cli_prints_the_jax_lines(key, use_structured, path):
    from disco4est_tpu_torch import __main__ as cli

    text = pins.options(key, use_structured=use_structured)
    problem = pins.RUNS[key]["problem"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main([text, f"--problem={problem}", "--device=cpu"])
    assert code == 0
    lines = buf.getvalue().splitlines()
    pin = CLI_PINS[key]
    for k, (E, nodes, l2) in enumerate(pin):
        tok = lines[k].split()
        assert (int(tok[0]), int(tok[1]), int(tok[2])) == (E, nodes, nodes)
        assert _rel(float(tok[3]), l2) <= 1e-6, (k, tok[3], l2)
        solve = lines[len(pin) + k]
        assert f"path={path} " in solve and "fallback=no" in solve, solve


# ---------------------------------------------------------------------------
# derivatives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,level,deg", [("brick3", 1, 3),
                                            ("sphere7", 1, 2),
                                            ("disk", 1, 3)])
def test_derivatives_match_jax(name, level, deg):
    from disco4est_tpu.laplacian import derivatives as jd
    from disco4est_tpu_torch.laplacian import derivatives as td

    if name == "brick3":
        from disco4est_tpu.geometry.brick import BrickGeometry as JB
        from disco4est_tpu_torch.geometry.brick import BrickGeometry as TB

        jg, tg = JB(dim=3), TB(dim=3)
    else:
        jg, tg = _geoms(name)
    jm = jbuild(jg, JForest.uniform(jg.conn, level), deg=deg)
    tm = tbuild(tg, TForest.uniform(tg.conn, level), deg=deg, device="cpu")
    u = _field(tm, 3)
    g = td.gradient(tm, torch.as_tensor(u))
    assert g.shape == (tm.n_elements, tm.dim) + (tm.nq,) * tm.dim
    assert _rel(g.numpy(), jd.gradient(jm, jnp.asarray(u))) <= 1e-12
    h = td.hessian_trace(tm, torch.as_tensor(u))
    assert _rel(h.numpy(), jd.hessian_trace(jm, jnp.asarray(u))) <= 1e-12
