"""Port general SIPG apply and tree-structured curved apply == the JAX
package's (f64, CPU).

- `apply_sipg` off the fast path, in the dense and the tensor volume
  modes, with and without Dirichlet data, with `neighbors="zero"` and with
  Robin data, on the 7-tree sphere (pointwise penalty), the compactified
  13-tree sphere with its per-element radial rule, and an adapted 7-tree
  sphere whose mortars cross reoriented tree faces: to 1e-12 relative.
- `fast._apply_general` on the forced non-orthogonal brick of
  `tests/test_fast_apply.py:71-83`, against JAX's and the orthogonal path.
- The tree-structured apply on the three meshes of
  `tests/test_curved_fast.py:46-65` against the general apply and against
  JAX's `apply_tree_structured` to 1e-13, its face classification against
  JAX's; adapted meshes refused; its f32 copy within 1e-5 of f64.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.geometry.brick import BrickGeometry as JBrick
from disco4est_tpu.geometry.cubed_sphere import CubedSphereGeometry as JSphere
from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch.geometry.brick import BrickGeometry as TBrick
from disco4est_tpu_torch.geometry.cubed_sphere import (
    CubedSphereGeometry as TSphere,
)
from disco4est_tpu_torch.laplacian import curved, fast
from disco4est_tpu_torch.laplacian.sipg import apply_sipg
from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest

SPHERE7 = dict(kind="7tree", R0=1.0, R1=2.0)
SPHERE13 = dict(kind="13tree", R0=10.0, R1=20.0, R2=1000.0,
                compactify_outer_shell=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _pair(geom_kw, level, deg, refine=(), **kw):
    jg, tg = JSphere(**geom_kw), TSphere(**geom_kw)
    jf, tf = JForest.uniform(jg.conn, level), TForest.uniform(tg.conn, level)
    if refine:
        flags = np.zeros(jf.n_elements, bool)
        flags[list(refine)] = True
        jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
    return (jbuild(jg, jf, deg=deg, **kw),
            tbuild(tg, tf, deg=deg, device="cpu", **kw))


@pytest.fixture(scope="module")
def meshes():
    return {
        "7tree": _pair(SPHERE7, 1, 2, face_h_type="j_div_sj_quad"),
        "13tree_k4": _pair(SPHERE13, 1, 2, face_h_type="j_div_sj_quad",
                           compactified_k=4),
        "7tree_adapted": _pair(SPHERE7, 1, 2, refine=(0, 5, 13, 50),
                               face_h_type="j_div_sj_quad"),
    }


OPTIONS = {
    "auto": {},
    "dense": dict(volume_mode="dense"),
    "tensor": dict(volume_mode="tensor"),
    "zero": dict(neighbors="zero"),
    "robin": dict(robin=True),
}


# the dense volume mode takes no per-element radial rule (13tree_k4)
CASES = [(key, option) for key in ("7tree", "13tree_k4", "7tree_adapted")
         for option in sorted(OPTIONS)
         if not (key == "13tree_k4" and option == "dense")]


@pytest.mark.parametrize("with_g", [False, True])
@pytest.mark.parametrize("key,option", CASES)
def test_general_apply_matches_jax(meshes, key, option, with_g):
    from disco4est_tpu.laplacian.sipg import apply_sipg as japply

    jm, tm = meshes[key]
    E, nl, nq = tm.n_elements, tm.nl, tm.nq
    rng = np.random.default_rng(7)
    u = rng.standard_normal((E,) + (nl,) * 3)
    g = rng.standard_normal((E, 6, nl, nl)) if with_g else None
    jkw, tkw = dict(OPTIONS[option]), dict(OPTIONS[option])
    if jkw.pop("robin", False):
        rc = rng.random((E, 6, nq, nq))
        rr = rng.standard_normal((E, 6, nq, nq))
        jkw = dict(robin_coeff=jnp.asarray(rc), robin_rhs=jnp.asarray(rr))
        tkw = dict(robin_coeff=torch.as_tensor(rc),
                   robin_rhs=torch.as_tensor(rr))
    a = japply(jm, jnp.asarray(u), None if g is None else jnp.asarray(g),
               **jkw)
    b = apply_sipg(tm, torch.as_tensor(u),
                   None if g is None else torch.as_tensor(g), **tkw)
    assert b.dtype == torch.float64
    assert _rel(b.numpy(), a) <= 1e-12


def test_general_apply_refuses_unknown_modes(meshes):
    _, tm = meshes["7tree"]
    u = torch.zeros((tm.n_elements,) + (tm.nl,) * 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="fast path"):
        apply_sipg(tm, u, volume_mode="fast")
    with pytest.raises(ValueError, match="volume_mode"):
        apply_sipg(tm, u, volume_mode="bogus")


def test_mass_and_rhs_match_jax_on_spheres(meshes):
    from disco4est_tpu.laplacian.sipg import apply_mass as jmass
    from disco4est_tpu.laplacian.sipg import (
        build_rhs_with_strong_bc as jrhs,
    )
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_mass,
        build_rhs_with_strong_bc,
    )

    for key in ("7tree", "13tree_k4"):
        jm, tm = meshes[key]
        rng = np.random.default_rng(8)
        f = rng.standard_normal((tm.n_elements,) + (tm.nl,) * 3)
        g = rng.standard_normal((tm.n_elements, 6, tm.nl, tm.nl))
        assert _rel(apply_mass(tm, torch.as_tensor(f)).numpy(),
                    jmass(jm, jnp.asarray(f))) <= 1e-12
        assert _rel(build_rhs_with_strong_bc(tm, torch.as_tensor(f),
                                             torch.as_tensor(g)).numpy(),
                    jrhs(jm, jnp.asarray(f), jnp.asarray(g))) <= 1e-12
        fq = tm.init_field_on_quad(lambda x, y, z: x * y + z)
        assert _rel(fq.numpy(), jm.init_field_on_quad(
            lambda x, y, z: x * y + z)) <= 1e-13
        bq = tm.boundary_values_quad(lambda x, y, z: 1.0 / (1.0 + x * x))
        assert _rel(bq.numpy(), jm.boundary_values_quad(
            lambda x, y, z: 1.0 / (1.0 + x * x))) <= 1e-13


def test_general_affine_path_matches_jax():
    """The forced non-orthogonal (6-block) path of
    `tests/test_fast_apply.py:71-83`: off-diagonal coefficients are zero,
    but the whole general-affine code path runs."""
    from disco4est_tpu.laplacian.fast import apply_sipg_fast as jfast

    kw = dict(x0=(0.0,) * 3, x1=(1.0, 2.0, 0.5), dim=3)
    jg, tg = JBrick(**kw), TBrick(**kw)
    jm = dataclasses.replace(jbuild(jg, JForest.uniform(jg.conn, 1), deg=3),
                             orth=False)
    tm0 = tbuild(tg, TForest.uniform(tg.conn, 1), deg=3, device="cpu")
    tm = dataclasses.replace(tm0, orth=False)
    assert fast.fast_path_available(tm, "full", None)
    assert not fast.fast_path_available(tm, "zero", None)
    u = np.random.default_rng(3).standard_normal((tm.n_elements, 4, 4, 4))
    g = np.random.default_rng(4).standard_normal((tm.n_elements, 6, 4, 4))
    for gg in (None, g):
        a = jfast(jm, jnp.asarray(u), None if gg is None else jnp.asarray(gg))
        tg_ = None if gg is None else torch.as_tensor(gg)
        b = fast._apply_general(tm, torch.as_tensor(u), tg_)
        c = fast._apply_orth(tm0, torch.as_tensor(u), tg_)
        assert _rel(b.numpy(), a) <= 1e-12
        assert _rel(b.numpy(), c.numpy()) <= 1e-12
        assert _rel(fast.apply_sipg_fast(tm, torch.as_tensor(u), tg_).numpy(),
                    a) <= 1e-12


def _curved_case(name):
    """The three meshes of `tests/test_curved_fast.py:46-65`."""
    if name == "13tree_compactified":
        return _pair(SPHERE13, 1, 2, face_h_type="j_div_sj_quad")
    if name == "7tree_scalar_sigma":
        return _pair(SPHERE7, 1, 3, face_h_type="j_div_sj_min_lobatto")
    jg, tg = JBrick(dim=3), TBrick(dim=3)
    return (jbuild(jg, JForest.uniform(jg.conn, 2), deg=2),
            tbuild(tg, TForest.uniform(tg.conn, 2), deg=2, device="cpu"))


@pytest.mark.parametrize("name", ["13tree_compactified", "7tree_scalar_sigma",
                                  "multitree_brick"])
def test_tree_structured_matches_general_and_jax(name):
    from disco4est_tpu.laplacian import curved as jc

    jm, tm = _curved_case(name)
    jts, ts = jc.build_tree_structured(jm), curved.build_tree_structured(tm)
    assert ts is not None
    # the same classification: rolled faces, crossing rows and their codes
    np.testing.assert_array_equal(ts.tmask.numpy(), np.asarray(jts.tmask))
    for f in ("perm", "inv_perm", "it_elem", "it_face", "it_nbr_row",
              "it_code"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(jts, f)), f)
    assert ts.it_codes == jts.it_codes and ts.deltas == jts.deltas
    E, nl = tm.n_elements, tm.nl
    u = np.random.default_rng(0).standard_normal((E,) + (nl,) * 3)
    ref = apply_sipg(tm, torch.as_tensor(u), volume_mode="tensor")
    lex = curved.permute_mesh_lex(ts, tm)
    out = curved.from_lex(ts, curved.apply_tree_structured(
        ts, lex, curved.to_lex(ts, torch.as_tensor(u))))
    jout = jc.from_lex(jts, jc.apply_tree_structured(
        jts, jc.permute_mesh_lex(jts, jm), jc.to_lex(jts, jnp.asarray(u))))
    assert _rel(out.numpy(), ref.numpy()) < 1e-13
    assert _rel(out.numpy(), jout) < 1e-13
    # the f32 copies, cast once per epoch as the inner solve takes them
    out32 = curved.from_lex(ts, curved.apply_tree_structured(
        ts.astype(torch.float32), lex.astype(torch.float32),
        curved.to_lex(ts, torch.as_tensor(u, dtype=torch.float32))))
    assert out32.dtype == torch.float32
    assert _rel(out32.numpy(), ref.numpy()) < 1e-5


def test_tree_structured_takes_the_radial_rule():
    """The compactified radial rule runs the tensor-form volume term."""
    jm, tm = _pair(SPHERE13, 1, 2, face_h_type="j_div_sj_quad",
                   compactified_k=4)
    ts = curved.build_tree_structured(tm)
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (tm.n_elements, 3, 3, 3)))
    out = curved.from_lex(ts, curved.apply_tree_structured(
        ts, curved.permute_mesh_lex(ts, tm), curved.to_lex(ts, u)))
    assert _rel(out.numpy(), apply_sipg(tm, u).numpy()) < 1e-13


def test_tree_structured_refuses_adapted_meshes():
    for geom in (TBrick(dim=3), TSphere(**SPHERE7)):
        forest = TForest.uniform(geom.conn, 1)
        flags = np.zeros(forest.n_elements, bool)
        flags[0] = True
        mesh = tbuild(geom, forest.refine(flags).balance(), deg=2,
                      device="cpu")
        assert curved.build_tree_structured(mesh) is None
    geom = TSphere(**SPHERE7)
    forest = TForest.uniform(geom.conn, 1)
    deg_e = np.full(forest.n_elements, 2)
    deg_e[3] = 1
    mesh = tbuild(geom, forest, deg=2, deg_e=deg_e, device="cpu")
    assert curved.build_tree_structured(mesh) is None
