"""Port cubed spheres == the JAX package's: connectivity, maps, meshes,
compactified rules and the estimator.

- The p8est connectivities and the converted `Connectivity` tables equal.
- `x` and the autodiff `dx` of the 7-tree, the compactified 13-tree (outer
  and inner shell) and the 12-tree holed sphere at seeded points on every
  tree to 1e-13, and no factor array of a mesh holds a NaN or inf on any
  tree, the core included (every tree evaluates every branch of the map).
- Every `MeshData` field of the 7-tree and the compactified 13-tree
  (level 1, deg 2) to 1e-12, with the pointwise (`j_div_sj_quad`) and
  the min-Lobatto penalty, and of a compactified_k = 4 mesh; the
  compactified rule arrays to 1e-13.
- An adapted 7-tree mesh whose mortars cross reoriented tree faces: the
  mortar permutations equal, `hc_sigma_q` to 1e-12, and `estimate_bi` to
  1e-10.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.geometry.cubed_sphere import CubedSphereGeometry as JSphere
from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch.geometry.cubed_sphere import (
    CubedSphereGeometry as TSphere,
)
from disco4est_tpu_torch.mesh.builder import MeshData, build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest

from torch_threads import torch_worker_threads  # noqa: F401

GEOMETRIES = {
    "7tree": ("7tree", dict(R0=1.0, R1=2.0)),
    "13tree_outer": ("13tree", dict(R0=10.0, R1=20.0, R2=1000.0,
                                    compactify_outer_shell=True)),
    "13tree_inner": ("13tree", dict(R0=10.0, R1=20.0, R2=1000.0,
                                    compactify_inner_shell=True)),
    "12tree_hole": ("12tree_hole", dict(R0=1.0, R1=2.0, R2=5.0)),
}
# the refined elements of the adapted 7-tree mesh: their mortars cross
# reoriented tree faces
REFINE = [0, 5, 13, 50]


def _geoms(name):
    kind, kw = GEOMETRIES[name]
    return JSphere(kind, **kw), TSphere(kind, **kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _assert_fields_match(jm, tm, tol=1e-12):
    """Every tensor field of the port's MeshData against the JAX field of
    the same name: index tables equal, floats to `tol` relative."""
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
    for name in ("orient_codes", "affine", "orth", "iso", "n_elements"):
        assert getattr(tm, name) == getattr(jm, name), name


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_sphere_maps_match_jax(name):
    jg, tg = _geoms(name)
    for f in ("nbr_tree", "nbr_face", "axis_map", "axis_flip"):
        np.testing.assert_array_equal(getattr(tg.conn, f),
                                      getattr(jg.conn, f), err_msg=f)
    assert tg.n_regions == jg.n_regions
    T = jg.n_trees_total
    np.testing.assert_array_equal(tg.tree_region(np.arange(T)),
                                  jg.tree_region(np.arange(T)))
    rng = np.random.default_rng(T)
    rst = rng.random((T, 6, 3))
    tree = np.repeat(np.arange(T)[:, None], 6, axis=1)
    xj = jg.x(jnp.asarray(tree), jnp.asarray(rst))
    xt = tg.x(torch.as_tensor(tree), torch.as_tensor(rst))
    assert _rel(xt.numpy(), xj) <= 1e-13
    dj = jg.dx(jnp.asarray(tree), jnp.asarray(rst))
    dt = tg.dx(torch.as_tensor(tree), torch.as_tensor(rst))
    assert dt.shape == (T, 6, 3, 3)
    assert _rel(dt.numpy(), dj) <= 1e-13


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_sphere_factors_finite_on_every_tree(name):
    _, tg = _geoms(name)
    mesh = tbuild(tg, TForest.uniform(tg.conn, 0), deg=2,
                  face_h_type="j_div_sj_quad", device="cpu")
    assert sorted(set(mesh.forest.tree)) == list(range(tg.n_trees_total))
    for f in dataclasses.fields(MeshData):
        a = getattr(mesh, f.name)
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            assert torch.isfinite(a).all(), f.name
    assert (mesh.j_quad > 0).all()


@pytest.fixture(scope="module")
def sphere_meshes():
    """(JAX mesh, port mesh) pairs at level 1, deg 2."""
    out = {}
    for key, name, kw in [
        ("7tree_quad", "7tree", dict(face_h_type="j_div_sj_quad")),
        ("7tree_lob", "7tree", dict(face_h_type="j_div_sj_min_lobatto")),
        ("13tree_quad", "13tree_outer", dict(face_h_type="j_div_sj_quad")),
        ("13tree_lob", "13tree_outer",
         dict(face_h_type="j_div_sj_min_lobatto")),
        ("13tree_k4", "13tree_outer",
         dict(face_h_type="j_div_sj_quad", compactified_k=4)),
    ]:
        jg, tg = _geoms(name)
        out[key] = (
            jbuild(jg, JForest.uniform(jg.conn, 1), deg=2, **kw),
            tbuild(tg, TForest.uniform(tg.conn, 1), deg=2, device="cpu",
                   **kw),
        )
    return out


@pytest.mark.parametrize("key", ["7tree_quad", "7tree_lob", "13tree_quad",
                                 "13tree_lob", "13tree_k4"])
def test_sphere_mesh_fields_match_jax(sphere_meshes, key):
    jm, tm = sphere_meshes[key]
    assert tm.orient_codes  # the spheres have reoriented tree faces
    assert (tm.sigma_q is not None) == key.endswith(("quad", "k4"))
    _assert_fields_match(jm, tm)


def test_compactified_rules_match_jax(sphere_meshes):
    from disco4est_tpu.quadrature import compactified as jc
    from disco4est_tpu_torch.quadrature import compactified as tc

    jm, tm = sphere_meshes["13tree_k4"]
    for name in ("rad_interp", "rad_w"):
        assert _rel(getattr(tm, name).numpy(), getattr(jm, name)) <= 1e-13
    # plain Gauss rows on the trees that are not outer shells
    inner = torch.as_tensor(tm.forest.tree >= 6)
    xg, wg = tm.quad.nodes_weights(tm.deg_quad)
    np.testing.assert_array_equal(tm.rad_w[inner].numpy(),
                                  np.tile(wg, (int(inner.sum()), 1)))
    for args in [(-3.5, 0.25, 4, 3), (-990.0, 490.0, 2, 5)]:
        for a, b in zip(tc.rule(*args), jc.rule(*args)):
            assert _rel(a, b) <= 1e-13
    assert tc.shell_c1_c2(1.0, 1.5, 20.0, 1000.0) == jc.shell_c1_c2(
        1.0, 1.5, 20.0, 1000.0)
    for a, b in zip(
        tc.element_rule_outer_shell(1 << 18, 1 << 18, 1 << 19, 20.0,
                                    1000.0, 4, 4),
        jc.element_rule_outer_shell(1 << 18, 1 << 18, 1 << 19, 20.0,
                                    1000.0, 4, 4),
    ):
        assert _rel(a, b) <= 1e-13


def test_compactified_needs_a_compactified_shell():
    for kind, kw in [("7tree", dict(R0=1.0, R1=2.0)),
                     ("13tree", dict(R0=10.0, R1=20.0, R2=1000.0))]:
        tg = TSphere(kind, **kw)
        with pytest.raises(ValueError, match="compactified"):
            tbuild(tg, TForest.uniform(tg.conn, 0), deg=1,
                   compactified_k=4, device="cpu")


@pytest.fixture(scope="module")
def adapted_meshes():
    """(JAX mesh, port mesh) pairs of the adapted 7-tree sphere, deg 2,
    with the pointwise penalty and with volume/area h."""
    jg, tg = _geoms("7tree")
    jf, tf = JForest.uniform(jg.conn, 1), TForest.uniform(tg.conn, 1)
    flags = np.zeros(jf.n_elements, bool)
    flags[REFINE] = True
    jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
    return {
        face_h: (jbuild(jg, jf, deg=2, face_h_type=face_h),
                 tbuild(tg, tf, deg=2, face_h_type=face_h, device="cpu"))
        for face_h in ("j_div_sj_quad", "volume_div_area")
    }


@pytest.mark.parametrize("face_h", ["j_div_sj_quad", "volume_div_area"])
def test_adapted_sphere_mortars_match_jax(adapted_meshes, face_h):
    jm, tm = adapted_meshes[face_h]
    M, n = tm.hc_elem.shape[0], tm.nl**2
    assert M > 0
    ident = torch.arange(n)
    reoriented = (tm.hc_perm_l != ident).any(-1)
    assert reoriented.any() and (tm.hf_perm_l != ident).any()
    # reoriented mortars: no dense hanging tables (the GEMM-form pass
    # applies no permutation), as in the JAX builder
    assert tm.hang_code is None
    assert (tm.hc_sigma_q is not None) == (face_h == "j_div_sj_quad")
    _assert_fields_match(jm, tm)


@pytest.mark.parametrize("face_h", ["j_div_sj_quad", "volume_div_area"])
def test_estimator_on_adapted_sphere_matches_jax(adapted_meshes, face_h):
    from disco4est_tpu.estimators.bi import estimate_bi as jest
    from disco4est_tpu_torch.estimators.bi import estimate_bi as test

    jm, tm = adapted_meshes[face_h]
    E, nl = tm.n_elements, tm.nl
    rng = np.random.default_rng(11)
    u = rng.standard_normal((E,) + (nl,) * 3)
    r = rng.standard_normal((E,) + (nl,) * 3)
    g = rng.standard_normal((E, 6, nl, nl))
    a = jest(jm, jnp.asarray(u), jnp.asarray(r), g=jnp.asarray(g))
    b = test(tm, torch.as_tensor(u), torch.as_tensor(r),
             g=torch.as_tensor(g))
    assert _rel(b.numpy(), a) <= 1e-10


def test_mesh_from_numpy_carries_a_sphere_mesh(adapted_meshes):
    """Every field of a JAX sphere mesh, the orientation and mortar
    permutations and the pointwise penalty included, carried across as
    numpy arrays, equals the port's own build."""
    from disco4est_tpu_torch.mesh.builder import mesh_from_numpy

    jm, tm = adapted_meshes["j_div_sj_quad"]
    arrays = {f.name: np.asarray(getattr(jm, f.name))
              for f in dataclasses.fields(MeshData)
              if hasattr(getattr(jm, f.name, None), "shape")}
    meta = dict(dim=jm.dim, deg=jm.deg, deg_quad=jm.deg_quad,
                quad=jm.quad.kind, geom=tm.geom, forest=tm.forest,
                affine=jm.affine, orth=jm.orth, iso=jm.iso,
                orient_codes=jm.orient_codes)
    cm = mesh_from_numpy(arrays, meta, "cpu")
    assert cm.orient_codes == tm.orient_codes
    _assert_fields_match(jm, cm)
