"""Port mesh builder == the JAX builder, field by field.

Both builders evaluate the same f64 formulas on the same brick; the
summed quantities (areas, volumes) may add in another order, so fields
are held to 1e-13 relative (to the field's max magnitude).  Integer and
boolean tables must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.geometry.brick import BrickGeometry as JBrick
from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch.geometry.base import Geometry
from disco4est_tpu_torch.geometry.brick import BrickGeometry as TBrick
from disco4est_tpu_torch.mesh.builder import (
    MeshData,
    build_mesh as tbuild,
    mesh_from_numpy,
)
from disco4est_tpu_torch.mesh.tree import Forest as TForest

TOL = 1e-13
FLOAT_FIELDS = (
    "xyz_lobatto", "xyz_quad", "j_quad", "wjgg", "face_xyz_lobatto",
    "face_xyz_quad", "face_sj", "face_n", "face_drst", "face_h", "volume",
    "area", "sigma", "j_c", "drdx_c", "wjgg_c", "face_sj_c", "face_n_c",
)
EXACT_FIELDS = ("deg_e", "nbr_elem", "nbr_face", "bnd_mask", "conf_mask")


def _pair(level, deg, x1=(1.0, 1.0, 1.0), **kw):
    jg, tg = JBrick(x1=x1, dim=3), TBrick(x1=x1, dim=3)
    jm = jbuild(jg, JForest.uniform(jg.conn, level), deg=deg, **kw)
    tm = tbuild(tg, TForest.uniform(tg.conn, level), deg=deg, device="cpu",
                **kw)
    return jm, tm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-300)


def _assert_mesh_matches(jm, tm):
    for name in FLOAT_FIELDS:
        t = getattr(tm, name)
        assert t.dtype == torch.float64, name
        err = _rel(t.numpy(), getattr(jm, name))
        assert err <= TOL, (name, err)
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
            err_msg=name,
        )
    for name in ("dim", "deg", "deg_quad", "affine", "orth", "iso",
                 "orient_codes", "n_elements", "local_nodes"):
        assert getattr(tm, name) == getattr(jm, name), name


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("deg", [1, 3, 7])
def test_build_mesh_matches_jax(level, deg):
    jm, tm = _pair(level, deg)
    _assert_mesh_matches(jm, tm)


@pytest.mark.parametrize("face_h_type", ["tree_h", "j_div_sj_min_lobatto"])
def test_build_mesh_penalty_modes_match_jax(face_h_type):
    jm, tm = _pair(1, 2, x1=(1.0, 2.0, 4.0), face_h_type=face_h_type,
                   penalty_fcn="meanp_sqr_over_meanh", deg_quad=3)
    _assert_mesh_matches(jm, tm)


def test_noncubic_brick_matches_jax():
    jm, tm = _pair(1, 2, x1=(1.0, 2.0, 4.0))
    assert not tm.iso and tm.orth
    _assert_mesh_matches(jm, tm)


def test_fields_and_norm_match_jax():
    jm, tm = _pair(2, 3)
    fj = jm.init_field(lambda x, y, z: jnp.sin(x) * jnp.cos(2 * y) + z)
    ft = tm.init_field(lambda x, y, z: torch.sin(x) * torch.cos(2 * y) + z)
    assert _rel(ft.numpy(), fj) <= TOL
    gj = jm.boundary_values(lambda x, y, z: x * y - z)
    gt = tm.boundary_values(lambda x, y, z: x * y - z)
    assert _rel(gt.numpy(), gj) <= TOL
    assert _rel(tm.l2_norm_sqr(ft).numpy(), jm.l2_norm_sqr(fj)) <= TOL

    from disco4est_tpu.io.norms import norm_L2 as jnorm
    from disco4est_tpu.laplacian.sipg import apply_mass as jmass
    from disco4est_tpu_torch.io.norms import norm_L2 as tnorm
    from disco4est_tpu_torch.laplacian.sipg import apply_mass as tmass

    assert abs(tnorm(tm, ft) - jnorm(jm, fj)) <= TOL * jnorm(jm, fj)
    assert _rel(tmass(tm, ft).numpy(), jmass(jm, fj)) <= TOL


def _jax_mesh_to_port(jm, device="cpu"):
    """The JAX MeshData's fields, carried across as numpy arrays."""
    arrays = {
        f: np.asarray(getattr(jm, f))
        for f in MeshData.__dataclass_fields__
        if hasattr(getattr(jm, f, None), "shape")
    }
    tg = TBrick(x0=tuple(jm.geom.x0), x1=tuple(jm.geom.x1), dim=3)
    meta = dict(
        dim=jm.dim, deg=jm.deg, deg_quad=jm.deg_quad, quad=jm.quad.kind,
        geom=tg, forest=TForest.uniform(tg.conn, int(jm.forest.level[0])),
        affine=jm.affine, orth=jm.orth, iso=jm.iso,
        orient_codes=jm.orient_codes,
    )
    return mesh_from_numpy(arrays, meta, device)


def test_mesh_from_numpy_carries_jax_mesh():
    jm, tm = _pair(1, 3)
    cm = _jax_mesh_to_port(jm)
    for name in FLOAT_FIELDS + EXACT_FIELDS:
        a, b = getattr(cm, name), getattr(tm, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=0,
                                   err_msg=name)
    assert cm.n_elements == tm.n_elements and cm.iso == tm.iso


def test_mesh_to_and_astype():
    _, tm = _pair(1, 2)
    m32 = tm.astype(torch.float32)
    assert m32.wjgg_c.dtype == torch.float32
    assert m32.nbr_elem.dtype == torch.int32 and m32.bnd_mask.dtype == torch.bool
    assert tm.wjgg_c.dtype == torch.float64  # the original is untouched
    assert tm.to("cpu").device.type == "cpu"


class _WarpedBox(Geometry):
    """A non-affine single-tree map, to exercise the autodiff Jacobian."""

    def __init__(self):
        from disco4est_tpu_torch.geometry.base import Connectivity

        self.dim = 3
        self.conn = Connectivity.single_tree(3)

    def x(self, tree, rst):
        r, s, t = rst[..., 0], rst[..., 1], rst[..., 2]
        return torch.stack([r + 0.1 * s * s, s + 0.2 * r * t, t * (1 + 0.1 * r)],
                           dim=-1)


def test_base_dx_is_forward_autodiff():
    rng = np.random.default_rng(3)
    rst = torch.as_tensor(rng.random((4, 5, 3)))
    tree = torch.zeros((4, 1), dtype=torch.int64)
    J = _WarpedBox().dx(tree, rst)
    r, s, t = rst[..., 0], rst[..., 1], rst[..., 2]
    # analytic ∂x_i/∂rst_j
    ref = torch.zeros(J.shape, dtype=torch.float64)
    ref[..., 0, 0] = 1.0
    ref[..., 0, 1] = 0.2 * s
    ref[..., 1, 0] = 0.2 * t
    ref[..., 1, 1] = 1.0
    ref[..., 1, 2] = 0.2 * r
    ref[..., 2, 0] = 0.1 * t
    ref[..., 2, 2] = 1 + 0.1 * r
    torch.testing.assert_close(J, ref, rtol=1e-14, atol=1e-14)

    # the brick's analytic Jacobian equals the base autodiff one
    brick = TBrick(x1=(1.0, 2.0, 4.0), n_trees_per_dim=(2, 1, 1), dim=3)
    tree = torch.as_tensor([[0], [1], [1], [0]])
    torch.testing.assert_close(brick.dx(tree, rst),
                               Geometry.dx(brick, tree, rst))


def test_unported_mesh_features_raise():
    """The two features this test once found refused (ROADMAP A11) are
    ported: the pointwise j_div_sj_quad penalty on a brick equals the JAX
    builder's (the sphere cases are in `tests/test_torch_sphere.py`), and
    compactified quadrature on a brick raises the JAX builder's
    ValueError, since a brick has no compactified shell."""
    jg, tg = JBrick(x1=(1.0, 2.0, 4.0), dim=3), TBrick(x1=(1.0, 2.0, 4.0),
                                                      dim=3)
    jm = jbuild(jg, JForest.uniform(jg.conn, 1), deg=2,
                face_h_type="j_div_sj_quad")
    tm = tbuild(tg, TForest.uniform(tg.conn, 1), deg=2,
                face_h_type="j_div_sj_quad", device="cpu")
    _assert_mesh_matches(jm, tm)
    assert _rel(tm.sigma_q.numpy(), jm.sigma_q) <= TOL
    with pytest.raises(ValueError, match="compactified"):
        tbuild(tg, TForest.uniform(tg.conn, 1), deg=2, compactified_k=2,
               device="cpu")


def test_face_tables_past_16_trees_match_lattice_search():
    """On an 18-tree brick the face table equals a brute-force neighbor
    search on the global lattice.  The JAX package packs the tree id above
    bit 60 of its leaf key, so trees 16 and 17 wrap onto trees 0 and 1 and
    its table differs here (ROADMAP C8); the port searches tree by tree."""
    from disco4est_tpu_torch.mesh.tree import ROOT

    level, trees = 1, (3, 3, 2)
    kw = dict(x1=(3.0, 3.0, 2.0), n_trees_per_dim=trees, dim=3)
    jg, tg = JBrick(**kw), TBrick(**kw)
    assert tg.conn.n_trees == 18
    jm = jbuild(jg, JForest.uniform(jg.conn, level), deg=1)
    tm = tbuild(tg, TForest.uniform(tg.conn, level), deg=1, device="cpu")
    forest = tm.forest
    coords = (np.asarray(tg.tree_origin)[forest.tree] * ROOT
              + forest.anchor) // (ROOT >> level)
    dims = np.asarray(trees) << level
    where = {tuple(c): e for e, c in enumerate(coords)}
    E = len(coords)
    nbr = np.tile(np.arange(E)[:, None], (1, 6))
    bnd = np.zeros((E, 6), bool)
    for e, c in enumerate(coords):
        for f in range(6):
            step = np.zeros(3, np.int64)
            step[f // 2] = 1 if f % 2 else -1
            n = c + step
            if np.all((n >= 0) & (n < dims)):
                nbr[e, f] = where[tuple(n)]
            else:
                bnd[e, f] = True
    np.testing.assert_array_equal(tm.nbr_elem.numpy(), nbr)
    np.testing.assert_array_equal(tm.bnd_mask.numpy(), bnd)
    interior = ~bnd
    face = np.tile(np.arange(6) ^ 1, (E, 1))
    np.testing.assert_array_equal(tm.nbr_face.numpy()[interior],
                                  face[interior])
    assert not np.array_equal(np.asarray(jm.nbr_elem), nbr)
