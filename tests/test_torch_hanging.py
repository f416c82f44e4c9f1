"""Port hanging-face mortars == the JAX package's and the reference's.

- The builder's mortar tables and factors against the JAX builder: index
  tables equal, f64 factors to 1e-13 relative (the same formulas).
- `apply_sipg` on the oracle's hanging mesh against the JAX apply to 1e-12
  relative, and the dense mortar pass of `fast._apply_orth` against the
  legacy [M, K] row pass (`tests/test_hanging.py:130`) to 1e-13.
- The reference's own dense-assembled matrices
  (`tests/data/hm_*.txt.gz`, see `tests/test_hanging_oracle.py`) through
  the port, entry by entry to the 1e-13 that test asserts, for the three
  scalar face_h_type variants and the pointwise J_DIV_SJ_QUAD one.
- The f32 cast of a hanging mesh applies within 1e-6 of f64.
"""

import dataclasses
import gzip
import pathlib

import numpy as np
import pytest
import torch

from disco4est_tpu_torch.geometry.brick import BrickGeometry as TBrick
from disco4est_tpu_torch.laplacian import fast
from disco4est_tpu_torch.laplacian.sipg import apply_sipg
from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import ROOT, Forest as TForest

DATA = pathlib.Path(__file__).resolve().parent / "data"
P4EST_ROOT = 1 << 30
SCALAR_VARIANTS = {
    "TREE_H": "tree_h",
    "VOLUME_DIV_AREA": "volume_div_area",
    "J_DIV_SJ_MIN_LOBATTO": "j_div_sj_min_lobatto",
}
INDEX_FIELDS = ("hc_elem", "hc_face", "hc_fine", "hc_fine_face",
                "hang_code", "conf_mask", "bnd_mask", "nbr_elem", "nbr_face")
FLOAT_FIELDS = ("hc_sj", "hc_n", "hc_drst_m", "hc_sigma", "hang_sigma",
                "sigma", "face_h")
# the oracle mesh of `tests/test_hanging_oracle.py:61`
ORACLE_KW = dict(deg=2, deg_quad=2, penalty_prefactor=10.0,
                 penalty_fcn="maxp_sqr_over_minh")


def _forests(dim, level, refine):
    from disco4est_tpu.geometry.brick import BrickGeometry as JBrick
    from disco4est_tpu.mesh.tree import Forest as JForest

    jg, tg = JBrick(dim=dim), TBrick(dim=dim)
    jf, tf = JForest.uniform(jg.conn, level), TForest.uniform(tg.conn, level)
    flags = np.arange(jf.n_elements) < refine
    return jg, jf.refine(flags).balance(), tg, tf.refine(flags).balance()


def _pair(dim, level, refine, **kw):
    from disco4est_tpu.mesh.builder import build_mesh as jbuild

    jg, jf, tg, tf = _forests(dim, level, refine)
    return jbuild(jg, jf, **kw), tbuild(tg, tf, device="cpu", **kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("face_h_type", sorted(SCALAR_VARIANTS.values()))
def test_mortar_tables_match_jax(face_h_type):
    jm, tm = _pair(3, 1, 1, face_h_type=face_h_type, **ORACLE_KW)
    assert tm.hc_elem.shape[0] > 0
    for name in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    for name in FLOAT_FIELDS:
        assert getattr(tm, name).dtype == torch.float64
        assert _rel(getattr(tm, name).numpy(), getattr(jm, name)) <= 1e-13


@pytest.mark.parametrize("dim,level,deg", [(2, 2, 4), (3, 2, 3), (3, 1, 2)])
def test_hanging_apply_matches_jax_dense_and_legacy(dim, level, deg):
    import jax.numpy as jnp

    from disco4est_tpu.laplacian.sipg import apply_sipg as japply

    jm, tm = _pair(dim, level, 5, deg=deg)
    assert tm.hang_code is not None
    u = np.random.default_rng(3).standard_normal(
        (tm.n_elements,) + (deg + 1,) * dim)
    ref = np.asarray(japply(jm, jnp.asarray(u)))
    dense = fast.apply_sipg_fast(tm, torch.as_tensor(u)).numpy()
    legacy_mesh = dataclasses.replace(tm, hang_code=None, hang_sigma=None)
    assert fast.fast_path_available(legacy_mesh, "full", None)
    legacy = fast.apply_sipg_fast(legacy_mesh, torch.as_tensor(u)).numpy()
    assert _rel(dense, ref) <= 1e-12
    assert _rel(legacy, ref) <= 1e-12
    assert _rel(dense, legacy) <= 1e-13


def _load_oracle(variant):
    with gzip.open(DATA / f"hm_{variant}.txt.gz", "rt") as f:
        tok = f.readline().split()
        assert tok[0] == "ELEMENTS"
        elems = [[int(x) for x in f.readline().split()]
                 for _ in range(int(tok[1]))]
        N = int(f.readline().split()[1])
        assert f.readline().strip() == "MATRIX"
        data = np.array(f.read().split(), np.float64)
    return np.array(elems), data.reshape(N, N)


def _oracle_mesh(face_h_type):
    geom = TBrick(x0=(0, 0, 0), x1=(1, 1, 1), dim=3)
    forest = TForest.uniform(geom.conn, 1)
    flags = np.zeros(forest.n_elements, bool)
    flags[0] = True
    forest = forest.refine(flags).balance()
    return forest, tbuild(geom, forest, face_h_type=face_h_type,
                          device="cpu", **ORACLE_KW)


@pytest.mark.parametrize("variant", sorted(SCALAR_VARIANTS))
def test_hanging_matrix_matches_reference(variant):
    _assert_matches_oracle(variant, *_oracle_mesh(SCALAR_VARIANTS[variant]))


def _assert_matches_oracle(variant, forest, mesh):
    elems, A_ref = _load_oracle(variant)
    # element correspondence by (tree, anchor); oracle anchors in
    # P4EST_ROOT units, ours in tree.ROOT units
    scale = P4EST_ROOT // ROOT
    ours = {
        (int(forest.tree[e]),) + tuple(int(a) * scale
                                       for a in forest.anchor[e]): e
        for e in range(forest.n_elements)
    }
    perm = [ours[tuple(int(x) for x in r[1:5])] for r in elems]
    E, n = mesh.n_elements, (mesh.deg + 1) ** 3
    N = E * n
    eye = torch.eye(N, dtype=torch.float64)
    A = torch.stack([apply_sipg(mesh, eye[j].reshape(E, 3, 3, 3)).reshape(-1)
                     for j in range(N)], dim=1).numpy()
    idx = np.concatenate([np.arange(p * n, (p + 1) * n) for p in perm])
    A = A[np.ix_(idx, idx)]
    scale_m = np.abs(A_ref).max()
    assert np.abs(A - A_ref).max() < 1e-13 * scale_m
    assert np.abs(A - A.T).max() < 1e-13 * scale_m


def test_pointwise_penalty_variant_raises():
    """The pointwise J_DIV_SJ_QUAD variant, which the port refused until
    ROADMAP A11, now builds: the reference's dense matrix through the
    port, entry by entry to 1e-13 as `tests/test_hanging_oracle.py`
    asserts, with the mortar-sized-quadrant penalty `hc_sigma_q`."""
    assert (DATA / "hm_J_DIV_SJ_QUAD.txt.gz").exists()
    forest, mesh = _oracle_mesh("j_div_sj_quad")
    assert mesh.sigma_q is not None and mesh.hc_sigma_q is not None
    _assert_matches_oracle("J_DIV_SJ_QUAD", forest, mesh)


def test_f32_hanging_mesh_applies_within_1e6():
    _, tm = _pair(3, 2, 5, deg=3)
    m32 = tm.astype(torch.float32)
    for name in ("hc_sj", "hc_n", "hc_drst_m", "hc_sigma", "hang_sigma"):
        assert getattr(m32, name).dtype == torch.float32, name
    assert m32.hang_code.dtype == torch.int32
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (tm.n_elements, 4, 4, 4)))
    a64 = apply_sipg(tm, u)
    a32 = apply_sipg(m32, u.float())
    assert a32.dtype == torch.float32
    assert _rel(a32.double().numpy(), a64.numpy()) <= 1e-6
