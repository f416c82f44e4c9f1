"""Fixed-order accumulation (ROADMAP C10) == the `index_add` it replaced
and the JAX package (f64, CPU).

`index_add` on a CUDA tensor runs as atomics, so its order of summation,
and with it the rounding, changed from run to run at three sites: the
crossing faces of the tree-structured curved apply, the mortar rows of
the hanging-face pass (`sipg._lift_rows`) and the mortar terms of the bi
estimator.  Each now sums an element's rows in a fixed order.  Held
here:

- `add_face_rows` against `index_add` on seeded rows, elements with
  several rows among them, to 1e-13;
- the curved apply on a 7-tree sphere, whose corner elements have up to
  three crossing faces (their rows now written into the face terms
  before the one lift GEMM), against JAX's one-hot product and the
  general apply, to 1e-13;
- the general apply and `estimate_bi` on an adapted 7-tree sphere, whose
  mortars cross reoriented tree faces and some of whose elements have
  several mortar rows, against the `index_add` accumulation and JAX, to
  1e-13.

The card's bit-for-bit repeatability is held in
`tests/test_torch_kernel.py` and `chip_smoke.py` phase 10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.geometry.cubed_sphere import CubedSphereGeometry as JSphere
from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch.estimators import bi
from disco4est_tpu_torch.geometry.cubed_sphere import (
    CubedSphereGeometry as TSphere,
)
from disco4est_tpu_torch.laplacian import curved, sipg
from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest
from disco4est_tpu_torch.laplacian.sipg import apply_sipg
from disco4est_tpu_torch.ops.rows import add_face_rows

SPHERE7 = dict(kind="7tree", R0=1.0, R1=2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the tier-1 run shares
    the host's cores among its workers, and spinning OpenMP threads then
    take most of the time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _index_add_face_rows(out, rows, elem, face, nfaces):
    return out.index_add(0, elem.long(), rows)


def test_face_rows_match_index_add():
    rng = np.random.default_rng(1)
    E = 50
    pairs = rng.choice(E * 6, 120, replace=False)  # distinct (e, f)
    e, f = torch.as_tensor(pairs // 6), torch.as_tensor(pairs % 6)
    assert np.bincount(pairs // 6).max() > 2
    rows = torch.as_tensor(rng.standard_normal((120, 3, 4)))
    out0 = torch.as_tensor(rng.standard_normal((E, 3, 4)))
    ref = out0.index_add(0, e, rows)
    assert _rel(add_face_rows(out0, rows, e, f, 6), ref) <= 1e-13


def _pair(level, deg, refine=(), **kw):
    jg, tg = JSphere(**SPHERE7), TSphere(**SPHERE7)
    jf, tf = JForest.uniform(jg.conn, level), TForest.uniform(tg.conn, level)
    if refine:
        flags = np.zeros(jf.n_elements, bool)
        flags[list(refine)] = True
        jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
    return (jbuild(jg, jf, deg=deg, **kw),
            tbuild(tg, tf, deg=deg, device="cpu", **kw))


def test_curved_crossing_faces_match_jax_and_general():
    from disco4est_tpu.laplacian import curved as jc

    jm, tm = _pair(1, 2, face_h_type="j_div_sj_quad")
    ts, jts = curved.build_tree_structured(tm), jc.build_tree_structured(jm)
    it_elem = ts.it_elem.numpy()
    assert np.bincount(it_elem[it_elem < tm.n_elements]).max() == 3
    assert len(np.unique(ts.it_row.numpy())) == ts.n_crossing
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (tm.n_elements, 3, 3, 3)))
    out = curved.from_lex(ts, curved.apply_tree_structured(
        ts, curved.permute_mesh_lex(ts, tm), curved.to_lex(ts, u)))
    jout = jc.from_lex(jts, jc.apply_tree_structured(
        jts, jc.permute_mesh_lex(jts, jm), jc.to_lex(jts, jnp.asarray(
            u.numpy()))))
    assert _rel(out, jout) <= 1e-13
    assert _rel(out, apply_sipg(tm, u, volume_mode="tensor")) <= 1e-13


@pytest.fixture(scope="module")
def adapted():
    return _pair(1, 2, refine=(0, 5, 13, 50), face_h_type="j_div_sj_quad")


def test_mortar_rows_match_index_add_and_jax(adapted, monkeypatch):
    from disco4est_tpu.laplacian.sipg import apply_sipg as japply

    jm, tm = adapted
    M = tm.hc_elem.shape[0]
    assert M > 0
    # some elements receive several coarse rows, some several fine rows
    assert np.bincount(tm.hc_elem.numpy()).max() > 1
    assert np.bincount(tm.hc_fine.numpy().reshape(-1)).max() > 1
    u = np.random.default_rng(4).standard_normal((tm.n_elements, 3, 3, 3))
    out = sipg.apply_sipg(tm, torch.as_tensor(u))
    assert _rel(out, japply(jm, jnp.asarray(u))) <= 1e-13
    monkeypatch.setattr(sipg, "add_face_rows", _index_add_face_rows)
    assert _rel(out, sipg.apply_sipg(tm, torch.as_tensor(u))) <= 1e-13


def test_estimator_mortar_terms_match_index_add_and_jax(adapted,
                                                        monkeypatch):
    from disco4est_tpu.estimators.bi import estimate_bi as jest

    jm, tm = adapted
    rng = np.random.default_rng(5)
    u = rng.standard_normal((tm.n_elements, 3, 3, 3))
    res = 1e-3 * rng.standard_normal(u.shape)
    g_fcn = lambda x, y, z: x * y - z
    eta2 = bi.estimate_bi(tm, torch.as_tensor(u), torch.as_tensor(res),
                          g=tm.boundary_values(g_fcn))
    ref = jest(jm, jnp.asarray(u), jnp.asarray(res),
               g=jm.boundary_values(g_fcn))
    assert _rel(eta2, ref) <= 1e-13
    monkeypatch.setattr(bi, "add_face_rows", _index_add_face_rows)
    old = bi.estimate_bi(tm, torch.as_tensor(u), torch.as_tensor(res),
                         g=tm.boundary_values(g_fcn))
    assert _rel(eta2, old) <= 1e-13
