"""Port forest operations and AMR transfers == the JAX package's.

Tree operations are integer host programs, so the port's tree, level and
anchor arrays, leaf indices and lineage must EQUAL the JAX `Forest`'s on
bricks of at most 15 trees (where the JAX packed key does not wrap,
ROADMAP C8).  Field transfers are the same f64 contractions in another
order: 1e-13 (absolute, fields of unit size).  `p_balance_log` is integer
logic plus a product by gamma_p: exact.
"""

import numpy as np
import pytest
import torch

from disco4est_tpu.amr import amr as jamr
from disco4est_tpu.geometry.brick import BrickGeometry as JBrick
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch.amr import amr as tamr
from disco4est_tpu_torch.geometry.brick import BrickGeometry as TBrick
from disco4est_tpu_torch.mesh.tree import ROOT, Forest as TForest

from torch_threads import torch_worker_threads  # noqa: F401

TOL = 1e-13
# (trees per axis, dim, level, refined fraction, seed); at most 15 trees
CASES = [
    ((1, 1, 1), 3, 1, 0.2, 0),
    ((2, 2, 2), 3, 1, 0.15, 1),
    ((3, 3, 1), 3, 1, 0.1, 2),
    ((3, 1, 1), 2, 2, 0.3, 3),
]


def _pair(trees, dim):
    kw = dict(x1=tuple(float(t) for t in trees), n_trees_per_dim=trees,
              dim=dim)
    return JBrick(**kw), TBrick(**kw)


def _same(jf, tf):
    np.testing.assert_array_equal(tf.tree, jf.tree)
    np.testing.assert_array_equal(tf.level, jf.level)
    np.testing.assert_array_equal(tf.anchor, jf.anchor)


def _refined_pair(case, steps=2):
    """The same refine + balance sequence on both forests: `steps` rounds
    of random flags (the second round refines inside the first, so the
    balance cascades)."""
    trees, dim, level, frac, seed = case
    jg, tg = _pair(trees, dim)
    jf, tf = JForest.uniform(jg.conn, level), TForest.uniform(tg.conn, level)
    rng = np.random.default_rng(seed)
    history = [(jf, tf)]
    for _ in range(steps):
        flags = rng.random(jf.n_elements) < frac
        jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
        _same(jf, tf)
        history.append((jf, tf))
    return history


@pytest.mark.parametrize("case", CASES)
def test_refine_balance_coarsen_find_leaf_match_jax(case):
    history = _refined_pair(case)
    jf, tf = history[-1]
    assert len(set(tf.level.tolist())) > 1
    # refine without balance
    flags = np.random.default_rng(7).random(jf.n_elements) < 0.3
    _same(jf.refine(flags), tf.refine(flags))
    # coarsen: every family whose members are all flagged
    cflags = np.random.default_rng(8).random(jf.n_elements) < 0.8
    (jc, jmask), (tc, tmask) = jf.coarsen(cflags), tf.coarsen(cflags)
    _same(jc, tc)
    np.testing.assert_array_equal(tmask, jmask)
    assert tmask.any()
    # find_leaf of random lattice points in random trees
    rng = np.random.default_rng(9)
    pts = rng.integers(0, ROOT, (200, tf.dim))
    tr = rng.integers(0, tf.conn.n_trees, 200)
    np.testing.assert_array_equal(tf.find_leaf(tr, pts), jf.find_leaf(tr, pts))


@pytest.mark.parametrize("case", CASES)
def test_element_lineage_matches_jax(case):
    history = _refined_pair(case)
    (jf0, tf0), (jf2, tf2) = history[0], history[-1]
    for (jo, to), (jn, tn) in ((history[0], history[1]),
                               (history[0], history[2])):
        for a, b in zip(tamr.element_lineage(to, tn),
                        jamr.element_lineage(jo, jn)):
            np.testing.assert_array_equal(a, b)
    # two rounds of refinement from the uniform forest descend two levels
    assert tamr.element_lineage(tf0, tf2)[2].max() == 2


def _brute_force_balanced(forest, geom):
    """2:1 across faces, edges and corners, checked pair by pair on the
    global lattice (closed boxes that touch)."""
    lo = (np.asarray(geom.tree_origin)[forest.tree] * ROOT
          + forest.anchor).astype(np.int64)
    hi = lo + (ROOT >> forest.level.astype(np.int64))[:, None]
    touch = np.all((lo[:, None] <= hi[None]) & (lo[None] <= hi[:, None]),
                   axis=-1)
    jump = np.abs(forest.level[:, None].astype(int) - forest.level[None])
    return not np.any(touch & (jump > 1))


def test_balance_past_16_trees_is_2to1():
    """On an 18-tree brick the port's balance gives a 2:1 forest by a
    brute-force check.  The JAX package packs the tree id above bit 60 of
    its leaf key, so trees 16 and 17 wrap onto trees 0 and 1: its balance
    looks up wrong leaves there and differs (ROADMAP C8)."""
    trees = (3, 3, 2)
    jg, tg = _pair(trees, 3)
    tf, jf = TForest.uniform(tg.conn, 1), JForest.uniform(jg.conn, 1)
    # refine twice in a corner of tree 16, next to trees 7 and 13
    for _ in range(2):
        flags = (tf.tree == 16) & np.all(tf.anchor == 0, axis=1)
        tf, jf = tf.refine(flags), jf.refine(flags)
    tb, jb = tf.balance(), jf.balance()
    assert tg.conn.n_trees == 18
    assert _brute_force_balanced(tb, tg)
    assert not _brute_force_balanced(tf, tg)
    assert tb.n_elements != jb.n_elements or not np.array_equal(
        tb.anchor, jb.anchor)


def _fields(rng, E, nl, dim):
    return rng.standard_normal((E,) + (nl,) * dim)


@pytest.mark.parametrize("case", CASES)
def test_transfer_field_matches_jax(case):
    import jax.numpy as jnp

    history = _refined_pair(case)
    (jf0, tf0), (jf2, tf2) = history[0], history[-1]
    rng = np.random.default_rng(11)
    deg = 2
    u = _fields(rng, jf0.n_elements, deg + 1, jf0.dim)
    a = tamr.transfer_field(tf0, tf2, torch.as_tensor(u), deg).numpy()
    b = np.asarray(jamr.transfer_field(jf0, jf2, jnp.asarray(u), deg))
    assert np.max(np.abs(a - b)) <= TOL
    # one uniform-degree step: h-marks, refine, balance, transfer
    jf1, tf1 = history[1]
    log = np.where(rng.random(jf1.n_elements) < 0.2, -deg, deg)
    v = _fields(rng, jf1.n_elements, deg + 1, jf1.dim)
    jn, jv = jamr.amr_step(jf1, log, {"u": jnp.asarray(v)}, deg)
    tn, tv = tamr.amr_step(tf1, log, {"u": torch.as_tensor(v)}, deg)
    _same(jn, tn)
    assert np.max(np.abs(tv["u"].numpy() - np.asarray(jv["u"]))) <= TOL
    for d_old, d_new in ((2, 4), (4, 2)):
        v = _fields(rng, 5, d_old + 1, 3)
        a = tamr.transfer_field_p(torch.as_tensor(v), d_old, d_new, 3)
        b = jamr.transfer_field_p(jnp.asarray(v), d_old, d_new, 3)
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= TOL


@pytest.mark.parametrize("case", CASES[:2])
def test_amr_step_hp_matches_jax(case):
    import jax.numpy as jnp

    (jf, tf), = _refined_pair(case, steps=1)[-1:]
    rng = np.random.default_rng(12)
    E, dim, storage = jf.n_elements, jf.dim, 3
    deg_e = rng.integers(1, storage + 1, E)
    # h-refine, p-refine, p-coarsen and no-op marks
    log = np.where(rng.random(E) < 0.2, -deg_e,
                   np.clip(deg_e + rng.integers(-1, 2, E), 1, 4))
    u = _fields(rng, E, storage + 1, dim)
    out_t = tamr.amr_step_hp(tf, deg_e, log, {"u": torch.as_tensor(u)},
                             storage, 4)
    out_j = jamr.amr_step_hp(jf, deg_e, log, {"u": jnp.asarray(u)},
                             storage, 4)
    _same(out_j[0], out_t[0])
    np.testing.assert_array_equal(out_t[1], out_j[1])
    assert out_t[3] == out_j[3] == 4
    assert np.max(np.abs(out_t[2]["u"].numpy()
                         - np.asarray(out_j[2]["u"]))) <= TOL


def test_amr_step_hp_transfer_exact():
    """`tests/test_hp.py:157` through the port: h-refine + p-refine +
    balance carry a quadratic exactly (every new degree ≥ 2)."""
    from disco4est_tpu_torch.laplacian.hp import (
        prolong_padded,
        restrict_padded,
    )
    from disco4est_tpu_torch.mesh.builder import build_mesh

    geom = TBrick(dim=2)
    forest = TForest.uniform(geom.conn, 1)
    deg_e = np.array([2, 3, 2, 3])
    mesh = build_mesh(geom, forest, deg=3, deg_e=deg_e, device="cpu")
    u_fcn = lambda x, y: x**2 + 0.5 * y**2 - x * y
    u_own = restrict_padded(mesh.init_field(u_fcn), mesh.deg_e, 3, 2)
    log = np.array([-2, 4, 2, 3], np.int64)
    nf, nde, fields, nstor = tamr.amr_step_hp(forest, deg_e, log,
                                              {"u": u_own}, 3)
    assert nstor == 4 and nf.n_elements > forest.n_elements
    mesh2 = build_mesh(geom, nf, deg=nstor, deg_e=nde, device="cpu")
    u2 = prolong_padded(fields["u"], nde, nstor, 2)
    assert float((u2 - mesh2.init_field(u_fcn)).abs().max()) < 1e-11


def test_p_balance_log_matches_jax():
    """On a hanging mesh with degree jumps across conforming and mortar
    faces, with and without a predictor."""
    from disco4est_tpu.mesh.builder import build_mesh as jbuild
    from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild

    jg, tg = _pair((1, 1, 1), 3)
    jf, tf = JForest.uniform(jg.conn, 1), TForest.uniform(tg.conn, 1)
    flags = np.zeros(8, bool)
    flags[0] = True
    jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
    rng = np.random.default_rng(5)
    deg_e = rng.integers(1, 6, jf.n_elements)
    jm = jbuild(jg, jf, deg=5, deg_e=deg_e)
    tm = tbuild(tg, tf, deg=5, deg_e=deg_e, device="cpu")
    log = np.where(rng.random(len(deg_e)) < 0.3, -deg_e, deg_e)
    pred = rng.random(len(deg_e))
    for kw in ({}, dict(predictor=pred, gamma_p=0.1)):
        lt, pt = tamr.p_balance_log(tm, deg_e, log, 2, 6, **kw)
        lj, pj = jamr.p_balance_log(jm, deg_e, log, 2, 6, **kw)
        np.testing.assert_array_equal(lt, lj)
        assert (lt != log).any()
        if kw:
            np.testing.assert_array_equal(pt, pj)
