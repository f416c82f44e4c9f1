"""Port estimator, statistics and smooth_pred marking == the JAX package's.

- `estimate_bi` on a hanging mixed-degree mesh (level 1, element 0
  refined and balanced, degrees 2-3 at storage 3), both volume-h options:
  1e-10 relative, the bound of the smooth_pred driver runs in
  `tests/test_torch_driver.py` (the same f64 sums in another order);
- `estimator_stats`, `percentile` and the per-region statistics: the
  sort, the max and the percentile exact, the total and the mean to
  1e-15 relative (XLA sums in another order than numpy);
- `smooth_pred_mark` and `transfer_predictor`, given the same η²: exact.
"""

import numpy as np
import pytest
import torch

from disco4est_tpu_torch.estimators import stats as tstats

from torch_threads import torch_worker_threads  # noqa: F401


@pytest.fixture(scope="module")
def hanging_mixed():
    from disco4est_tpu.geometry.brick import BrickGeometry as JBrick
    from disco4est_tpu.mesh.builder import build_mesh as jbuild
    from disco4est_tpu.mesh.tree import Forest as JForest
    from disco4est_tpu_torch.geometry.brick import BrickGeometry as TBrick
    from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
    from disco4est_tpu_torch.mesh.tree import Forest as TForest

    jg, tg = JBrick(dim=3), TBrick(dim=3)
    jf, tf = JForest.uniform(jg.conn, 1), TForest.uniform(tg.conn, 1)
    flags = np.zeros(8, bool)
    flags[0] = True
    jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
    deg_e = np.random.default_rng(3).integers(2, 4, jf.n_elements)
    jm = jbuild(jg, jf, deg=3, deg_e=deg_e)
    tm = tbuild(tg, tf, deg=3, deg_e=deg_e, device="cpu")
    return jm, tm, jf, tf, deg_e


@pytest.mark.parametrize("vol_h", ["cube_approx", "diam"])
def test_estimate_bi_matches_jax(hanging_mixed, vol_h):
    import jax.numpy as jnp

    from disco4est_tpu.estimators.bi import estimate_bi as jest
    from disco4est_tpu_torch.estimators.bi import estimate_bi as test_

    jm, tm, *_ = hanging_mixed
    assert tm.hc_elem.shape[0] > 0
    rng = np.random.default_rng(6)
    u = rng.standard_normal((tm.n_elements, 4, 4, 4))
    res = 1e-3 * rng.standard_normal(u.shape)
    g_fcn = lambda x, y, z: x * y - z
    a = test_(tm, torch.as_tensor(u), torch.as_tensor(res),
              g=tm.boundary_values(g_fcn), penalty_prefactor=2.0,
              vol_h=vol_h).numpy()
    b = np.asarray(jest(jm, jnp.asarray(u), jnp.asarray(res),
                        g=jm.boundary_values(g_fcn), penalty_prefactor=2.0,
                        vol_h=vol_h))
    assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b))


def test_stats_and_percentile_match_jax():
    from disco4est_tpu.estimators import stats as jstats

    eta2 = np.random.default_rng(7).random(101)
    st, sj = tstats.estimator_stats(eta2), jstats.estimator_stats(eta2)
    np.testing.assert_array_equal(st["sorted"], np.asarray(sj["sorted"]))
    assert st["max"] == float(sj["max"])
    for key in ("total", "mean"):
        assert abs(st[key] - float(sj[key])) <= 1e-15 * st[key], key
    for pct in (0.0, 5.0, 25.0, 50.0, 99.0, 100.0):
        assert tstats.percentile(st, pct) == float(jstats.percentile(sj, pct))
    regions = np.arange(101) % 3
    for a, b in zip(tstats.estimator_stats_per_region(eta2, regions, 3),
                    jstats.estimator_stats_per_region(eta2, regions, 3)):
        np.testing.assert_array_equal(a.pop("sorted"), b.pop("sorted"))
        assert a == b


def test_element_regions_match_jax(hanging_mixed):
    from disco4est_tpu.estimators import stats as jstats

    jm, tm, *_ = hanging_mixed
    np.testing.assert_array_equal(tstats.element_regions(tm),
                                  jstats.element_regions(jm))


def test_smooth_pred_mark_and_transfer_match_jax(hanging_mixed):
    from disco4est_tpu.amr import amr as jamr
    from disco4est_tpu.amr import smooth_pred as jsp
    from disco4est_tpu_torch.amr import amr as tamr
    from disco4est_tpu_torch.amr import smooth_pred as tsp

    _, _, jf, tf, deg_e = hanging_mixed
    E = len(deg_e)
    rng = np.random.default_rng(8)
    eta2 = rng.random(E)
    eta2[:4] = eta2[4]  # symmetric ties at the threshold's scale
    pred0 = 2.0 * rng.random(E)
    kw = dict(gamma_h=10.0, gamma_p=0.1, gamma_n=1.0, percentile=25.0,
              max_degree=4)
    tp, jp = tsp.SmoothPredParams(**kw), jsp.SmoothPredParams(**kw)
    for marker in ("percentile", "mean"):
        tp.marker = jp.marker = marker
        lt, pt = tsp.smooth_pred_mark(eta2, deg_e,
                                      tsp.SmoothPredState(pred0), tp, 3)
        lj, pj = jsp.smooth_pred_mark(eta2, deg_e,
                                      jsp.SmoothPredState(pred0), jp, 3)
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(pt, pj)
        assert (lt < 0).any() and (lt > deg_e).any()
    np.testing.assert_array_equal(
        tsp.SmoothPredState.fresh(E, tp).predictor,
        jsp.SmoothPredState.fresh(E, jp).predictor)
    # the marks through refine + balance, then the predictor transfer
    tn = tamr.refine_and_balance(tf, lt < 0)
    jn = jamr.refine_and_balance(jf, lj < 0)
    np.testing.assert_array_equal(
        tsp.transfer_predictor(tf, tn, pt, deg_e, tp, lt),
        jsp.transfer_predictor(jf, jn, pj, deg_e, jp, lj))
