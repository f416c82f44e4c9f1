"""Port host tables and tensor applies == the JAX package's.

The operator, quadrature and fused-layout tables are host numpy code in
both packages, so they must agree to 1e-15 (the same float64 arithmetic);
the tensor applies run the same f64 contractions in torch and jnp, held
to 1e-15 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.ops import tensor as jtensor
from disco4est_tpu.ops.operators import DB as JDB
from disco4est_tpu.quadrature.quadrature import Quadrature as JQuadrature
from disco4est_tpu_torch.ops import tensor as ttensor
from disco4est_tpu_torch.ops.operators import DB as TDB
from disco4est_tpu_torch.quadrature.quadrature import Quadrature as TQuadrature

TOL = 1e-15
DEGS = list(range(1, 8))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(1.0, float(np.max(np.abs(b))))
    err = float(np.max(np.abs(a - b))) / scale
    assert err <= tol, err


@pytest.mark.parametrize("deg", DEGS)
def test_operator_tables_match(deg):
    j, t = JDB.ops(deg), TDB.ops(deg)
    for name in ("lobatto_nodes", "lobatto_weights", "gauss_nodes",
                 "gauss_weights", "vandermonde", "mass", "inv_mass", "diff"):
        _close(getattr(t, name), getattr(j, name))
    pts = tuple(JDB.ops(deg + 1).gauss_nodes)
    _close(TDB.interp_to_points(deg, pts), JDB.interp_to_points(deg, pts))


@pytest.mark.parametrize("kind", ["legendre", "lobatto"])
@pytest.mark.parametrize("deg", DEGS)
def test_quadrature_matches(kind, deg):
    tq, jq = TQuadrature(kind), JQuadrature(kind)
    for dq in (deg, deg + 1):
        xt, wt = tq.nodes_weights(dq)
        xj, wj = jq.nodes_weights(dq)
        _close(xt, xj)
        _close(wt, wj)
        _close(tq.interp(deg, dq), jq.interp(deg, dq))


def test_tensor_applies_match():
    rng = np.random.default_rng(7)
    u = rng.standard_normal((5, 4, 4, 4))
    A = rng.standard_normal((3, 4))
    mats = [rng.standard_normal((4, 4)) for _ in range(3)]
    ut = torch.as_tensor(u)
    uj = jnp.asarray(u)
    for d in range(3):
        _close(ttensor.apply_axis(A, ut, d).numpy(),
               jtensor.apply_axis(A, uj, d))
    _close(ttensor.apply_iso(mats[0], ut, 3).numpy(),
           jtensor.apply_iso(mats[0], uj, 3))
    _close(ttensor.apply_tensor(mats, ut, 3).numpy(),
           jtensor.apply_tensor(mats, uj, 3))
    w = [rng.random(4), rng.random(4), rng.random(4)]
    tw = ttensor.tensor_weights(w)
    assert tw.dtype == torch.float64
    _close(tw.numpy(), jtensor.tensor_weights(w))
    for f in range(6):
        np.testing.assert_array_equal(
            ttensor.np_face_slice_indices(f, 3, 4),
            jtensor.np_face_slice_indices(f, 3, 4),
        )


@pytest.mark.parametrize("deg", DEGS)
@pytest.mark.parametrize("iso", [True, False])
def test_fused_and_orth_tables_match(deg, iso):
    from disco4est_tpu.laplacian import fast as jfast
    from disco4est_tpu.laplacian import pallas_sipg as jps
    from disco4est_tpu_torch.laplacian import fast as tfast
    from disco4est_tpu_torch.laplacian import fused as tfused

    jm = jps._mats(deg, deg, "legendre", 3, iso)
    tm = tfused._mats(deg, deg, "legendre", 3, iso)
    for k in ("W_vol", "W_tr", "W_lift"):
        _close(tm[k], jm[k])
    assert (tm["nblk"], tm["nv"], tm["nfl"]) == (jm["nblk"], jm["nv"],
                                                 jm["nfl"])
    jo = jfast._host_mats_orth(deg, deg, "legendre", 3, iso)
    to = tfast._host_mats_orth(deg, deg, "legendre", 3, iso)
    for k in ("W_vol", "W_tr", "W_lift", "Mf"):
        _close(to[k], jo[k])


def test_options_parse_like_jax():
    from disco4est_tpu.util.config import Options as JOptions
    from disco4est_tpu_torch.util.config import Options as TOptions

    text = "[a]\nx = 1 ; comment\ny = 2.5;\nflag = yes\n[b]\nname = brick\n"
    jo, to = JOptions.load(text), TOptions.load(text)
    assert to.get_int("a", "x") == jo.get_int("a", "x") == 1
    assert to.get_float("a", "y") == jo.get_float("a", "y") == 2.5
    assert to.get("a", "flag", cast=bool) is True
    assert to.section("b") == jo.section("b")
    with pytest.raises(KeyError):
        to.get("b", "missing", required=True)


@pytest.mark.parametrize("rule", ["gauss", "lobatto"])
def test_gauss_table(rule):
    """The shipped Gauss and Gauss-Lobatto rules (ROADMAP C9): within 64
    ulp of the JAX package's, which computes them with numpy at run time
    (numpy 2.0.2 and 2.3.5 differ by up to 33 ulp), exact for polynomials
    of degree 2n - 1 (Gauss) or 2n - 3 (Gauss-Lobatto), and what
    `util/gen_gauss.py` writes under the numpy version the table names."""
    from disco4est_tpu.ops import lgl as jlgl
    from disco4est_tpu_torch.ops import gauss_table, lgl
    from disco4est_tpu_torch.util import gen_gauss

    fn = f"{rule}_nodes_weights"
    first, exact_to = (1, 1) if rule == "gauss" else (2, 3)
    for n in range(first, gauss_table.MAX_NODES + 1):
        x, w = getattr(lgl, fn)(n)
        xj, wj = getattr(jlgl, fn)(n)
        for a, b in ((x, xj), (w, wj)):
            assert np.all(np.abs(a - b) <= 64 * np.spacing(np.abs(b))), n
        k = np.arange(2 * n - exact_to + 1)
        exact = np.where(k % 2 == 0, 2.0 / (k + 1), 0.0)
        err = (w[:, None] * x[:, None] ** k).sum(axis=0) - exact
        assert np.max(np.abs(err)) <= 1e-14, n
    with pytest.raises(ValueError, match="gen_gauss"):
        getattr(lgl, fn)(gauss_table.MAX_NODES + 1)
    if f"numpy\n{np.__version__}." in gen_gauss.OUT.read_text():
        assert gen_gauss.render() == gen_gauss.OUT.read_text()
