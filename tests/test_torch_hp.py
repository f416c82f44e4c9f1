"""Port hp embedding (`laplacian/hp.py`) == the JAX package's.

One dim-3 hanging mesh (level 1, element 0 refined and 2:1 balanced, 15
elements) with random per-element degrees in [2, 3] at storage degree 3,
built by both packages.  Every operator is an f64 contraction of the same
tables in another order: 1e-12 relative to the result's largest entry.
The hp operator restricted to the true coefficient slots must also be
symmetric and positive definite (`tests/test_hp.py:79`).
"""

import numpy as np
import pytest
import torch

TOL = 1e-12


@pytest.fixture(scope="module")
def meshes():
    import jax.numpy as jnp

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
    assert set(deg_e.tolist()) == {2, 3}
    jm = jbuild(jg, jf, deg=3, deg_e=deg_e)
    tm = tbuild(tg, tf, deg=3, deg_e=deg_e, device="cpu")
    assert tm.hc_elem.shape[0] > 0
    rng = np.random.default_rng(4)
    u = rng.standard_normal((tm.n_elements, 4, 4, 4))
    return jm, tm, jnp.asarray(u), torch.as_tensor(u)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


U_FCN = (lambda x, y, z: x * x - 2.0 * y * z + 0.5 * z + 1.0)


@pytest.mark.parametrize("name", [
    "to_max", "adjoint_to_own", "restrict_to_own",
    "adjoint_restrict_to_storage", "apply_sipg_hp", "apply_mass_hp",
    "residual_own_embedded",
])
def test_mesh_operators_match_jax(meshes, name):
    from disco4est_tpu.laplacian import hp as jhp
    from disco4est_tpu_torch.laplacian import hp as thp

    jm, tm, uj, ut = meshes
    assert _rel(getattr(thp, name)(tm, ut).numpy(),
                getattr(jhp, name)(jm, uj)) <= TOL


def test_padded_ops_and_mask_match_jax(meshes):
    from disco4est_tpu.laplacian import hp as jhp
    from disco4est_tpu_torch.laplacian import hp as thp

    jm, tm, uj, ut = meshes
    deg_e = tm.deg_e.numpy()
    for fn in ("prolong_padded", "restrict_padded"):
        assert _rel(getattr(thp, fn)(ut, deg_e, 3, 3).numpy(),
                    getattr(jhp, fn)(uj, deg_e, 3, 3)) <= TOL
    np.testing.assert_array_equal(thp.own_mask(tm).numpy(),
                                  np.asarray(jhp.own_mask(jm)))


def test_rhs_and_own_degree_norms_match_jax(meshes):
    import jax.numpy as jnp

    from disco4est_tpu.laplacian import hp as jhp
    from disco4est_tpu_torch.laplacian import hp as thp

    jm, tm, uj, ut = meshes
    fj = jm.init_field(lambda x, y, z: jnp.sin(x) + y * z)
    gj = jm.boundary_values(U_FCN)
    ft = tm.init_field(lambda x, y, z: torch.sin(x) + y * z)
    gt = tm.boundary_values(U_FCN)
    assert _rel(thp.build_rhs_with_strong_bc_hp(tm, ft, gt).numpy(),
                jhp.build_rhs_with_strong_bc_hp(jm, fj, gj)) <= TOL
    assert _rel(thp.init_field_own(tm, U_FCN).numpy(),
                jhp.init_field_own(jm, U_FCN)) <= TOL
    assert _rel(thp.l2_norm_sqr_own(tm, ut).numpy(),
                jhp.l2_norm_sqr_own(jm, uj)) <= TOL
    a = float(thp.norm_L2_interp_abs_own(tm, thp.to_max(tm, ut), U_FCN))
    b = float(jhp.norm_L2_interp_abs_own(jm, jhp.to_max(jm, uj), U_FCN))
    assert abs(a - b) <= TOL * b


def test_hp_operator_symmetric_spd(meshes):
    from disco4est_tpu_torch.laplacian.hp import apply_sipg_hp, own_mask

    _, tm, _, ut = meshes
    n = ut.numel()
    cols = []
    for i in range(n):
        e = torch.zeros(n, dtype=torch.float64)
        e[i] = 1.0
        cols.append(apply_sipg_hp(tm, e.reshape(ut.shape)).reshape(-1))
    A = torch.stack(cols, dim=1).numpy()
    slots = np.where(own_mask(tm).reshape(-1).numpy() > 0.5)[0]
    pad = np.setdiff1d(np.arange(n), slots)
    assert np.max(np.abs(A[pad])) == 0.0 and np.max(np.abs(A[:, pad])) == 0.0
    A = A[np.ix_(slots, slots)]
    assert np.max(np.abs(A - A.T)) < 1e-11 * np.max(np.abs(A))
    assert np.linalg.eigvalsh(0.5 * (A + A.T)).min() > 0
