"""The compact mesh (`build_mesh(..., store_full=False)`), the staged
GEMM-form apply (`fast.apply_staged`), `io.norms.norm_energy` and the
`ops` helpers of the port, against the JAX package (f64, CPU):

- a compact mesh keeps the fields JAX's keeps, equal to them to 1e-14
  relative, and leaves None where JAX does;
- on a compact mesh `l2_norm_sqr`, the f64 GEMM-form apply (conforming
  and hanging) and the plain versions of B1 and B2 equal the same on the
  full mesh bit for bit: the port sums the compact volume and areas as
  the full builder does, so σ is the same;
- each refusal raises where JAX's raises, with its exception type;
- each prefix of `apply_staged` equals JAX's to 1e-13 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.geometry.brick import BrickGeometry as JBrick
from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch.geometry.brick import BrickGeometry as TBrick
from disco4est_tpu_torch.mesh import builder as TB
from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest

from torch_threads import torch_worker_threads  # noqa: F401

TOL = 1e-14
STAGE_TOL = 1e-13
KEPT = ("j_c", "drdx_c", "wjgg_c", "face_sj_c", "face_n_c", "volume",
        "area", "face_h", "sigma")


def _forests(level, refine=0, x1=(1.0, 1.0, 1.0)):
    jg, tg = JBrick(x1=x1, dim=3), TBrick(x1=x1, dim=3)
    jf, tf = JForest.uniform(jg.conn, level), TForest.uniform(tg.conn, level)
    if refine:
        flags = np.arange(jf.n_elements) < refine
        jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
    return jg, jf, tg, tf


def _pair(level, deg, refine=0, x1=(1.0, 1.0, 1.0), **kw):
    jg, jf, tg, tf = _forests(level, refine, x1)
    return (jbuild(jg, jf, deg=deg, **kw),
            tbuild(tg, tf, deg=deg, device="cpu", **kw))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              1e-300)


def _field(seed, mesh, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    shape = (mesh.n_elements,) + (mesh.nl,) * mesh.dim
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)


@pytest.mark.parametrize("deg,level,x1", [
    (2, 1, (1.0, 1.0, 1.0)), (2, 2, (1.0, 2.0, 4.0)),
    (3, 1, (1.0, 2.0, 4.0)), (3, 2, (1.0, 1.0, 1.0)),
])
def test_compact_fields_match_jax(deg, level, x1):
    jm, tm = _pair(level, deg, x1=x1, store_full=False)
    for name in TB._FULL_FIELDS:
        assert getattr(jm, name) is None, name
        assert getattr(tm, name) is None, name
    for name in KEPT:
        err = _rel(getattr(tm, name).numpy(), getattr(jm, name))
        assert err <= TOL, (name, err)
    for name in ("nbr_elem", "nbr_face", "bnd_mask", "conf_mask", "deg_e"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    for name in ("affine", "orth", "iso", "orient_codes", "n_elements"):
        assert getattr(tm, name) == getattr(jm, name), name


@pytest.mark.parametrize("deg,level,x1", [
    (2, 2, (1.0, 1.0, 1.0)), (3, 2, (1.0, 2.0, 4.0)), (7, 1, (1.0, 1.0, 1.0)),
])
def test_compact_mesh_applies_equal_the_full_mesh(deg, level, x1):
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.laplacian import structured as S
    from disco4est_tpu_torch.laplacian.fast import _apply_orth

    _, _, tg, tf = _forests(level, x1=x1)
    full = tbuild(tg, tf, deg=deg, device="cpu")
    comp = tbuild(tg, tf, deg=deg, device="cpu", store_full=False)
    for name in ("volume", "area", "face_h", "sigma"):
        assert torch.equal(getattr(comp, name), getattr(full, name)), name
    u = _field(1, full)
    assert torch.equal(comp.l2_norm_sqr(u), full.l2_norm_sqr(u))
    assert torch.equal(_apply_orth(comp, u), _apply_orth(full, u))
    u32 = u.float()
    assert torch.equal(fused.apply_sipg_fused(comp, u32),
                       fused.apply_sipg_fused(full, u32))
    sb_c, sb_f = S.build_structured(comp), S.build_structured(full)
    assert torch.equal(S.apply_structured(sb_c, S.to_lex(sb_c, u32)),
                       S.apply_structured(sb_f, S.to_lex(sb_f, u32)))


def test_compact_hanging_brick_takes_the_gemm_form():
    """A compact 2:1 brick runs the GEMM form's dense mortar pass, equal
    to the full mesh's apply and to JAX's on its compact mesh."""
    from disco4est_tpu.laplacian.sipg import apply_sipg as japply
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg

    jm, comp = _pair(1, 2, refine=3, store_full=False)
    assert comp.hc_elem.shape[0] > 0 and comp.hang_code is not None
    _, _, tg, tf = _forests(1, refine=3)
    full = tbuild(tg, tf, deg=2, device="cpu")
    u = _field(2, full)
    got = apply_sipg(comp, u)
    assert torch.equal(got, apply_sipg(full, u))
    assert _rel(got.numpy(), japply(jm, jnp.asarray(u.numpy()))) <= 1e-13


def _refusal(case, pkg):
    """Run refusal `case` in package `pkg` ("jax" or "torch")."""
    if pkg == "jax":
        from disco4est_tpu.estimators.bi import estimate_bi
        from disco4est_tpu.geometry.cubed_sphere import CubedSphereGeometry
        from disco4est_tpu.laplacian.sipg import apply_sipg
        Brick, Forest, build = JBrick, JForest, jbuild
        kw, asarray = {}, jnp.asarray
    else:
        from disco4est_tpu_torch.estimators.bi import estimate_bi
        from disco4est_tpu_torch.geometry.cubed_sphere import (
            CubedSphereGeometry,
        )
        from disco4est_tpu_torch.laplacian.sipg import apply_sipg
        Brick, Forest, build = TBrick, TForest, tbuild
        kw, asarray = dict(device="cpu"), torch.as_tensor
    if case == "curved":
        geom = CubedSphereGeometry("7tree", R0=1.0, R1=2.0)
        build(geom, Forest.uniform(geom.conn, 0), deg=1, store_full=False,
              **kw)
        return
    geom = Brick(dim=3)
    forest = Forest.uniform(geom.conn, 1)
    if case in ("j_div_sj_min_lobatto", "j_div_sj_quad"):
        build(geom, forest, deg=1, store_full=False, face_h_type=case, **kw)
        return
    if case == "compactified_k":
        build(geom, forest, deg=1, store_full=False, compactified_k=2, **kw)
        return
    if case == "hanging_apply":
        forest = forest.refine(np.arange(8) < 1).balance()
    mesh = build(geom, forest, deg=1, store_full=False, **kw)
    one = lambda x, y, z: x  # noqa: E731
    u = asarray(np.ones((mesh.n_elements, 2, 2, 2)))
    if case == "hanging_apply":
        # off the GEMM form (no neighbors): the general mortar pass
        apply_sipg(mesh, u, neighbors="zero")
    elif case == "estimate_bi":
        estimate_bi(mesh, u, u)
    else:
        getattr(mesh, case)(one)


@pytest.mark.parametrize("case,exc", [
    ("curved", ValueError),
    ("j_div_sj_min_lobatto", ValueError),
    ("compactified_k", ValueError),
    ("j_div_sj_quad", ValueError),
    ("init_field", ValueError),
    ("init_field_on_quad", ValueError),
    ("boundary_values", ValueError),
    ("boundary_values_quad", ValueError),
    ("hanging_apply", NotImplementedError),
    # JAX's estimator reads the missing positions and fails on None
    # (AttributeError); the port refuses with the `require_full` message
    ("estimate_bi", AttributeError),
])
def test_compact_mesh_refuses_where_jax_refuses(case, exc):
    with pytest.raises(exc) as jax_err:
        _refusal(case, "jax")
    with pytest.raises(ValueError if case == "estimate_bi" else exc) as err:
        _refusal(case, "torch")
    if case != "estimate_bi":
        assert type(err.value) is type(jax_err.value)
        assert str(err.value) == str(jax_err.value)
    else:
        assert "store_full=False" in str(err.value)


def test_compact_mesh_refuses_vtk(tmp_path):
    from disco4est_tpu_torch.io.vtk import write_vtu

    _, _, tg, tf = _forests(1)
    mesh = tbuild(tg, tf, deg=1, device="cpu", store_full=False)
    with pytest.raises(ValueError, match="store_full=False"):
        write_vtu(str(tmp_path / "m.vtu"), mesh)


@pytest.mark.parametrize("upto", ["volume", "trace+gather", "full"])
@pytest.mark.parametrize("deg", [1, 3, 7])
def test_apply_staged_matches_jax(deg, upto):
    from disco4est_tpu.laplacian.fast import apply_staged as japply_staged
    from disco4est_tpu_torch.laplacian.fast import _apply_orth, apply_staged

    jm, tm = _pair(1, deg, x1=(1.0, 2.0, 4.0))
    u = _field(3, tm)
    got = apply_staged(tm, u, upto)
    ref = np.asarray(japply_staged(jm, jnp.asarray(u.numpy()), upto))
    assert _rel(got.numpy(), ref) <= STAGE_TOL
    if upto == "full":
        assert torch.equal(got, _apply_orth(tm, u))


def test_apply_staged_refuses_an_unknown_stage():
    from disco4est_tpu_torch.laplacian.fast import apply_staged

    _, tm = _pair(1, 1)
    with pytest.raises(ValueError, match="stage"):
        apply_staged(tm, _field(0, tm), "lift")


def test_norm_energy_matches_jax():
    from disco4est_tpu.io.norms import norm_energy as jnorm
    from disco4est_tpu.laplacian.sipg import apply_sipg as japply
    from disco4est_tpu_torch.io.norms import norm_energy
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg

    jm, tm = _pair(2, 2, x1=(1.0, 2.0, 4.0))
    e = _field(4, tm)
    got = norm_energy(tm, e, apply_sipg)
    ref = jnorm(jm, jnp.asarray(e.numpy()), japply)
    assert abs(got - ref) <= 1e-13 * ref


@pytest.mark.parametrize("dim", [2, 3])
def test_ops_helpers_match_jax(dim):
    from disco4est_tpu.ops import lgl as jlgl
    from disco4est_tpu.ops import tensor as jtensor
    from disco4est_tpu.ops.operators import DB as JDB
    from disco4est_tpu_torch.ops import lgl, tensor

    for deg in (1, 2, 5):
        assert lgl.n_volume_nodes(dim, deg) == jlgl.n_volume_nodes(dim, deg)
        assert lgl.n_face_nodes(dim, deg) == jlgl.n_face_nodes(dim, deg)
        D = np.asarray(JDB.ops(deg).diff)
        u = np.random.default_rng(deg).standard_normal((3,) + (deg + 1,) * dim)
        got = tensor.grad(torch.as_tensor(D), torch.as_tensor(u), dim)
        ref = np.asarray(jtensor.grad(jnp.asarray(D), jnp.asarray(u), dim))
        assert got.shape == ref.shape
        assert _rel(got.numpy(), ref) <= 1e-15
    for face in range(2 * dim):
        assert tensor.face_normal_sign(face) == jtensor.face_normal_sign(face)
