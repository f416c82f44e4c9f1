"""Port SIPG applies == the JAX package's.

- The port's f64 `_apply_orth` against JAX `apply_sipg_fast`: the same
  f64 operator with GEMMs summed in another order, held to 1e-13
  relative.
- The structured f32 apply (plain version on the CPU) against JAX
  `apply_structured(precision="f32", interpret=True)` and against the f64
  apply, to 5e-6 relative: the bound of `tests/test_structured.py`, set by
  f32 rounding over GEMMs of depth up to 1280.

The CUDA kernel itself is tested on the card by `test_torch_kernel.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.geometry.brick import BrickGeometry as JBrick
from disco4est_tpu.laplacian.fast import apply_sipg_fast as japply
from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch.geometry.brick import BrickGeometry as TBrick
from disco4est_tpu_torch.laplacian import structured as S
from disco4est_tpu_torch.laplacian.fast import _apply_orth
from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest

F64_TOL = 1e-13
F32_TOL = 5e-6
CASES = [(2, 1, (1.0, 1.0, 1.0)), (7, 1, (1.0, 1.0, 1.0)),
         (3, 2, (1.0, 1.0, 1.0)), (2, 1, (1.0, 2.0, 4.0))]


def _meshes(deg, level, x1, **kw):
    jg, tg = JBrick(x1=x1, dim=3, **kw), TBrick(x1=x1, dim=3, **kw)
    return (jbuild(jg, JForest.uniform(jg.conn, level), deg=deg),
            tbuild(tg, TForest.uniform(tg.conn, level), deg=deg,
                   device="cpu"))


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref))) / float(np.max(np.abs(ref)))


def _field(rng, E, deg):
    return rng.standard_normal((E,) + (deg + 1,) * 3)


@pytest.mark.parametrize("deg,level,x1", CASES)
def test_apply_orth_matches_jax(deg, level, x1):
    jm, tm = _meshes(deg, level, x1)
    rng = np.random.default_rng(deg + level)
    u = _field(rng, tm.n_elements, deg)
    g = rng.standard_normal((tm.n_elements, 6) + (deg + 1,) * 2)
    out = _apply_orth(tm, torch.as_tensor(u))
    assert out.dtype == torch.float64 and out.shape == u.shape
    assert _rel(out.numpy(), japply(jm, jnp.asarray(u))) <= F64_TOL
    out_g = _apply_orth(tm, torch.as_tensor(u), torch.as_tensor(g))
    ref_g = japply(jm, jnp.asarray(u), jnp.asarray(g))
    assert _rel(out_g.numpy(), ref_g) <= F64_TOL


def test_apply_orth_on_carried_jax_mesh():
    from test_torch_mesh import _jax_mesh_to_port

    jm, _ = _meshes(3, 1, (1.0, 1.0, 1.0))
    cm = _jax_mesh_to_port(jm)
    u = _field(np.random.default_rng(11), cm.n_elements, 3)
    out = _apply_orth(cm, torch.as_tensor(u))
    assert _rel(out.numpy(), japply(jm, jnp.asarray(u))) <= F64_TOL


@pytest.mark.parametrize("deg,level,x1", CASES)
def test_structured_plain_matches_jax(deg, level, x1):
    from disco4est_tpu.laplacian import structured as JS

    jm, tm = _meshes(deg, level, x1)
    jsb, tsb = JS.build_structured(jm), S.build_structured(tm)
    assert tsb.deltas == jsb.deltas and tsb.opp == jsb.opp
    assert tsb.nblk == jsb.nblk == (1 if x1 == (1.0, 1.0, 1.0) else 3)
    np.testing.assert_array_equal(tsb.perm.numpy(), np.asarray(jsb.perm))

    E = tm.n_elements
    u = _field(np.random.default_rng(deg + level), E, deg).astype(np.float32)
    ref64 = japply(jm, jnp.asarray(u, jnp.float64))

    u_lex = S.to_lex(tsb, torch.as_tensor(u).reshape(E, -1))
    before = S.KERNEL_LAUNCHES
    out = S.from_lex(tsb, S.apply_structured(tsb, u_lex)).reshape(u.shape)
    assert S.KERNEL_LAUNCHES == before  # CPU tensors never reach the kernel
    assert out.dtype == torch.float32
    assert _rel(out.numpy(), ref64) <= F32_TOL

    ju = JS.to_lex(jsb, jnp.asarray(u).reshape(E, -1))
    jout = JS.from_lex(
        jsb, JS.apply_structured(jsb, ju, precision="f32", interpret=True)
    ).reshape(u.shape)
    assert _rel(out.numpy(), jout) <= F32_TOL


def test_structured_takes_bricks_past_the_pallas_window():
    """z-stride 1024: the JAX builder refuses it (max_be = 512); the port,
    which has no trace window, takes it and stays the same operator.
    (A 4x4x1-tree brick at level 3: 32 x 32 x 8 cubic elements.)"""
    from disco4est_tpu.laplacian import structured as JS

    jm, tm = _meshes(1, 3, (4.0, 4.0, 1.0), n_trees_per_dim=(4, 4, 1))
    assert JS.build_structured(jm) is None
    sb = S.build_structured(tm)
    assert sb is not None and max(abs(d) for d in sb.deltas) == 1024
    E = tm.n_elements
    u = _field(np.random.default_rng(5), E, 1)
    ref = japply(jm, jnp.asarray(u))
    out = S.from_lex(sb, S.apply_structured(
        sb, S.to_lex(sb, torch.as_tensor(u, dtype=torch.float32).reshape(E, -1))
    )).reshape(u.shape)
    assert _rel(out.numpy(), ref) <= F32_TOL


def test_structured_refuses_what_jax_refuses():
    _, tm = _meshes(2, 1, (1.0, 1.0, 1.0))
    import dataclasses

    assert S.build_structured(dataclasses.replace(tm, orth=False)) is None
    forest = tm.forest
    mixed = dataclasses.replace(
        forest, level=np.where(np.arange(forest.n_elements) == 0,
                               forest.level + 1, forest.level).astype(np.int8)
    )
    assert S.build_structured(dataclasses.replace(tm, forest=mixed)) is None


def test_mixed_solve_with_structured_inner():
    """Port analog of `tests/test_structured.py:60`: the f64 solve whose
    inner f32 CG runs the structured apply equals plain f64 CG to 1e-10."""
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.solvers.cg import cg_solve
    from disco4est_tpu_torch.solvers.mixed import mixed_refine_solve

    geom = TBrick(dim=3)
    mesh = tbuild(geom, TForest.uniform(geom.conn, 1), deg=3, device="cpu")
    sb = S.build_structured(mesh)

    def u_exact(x, y, z):
        return torch.sin(np.pi * x) * torch.sin(np.pi * y) * torch.sin(
            np.pi * z)

    f = mesh.init_field(lambda x, y, z: 3 * np.pi**2 * u_exact(x, y, z))
    g = mesh.boundary_values(u_exact)
    rhs = build_rhs_with_strong_bc(mesh, f, g)
    x64 = cg_solve(lambda v: apply_sipg(mesh, v), rhs, atol=5e-15,
                   rtol=1e-13, max_iter=20000).x
    res = mixed_refine_solve(
        lambda v: apply_sipg(mesh, v), rhs,
        inner_solve=S.make_inner_solve(sb, rtol=1e-4),
        atol=5e-15, rtol=1e-12,
    )
    assert res.residual_norm < 1e-11
    rel = float(torch.linalg.norm((res.x - x64).reshape(-1))
                / torch.linalg.norm(x64.reshape(-1)))
    assert rel < 1e-10, rel


def test_wrappers_refuse_instead_of_falling_back():
    _, tm = _meshes(2, 1, (1.0, 1.0, 1.0))
    sb = S.build_structured(tm)
    E = tm.n_elements
    with pytest.raises(ValueError, match="device"):
        S.apply_structured(sb, torch.zeros(E, 27, device="meta"))
    u2 = torch.zeros(E, 27)
    with pytest.raises(ValueError, match="CUDA"):
        S.lex_apply_cuda(sb, u2, S.compute_traces_lex(sb, u2))


def test_structured_brick_moves_with_to():
    _, tm = _meshes(3, 1, (1.0, 1.0, 1.0))
    sb = S.build_structured(tm.to("cpu"))
    moved = sb.to("cpu")
    assert moved.deltas == sb.deltas and moved.W_lift.device.type == "cpu"
    u = torch.as_tensor(_field(np.random.default_rng(2), tm.n_elements, 3),
                        dtype=torch.float32).reshape(tm.n_elements, -1)
    torch.testing.assert_close(S.apply_structured(moved, u),
                               S.apply_structured(sb, u), rtol=0, atol=0)
