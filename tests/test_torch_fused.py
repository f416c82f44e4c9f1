"""Port fused SIPG apply (`laplacian/fused.py`) == the JAX `pallas_sipg.py`.

- `compute_traces` against JAX `compute_traces` in f64, to 1e-12
  relative: the same GEMM and scaling, summed in another order.
- `apply_sipg_fused` (its plain version, on the CPU) against
  `apply_sipg_pallas(precision="f32", interpret=True)` and against the f64
  JAX `apply_sipg_fast`, to 5e-6 relative: the f32 bound of
  `tests/test_pallas_sipg.py`, set by f32 rounding over GEMMs of depth up
  to 1280.  Besides that file's meshes, a (2, 2, 1)- and a (3, 1, 1)-tree
  brick, whose elements are not in lex order.
- `fused_path_available` against `pallas_path_available` on those meshes.

The CUDA kernel itself is tested on the card by `test_torch_kernel.py`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.geometry.brick import BrickGeometry as JBrick
from disco4est_tpu.laplacian import pallas_sipg as JP
from disco4est_tpu.laplacian.fast import apply_sipg_fast as japply
from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch.geometry.brick import BrickGeometry as TBrick
from disco4est_tpu_torch.laplacian import fused
from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest

from torch_threads import torch_worker_threads  # noqa: F401

F64_TOL = 1e-12
F32_TOL = 5e-6
# (deg, level, x1, trees per axis): `tests/test_pallas_sipg.py:23,41`,
# then two multi-tree bricks
CASES = [
    (2, 1, (1.0, 1.0, 1.0), (1, 1, 1)),
    (3, 1, (1.0, 1.0, 1.0), (1, 1, 1)),
    (7, 1, (1.0, 1.0, 1.0), (1, 1, 1)),
    (3, 1, (2.0, 1.0, 0.5), (1, 1, 1)),
    (2, 1, (2.0, 2.0, 1.0), (2, 2, 1)),
    (3, 1, (3.0, 1.0, 1.0), (3, 1, 1)),
]


def _meshes(deg, level, x1, trees):
    kw = dict(x1=x1, n_trees_per_dim=trees, dim=3)
    jg, tg = JBrick(**kw), TBrick(**kw)
    return (jbuild(jg, JForest.uniform(jg.conn, level), deg=deg),
            tbuild(tg, TForest.uniform(tg.conn, level), deg=deg,
                   device="cpu"))


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref))) / float(np.max(np.abs(ref)))


def _field(seed, E, deg):
    return np.random.default_rng(seed).standard_normal((E,) + (deg + 1,) * 3)


@pytest.mark.parametrize("deg,level,x1,trees", CASES[:4])
def test_compute_traces_matches_jax(deg, level, x1, trees):
    jm, tm = _meshes(deg, level, x1, trees)
    u = _field(deg, tm.n_elements, deg)
    out = fused.compute_traces(tm, torch.as_tensor(u))
    ref = JP.compute_traces(jm, jnp.asarray(u))
    assert out.dtype == torch.float64 and out.shape == ref.shape
    assert _rel(out.numpy(), ref) <= F64_TOL


@pytest.mark.parametrize("deg,level,x1,trees", CASES)
def test_fused_plain_matches_jax(deg, level, x1, trees):
    jm, tm = _meshes(deg, level, x1, trees)
    u = _field(deg + level, tm.n_elements, deg).astype(np.float32)
    before = fused.KERNEL_LAUNCHES
    out = fused.apply_sipg_fused(tm, torch.as_tensor(u))
    assert fused.KERNEL_LAUNCHES == before  # CPU tensors never reach it
    assert out.dtype == torch.float32 and out.shape == u.shape
    ref64 = japply(jm, jnp.asarray(u, jnp.float64))
    assert _rel(out.numpy(), ref64) <= F32_TOL
    jout = JP.apply_sipg_pallas(jm, jnp.asarray(u), precision="f32",
                                interpret=True)
    assert _rel(out.numpy(), jout) <= F32_TOL


@pytest.mark.parametrize("deg,level,x1,trees", [CASES[0], CASES[3],
                                                CASES[5]])
@pytest.mark.parametrize("edit", [{}, {"orth": False}, {"deg": 0}])
def test_fused_gate_matches_jax(deg, level, x1, trees, edit):
    jm, tm = _meshes(deg, level, x1, trees)
    jm, tm = dataclasses.replace(jm, **edit), dataclasses.replace(tm, **edit)
    g = np.zeros((tm.n_elements, 6) + (deg + 1,) * 2)
    for gj, gt in ((None, None), (jnp.asarray(g), torch.as_tensor(g))):
        assert (fused.fused_path_available(tm, gt)
                == JP.pallas_path_available(jm, gj))
    assert fused.fused_path_available(tm, None) == (edit == {})


def test_fused_refuses_instead_of_falling_back():
    _, tm = _meshes(2, 1, (1.0, 1.0, 1.0), (1, 1, 1))
    with pytest.raises(ValueError, match="orthogonal"):
        fused.build_fused(dataclasses.replace(tm, orth=False))
    fm = fused.build_fused(tm)
    with pytest.raises(ValueError, match="device"):
        fused.apply_fused(fm, torch.zeros(8, 27, device="meta"))
    u2 = torch.zeros(8, 27)
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_apply_cuda(
            fm, u2, fused.scaled_traces(u2, fm.W_tr, fm.drstn))


def test_structured_and_fused_share_one_operator():
    """B1 and B2 are the same fused pass with another neighbor lookup: on
    a uniform brick their plain versions agree to f32 rounding."""
    from disco4est_tpu_torch.laplacian import structured as S

    _, tm = _meshes(3, 2, (1.0, 1.0, 1.0), (1, 1, 1))
    sb = S.build_structured(tm)
    E = tm.n_elements
    u = torch.as_tensor(_field(4, E, 3), dtype=torch.float32).reshape(E, -1)
    via_lex = S.from_lex(sb, S.apply_structured(sb, S.to_lex(sb, u)))
    assert _rel(fused.apply_sipg_fused(tm, u).numpy(), via_lex.numpy()) \
        <= F32_TOL
