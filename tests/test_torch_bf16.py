"""The bf16 mode of the port's SIPG applies (ROADMAP B4) == the JAX
package's `precision="bf16"` kernels.

- The plain bf16 B1 (`structured.apply_structured(..., "bf16")` on the
  CPU) against JAX `apply_structured(precision="bf16", interpret=True)`,
  and the plain bf16 B2 (`fused.apply_sipg_fused(..., "bf16")`) against
  the same JAX B1 in lex order, at degrees 1, 2, 3 and 7 on four level-1
  bricks.  Both emulate the kernels' rounding points: bf16(u), bf16
  weights, bf16 traces rounded once from phase A's f32 product, bf16(Z),
  f32 sums.  Where cw is a power of two (extents (1, 1, 1) and (1, 2, 4))
  only the order of the f32 sums differs: 1e-5 relative max.  Elsewhere
  bf16(Z) may round the other way where XLA orders an f32 operation
  otherwise: 1e-3 relative max and 2e-4 relative L2 (the port forms t13
  with XLA CPU's fused multiply-add and measured at most 7e-7 relative
  max on every brick).
- C18: JAX's bf16 B2 reads its own traces recomputed in the kernel and the
  neighbor's from phase A, rounded differently off the TPU, so it differs
  from JAX's bf16 B1 by at least 5e-4 relative L2 (1.0e-3 to 1.8e-3
  at deg 2, 3, 7 on the level-1 unit cube); the port's B2 reads one
  trace array for both sides and equals its B1.
- The bf16 mixed solve (`make_inner_solve(precision="bf16")`) reaches the
  f32-inner solve's L2 at deg 2, level 2 to 1e-9 relative.
- Every entry point raises on an unknown precision; the bf16 pack's
  layout and read-back; the bf16 layout agrees with the kernels' `Cfg`.

The bf16 kernels themselves run on the card in `tests/test_torch_kernel.py`.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.geometry.brick import BrickGeometry as JBrick
from disco4est_tpu.laplacian import pallas_sipg as JP
from disco4est_tpu.laplacian import structured as JS
from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch.geometry.brick import BrickGeometry as TBrick
from disco4est_tpu_torch.laplacian import fused
from disco4est_tpu_torch.laplacian import structured as S
from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest
from disco4est_tpu_torch.util import gen_wgmma

POW2_BRICKS = [(1.0, 1.0, 1.0), (1.0, 2.0, 4.0)]
OTHER_BRICKS = [(1.0, 1.0, 3.0), (1.5, 1.0, 0.7)]
DEGREES = [1, 2, 3, 7]
POW2_MAX = 1e-5
OTHER_MAX, OTHER_L2 = 1e-3, 2e-4
C18_MIN_L2 = 5e-4
SOLVE_REL = 1e-9


def _jax_brick(tm):
    """The JAX `StructuredBrick` of the port mesh `tm`, from the port's
    lex tables (perm, offsets, cw, the per-face scalars; equal to JAX's
    own, `test_c18_*` checks it) and JAX's block size rule: the smallest
    power of two >= the largest offset that divides E.  Building the JAX
    mesh instead would cost ~1 s a case."""
    sb = S.build_structured(tm)
    E, maxd = sb.n_elements, max(abs(d) for d in sb.deltas)
    BE = next(be for be in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
              if E % be == 0 and be >= maxd)
    return JS.StructuredBrick(
        dim=3, deg=tm.deg, deg_quad=tm.deg_quad, quad_key=tm.quad.kind,
        iso=tm.iso, nblk=sb.nblk, BE=BE, deltas=sb.deltas, opp=sb.opp,
        perm=jnp.asarray(sb.perm.numpy(), jnp.int32),
        inv_perm=jnp.asarray(sb.inv_perm.numpy(), jnp.int32),
        **{k: jnp.asarray(getattr(sb, k).numpy())
           for k in ("cw_in", "scal", "drstn")})


@functools.lru_cache(maxsize=None)
def _case(deg, x1):
    """(port mesh, u [E, nv] f32 in the original order, JAX bf16 B1 of u
    in lex order); each JAX kernel runs once per case."""
    tg = TBrick(x1=x1, dim=3)
    tm = tbuild(tg, TForest.uniform(tg.conn, 1), deg=deg, device="cpu")
    u = np.random.default_rng(deg).standard_normal(
        (tm.n_elements, (deg + 1) ** 3)).astype(np.float32)
    jsb = _jax_brick(tm)
    jout = JS.apply_structured(jsb, JS.to_lex(jsb, jnp.asarray(u)),
                               precision="bf16", interpret=True)
    return tm, u, np.asarray(jout, np.float64)


def _rel(a, ref):
    """(relative max, relative L2) of a against ref."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return (float(np.abs(a - ref).max() / np.abs(ref).max()),
            float(np.linalg.norm(a - ref) / np.linalg.norm(ref)))


def _bounds_hold(rel, x1):
    rmax, rl2 = rel
    if x1 in POW2_BRICKS:
        return rmax <= POW2_MAX
    return rmax <= OTHER_MAX and rl2 <= OTHER_L2


def _b2_lex(tm, u):
    sb = S.build_structured(tm)
    out = fused.apply_sipg_fused(tm, torch.as_tensor(u), precision="bf16")
    return S.to_lex(sb, out).numpy()


@pytest.mark.parametrize("x1", POW2_BRICKS + OTHER_BRICKS)
@pytest.mark.parametrize("deg", DEGREES)
def test_plain_bf16_b1_matches_jax(deg, x1):
    tm, u, jout = _case(deg, x1)
    sb = S.build_structured(tm)
    before = S.KERNEL_LAUNCHES, S.KERNEL_LAUNCHES_BF16
    out = S.apply_structured(sb, S.to_lex(sb, torch.as_tensor(u)),
                             precision="bf16")
    assert (S.KERNEL_LAUNCHES, S.KERNEL_LAUNCHES_BF16) == before
    assert out.dtype == torch.float32
    rel = _rel(out.numpy(), jout)
    assert _bounds_hold(rel, x1), rel


@pytest.mark.parametrize("x1", POW2_BRICKS + OTHER_BRICKS)
@pytest.mark.parametrize("deg", DEGREES)
def test_plain_bf16_b2_matches_jax_b1(deg, x1):
    tm, u, jout = _case(deg, x1)
    before = fused.KERNEL_LAUNCHES_BF16
    rel = _rel(_b2_lex(tm, u), jout)
    assert fused.KERNEL_LAUNCHES_BF16 == before
    assert _bounds_hold(rel, x1), rel


@pytest.mark.parametrize("deg", [2, 3, 7])
def test_c18_jax_b2_differs_from_b1_and_the_port_does_not(deg):
    x1 = (1.0, 1.0, 1.0)
    tm, u, jout = _case(deg, x1)
    E, shape = tm.n_elements, (tm.n_elements,) + (deg + 1,) * 3
    jg = JBrick(x1=x1, dim=3)
    jm = jbuild(jg, JForest.uniform(jg.conn, 1), deg=deg)
    jsb = JS.build_structured(jm)
    mine = _jax_brick(tm)
    for k in ("BE", "deltas", "opp", "nblk", "deg_quad", "quad_key"):
        assert getattr(jsb, k) == getattr(mine, k), k
    for k in ("perm", "cw_in", "scal", "drstn"):
        np.testing.assert_array_equal(getattr(jsb, k), getattr(mine, k))
    jb2 = JS.to_lex(jsb, JP.apply_sipg_pallas(
        jm, jnp.asarray(u.reshape(shape)), precision="bf16",
        interpret=True).reshape(E, -1))
    assert _rel(jb2, jout)[1] >= C18_MIN_L2
    sb = S.build_structured(tm)
    b1 = S.apply_structured(sb, S.to_lex(sb, torch.as_tensor(u)),
                            precision="bf16").numpy()
    assert _rel(_b2_lex(tm, u), b1)[1] <= 1e-6


def test_bf16_inner_mixed_solve_reaches_the_f32_inner_l2():
    from disco4est_tpu_torch.io.norms import norm_L2
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.solvers.mixed import mixed_refine_solve

    geom = TBrick(dim=3)
    mesh = tbuild(geom, TForest.uniform(geom.conn, 2), deg=2, device="cpu")
    sb = S.build_structured(mesh)
    rhs = build_rhs_with_strong_bc(
        mesh, mesh.init_field(SinxProblem.rhs),
        mesh.boundary_values(SinxProblem.boundary))
    u_a = mesh.init_field(SinxProblem.analytic)
    l2, res = {}, {}
    for precision in ("f32", "bf16"):
        res[precision] = mixed_refine_solve(
            lambda v: apply_sipg(mesh, v), rhs,
            inner_solve=S.make_inner_solve(sb, rtol=1e-3, max_iter=400,
                                           precision=precision),
            atol=5e-15, rtol=1e-20, max_outer=60)
        l2[precision] = float(norm_L2(mesh, res[precision].x - u_a))
    bnorm = float(torch.linalg.norm(rhs.reshape(-1)))
    assert res["bf16"].residual_norm <= 1e-10 * (1.0 + bnorm)
    assert res["bf16"].outer_iterations < 60
    assert abs(l2["bf16"] - l2["f32"]) <= SOLVE_REL * l2["f32"], l2


def test_entry_points_raise_on_an_unknown_precision():
    tm, u, _ = _case(1, (1.0, 1.0, 1.0))
    sb = S.build_structured(tm)
    fm = fused.build_fused(tm)
    u_t = torch.as_tensor(u)
    calls = [
        lambda: S.apply_structured(sb, u_t, precision="fp16"),
        lambda: S.apply_structured_plain(sb, u_t, precision="bf"),
        lambda: S.make_inner_solve(sb, precision="f64"),
        lambda: S.compute_traces_lex(sb, u_t, "tf32"),
        lambda: fused.apply_fused(fm, u_t, precision="BF16"),
        lambda: fused.apply_sipg_fused(tm, u_t, precision=None),
        lambda: fused.fused_apply_plain(
            fm, u_t, fused.scaled_traces(u_t, fm.W_tr, fm.drstn), "half"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="precision"):
            call()
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_apply_cuda_bf16(
            fm, u_t, fused.scaled_traces(u_t, fm.W_tr, fm.drstn, "bf16"))
    with pytest.raises(ValueError, match="CUDA"):
        S.lex_apply_cuda_bf16(sb, u_t, S.compute_traces_lex(sb, u_t, "bf16"))


def _unpack_bf16(packed):
    """`pack_sipg_weights_bf16`'s result as B^T [NP, NCH·KC] in f64."""
    NCH, G, Q, _, _ = packed.shape
    return (packed.double().permute(1, 3, 0, 2, 4)
            .reshape(G * 8, NCH * Q * 8))


@pytest.mark.parametrize("deg,x1", [(d, (1.0, 1.0, 1.0)) for d in
                                    range(1, 8)] + [(2, (1.0, 2.0, 4.0))])
def test_bf16_pack_layout_and_read_back(deg, x1):
    tg = TBrick(x1=x1, dim=3)
    fm = fused.build_fused(tbuild(tg, TForest.uniform(tg.conn, 0), deg=deg,
                                  device="cpu"))
    assert fm._W_pack_bf16 is None  # built at first use only
    nv, nblk, tw = fm.nv, fm.nblk, fm.W_lift.shape[0]
    nvk = fused.sipg_block_k(nv, "bf16")
    assert nvk % fused.SIPG_KC == 0 and nv <= nvk < nv + fused.SIPG_KC
    NP, NCH = fused.sipg_layout(nv, nblk, tw, "bf16")
    assert NP == fused.sipg_layout(nv, nblk, tw)[0]
    assert NCH == -(-(nblk * nvk + tw) // fused.SIPG_KC)
    packed = fm.W_pack_bf16
    assert packed is fm.W_pack_bf16  # kept
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (NCH, NP // 8, fused.SIPG_KC // 8, 8, 8)
    Bt = _unpack_bf16(packed)
    assert not Bt[nv:].any()  # padded columns
    for b in range(nblk):  # each volume block, then its zero rows
        blk = Bt[:nv, b * nvk:(b + 1) * nvk].T
        torch.testing.assert_close(
            blk[:nv], fused.bf16_round(fm.W_vol[:, b * nv:(b + 1) * nv])
            .double(), rtol=0, atol=0)
        assert not blk[nv:].any()
    K = nblk * nvk + tw
    torch.testing.assert_close(Bt[:nv, nblk * nvk:K].T,
                               fused.bf16_round(fm.W_lift).double(),
                               rtol=0, atol=0)
    assert not Bt[:, K:].any()
    # the entry the kernel's tile_index_bf16 reads for (row n, column k)
    c, k = divmod(nblk * nvk + 3, fused.SIPG_KC)
    n = nv - 1
    flat = packed.reshape(NCH, -1)[c, ((n >> 3) * 2 + (k >> 3)) * 64
                                   + (n & 7) * 8 + (k & 7)]
    assert float(flat) == float(fused.bf16_round(fm.W_lift)[3, n])


@pytest.mark.parametrize("nl", range(2, 9))
def test_bf16_layout_matches_the_kernel_config(nl):
    """`Cfg<NL, NBLK, true>` of `sipg_gemm.cuh`: NVK = nv rounded up to 16,
    K = nblk·NVK + tw, the same NP and sub-block widths as f32 (so the
    generated k16 wrappers cover them)."""
    nv, tw = nl**3, 12 * nl * nl
    for nblk in (1, 3):
        NP, NCH = fused.sipg_layout(nv, nblk, tw, "bf16")
        assert NCH == -(-(nblk * (-(-nv // 16) * 16) + tw) // 16)
        wn = NP // 2 if nv > 256 else NP
        assert (wn // 2 if wn > 128 else wn) in gen_wgmma.WIDTHS
    assert "m64n8k16.f32.bf16.bf16" in gen_wgmma.render("bf16")
