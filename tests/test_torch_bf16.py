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
  layout, read back through the kernels' tile index and through their
  matrix descriptors (no swizzle: 128-byte leading, 512-byte stride
  offsets, k16 steps 256 bytes apart); the bf16 layout agrees with the
  kernels' `CfgBf16`.
- The bf16 kernels' order of summation, in plain torch: the chunks of a
  volume block summed on in one f32 accumulator, scaled by cw after the
  block (by cw[b] / cw[b+1] where block b + 1 follows), the face chunks
  added into the same sum, at deg 1-7 and nblk 1 and 3 (and two units of
  half the chunks each, added, at deg 7), meets the plain bf16 version
  within 1e-6 relative L2: the per-chunk restart of the f32 kernels buys
  nothing at the bf16 bound of 2e-4.

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

from torch_threads import torch_worker_threads  # noqa: F401

POW2_BRICKS = [(1.0, 1.0, 1.0), (1.0, 2.0, 4.0)]
OTHER_BRICKS = [(1.0, 1.0, 3.0), (1.5, 1.0, 0.7)]
DEGREES = [1, 2, 3, 7]
POW2_MAX = 1e-5
OTHER_MAX, OTHER_L2 = 1e-3, 2e-4
C18_MIN_L2 = 5e-4
SOLVE_REL = 1e-9
ORDER_L2 = 1e-6


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


# the kernels' matrix descriptors of a bf16 chunk tile (`tile_desc_bf16`):
# no swizzle, bytes between the two core matrices of a k16 step (leading
# byte offset), between row groups (stride byte offset), between k16 steps
DESC_LBO, DESC_SBO, DESC_STEP = 128, 16 * fused.SIPG_KC_BF16, 256


def _read_through_descriptor(chunk_bytes, rows):
    """A [rows, KC] bf16 tile as a k16 product reads it from the bytes of
    one chunk: step j, row group g, core matrix h (K columns 8h..8h+7 of
    the step) at j·STEP + g·SBO + h·LBO, its row r at 16·r, lane i at
    2·i."""
    out = torch.empty((rows, fused.SIPG_KC_BF16), dtype=torch.float64)
    words = chunk_bytes.view(torch.bfloat16).double()
    for j in range(fused.SIPG_KC_BF16 // 16):
        for g in range(rows // 8):
            for h in range(2):
                at = (j * DESC_STEP + g * DESC_SBO + h * DESC_LBO) // 2
                core = words[at:at + 64].reshape(8, 8)
                out[8 * g:8 * g + 8, 16 * j + 8 * h:16 * j + 8 * h + 8] = core
    return out


@pytest.mark.parametrize("deg,x1", [(d, (1.0, 1.0, 1.0)) for d in
                                    range(1, 8)] + [(2, (1.0, 2.0, 4.0))])
def test_bf16_pack_layout_and_read_back(deg, x1):
    tg = TBrick(x1=x1, dim=3)
    fm = fused.build_fused(tbuild(tg, TForest.uniform(tg.conn, 0), deg=deg,
                                  device="cpu"))
    assert fm._W_pack_bf16 is None  # built at first use only
    nv, nblk, tw = fm.nv, fm.nblk, fm.W_lift.shape[0]
    KC = fused.SIPG_KC_BF16
    nvk = fused.sipg_block_k(nv, "bf16")
    assert nvk % KC == 0 and nv <= nvk < nv + KC
    NP, NCH = fused.sipg_layout(nv, nblk, tw, "bf16")
    assert NP == fused.sipg_layout(nv, nblk, tw)[0]
    assert NCH == -(-(nblk * nvk + tw) // KC)
    packed = fm.W_pack_bf16
    assert packed is fm.W_pack_bf16  # kept
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert fused.sipg_chunk_k("bf16") == KC
    assert tuple(packed.shape) == (NCH, NP // 8, KC // 8, 8, 8)
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
    c, k = divmod(nblk * nvk + 3, KC)
    n = nv - 1
    flat = packed.reshape(NCH, -1)[c, ((n >> 3) * (KC // 8) + (k >> 3)) * 64
                                   + (n & 7) * 8 + (k & 7)]
    assert float(flat) == float(fused.bf16_round(fm.W_lift)[3, n])
    # every chunk read back through the descriptors, and its two halves (a
    # cluster's CTAs each stage one) whole 16-byte units
    raw = packed.reshape(NCH, -1).contiguous().view(torch.uint8)
    assert raw.shape[1] == NP * 2 * KC and raw.shape[1] % 32 == 0
    for c in range(NCH):
        torch.testing.assert_close(_read_through_descriptor(raw[c], NP),
                                   Bt[:, c * KC:(c + 1) * KC],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("nl", range(2, 9))
def test_bf16_layout_matches_the_kernel_config(nl):
    """`Cfg<NL, NBLK, true>` of `sipg_gemm.cuh`: NVK = nv rounded up to 16,
    K = nblk·NVK + tw, the same NP and sub-block widths as f32 (so the
    generated k16 wrappers cover them)."""
    nv, tw = nl**3, 12 * nl * nl
    for nblk in (1, 3):
        NP, NCH = fused.sipg_layout(nv, nblk, tw, "bf16")
        assert NCH == -(-(nblk * (-(-nv // 32) * 32) + tw) // 32)
        wn = NP // 2 if nv > 256 else NP
        assert (wn // 2 if wn > 128 else wn) in gen_wgmma.WIDTHS
    assert "m64n8k16.f32.bf16.bf16" in gen_wgmma.render("bf16")


def _kernel_order_bf16(fm, u, tr, splits=1):
    """The bf16 kernels' sum in plain torch: the generated A (bf16(u) in
    each volume block padded to whole chunks, bf16(Z)) times the packed B,
    chunk by chunk into one f32 accumulator; at the end of volume block b
    the accumulator times cw[b], or cw[b] / cw[b+1] where block b + 1
    follows in the unit; with `splits` = 2 two units of half the chunks
    each, added."""
    E, nv, nblk = fm.n_elements, fm.nv, fm.nblk
    KC, nvk = fused.SIPG_KC_BF16, fused.sipg_block_k(nv, "bf16")
    B = _unpack_bf16(fm.W_pack_bf16).float().T  # [NCH·KC, NP]
    A = torch.zeros((E, B.shape[0]))
    ub = fused.bf16_round(u)
    for b in range(nblk):
        A[:, b * nvk:b * nvk + nv] = ub
    Z = fused.bf16_round(fused.face_terms(tr.float(), fused.gather_rows(
        fm, tr).float(), fm.scal, "bf16"))
    A[:, nblk * nvk:nblk * nvk + Z.shape[1]] = Z
    cw = fm.cw_in.float()
    nch = B.shape[0] // KC
    ncu = nch // splits
    total = torch.zeros((E, B.shape[1]))
    for unit in range(splits):
        acc = torch.zeros_like(total)
        for c in range(unit * ncu, (unit + 1) * ncu):
            k = slice(c * KC, (c + 1) * KC)
            acc = acc + A[:, k] @ B[k]
            b, last = divmod(c, nvk // KC)
            end = c == (unit + 1) * ncu - 1
            if b < nblk and (last == nvk // KC - 1 or end):
                fac = cw[:, b]
                if last == nvk // KC - 1 and not end and b + 1 < nblk:
                    fac = fac / cw[:, b + 1]
                acc = acc * fac[:, None]
        total = total + acc
    return total[:, :nv]


@pytest.mark.parametrize("nblk,x1,splits",
                         [(1, (1.0, 1.0, 1.0), 1), (3, (1.5, 1.0, 0.7), 1)])
@pytest.mark.parametrize("deg", range(1, 8))
def test_bf16_kernel_order_meets_the_plain_version(deg, nblk, x1, splits):
    _check_kernel_order(deg, nblk, x1, splits)


@pytest.mark.parametrize("nblk,x1", [(1, (1.0, 1.0, 1.0)),
                                     (3, (1.5, 1.0, 0.7))])
def test_bf16_kernel_order_in_two_units_meets_the_plain_version(nblk, x1):
    _check_kernel_order(7, nblk, x1, 2)


def _check_kernel_order(deg, nblk, x1, splits):
    tg = TBrick(x1=x1, dim=3)
    fm = fused.build_fused(tbuild(tg, TForest.uniform(tg.conn, 1), deg=deg,
                                  device="cpu"))
    assert fm.nblk == nblk
    u = torch.as_tensor(np.random.default_rng(100 + deg).standard_normal(
        (fm.n_elements, fm.nv)), dtype=torch.float32)
    tr = fused.scaled_traces(u, fm.W_tr, fm.drstn, "bf16")
    mine = _kernel_order_bf16(fm, u, tr, splits)
    ref = fused.fused_apply_plain(fm, u, tr, "bf16")
    assert _rel(mine.numpy(), ref.numpy())[1] <= ORDER_L2
