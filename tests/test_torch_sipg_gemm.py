"""The host half of the split-TF32 SIPG kernels (`csrc/sipg_gemm.cuh`).

- `fused.pack_sipg_weights`: B = [W_vol ; W_lift] split into TF32 hi and
  lo, K-major, padded and cut into K chunks.  hi + lo reproduces every
  entry of B to 2^-21 relative (each part keeps 11 significant bits, so
  the remainder is below 2^-22 of the entry); the padding is zero; the
  packed array reads back as W_vol and W_lift.
- `_split_tf32_pass` here: the fused pass with the operands rounded as
  the kernels round them (`fused.split_tf32`, cvt.rna to TF32), products
  exact.  With the
  three products it matches the f64 apply (`_apply_orth` of the port and
  the JAX `apply_sipg_fast`) to 5e-6 relative, the kernels' bound, at
  degrees 1-7 and on an nblk-3 brick.  With one TF32 product it misses
  that bound by orders at degree 7: the tolerance has teeth.
- The committed `csrc/wgmma_tf32.cuh` and `csrc/wgmma_bf16.cuh` are what
  `util/gen_wgmma.py` writes, and `fused.sipg_layout` agrees with the
  kernels' `Cfg`.

The kernels themselves run on the card in `tests/test_torch_kernel.py`.
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
from disco4est_tpu_torch.laplacian import fused
from disco4est_tpu_torch.laplacian.fast import _apply_orth
from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest
from disco4est_tpu_torch.util import gen_wgmma

from torch_threads import torch_worker_threads  # noqa: F401

REL_TOL = 5e-6
PART_TOL = 2.0**-21
# (deg, x1): degrees 1-7 on the unit cube (nblk 1) and an nblk-3 brick
CASES = [(d, (1.0, 1.0, 1.0)) for d in range(1, 8)] + [(2, (1.0, 2.0, 4.0))]
# per nl = 2..8, the padded columns and K chunks of `Cfg` in sipg_gemm.cuh
# (nblk 1): NP = nv rounded up to 8, or to 16 when a warpgroup's columns
# are cut in two sub-blocks (nv > 128); NCH = ceil((nv + 12 nl^2) / 16)
LAYOUT = {2: (8, 4), 3: (32, 9), 4: (64, 16), 5: (128, 27), 6: (224, 41),
          7: (352, 59), 8: (512, 80)}


def _meshes(deg, x1, level=1):
    jg, tg = JBrick(x1=x1, dim=3), TBrick(x1=x1, dim=3)
    return (jbuild(jg, JForest.uniform(jg.conn, level), deg=deg),
            tbuild(tg, TForest.uniform(tg.conn, level), deg=deg,
                   device="cpu"))


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref))) / float(np.max(np.abs(ref)))


def _unpack(packed, nv):
    """The two parts of `pack_sipg_weights`'s result, each as B^T [NP,
    NCH·KC] in f64."""
    NCH, _, G, Q, _, _ = packed.shape
    return [packed[:, i].double().permute(1, 3, 0, 2, 4)
            .reshape(G * 8, NCH * Q * 4) for i in (0, 1)]


def _split_tf32_pass(fm, u2, tr, products=3):
    """The fused pass as the kernels round it: the generated operand A =
    [cw_b ⊙ u per volume block | Z] and B split into TF32 hi and lo, then
    a_hi·b_hi + a_hi·b_lo + a_lo·b_hi (or a_hi·b_hi alone), each product
    exact and summed in f64."""
    nblk = fm.nblk
    Z = fused.face_terms(tr, fused.gather_rows(fm, tr), fm.scal)
    A = torch.cat([fm.cw_in[:, b][:, None] * u2 for b in range(nblk)] + [Z],
                  dim=1)
    a_hi, a_lo = (p.double() for p in fused.split_tf32(A))
    b_hi, b_lo = (p[:fm.nv, :A.shape[1]].T for p in _unpack(fm.W_pack, fm.nv))
    out = a_hi @ b_hi
    if products == 3:
        out = out + a_hi @ b_lo + a_lo @ b_hi
    return out


@pytest.mark.parametrize("deg,x1", CASES)
def test_pack_splits_and_reads_back(deg, x1):
    _, tm = _meshes(deg, x1)
    fm = fused.build_fused(tm)
    nv, nblk, tw = fm.nv, fm.nblk, fm.W_lift.shape[0]
    NP, NCH = fused.sipg_layout(nv, nblk, tw)
    packed = fm.W_pack
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert tuple(packed.shape) == (NCH, 2, NP // 8, fused.SIPG_KC // 4, 8, 4)
    # both parts are TF32 values: the 13 low mantissa bits are zero
    assert not (packed.view(torch.int32) & 0x1FFF).any()
    Bt = sum(_unpack(packed, nv))  # hi + lo, as B^T
    B = fused.sipg_b(fm.W_vol, fm.W_lift, nblk).double()
    K = B.shape[0]
    assert torch.all((Bt[:nv, :K].T - B).abs() <= PART_TOL * B.abs())
    assert not Bt[nv:].any() and not Bt[:, K:].any()  # the padding
    # read back: the volume blocks side by side, then the lift rows
    back = Bt[:nv, :K].T
    W_vol = torch.cat([back[b * nv:(b + 1) * nv] for b in range(nblk)], 1)
    assert _rel(W_vol, fm.W_vol) <= PART_TOL
    assert _rel(back[nblk * nv:], fm.W_lift) <= PART_TOL


def test_tf32_round_is_round_to_nearest_ties_away():
    one_ulp = 2.0**-10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0**-23, 1.0 + 3 * one_ulp / 2,
                      0.0], dtype=torch.float32)
    want = [1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + 2 * one_ulp,
            0.0]
    assert fused.tf32_round(x).tolist() == want
    hi, lo = fused.split_tf32(torch.tensor([np.pi], dtype=torch.float32))
    assert abs(float(hi) + float(lo) - float(np.float32(np.pi))) \
        <= 2.0**-22 * np.pi


@pytest.mark.parametrize("deg,x1", CASES)
def test_split_tf32_pass_matches_f64(deg, x1):
    jm, tm = _meshes(deg, x1)
    fm = fused.build_fused(tm)
    E = tm.n_elements
    u = np.random.default_rng(deg).standard_normal((E, fm.nv))
    u2 = torch.as_tensor(u, dtype=torch.float32)
    out = _split_tf32_pass(fm, u2, fused.scaled_traces(u2, fm.W_tr, fm.drstn))
    shape = (E,) + (deg + 1,) * 3
    ref = _apply_orth(tm, u2.double().reshape(shape)).reshape(E, -1)
    assert _rel(out, ref) <= REL_TOL
    jref = japply(jm, jnp.asarray(u2.double().numpy().reshape(shape)))
    assert _rel(out, np.asarray(jref).reshape(E, -1)) <= REL_TOL


def test_one_tf32_product_misses_the_bound():
    _, tm = _meshes(7, (1.0, 1.0, 1.0))
    fm = fused.build_fused(tm)
    E = tm.n_elements
    u2 = torch.as_tensor(np.random.default_rng(7).standard_normal((E, fm.nv)),
                         dtype=torch.float32)
    tr = fused.scaled_traces(u2, fm.W_tr, fm.drstn)
    ref = _apply_orth(tm, u2.double().reshape((E,) + (8,) * 3)).reshape(E, -1)
    one = _split_tf32_pass(fm, u2, tr, products=1)
    three = _split_tf32_pass(fm, u2, tr, products=3)
    assert _rel(one, ref) > 20 * REL_TOL
    assert _rel(three, ref) <= REL_TOL


@pytest.mark.parametrize("nl", sorted(LAYOUT))
def test_layout_matches_the_kernel_config(nl):
    nv, tw = nl**3, 12 * nl * nl
    assert fused.sipg_layout(nv, 1, tw) == LAYOUT[nl]
    NP, NCH = fused.sipg_layout(nv, 3, tw)
    assert NP == LAYOUT[nl][0] and NCH == -(-(3 * nv + tw) // 16)
    # a warpgroup's sub-block width is one of the generated wgmma widths
    wn = NP // 2 if nv > 256 else NP
    assert (wn // 2 if wn > 128 else wn) in gen_wgmma.WIDTHS


def test_wgmma_header_is_generated():
    assert gen_wgmma.OUT.read_text() == gen_wgmma.render()
    assert gen_wgmma.OUT_BF16.read_text() == gen_wgmma.render("bf16")
