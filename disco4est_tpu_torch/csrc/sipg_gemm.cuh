// Shared tile code of the two fused SIPG applies for NVIDIA Hopper
// (sm_90a): `structured_apply.cu` (neighbors at constant lex offsets) and
// `fused_apply.cu` (neighbors from a row table).  Each source defines a
// neighbor policy and instantiates the kernel below with it.
//
// What it computes.  The whole apply is ONE matrix product
//
//     Au[e, :] = A[e, :] @ B,        K = nblk*nv + tw columns of A,
//     A[e, b*nv + m]      = cw[e, b] * u[e, m]             (volume blocks)
//     A[e, nblk*nv + j]   = Z[e, j]                        (face terms)
//     B                   = [W_vol blocks stacked along K ; W_lift]
//
// with nv = (p+1)^3, nfl = (p+1)^2, tw = 6*2*nfl.  Lane j of Z belongs to
// face f = j / (2 nfl); its first nfl lanes hold
//     t13 = -1/2 sj (dn- - dn+) + sj sigma (u- - u+)
// and its last nfl lanes hold
//     s2n = -1/2 c2 sj drstn (u- - u+),
// where u-, dn- are the element's own traces tr[e, f, :] and u+, dn+ the
// neighbor's, read at the face row (in units of 2*nfl floats, i.e. a row of
// tr seen as [E*6, 2*nfl]) that the policy's `row(e, f)` returns; a
// negative row means "no neighbor" and reads zeros.  On a boundary face
// (bnd = 1) the neighbor is not read: u+ = 0, dn+ = -dn- and c2 = 2;
// otherwise c2 = 1.  The traces' dn lanes arrive already scaled by the
// face's own drstn, so both sides of every face read the same values.
//
// What bounds it.  2*E*nv*K flop against ~4*E*(2 nv + tw) bytes: 5.37
// GFLOP and 32 MB at p = 7, E = 4096 (166 flop/byte); 1.07 GFLOP and 45 MB
// at p = 3, E = 32768.  On the f32 FFMA pipes (67 TFLOP/s) the operations
// bound both.  This design runs the products on the tensor cores instead,
// in split TF32 (below), three TF32 products per f32 product against a
// 495 TFLOP/s peak: then p = 7 is still bound by operations (32.5 us) and
// p = 3 by the bytes (13.5 us).  Measured on an H100 (PERF.md), the
// generation of A, not the products, takes most of a chunk at p = 3.
//
// The design.
// - Split-TF32 products.  Every operand x is split as x = hi + lo, each
//   rounded to TF32 (cvt.rna), and the product is accumulated as
//   a_hi*b_hi + a_hi*b_lo + a_lo*b_hi (a_lo*b_lo, ~2^-22 relative, is
//   dropped) with `wgmma.mma_async ... m64nNk8 .tf32` (`wgmma_tf32.cuh`).
//   One TF32 product alone loses ~3 digits, which stalls the inner CG.
// - The tensor cores add in f32 but truncate, so a long sum in their
//   accumulator drifts by about an ulp per addition (5.3e-6 relative at
//   p = 7 on the card, against the 5e-6 bound).  Each K chunk's products
//   therefore start from zero in `part` and are added to `total` with
//   IEEE f32 adds; a warpgroup's columns go in NS sub-blocks of SW, which
//   keeps part + total within the registers.
// - B = [W_vol ; W_lift] is split, transposed to K-major and cut into
//   K chunks of kKC columns once per mesh epoch on the host
//   (`fused.pack_sipg_weights`), already in the shared-memory image the
//   product reads (8x4 core matrices, no swizzle), so one bulk copy
//   (`cp.async.bulk`, completion on an mbarrier) stages a chunk, SB-1
//   chunks ahead.  It is read from L2 (5 MB at p = 7) for every tile.
// - A is generated ONCE per element tile: a block owns BM elements and ALL
//   nv output columns.  Two warpgroups run the products: they split the
//   columns when nv > 256 (p = 6, 7: BM = 64, 176 or 256 columns each)
//   and the rows otherwise (BM = 128).  Both read one A chunk.  Where nv
//   <= 64 two more warpgroups join the generation of A.
// - Pipelined staging.  A chunk's A sources (u, own and neighbor trace
//   lanes: up to four values an entry, 16-byte copies where the lanes
//   allow) are fetched RS chunks ahead with `cp.async` into slots private
//   to the thread, zero-filled where there is no element or no neighbor;
//   the neighbor rows are looked up one chunk before that.  A tile's
//   table rows (per-face scalars and cw, `fused.sipg_meta`) arrive by
//   bulk copy with its first chunk.  While the tensor cores run chunk g,
//   the threads generate chunk g+1's A (hi and lo) from the slots.
// - Persistent grid: one block per SM walks the element tiles; the chunk
//   stream runs on across tiles, so the next tile's loads overlap this
//   tile's products.  With fewer tiles than half the SMs (p = 7, E =
//   4096) two blocks share a tile, half of its K chunks each, and add
//   their partial sums into the zeroed output.  The epilogue writes from
//   registers, masked at the ragged last tile and the padded columns.
// Degrees 1-7 and nblk in {1, 3} are compiled as separate instances, so
// every index is a constant.
//
// The bf16 mode (`sipg_bf16_kernel`, `CfgBf16`; the Pallas kernels'
// precision="bf16", the TPU's default) multiplies bf16 operands with f32
// sums, at the rounding points of the TPU kernels: u is read in f32 and
// rounded to bf16 (RNE) as A is generated; the traces arrive in bf16
// (phase A's f32 product rounded once, read by both sides of every face),
// Z is formed in f32 from them and the f32 scalars with the plain
// version's roundings, and rounded once to bf16; B is packed in bf16
// (`fused.pack_sipg_weights_bf16`, no hi/lo split); cw is applied after
// the product, as the TPU kernels do (cw * (bf16(u) @ bf16(W_b))), not
// folded into A, where bf16(cw * u) would move the apply by as much as
// the bf16 error itself.  In bf16 the bytes bound both sizes (7.4 us at
// p = 7, E = 4096; 9.8 us at p = 3, E = 32768) and one k16 product is a
// few tens of ns, so the f32 design's chain of short chunk steps, each a
// block-wide barrier, a product, a wait and a drain, would leave the
// tensor cores idle.  The bf16 mode has a main loop of its own:
// - Warp specialization.  Producer warpgroups fetch the A
//   sources (u, own and neighbor trace lanes, as in f32: RS chunks ahead
//   into cp.async slots private to the thread; a tile's table rows by bulk
//   copy into one of two buffers, refilled once every producer warp has
//   released it), generate bf16 A chunks into a ring of S (4-8) stages and
//   stage each B chunk beside its A chunk by bulk copy.  Two consumer
//   warpgroups only issue the products and add up.  Each stage has a full
//   mbarrier (one arrival a producer warp after its stores and a proxy
//   fence, and the B copy's bytes) and an empty one (one arrival a
//   consumer warpgroup once its products of the stage are done); there is
//   no block-wide barrier, and the producer warps do not wait for each
//   other.  Waits sleep on the barrier (`ring_wait`).  There are four
//   producer warpgroups at nv <= 64, two up to 128 columns, and one where
//   the sums are large (nv > 128), with `setmaxnreg` moving registers to
//   the consumers.
// - A chunk is kKCB = 32 K columns (64-byte rows, two k16 products a
//   column sub-block), 8x8 core matrices without swizzle.  64 columns
//   would leave fewer than three ring stages at p = 7 (72 KB a stage) and
//   miss the shared memory by 2 KB at p = 3.
// - Block-long sums.  The tensor cores' sum runs on through every chunk
//   of a unit (scale_d = 0 at its first product only), with one commit
//   group in flight while the next chunk's is issued (wait_group 1).  At
//   the end of volume block b the accumulator is scaled in registers by
//   cw[e, b], or by cw[e, b] / cw[e, b+1] where block b + 1 follows, whose
//   own factor completes it (nblk = 3: a separate `part` per block would
//   need 224-256 floats a thread at p >= 5).  The face chunks then add
//   into the same accumulator.  The tensor cores truncate, so the sum
//   drifts by ~1e-6 relative over K = 1280 columns: far inside the bf16
//   kernels' 2e-4 bound, so the f32 design's restart every chunk is gone.
// - As in f32: the tile shapes (BM = 64 and the warpgroups splitting the
//   columns at nv > 256, BM = 128 and the rows otherwise), the persistent
//   grid (a unit is one tile and 1/splits of its K chunks), the ragged
//   last tile, each volume block of K padded with zero columns to whole
//   chunks, trace lanes fetched 2 * VEC bytes at a time at even nl and as
//   the aligned 4-byte word that holds the lane at odd nl (an odd lane
//   count a face), whose half the generation then picks.  B is read from
//   L2 for every tile (1.3 MB at p = 7): sharing it across a cluster of
//   two CTAs by multicast bulk copies, or across 128-row tiles cut into
//   two column parts, measured slower on an H100 (PERF.md).
// What paces it (PERF.md, `tools/ablate_sipg.py`): the producers, at ~1
// us a chunk a CTA, most of it the fetch and generation of A through
// shared memory; the tensor cores wait.
// The f32 instances do not share this loop and are unchanged.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace d4est {

constexpr int kFaces = 6;
constexpr int kKC = 16;        // K columns a chunk: two k8 products
// per-element table row (`fused.sipg_meta`): (drstn, sj, sigma, bnd) for
// the six faces, then cw for the nblk volume blocks, zero-padded to 112
// bytes so that a tile's rows are one 16-byte-aligned bulk copy
constexpr int kMetaW = 28;
constexpr int kSmemMax = 232448;  // dynamic shared memory of one block

template <int NL, int NBLK>
struct Cfg {
  static constexpr int NV = NL * NL * NL;
  static constexpr int NFL = NL * NL;
  static constexpr int TW = kFaces * 2 * NFL;
  static constexpr int KVOL = NBLK * NV;
  static constexpr int K = KVOL + TW;
  static constexpr int NCH = (K + kKC - 1) / kKC;  // K chunks
  static constexpr bool SPLIT_N = NV > 256;  // warpgroups split the columns
  // a warpgroup's columns, in NS sub-blocks of SW (see the main loop)
  static constexpr int WN = SPLIT_N    ? (NV + 15) / 16 * 8
                            : NV > 128 ? (NV + 15) / 16 * 16
                                       : (NV + 7) / 8 * 8;
  static constexpr int NS = WN > 128 ? 2 : 1;
  static constexpr int SW = WN / NS;
  // Two warpgroups run the products; where their accumulators are small
  // (nv <= 64), two more join them in fetching and generating A, the part
  // of a chunk that costs the most there.
  static constexpr int THREADS = WN <= 64 ? 512 : 256;
  static constexpr int NP = SPLIT_N ? 2 * WN : WN;  // padded columns
  static constexpr int BM = SPLIT_N ? 64 : 128;     // elements a tile
  // A thread fetches and generates VEC consecutive K columns of an element
  // at a time: 16-byte copies and shared-memory accesses where every row
  // offset is a multiple of four floats (even nl), single floats otherwise.
  static constexpr int VEC = (NV % 4 == 0 && NFL % 4 == 0) ? 4 : 1;
  static constexpr int KQ = kKC / VEC;         // threads on one element row
  static constexpr int RPP = THREADS / KQ;     // element rows of one pass
  static constexpr int NPASS = BM / RPP;       // passes over a chunk's rows
  static constexpr int SB = NL == 8 ? 2 : 3;        // B stages
  static constexpr int B_CHUNK = 2 * NP * kKC;  // floats: TF32 hi and lo
  static constexpr int A_STAGE = 2 * BM * kKC;
  static constexpr int RAW_STAGE = NPASS * 4 * VEC * THREADS;
  static constexpr int META = BM * kMetaW;
  static constexpr int OFF_A = SB * B_CHUNK;
  static constexpr int OFF_META = OFF_A + 2 * A_STAGE;
  static constexpr int OFF_RAW = OFF_META + 2 * META;
  // as many raw stages (chunks of A sources in flight) as fit, up to 4
  static constexpr int RS_FIT =
      (kSmemMax / 4 - OFF_RAW - 2 * (SB + 2)) / RAW_STAGE;
  static constexpr int RS = RS_FIT < 4 ? RS_FIT : 4;
  static constexpr int OFF_BAR = OFF_RAW + RS * RAW_STAGE;
  static constexpr int SMEM_BYTES = OFF_BAR * 4 + (SB + 2) * 8;
  static_assert(RS >= 2 && RS <= NCH, "raw stages");
  static_assert(SMEM_BYTES <= kSmemMax, "shared memory of one block");
  static_assert(SW % 8 == 0 && SW <= 128, "wgmma width");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Matrix descriptor of a K-major tile without swizzle: 8x4 core matrices
// (8 rows of 16 bytes, 128 contiguous bytes), the two core matrices of one
// k8 step 128 bytes apart (leading byte offset), successive groups of 8
// rows 4 core matrices = 512 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t tile_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(512 >> 4) << 32);
}

// Offset (floats) of entry (row, k) of a [rows, kKC] K-major tile.
__device__ __forceinline__ int tile_index(int row, int k) {
  return ((row >> 3) * (kKC / 4) + (k >> 2)) * 32 + (row & 7) * 4 + (k & 3);
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Copy of BYTES (4, 8 or 16) from global to shared memory, zero-filled
// when `valid` is false (then nothing is read).  16-byte copies go through
// L2 only (.cg): the small L1 beside this much shared memory only slowed
// them.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const void* src,
                                         bool valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

// N consecutive floats in registers, moved to and from shared memory in
// one access when N = 4.
template <int N>
struct Lanes {
  float v[N];
};

template <int N>
__device__ __forceinline__ Lanes<N> lds(const float* p) {
  Lanes<N> r;
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x, r.v[1] = t.y, r.v[2] = t.z, r.v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r.v[i] = p[i];
  }
  return r;
}

template <int N>
__device__ __forceinline__ void sts(float* p, const Lanes<N>& x) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = x.v[i];
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Bulk copy of `bytes` contiguous bytes to shared memory, completion
// counted on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int NL, int NBLK, class Nbr>
__global__ void __launch_bounds__(Cfg<NL, NBLK>::THREADS, 1)
    sipg_gemm_kernel(const float* __restrict__ u,
                     const float* __restrict__ tr,
                     const float* __restrict__ meta,
                     const float* __restrict__ wpack,
                     float* __restrict__ out, int E, int splits, Nbr nbr) {
  using C = Cfg<NL, NBLK>;
  constexpr int VEC = C::VEC;
  extern __shared__ __align__(128) float smem[];
  float* const sB = smem;
  float* const sA = smem + C::OFF_A;
  float* const sMeta = smem + C::OFF_META;
  float* const sRaw = smem + C::OFF_RAW;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* const meta_bars = bars + C::SB;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int kq = tid % C::KQ;    // this thread's VEC columns within a chunk
  const int row0 = tid / C::KQ;  // its first element row; then + RPP
  // A work unit is one element tile and 1/splits of its K chunks; the
  // block's chunk stream g runs over its units in turn.
  const int ncu = C::NCH / splits;
  const int nunits = (E + C::BM - 1) / C::BM * splits;
  const int my_units =
      (int)blockIdx.x < nunits ? (nunits - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int nchunks = my_units * ncu;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::SB + 2; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  struct Where {
    int lt;  // the block's unit
    int cc;  // the chunk within the unit
    int c;   // the K chunk
    int e0;  // the tile's first element
  };
  // (splits is 1 or 2, so every division here is by a constant)
  auto where = [&](int g) {
    Where w;
    w.lt = splits == 1 ? g / C::NCH : g / (C::NCH / 2);
    w.cc = g - w.lt * ncu;
    const int unit = blockIdx.x + w.lt * gridDim.x;
    const int tile = splits == 1 ? unit : unit >> 1;
    w.c = (unit - tile * splits) * ncu + w.cc;
    w.e0 = tile * C::BM;
    return w;
  };
  auto slot = [&](float* raw, int p, int q) {
    return raw + ((p * 4 + q) * C::THREADS + tid) * VEC;
  };
  auto load_b = [&](int g) {
    if (g < nchunks) {
      const int s = g % C::SB;
      bulk_load(sB + s * C::B_CHUNK,
                wpack + (long long)where(g).c * C::B_CHUNK, C::B_CHUNK * 4,
                &bars[s]);
    }
  };

  // The neighbor face rows of this thread's entries of chunk g (-1: none,
  // or not a face column), looked up one chunk before they are used so
  // that a table read is in flight while the thread works.
  int nrow[C::NPASS];
  auto lookup_rows = [&](int g) {
    const Where w = where(g);
    const int jz = w.c * kKC + kq * VEC - C::KVOL;
    const bool face = g < nchunks && jz >= 0 && jz < C::TW;
    const int f = face ? jz / (2 * C::NFL) : 0;
#pragma unroll
    for (int p = 0; p < C::NPASS; ++p) {
      const int e = w.e0 + row0 + p * C::RPP;
      nrow[p] = face && e < E ? (int)nbr.row(e, f) : -1;
    }
  };

  // Fetch chunk g's A sources into this thread's own slots of raw stage
  // g % RS (with a unit's first chunk, thread 0 also starts the bulk copy
  // of the tile's table rows); one commit group per call, empty past the
  // end.  The slots are private to the thread, so waiting for its own
  // groups is all the synchronization they need.
  auto issue_raw = [&](int g) {
    if (g < nchunks) {
      const Where w = where(g);
      float* raw = sRaw + (g % C::RS) * C::RAW_STAGE;
      if (w.cc == 0 && tid == 0) {
        const int rows = E - w.e0 < C::BM ? E - w.e0 : C::BM;
        bulk_load(sMeta + (w.lt & 1) * C::META,
                  meta + (long long)w.e0 * kMetaW, rows * kMetaW * 4,
                  &meta_bars[w.lt & 1]);
      }
      const int k = w.c * kKC + kq * VEC;
      if (k < C::KVOL) {
        const int m = k % C::NV;
#pragma unroll
        for (int p = 0; p < C::NPASS; ++p) {
          const int e = w.e0 + row0 + p * C::RPP;
          const bool ok = e < E;
          cp_async<4 * VEC>(slot(raw, p, 0),
                            ok ? u + (long long)e * C::NV + m : u, ok);
        }
      } else if (k < C::K) {
        const int jz = k - C::KVOL;
        const int f = jz / (2 * C::NFL);
        const int lane = jz - f * (2 * C::NFL);
        const bool is_s2n = lane >= C::NFL;
        const int i = is_s2n ? lane - C::NFL : lane;
#pragma unroll
        for (int p = 0; p < C::NPASS; ++p) {
          const int e = w.e0 + row0 + p * C::RPP;
          const bool ok = e < E;
          const bool has_nb = nrow[p] >= 0;
          const float* own =
              tr + (long long)e * C::TW + f * (2 * C::NFL) + i;
          const float* nb = tr + (long long)nrow[p] * (2 * C::NFL) + i;
          cp_async<4 * VEC>(slot(raw, p, 0), ok ? own : tr, ok);
          cp_async<4 * VEC>(slot(raw, p, 2), has_nb ? nb : tr, has_nb);
          if (!is_s2n) {
            cp_async<4 * VEC>(slot(raw, p, 1), ok ? own + C::NFL : tr, ok);
            cp_async<4 * VEC>(slot(raw, p, 3), has_nb ? nb + C::NFL : tr,
                              has_nb);
          }
        }
      }
    }
    cp_async_commit();
    lookup_rows(g + 1);
  };

  // Generate chunk g's A entries (hi and lo) into A stage g & 1.
  auto gen_a = [&](int g) {
    if (g >= nchunks) return;
    const Where w = where(g);
    if (w.cc == 0) mbar_wait(&meta_bars[w.lt & 1], (w.lt >> 1) & 1);
    float* raw = sRaw + (g % C::RS) * C::RAW_STAGE;
    const float* ms = sMeta + (w.lt & 1) * C::META;
    float* ah = sA + (g & 1) * C::A_STAGE;
    float* al = ah + C::BM * kKC;
    const int k = w.c * kKC + kq * VEC;
    const int jz = k - C::KVOL;
    const int f = jz / (2 * C::NFL);
    const bool is_s2n = jz - f * (2 * C::NFL) >= C::NFL;
#pragma unroll
    for (int p = 0; p < C::NPASS; ++p) {
      const int m = row0 + p * C::RPP;
      Lanes<VEC> a, hi, lo;
      const Lanes<VEC> own = lds<VEC>(slot(raw, p, 0));
      if (k < C::KVOL) {
        const float cw = ms[m * kMetaW + 4 * kFaces + k / C::NV];
#pragma unroll
        for (int v = 0; v < VEC; ++v) a.v[v] = cw * own.v[v];
      } else if (k < C::K) {
        const float* sc = ms + m * kMetaW + f * 4;
        const float drstn = sc[0], sj = sc[1], sig = sc[2], bnd = sc[3];
        const bool boundary = bnd > 0.f;
        const Lanes<VEC> nb = lds<VEC>(slot(raw, p, 2));
        if (is_s2n) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float jump = own.v[v] - (boundary ? 0.f : nb.v[v]);
            a.v[v] = -0.5f * (1.f + bnd) * sj * drstn * jump;
          }
        } else {
          const Lanes<VEC> dn_m = lds<VEC>(slot(raw, p, 1));
          const Lanes<VEC> dn_nb = lds<VEC>(slot(raw, p, 3));
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float jump = own.v[v] - (boundary ? 0.f : nb.v[v]);
            const float dn_p = boundary ? -dn_m.v[v] : dn_nb.v[v];
            a.v[v] = -0.5f * sj * (dn_m.v[v] - dn_p) + sj * sig * jump;
          }
        }
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) a.v[v] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        hi.v[v] = tf32_rna(a.v[v]);
        lo.v[v] = tf32_rna(a.v[v] - hi.v[v]);
      }
      const int idx = tile_index(m, kq * VEC);
      sts<VEC>(ah + idx, hi);
      sts<VEC>(al + idx, lo);
    }
    // make the generic-proxy stores visible to the tensor cores' reads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  if (tid == 0) {
    for (int q = 0; q < C::SB - 1; ++q) load_b(q);
  }
  lookup_rows(0);
#pragma unroll
  for (int q = 0; q < C::RS; ++q) issue_raw(q);
  cp_async_wait<C::RS - 1>();
  gen_a(0);

  // One barrier a chunk: A chunk g is written and every product of chunk
  // g-1 is done.  Named, so that the helper warpgroups may reach it from
  // their own loop.
  auto chunk_barrier = [] {
    asm volatile("bar.sync 1, %0;" ::"n"(C::THREADS) : "memory");
  };
  // Stage the next chunk while the tensor cores run this one.
  auto stage_next = [&](int g) {
    issue_raw(g + C::RS);        // into the stage chunk g's sources left
    cp_async_wait<C::RS - 1>();  // this thread's sources of chunk g+1
    gen_a(g + 1);
  };

  if (C::THREADS > 256 && wg >= 2) {
    // helper warpgroups: staging only, on a path of their own to the end
    // (a branch around the products would serialize them)
    for (int g = 0; g < nchunks; ++g) {
      chunk_barrier();
      stage_next(g);
    }
    return;
  }

  // The tensor cores add in f32 but truncate, so a long sum drifts by
  // about an ulp of the accumulator per addition.  Each chunk's products
  // therefore go into `part` (scale_d = 0 at the chunk's first product)
  // and are added to `total` with IEEE f32 adds; a warpgroup's columns go
  // in NS sub-blocks of SW, which keeps part + total within the registers.
  float total[C::WN / 2];
  float part[C::SW / 2];
#pragma unroll
  for (int i = 0; i < C::WN / 2; ++i) total[i] = 0.f;

  const int a_off = C::SPLIT_N ? 0 : wg * 64 * kKC;  // this warpgroup's
  const int b_off = C::SPLIT_N ? wg * C::WN * kKC : 0;  // rows, columns
  for (int g = 0; g < nchunks; ++g) {
    const int s = g % C::SB;
    mbar_wait(&bars[s], (g / C::SB) & 1);
    chunk_barrier();
    if (tid == 0) load_b(g + C::SB - 1);  // into the stage chunk g-1 left

    const float* a_hi = sA + (g & 1) * C::A_STAGE + a_off;
    const float* a_lo = a_hi + C::BM * kKC;
#pragma unroll
    for (int sb = 0; sb < C::NS; ++sb) {
      const float* b_hi = sB + s * C::B_CHUNK + b_off + sb * C::SW * kKC;
      const float* b_lo = b_hi + C::NP * kKC;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int st = 0; st < kKC / 8; ++st) {
        const int off = st * 64;  // two core matrices along K
        Wgmma<C::SW>::mma(part, tile_desc(a_hi + off), tile_desc(b_hi + off),
                          st > 0 ? 1 : 0);
        Wgmma<C::SW>::mma(part, tile_desc(a_hi + off), tile_desc(b_lo + off),
                          1);
        Wgmma<C::SW>::mma(part, tile_desc(a_lo + off), tile_desc(b_hi + off),
                          1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (sb == 0) stage_next(g);
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int i = 0; i < C::SW / 2; ++i) {
        total[sb * (C::SW / 2) + i] += part[i];
      }
    }

    const Where w = where(g);
    if (w.cc == ncu - 1) {  // the unit's last chunk: write it out
      const int lane = tid % 32;
      const int row = w.e0 + (C::SPLIT_N ? 0 : wg * 64) +
                      16 * ((tid % 128) / 32) + lane / 4;
      const int col = (C::SPLIT_N ? wg * C::WN : 0) + 2 * (lane % 4);
      // a thread holds column pairs (n, n+1): one 8-byte store a pair
      // where nv is even.  Split units add into the zeroed output: two
      // partial sums added to 0 give the same f32 result in either order.
#pragma unroll
      for (int i = 0; i < C::WN / 2; i += 2) {
        const int e = row + 8 * ((i >> 1) & 1);
        const int n = col + 8 * (i >> 2);
        float* dst = out + (long long)e * C::NV + n;
        if (e < E && C::NV % 2 == 0 && n < C::NV) {
          const float2 v = make_float2(total[i], total[i + 1]);
          if (splits == 1) {
            *reinterpret_cast<float2*>(dst) = v;
          } else {
            atomicAdd(reinterpret_cast<float2*>(dst), v);
          }
        } else if (e < E && C::NV % 2 == 1) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (n + q >= C::NV) continue;
            if (splits == 1) {
              dst[q] = total[i + q];
            } else {
              atomicAdd(dst + q, total[i + q]);
            }
          }
        }
        total[i] = total[i + 1] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 mode: its own main loop (the header's last section).

constexpr int kKCB = 32;  // K columns of a bf16 chunk: two k16 products

template <int NL, int NBLK>
struct CfgBf16 {
  static constexpr int NV = NL * NL * NL;
  static constexpr int NFL = NL * NL;
  static constexpr int TW = kFaces * 2 * NFL;
  // the tile shapes of `Cfg`: the two consumer warpgroups split a tile's
  // columns where nv > 256 (BM = 64) and its rows otherwise (BM = 128);
  // a warpgroup's WN columns go in NS sub-blocks of SW
  static constexpr bool SPLIT_N = Cfg<NL, NBLK>::SPLIT_N;
  static constexpr int WN = Cfg<NL, NBLK>::WN;
  static constexpr int NS = Cfg<NL, NBLK>::NS;
  static constexpr int SW = Cfg<NL, NBLK>::SW;
  static constexpr int NP = Cfg<NL, NBLK>::NP;
  static constexpr int BM = Cfg<NL, NBLK>::BM;
  // producer warpgroups (they fetch and generate A: four where the
  // consumers' sums are small, nv <= 64, and two up to 128 columns; one
  // where `setmaxnreg` must give the consumers more), then two consumer
  // warpgroups
  static constexpr int NPW = WN <= 64 ? 4 : WN <= 128 ? 2 : 1;
  static constexpr int NPT = 128 * NPW;
  static constexpr int THREADS = NPT + 256;
  // registers a thread after `setmaxnreg` where one producer warpgroup
  // gives its share to the consumers' accumulators (384 threads)
  static constexpr int PROD_REGS = 104;
  static constexpr int CONS_REGS = 200;
  // A producer thread fetches and generates VEC consecutive K columns of an
  // element: trace lanes in copies of 2 * VEC bytes (VEC = 1: the aligned
  // 4-byte word that holds the lane), u in two copies of VEC / 2 floats.
  static constexpr int VEC = (NV % 8 == 0 && NFL % 8 == 0)   ? 8
                             : (NV % 4 == 0 && NFL % 4 == 0) ? 4
                                                             : 1;
  static constexpr int SLB = VEC == 1 ? 4 : 2 * VEC;  // bytes of a slot
  // each volume block of K padded with zero columns to whole chunks
  static constexpr int NVK = (NV + kKCB - 1) / kKCB * kKCB;
  static constexpr int CPB = NVK / kKCB;  // chunks of a volume block
  static constexpr int KVOL = NBLK * NVK;
  static constexpr int K = KVOL + TW;
  static constexpr int NCH = (K + kKCB - 1) / kKCB;
  static constexpr int KQ = kKCB / VEC;     // threads on one element row
  static constexpr int RPP = NPT / KQ;      // element rows of one pass
  static constexpr int NPASS = BM / RPP;    // passes over a chunk's rows
  // bytes: a ring stage (the A chunk, then the B chunk), a raw stage (four
  // cp.async slots a thread and pass: one chunk's A sources), a tile's
  // table rows
  static constexpr int A_BYTES = BM * kKCB * 2;
  static constexpr int B_BYTES = NP * kKCB * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RAW = NPASS * 4 * NPT * SLB;
  static constexpr int META = BM * kMetaW * 4;
  static constexpr int FIX = 2 * META + 160;  // two table buffers, barriers
  // three raw stages where they fit beside three ring stages, else two;
  // then as many ring stages as fit, up to 8
  static constexpr int RS =
      FIX + 3 * STAGE + 3 * RAW <= kSmemMax ? 3 : 2;
  static constexpr int S_FIT = (kSmemMax - FIX - RS * RAW) / STAGE;
  static constexpr int S = S_FIT < 8 ? S_FIT : 8;
  static constexpr int OFF_RAW = S * STAGE;
  static constexpr int OFF_META = OFF_RAW + RS * RAW;
  static constexpr int OFF_BAR = OFF_META + 2 * META;
  static constexpr int SMEM_BYTES = OFF_BAR + (2 * S + 4) * 8;
  static_assert(S >= 3 && RS >= 2 && RS <= NCH, "ring and raw stages");
  static_assert(SMEM_BYTES <= kSmemMax, "shared memory of one block");
  static_assert(NPASS * RPP == BM && NVK % VEC == 0, "producer passes");
  static_assert(NPW > 1 || 128 * PROD_REGS + 256 * CONS_REGS <= 65536,
                "register split");
};

// Matrix descriptor of a K-major bf16 tile without swizzle: 8x8 core
// matrices (8 rows of 16 bytes), the two of a k16 step 128 bytes apart
// (leading byte offset), row groups kKCB / 8 core matrices = 512 bytes
// apart (stride byte offset).  k16 step j starts 256 * j bytes in.
__device__ __forceinline__ uint64_t tile_desc_bf16(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(128 >> 4) << 16) | ((uint64_t)((16 * kKCB) >> 4) << 32);
}

// Offset (bf16 values) of entry (row, k) of a [rows, kKCB] bf16 tile.
__device__ __forceinline__ int tile_index_bf16(int row, int k) {
  return ((row >> 3) * (kKCB / 8) + (k >> 3)) * 64 + (row & 7) * 8 + (k & 7);
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// N consecutive bf16 lanes from a fetch slot, as floats: the 2N bytes of
// N lanes (N = 8, 4), or (N = 1) the aligned 4-byte word that holds the
// lane, whose high half it is when `odd` (the lane's index is odd).
template <int N>
__device__ __forceinline__ void bf16_lanes(float (&x)[N], const void* slot,
                                           bool odd) {
  if constexpr (N == 1) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(slot);
    x[0] = __uint_as_float(odd ? w & 0xFFFF0000u : w << 16);
  } else {
    uint32_t w[N / 2];
    if constexpr (N == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(slot);
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(slot);
      w[0] = q.x, w[1] = q.y;
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// N consecutive floats from two slots of N / 2 each (N = 1: one slot).
template <int N>
__device__ __forceinline__ void f32_lanes(float (&x)[N], const void* s0,
                                          const void* s1) {
  if constexpr (N == 1) {
    x[0] = *reinterpret_cast<const float*>(s0);
  } else {
    const float* a = reinterpret_cast<const float*>(s0);
    const float* b = reinterpret_cast<const float*>(s1);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) x[i] = a[i], x[N / 2 + i] = b[i];
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// mbar_wait for the ring.  A waiting thread sleeps until the phase
// completes (the suspend-time hint, 10 ms, keeps it from polling, so a
// waiting warp leaves its issue slots to the producers); a wait that
// outlasts 4 s traps, so that a fault in the protocol fails the launch
// instead of holding the card.
__device__ __forceinline__ void ring_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity), "r"(10000000)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 4000000000ull) {
      __trap();
    }
  }
}

// The bf16 kernel: `tr` the bf16 traces, `wpack` the bf16 B of
// `fused.pack_sipg_weights_bf16`.
template <int NL, int NBLK, class Nbr>
__global__ void __launch_bounds__(CfgBf16<NL, NBLK>::THREADS, 1)
    sipg_bf16_kernel(const float* __restrict__ u,
                     const uint16_t* __restrict__ tr,
                     const float* __restrict__ meta,
                     const uint8_t* __restrict__ wpack,
                     float* __restrict__ out, int E, int splits, Nbr nbr) {
  using C = CfgBf16<NL, NBLK>;
  constexpr int VEC = C::VEC;
  extern __shared__ __align__(128) uint8_t smem8[];
  uint8_t* const ring = smem8;
  uint8_t* const sRaw = smem8 + C::OFF_RAW;
  float* const sMeta = reinterpret_cast<float*>(smem8 + C::OFF_META);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem8 + C::OFF_BAR);
  uint64_t* const empty = full + C::S;
  uint64_t* const meta_bar = empty + C::S;   // a table buffer is full
  uint64_t* const meta_free = meta_bar + 2;  // and free again

  const int tid = threadIdx.x;
  // A work unit is one element tile and 1/splits of its K chunks; the
  // CTA's chunk stream g runs over its units in turn.
  const int ncu = C::NCH / splits;
  const int nunits = (E + C::BM - 1) / C::BM * splits;
  const int my_units =
      (int)blockIdx.x < nunits ? (nunits - 1 - blockIdx.x) / gridDim.x + 1
                               : 0;
  const int nchunks = my_units * ncu;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::S; ++s) {
      mbar_init(&full[s], C::NPT / 32 + 1);  // producer warps, B copy
      mbar_init(&empty[s], 2);               // consumer warpgroups
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&meta_bar[b]);
      mbar_init(&meta_free[b], C::NPT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  struct Where {
    int lt;  // the CTA's unit
    int cc;  // the chunk within the unit
    int c;   // the K chunk
    int e0;  // the tile's first element
  };
  // (splits is 1 or 2, so every division here is by a constant)
  auto where = [&](int g) {
    Where w;
    w.lt = splits == 1 ? g / C::NCH : g / (C::NCH / 2);
    w.cc = g - w.lt * ncu;
    const int unit = blockIdx.x + w.lt * gridDim.x;
    const int tile = splits == 1 ? unit : unit >> 1;
    w.c = (unit - tile * splits) * ncu + w.cc;
    w.e0 = tile * C::BM;
    return w;
  };

  if (tid < C::NPT) {
    // ----- producers: fetch the A sources, generate A chunks into the
    // ring, stage the B chunks and the tables
    if constexpr (C::NPW == 1) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::PROD_REGS));
    }
    const int kq = tid % C::KQ;    // this thread's VEC columns of a chunk
    const int row0 = tid / C::KQ;  // its first element row; then + RPP
    const int lane = tid % 32;
    auto slot = [&](uint8_t* raw, int p, int q) {
      return raw + ((p * 4 + q) * C::NPT + tid) * C::SLB;
    };

    // The neighbor face rows of this thread's entries of chunk g (-1:
    // none, or not a face column) in nrow, looked up two chunks ahead
    // (nrow_next holds chunk g + 1's), so that a table read is in flight
    // while the thread works.
    int nrow[C::NPASS], nrow_next[C::NPASS];
    auto lookup_rows = [&](int g, int (&rows)[C::NPASS]) {
      const Where w = where(g);
      const int jz = w.c * kKCB + kq * VEC - C::KVOL;
      const bool face = g < nchunks && jz >= 0 && jz < C::TW;
      const int f = face ? jz / (2 * C::NFL) : 0;
#pragma unroll
      for (int p = 0; p < C::NPASS; ++p) {
        const int e = w.e0 + row0 + p * C::RPP;
        rows[p] = face && e < E ? (int)nbr.row(e, f) : -1;
      }
    };

    // Fetch chunk g's A sources into this thread's own slots of raw stage
    // g % RS (with a unit's first chunk, thread 0 also starts the bulk copy
    // of the tile's table rows, once every producer warp has released the
    // buffer's previous rows); one commit group a call, empty past the
    // end.  Slot q of a face entry: 0 own u, 1 own dn, 2 neighbor u, 3
    // neighbor dn (lane indices into tr seen as bf16 values); a volume
    // entry's u takes slots 0 and 1 (a padding column has no source).  The
    // slots are private to the thread, so waiting for its own groups is
    // all the synchronization they need.
    auto issue_raw = [&](int g) {
      if (g < nchunks) {
        const Where w = where(g);
        uint8_t* raw = sRaw + (g % C::RS) * C::RAW;
        if (w.cc == 0 && tid == 0) {
          const int rows = E - w.e0 < C::BM ? E - w.e0 : C::BM;
          if (w.lt >= 2) ring_wait(&meta_free[w.lt & 1], ((w.lt >> 1) + 1) & 1);
          bulk_load(sMeta + (w.lt & 1) * (C::BM * kMetaW),
                    meta + (long long)w.e0 * kMetaW, rows * kMetaW * 4,
                    &meta_bar[w.lt & 1]);
        }
        const int kb = w.c * kKCB + kq * VEC;
        if (kb < C::KVOL) {
          const int m = kb % C::NVK;
          if (m < C::NV) {
#pragma unroll
            for (int p = 0; p < C::NPASS; ++p) {
              const int e = w.e0 + row0 + p * C::RPP;
              const bool ok = e < E;
              const float* src = ok ? u + (long long)e * C::NV + m : u;
              cp_async<C::SLB>(reinterpret_cast<float*>(slot(raw, p, 0)), src,
                               ok);
              if constexpr (VEC > 1) {
                cp_async<C::SLB>(reinterpret_cast<float*>(slot(raw, p, 1)),
                                 ok ? src + VEC / 2 : u, ok);
              }
            }
          }
        } else if (kb < C::K) {
          const int jz = kb - C::KVOL;
          const int f = jz / (2 * C::NFL);
          const int lane_f = jz - f * (2 * C::NFL);
          const bool is_s2n = lane_f >= C::NFL;
          const int i = is_s2n ? lane_f - C::NFL : lane_f;
#pragma unroll
          for (int p = 0; p < C::NPASS; ++p) {
            const int e = w.e0 + row0 + p * C::RPP;
            const bool ok = e < E;
            const bool has_nb = nrow[p] >= 0;
            const long long own = (long long)e * C::TW + f * (2 * C::NFL) + i;
            const long long nb = (long long)nrow[p] * (2 * C::NFL) + i;
            auto fetch = [&](int q, long long at, bool valid) {
              float* dst = reinterpret_cast<float*>(slot(raw, p, q));
              if constexpr (VEC > 1) {
                cp_async<C::SLB>(dst, valid ? tr + at : tr, valid);
              } else {  // E * tw is even, so the word is in range
                cp_async<4>(dst, valid ? tr + (at & ~1LL) : tr, valid);
              }
            };
            fetch(0, own, ok);
            fetch(2, nb, has_nb);
            if (!is_s2n) {
              fetch(1, own + C::NFL, ok);
              fetch(3, nb + C::NFL, has_nb);
            }
          }
        }
      }
      cp_async_commit();
#pragma unroll
      for (int p = 0; p < C::NPASS; ++p) nrow[p] = nrow_next[p];
      lookup_rows(g + 2, nrow_next);
    };

    // Generate chunk g's A (bf16) into the ring stage at `a_st`: bf16(u) in
    // a volume block (zero in its padding columns), bf16(Z) in the face
    // block.  Z is formed with explicit roundings in the order of the plain
    // version (`fused.face_terms`): IEEE multiplies and adds, t13's last
    // product and its sum one FMA (as XLA's CPU code forms it in the
    // reference's interpreted kernels), so that its bf16 rounding is that
    // of the plain version.
    auto gen_a = [&](int g, uint8_t* a_st) {
      const Where w = where(g);
      if (w.cc == 0) ring_wait(&meta_bar[w.lt & 1], (w.lt >> 1) & 1);
      uint8_t* raw = sRaw + (g % C::RS) * C::RAW;
      const float* ms = sMeta + (w.lt & 1) * (C::BM * kMetaW);
      uint16_t* a16 = reinterpret_cast<uint16_t*>(a_st);
      const int kb = w.c * kKCB + kq * VEC;
      const int jz = kb - C::KVOL;
      const int f = jz / (2 * C::NFL);
      const int lane_f = jz - f * (2 * C::NFL);
      const bool is_s2n = lane_f >= C::NFL;
      const int i = is_s2n ? lane_f - C::NFL : lane_f;
      const bool odd_u = i & 1, odd_dn = (i + C::NFL) & 1;
#pragma unroll
      for (int p = 0; p < C::NPASS; ++p) {
        const int m = row0 + p * C::RPP;
        float a[VEC];
        if (kb < C::KVOL) {
          float x[VEC];
          f32_lanes<VEC>(x, slot(raw, p, 0), slot(raw, p, 1));
          const bool real = kb % C::NVK < C::NV;
#pragma unroll
          for (int v = 0; v < VEC; ++v) a[v] = real ? x[v] : 0.f;
        } else if (kb < C::K) {
          const float* sc = ms + m * kMetaW + f * 4;
          const float drstn = sc[0], sj = sc[1], sig = sc[2], bnd = sc[3];
          const bool boundary = bnd > 0.f;
          float u_m[VEC], u_n[VEC];
          bf16_lanes<VEC>(u_m, slot(raw, p, 0), odd_u);
          bf16_lanes<VEC>(u_n, slot(raw, p, 2), odd_u);
          if (is_s2n) {
            const float c = __fmul_rn(__fmul_rn(-0.5f, 1.f + bnd), sj);
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const float jump = __fsub_rn(u_m[v], boundary ? 0.f : u_n[v]);
              a[v] = __fmul_rn(__fmul_rn(c, drstn), jump);
            }
          } else {
            float dn_m[VEC], dn_n[VEC];
            bf16_lanes<VEC>(dn_m, slot(raw, p, 1), odd_dn);
            bf16_lanes<VEC>(dn_n, slot(raw, p, 3), odd_dn);
            const float hs = __fmul_rn(-0.5f, sj), ss = __fmul_rn(sj, sig);
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const float jump = __fsub_rn(u_m[v], boundary ? 0.f : u_n[v]);
              const float dn_p = boundary ? -dn_m[v] : dn_n[v];
              a[v] = __fmaf_rn(ss, jump,
                               __fmul_rn(hs, __fsub_rn(dn_m[v], dn_p)));
            }
          }
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) a[v] = 0.f;
        }
        uint16_t* dst = a16 + tile_index_bf16(m, kq * VEC);
        if constexpr (VEC == 1) {
          dst[0] = bf16_bits(a[0]);
        } else {
          uint32_t h[VEC / 2];
#pragma unroll
          for (int v = 0; v < VEC / 2; ++v) {
            h[v] = bf16_bits(a[2 * v]) | (uint32_t)bf16_bits(a[2 * v + 1]) << 16;
          }
          if constexpr (VEC == 8) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
          } else {
            *reinterpret_cast<uint2*>(dst) = make_uint2(h[0], h[1]);
          }
        }
      }
    };

    lookup_rows(0, nrow);
    lookup_rows(1, nrow_next);
#pragma unroll
    for (int q = 0; q < C::RS; ++q) issue_raw(q);
    for (int g = 0; g < nchunks; ++g) {
      const int s = g % C::S;
      // the consumers are done with chunk g - S
      if (g >= C::S) ring_wait(&empty[s], ((g / C::S) + 1) & 1);
      uint8_t* st = ring + s * C::STAGE;
      const Where w = where(g);
      if (tid == 0) {  // B chunk c: one bulk copy
        bulk_load(reinterpret_cast<float*>(st + C::A_BYTES),
                  reinterpret_cast<const float*>(wpack) +
                      (long long)w.c * (C::B_BYTES / 4),
                  C::B_BYTES, &full[s]);
      }
      cp_async_wait<C::RS - 1>();  // this thread's sources of chunk g
      gen_a(g, st);
      // make the generic-proxy stores visible to the tensor cores' reads;
      // one arrival a warp
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&full[s]);
        if (w.cc == ncu - 1) mbar_arrive(&meta_free[w.lt & 1]);
      }
      issue_raw(g + C::RS);
    }
  } else {
    // ----- consumers: the products, block-long sums, cw, the epilogue
    if constexpr (C::NPW == 1) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::CONS_REGS));
    }
    const int ct = tid - C::NPT;
    const int wg = ct / 128;
    const int lane = ct % 32;
    // the warpgroup's rows r and r + 8 of its 64 hold this thread's sums
    const int r = (C::SPLIT_N ? 0 : wg * 64) + 16 * ((ct % 128) / 32) + lane / 4;
    const bool elect = ct % 128 == 0;
    auto release = [&](int s) {
      if (elect) mbar_arrive(&empty[s]);
    };
    float acc[C::NS][C::SW / 2];
#pragma unroll
    for (int sb = 0; sb < C::NS; ++sb) {
#pragma unroll
      for (int i = 0; i < C::SW / 2; ++i) acc[sb][i] = 0.f;
    }
    float cw[2][NBLK];  // cw of rows r and r + 8, per volume block
    const int a_off = (C::SPLIT_N ? 0 : wg * 64) * kKCB * 2;  // bytes
    const int b_off = C::A_BYTES + (C::SPLIT_N ? wg * C::WN : 0) * kKCB * 2;
    bool pending = false;  // the previous chunk's stage is not released
    int prev = 0;
    for (int g = 0; g < nchunks; ++g) {
      const Where w = where(g);
      if (w.cc == 0) {  // the tile's cw, read now, used after its products
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = w.e0 + r + 8 * h;
#pragma unroll
          for (int b = 0; b < NBLK; ++b) {
            cw[h][b] = e < E ? __ldg(meta + (long long)e * kMetaW +
                                     4 * kFaces + b)
                             : 1.f;
          }
        }
      }
      const int s = g % C::S;
      ring_wait(&full[s], (g / C::S) & 1);
      const uint8_t* st = ring + s * C::STAGE;
      // The sum runs on in the accumulator across every chunk of the unit
      // (scale_d = 0 only at its first product); one commit group a chunk,
      // and the previous chunk's group completes while this one is issued.
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int sb = 0; sb < C::NS; ++sb) {
#pragma unroll
        for (int j = 0; j < kKCB / 16; ++j) {
          WgmmaBf16<C::SW>::mma(
              acc[sb], tile_desc_bf16(st + a_off + 256 * j),
              tile_desc_bf16(st + b_off + sb * C::SW * kKCB * 2 + 256 * j),
              (w.cc == 0 && j == 0) ? 0 : 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      const bool vol = w.c < C::KVOL / kKCB;
      const bool unit_end = w.cc == ncu - 1;
      const bool blk_end = vol && w.c % C::CPB == C::CPB - 1;
      if (!(blk_end || unit_end)) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (pending) release(prev);
        pending = true;
        prev = s;
        continue;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      if (pending) release(prev);
      release(s);
      pending = false;
      if (vol) {
        // cw after the product: the sum of volume block b times cw[e, b];
        // where block b + 1 follows in the unit, times cw[e, b] / cw[e, b +
        // 1] instead, which its own factor then completes
        const int b = w.c / C::CPB;
        const bool carry = blk_end && !unit_end && b + 1 < NBLK;
        float fac[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = cw[h][0], y = 1.f;
#pragma unroll
          for (int bb = 1; bb < NBLK; ++bb) {
            if (b == bb) x = cw[h][bb];
            if (b + 1 == bb) y = cw[h][bb];
          }
          fac[h] = carry ? __fdiv_rn(x, y) : x;
        }
#pragma unroll
        for (int sb = 0; sb < C::NS; ++sb) {
#pragma unroll
          for (int i = 0; i < C::SW / 2; ++i) acc[sb][i] *= fac[(i >> 1) & 1];
        }
      }
      if (unit_end) {  // write the unit's sums out
        const int row = w.e0 + r;
        const int col = (C::SPLIT_N ? wg * C::WN : 0) + 2 * (lane % 4);
        // column pairs (n, n+1): one 8-byte store a pair where nv is even;
        // split units add into the zeroed output (two partial sums added
        // to 0 give the same f32 result in either order)
#pragma unroll
        for (int sb = 0; sb < C::NS; ++sb) {
#pragma unroll
          for (int i = 0; i < C::SW / 2; i += 2) {
            const int e = row + 8 * ((i >> 1) & 1);
            const int n = col + sb * C::SW + 8 * (i >> 2);
            float* dst = out + (long long)e * C::NV + n;
            if (e < E && C::NV % 2 == 0 && n < C::NV) {
              const float2 v = make_float2(acc[sb][i], acc[sb][i + 1]);
              if (splits == 1) {
                *reinterpret_cast<float2*>(dst) = v;
              } else {
                atomicAdd(reinterpret_cast<float2*>(dst), v);
              }
            } else if (e < E && C::NV % 2 == 1) {
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                if (n + q >= C::NV) continue;
                if (splits == 1) {
                  dst[q] = acc[sb][i + q];
                } else {
                  atomicAdd(dst + q, acc[sb][i + q]);
                }
              }
            }
          }
        }
      }
    }
  }
}

// How an instance of the bf16 kernel runs at E elements: grid (CTAs),
// splits (1, or 2 units a tile), steps (K chunks the busiest CTA runs).
struct PlanBf16 {
  int grid, splits, steps;
};

template <int NL, int NBLK, class Nbr>
int plan_bf16(int E, PlanBf16* plan) {
  using C = CfgBf16<NL, NBLK>;
  cudaError_t err = cudaFuncSetAttribute(
      sipg_bf16_kernel<NL, NBLK, Nbr>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // Too few tiles to fill the card: split each tile's K chunks over two
  // CTAs, which add their partial sums into the zeroed output.
  const int ntiles = (E + C::BM - 1) / C::BM;
  const int splits =
      (ntiles * 2 <= sms && C::NCH % 2 == 0 && C::NCH / 2 >= C::RS) ? 2 : 1;
  const int units = ntiles * splits;
  const int grid = units < sms ? units : sms;  // one CTA an SM
  plan->grid = grid;
  plan->splits = splits;
  plan->steps = (units + grid - 1) / grid * (C::NCH / splits);
  return 0;
}

template <int NL, int NBLK, class Nbr>
int launch_instance_bf16(const float* u, const uint16_t* tr, const float* meta,
                         const uint8_t* wpack, float* out, int E,
                         const Nbr& nbr, cudaStream_t stream) {
  using C = CfgBf16<NL, NBLK>;
  PlanBf16 plan;
  const int code = plan_bf16<NL, NBLK, Nbr>(E, &plan);
  if (code) return code;
  if (plan.splits > 1) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, sizeof(float) * (size_t)E * C::NV, stream);
    if (err != cudaSuccess) return (int)err;
  }
  sipg_bf16_kernel<NL, NBLK, Nbr>
      <<<plan.grid, C::THREADS, C::SMEM_BYTES, stream>>>(
          u, tr, meta, wpack, out, E, plan.splits, nbr);
  return (int)cudaGetLastError();
}

template <int NL, int NBLK, class Nbr>
int launch_instance(const float* u, const float* tr, const float* meta,
                    const float* wpack, float* out, int E, const Nbr& nbr,
                    cudaStream_t stream) {
  using C = Cfg<NL, NBLK>;
  auto kernel = sipg_gemm_kernel<NL, NBLK, Nbr>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // Too few element tiles to fill the card: split each tile's K chunks
  // over two blocks, which add their partial sums into the zeroed output
  // (two, not more, so that the f32 sum does not depend on their order).
  const int ntiles = (E + C::BM - 1) / C::BM;
  const int splits =
      (ntiles * 2 <= sms && C::NCH % 2 == 0 && C::NCH / 2 >= C::RS) ? 2 : 1;
  if (splits > 1) {
    err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)E * C::NV, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int units = ntiles * splits;
  const int grid = units < sms ? units : sms;
  kernel<<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(u, tr, meta, wpack, out,
                                                     E, splits, nbr);
  return (int)cudaGetLastError();
}

// Launches instance (NL, NBLK) of the f32 kernel, or of the bf16 kernel.
template <bool BF16, int NL, int NBLK, class Nbr>
int launch_mode(const float* u, const void* tr, const float* meta,
                const void* wpack, float* out, int E, const Nbr& nbr,
                cudaStream_t s) {
  if constexpr (BF16) {
    return launch_instance_bf16<NL, NBLK>(
        u, static_cast<const uint16_t*>(tr), meta,
        static_cast<const uint8_t*>(wpack), out, E, nbr, s);
  } else {
    return launch_instance<NL, NBLK>(u, static_cast<const float*>(tr), meta,
                                     static_cast<const float*>(wpack), out, E,
                                     nbr, s);
  }
}

// Picks the (nl, nblk) instance and launches it on `stream`.  `meta` is
// the per-element table of `fused.sipg_meta` and `wpack` B as
// `fused.pack_sipg_weights` lays it out (bf16 mode: the bf16 traces and
// `fused.pack_sipg_weights_bf16`).  Returns the cudaError_t of the launch
// (0 on success).
template <bool BF16, class Nbr>
int launch_sipg(const float* u, const void* tr, const float* meta,
                const void* wpack, float* out, int E, int nl, int nblk,
                const Nbr& nbr, cudaStream_t s) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
#define D4EST_CASE(NL_)                                                     \
  case NL_:                                                                 \
    if (nblk == 1)                                                          \
      return launch_mode<BF16, NL_, 1>(u, tr, meta, wpack, out, E, nbr, s); \
    if (nblk == 3)                                                          \
      return launch_mode<BF16, NL_, 3>(u, tr, meta, wpack, out, E, nbr, s); \
    return (int)cudaErrorInvalidValue;
  switch (nl) {
    D4EST_CASE(2)
    D4EST_CASE(3)
    D4EST_CASE(4)
    D4EST_CASE(5)
    D4EST_CASE(6)
    D4EST_CASE(7)
    D4EST_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef D4EST_CASE
}

// The bf16 kernel's plan (`PlanBf16`) at E elements, into plan[0..2]:
// grid, splits, steps.  Returns a cudaError_t (0 on success).
template <class Nbr>
int plan_sipg_bf16(int E, int nl, int nblk, int* plan) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
  PlanBf16 p;
  int err = (int)cudaErrorInvalidValue;
#define D4EST_CASE(NL_)                                          \
  case NL_:                                                      \
    if (nblk == 1) err = plan_bf16<NL_, 1, Nbr>(E, &p);          \
    if (nblk == 3) err = plan_bf16<NL_, 3, Nbr>(E, &p);          \
    break;
  switch (nl) {
    D4EST_CASE(2)
    D4EST_CASE(3)
    D4EST_CASE(4)
    D4EST_CASE(5)
    D4EST_CASE(6)
    D4EST_CASE(7)
    D4EST_CASE(8)
    default:
      break;
  }
#undef D4EST_CASE
  if (err) return err;
  plan[0] = p.grid, plan[1] = p.splits, plan[2] = p.steps;
  return 0;
}

}  // namespace d4est
