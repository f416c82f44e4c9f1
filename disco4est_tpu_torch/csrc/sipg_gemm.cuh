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
// The bf16 mode (BF16 = true; the Pallas kernels' precision="bf16", the
// TPU's default) multiplies bf16 operands with f32 sums, at the rounding
// points of the TPU kernels: u is read in f32 and rounded to bf16 (RNE)
// as A is generated; the traces arrive in bf16 (phase A's f32 product
// rounded once, read by both sides of every face), Z is formed in f32
// from them and the f32 scalars with the plain version's roundings, and
// rounded once to bf16; B is packed in bf16 (`fused.pack_sipg_weights_bf16`,
// core matrices of 8 rows x 16 bytes, no hi/lo split).  A 16-column K
// chunk is one k16 bf16 product (`wgmma_bf16.cuh`), still started from
// zero in `part` and added to `total` in IEEE f32.  cw is applied after
// the product, as the TPU kernels do (cw * (bf16(u) @ bf16(W_b))), not
// folded into A, where bf16(cw * u) would move the apply by as much as
// the bf16 error itself: each volume block of K is padded with zero
// columns to whole chunks, so that a chunk lies in one volume block or in
// the face block, and a thread adds cw[e, b] * part of a volume chunk
// (part of a face chunk) for the two element rows it holds.  Trace
// lanes are fetched 8 bytes (four lanes) at a time at even nl, and as
// the aligned 4-byte word that holds the lane at odd nl (an odd lane
// count a face), whose half the generation then picks.
// Every f32 instance is the same code as without the mode.

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

template <int NL, int NBLK, bool BF16 = false>
struct Cfg {
  static constexpr int NV = NL * NL * NL;
  static constexpr int NFL = NL * NL;
  static constexpr int TW = kFaces * 2 * NFL;
  // K columns of one volume block: nv, or in bf16 mode nv padded with zero
  // columns to whole chunks (cw is applied after each chunk's product)
  static constexpr int NVK = BF16 ? (NV + kKC - 1) / kKC * kKC : NV;
  static constexpr int KVOL = NBLK * NVK;
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
  // floats of one row of a chunk tile (kKC f32 or kKC bf16 values) and
  // the tiles a chunk holds (TF32 hi and lo, or the bf16 values)
  static constexpr int ROW_F = BF16 ? kKC / 2 : kKC;
  static constexpr int PARTS = BF16 ? 1 : 2;
  static constexpr int B_CHUNK = PARTS * NP * ROW_F;  // floats
  static constexpr int A_STAGE = PARTS * BM * ROW_F;
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

// The bf16 tiles: 8x8 core matrices (8 rows of 16 bytes), the two of a
// row group's 16 K columns 128 bytes apart (leading byte offset), row
// groups 256 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t tile_desc_bf16(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// Offset (bf16 values) of entry (row, k) of a [rows, kKC] bf16 tile.
__device__ __forceinline__ int tile_index_bf16(int row, int k) {
  return ((row >> 3) * (kKC / 8) + (k >> 3)) * 64 + (row & 7) * 8 + (k & 7);
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// N consecutive bf16 lanes from a fetch slot, as floats.  N = 4: the 8
// bytes of four lanes.  N = 1: the aligned 4-byte word that holds the
// lane, whose high half it is when `odd` (the lane's index is odd).
template <int N>
__device__ __forceinline__ void bf16_lanes(float (&x)[N], const float* slot,
                                           bool odd) {
  if constexpr (N == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(slot);
    x[0] = __uint_as_float(w.x << 16);
    x[1] = __uint_as_float(w.x & 0xFFFF0000u);
    x[2] = __uint_as_float(w.y << 16);
    x[3] = __uint_as_float(w.y & 0xFFFF0000u);
  } else {
    const uint32_t w = __float_as_uint(slot[0]);
    x[0] = __uint_as_float(odd ? w & 0xFFFF0000u : w << 16);
  }
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

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
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

// `tr` and `wpack` hold f32 values, or bf16 values in bf16 mode.
template <int NL, int NBLK, bool BF16, class Nbr>
__global__ void __launch_bounds__(Cfg<NL, NBLK, BF16>::THREADS, 1)
    sipg_gemm_kernel(const float* __restrict__ u,
                     const float* __restrict__ tr,
                     const float* __restrict__ meta,
                     const float* __restrict__ wpack,
                     float* __restrict__ out, int E, int splits, Nbr nbr) {
  using C = Cfg<NL, NBLK, BF16>;
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
        const int m = k % C::NVK;
        // (bf16 mode: a padding column has no source; A gets a zero)
        if (!BF16 || m < C::NV) {
#pragma unroll
          for (int p = 0; p < C::NPASS; ++p) {
            const int e = w.e0 + row0 + p * C::RPP;
            const bool ok = e < E;
            cp_async<4 * VEC>(slot(raw, p, 0),
                              ok ? u + (long long)e * C::NV + m : u, ok);
          }
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
          if constexpr (BF16) {
            // lane indices into tr seen as bf16 values; VEC = 1 fetches
            // the aligned word that holds the lane (E * tw is even there)
            const uint16_t* t16 = reinterpret_cast<const uint16_t*>(tr);
            const long long own = (long long)e * C::TW + f * (2 * C::NFL) + i;
            const long long nb = (long long)nrow[p] * (2 * C::NFL) + i;
            auto fetch = [&](int q, long long at, bool valid) {
              if constexpr (VEC == 4) {
                cp_async<8>(slot(raw, p, q), valid ? t16 + at : t16, valid);
              } else {
                cp_async<4>(slot(raw, p, q), valid ? t16 + (at & ~1LL) : t16,
                            valid);
              }
            };
            fetch(0, own, ok);
            fetch(2, nb, has_nb);
            if (!is_s2n) {
              fetch(1, own + C::NFL, ok);
              fetch(3, nb + C::NFL, has_nb);
            }
          } else {
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
    if constexpr (BF16) {
      // A in bf16: bf16(u) in a volume block (zero in its padding
      // columns), bf16(Z) in the face block.  Z is formed with explicit
      // roundings in the order of the plain version (`fused.face_terms`):
      // IEEE multiplies and adds, t13's last product and its sum one FMA
      // (as XLA's CPU code forms it in the reference's interpreted
      // kernels), so that its bf16 rounding is that of the plain version.
      uint16_t* a16 = reinterpret_cast<uint16_t*>(sA + (g & 1) * C::A_STAGE);
      const int lane = jz - f * (2 * C::NFL);
      const int i = is_s2n ? lane - C::NFL : lane;
      const bool odd_u = i & 1, odd_dn = (i + C::NFL) & 1;
#pragma unroll
      for (int p = 0; p < C::NPASS; ++p) {
        const int m = row0 + p * C::RPP;
        float a[VEC];
        if (k < C::KVOL) {
          const Lanes<VEC> own = lds<VEC>(slot(raw, p, 0));
          const bool real = k % C::NVK < C::NV;
#pragma unroll
          for (int v = 0; v < VEC; ++v) a[v] = real ? own.v[v] : 0.f;
        } else if (k < C::K) {
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
        if constexpr (VEC == 4) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(
              bf16_bits(a[0]) | (uint32_t)bf16_bits(a[1]) << 16,
              bf16_bits(a[2]) | (uint32_t)bf16_bits(a[3]) << 16);
        } else {
          dst[0] = bf16_bits(a[0]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      return;
    }
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

  const int a_off = C::SPLIT_N ? 0 : wg * 64 * C::ROW_F;  // this warpgroup's
  const int b_off = C::SPLIT_N ? wg * C::WN * C::ROW_F : 0;  // rows, columns
  for (int g = 0; g < nchunks; ++g) {
    const int s = g % C::SB;
    mbar_wait(&bars[s], (g / C::SB) & 1);
    chunk_barrier();
    if (tid == 0) load_b(g + C::SB - 1);  // into the stage chunk g-1 left

    if constexpr (BF16) {
      // the chunk's factor for each of the thread's two accumulator rows
      // (r and r + 8 of the warpgroup's 64): cw[e, b] after a chunk of
      // volume block b, 1 after a face chunk
      const Where w = where(g);
      const int k0 = w.c * kKC;
      float scale[2] = {1.f, 1.f};
      if (k0 < C::KVOL) {
        const float* ms = sMeta + (w.lt & 1) * C::META;
        const int r = (C::SPLIT_N ? 0 : wg * 64) + 16 * ((tid % 128) / 32) +
                      (tid % 32) / 4;
        const int b = k0 / C::NVK;
        scale[0] = ms[r * kMetaW + 4 * kFaces + b];
        scale[1] = ms[(r + 8) * kMetaW + 4 * kFaces + b];
      }
      const float* a16 = sA + (g & 1) * C::A_STAGE + a_off;
#pragma unroll
      for (int sb = 0; sb < C::NS; ++sb) {
        const float* b16 = sB + s * C::B_CHUNK + b_off + sb * C::SW * C::ROW_F;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        WgmmaBf16<C::SW>::mma(part, tile_desc_bf16(a16), tile_desc_bf16(b16),
                              0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if (sb == 0) stage_next(g);
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
        for (int i = 0; i < C::SW / 2; ++i) {
          total[sb * (C::SW / 2) + i] += scale[(i >> 1) & 1] * part[i];
        }
      }
    } else {
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

template <int NL, int NBLK, bool BF16, class Nbr>
int launch_instance(const float* u, const float* tr, const float* meta,
                    const float* wpack, float* out, int E, const Nbr& nbr,
                    cudaStream_t stream) {
  using C = Cfg<NL, NBLK, BF16>;
  auto kernel = sipg_gemm_kernel<NL, NBLK, BF16, Nbr>;
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
  const float* t = static_cast<const float*>(tr);
  const float* w = static_cast<const float*>(wpack);
#define D4EST_CASE(NL_)                                                   \
  case NL_:                                                               \
    if (nblk == 1)                                                        \
      return launch_instance<NL_, 1, BF16>(u, t, meta, w, out, E, nbr, s); \
    if (nblk == 3)                                                        \
      return launch_instance<NL_, 3, BF16>(u, t, meta, w, out, E, nbr, s); \
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

}  // namespace d4est
