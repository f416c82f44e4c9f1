// Shared tile code of the two fused SIPG applies for NVIDIA Hopper
// (sm_90a), f32 on FFMA: `structured_apply.cu` (neighbors at constant lex
// offsets) and `fused_apply.cu` (neighbors from a row table).  Each source
// defines a neighbor policy and instantiates the kernel below with it.
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
// The design.  A register-blocked SGEMM: a block owns a 64-element x
// 64-column output tile, each thread a 4 x 4 register tile, and K streams
// through shared memory 16 columns at a time.  The A tile is GENERATED
// while it is staged: volume columns as cw * u, face columns from four
// trace values and four per-face scalars, so the face block Z never exists
// in device memory.  W_vol and W_lift (2.5 MiB at p = 7) are tiled along K
// like any B operand and stay hot in the 50 MB L2.  The ragged last
// element tile is masked.  Degrees 1-7 and nblk in {1, 3} are compiled as
// separate instances so every index is a constant.

#pragma once

#include <cuda_runtime.h>

namespace d4est {

constexpr int kFaces = 6;
constexpr int kBM = 64;  // elements per block tile
constexpr int kBN = 64;  // output columns per block tile
constexpr int kBK = 16;  // K columns staged per step
constexpr int kTM = 4;   // rows per thread
constexpr int kTN = 4;   // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;  // shared-row padding: spreads the A-tile stores

// Entry (e, k) of the generated operand A.
template <int NL, int NBLK, class Nbr>
__device__ __forceinline__ float a_entry(
    int e, int k, const float* __restrict__ u, const float* __restrict__ tr,
    const float* __restrict__ cw, const float* __restrict__ scal,
    const Nbr& nbr) {
  constexpr int NV = NL * NL * NL;
  constexpr int NFL = NL * NL;
  constexpr int TW = kFaces * 2 * NFL;
  constexpr int KVOL = NBLK * NV;
  if (k < KVOL) {
    const int b = k / NV;
    const int m = k - b * NV;
    return cw[(long long)e * NBLK + b] * u[(long long)e * NV + m];
  }
  const int j = k - KVOL;
  const int f = j / (2 * NFL);
  const int w = j - f * (2 * NFL);
  const bool is_s2n = w >= NFL;
  const int i = is_s2n ? w - NFL : w;
  const float* sc = scal + (long long)e * (kFaces * 4) + f * 4;
  const float drstn = sc[0], sj = sc[1], sig = sc[2], bnd = sc[3];
  const float* own = tr + (long long)e * TW + f * (2 * NFL);
  const bool boundary = bnd > 0.f;
  float u_p = 0.f, dn_p = 0.f;
  if (!boundary) {
    const long long r = nbr.row(e, f);
    if (r >= 0) {
      const float* nb = tr + r * (2 * NFL);
      u_p = nb[i];
      if (!is_s2n) dn_p = nb[NFL + i];
    }
  }
  const float jump = own[i] - u_p;
  if (is_s2n) return -0.5f * (1.f + bnd) * sj * drstn * jump;
  const float dn_m = own[NFL + i];
  if (boundary) dn_p = -dn_m;
  return -0.5f * sj * (dn_m - dn_p) + sj * sig * jump;
}

template <int NL, int NBLK, class Nbr>
__global__ void __launch_bounds__(kThreads) sipg_gemm_kernel(
    const float* __restrict__ u, const float* __restrict__ tr,
    const float* __restrict__ cw, const float* __restrict__ scal,
    const float* __restrict__ wvol, const float* __restrict__ wlift,
    float* __restrict__ out, int E, Nbr nbr) {
  constexpr int NV = NL * NL * NL;
  constexpr int NFL = NL * NL;
  constexpr int TW = kFaces * 2 * NFL;
  constexpr int KVOL = NBLK * NV;
  constexpr int K = KVOL + TW;

  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ty = tid / (kBN / kTN);
  const int tx = tid % (kBN / kTN);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // stage A: consecutive threads take consecutive k of one element, so
    // the u and trace reads of a warp are contiguous
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int kk = idx % kBK;
      const int m = idx / kBK;
      const int e = e0 + m;
      const int k = k0 + kk;
      As[kk][m] = (e < E && k < K)
                      ? a_entry<NL, NBLK>(e, k, u, tr, cw, scal, nbr)
                      : 0.f;
    }
    // stage B: row k of [W_vol blocks ; W_lift], columns n0..n0+63
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int n = idx % kBN;
      const int kk = idx / kBN;
      const int k = k0 + kk;
      const int col = n0 + n;
      float v = 0.f;
      if (k < K && col < NV) {
        if (k < KVOL) {
          const int b = k / NV;
          v = wvol[(long long)(k - b * NV) * KVOL + b * NV + col];
        } else {
          v = wlift[(long long)(k - KVOL) * NV + col];
        }
      }
      Bs[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int e = e0 + ty * kTM + i;
    if (e >= E) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col < NV) out[(long long)e * NV + col] = acc[i][j];
    }
  }
}

template <int NL, int NBLK, class Nbr>
void launch_instance(const float* u, const float* tr, const float* cw,
                     const float* scal, const float* wvol,
                     const float* wlift, float* out, int E, const Nbr& nbr,
                     cudaStream_t stream) {
  constexpr int NV = NL * NL * NL;
  const dim3 grid((E + kBM - 1) / kBM, (NV + kBN - 1) / kBN);
  sipg_gemm_kernel<NL, NBLK, Nbr><<<grid, kThreads, 0, stream>>>(
      u, tr, cw, scal, wvol, wlift, out, E, nbr);
}

// Picks the (nl, nblk) instance and launches it on `stream`.  Returns the
// cudaError_t of the launch (0 on success).
template <class Nbr>
int launch_sipg(const float* u, const float* tr, const float* cw,
                const float* scal, const float* wvol, const float* wlift,
                float* out, int E, int nl, int nblk, const Nbr& nbr,
                cudaStream_t s) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
#define D4EST_CASE(NL_)                                                     \
  case NL_:                                                                 \
    if (nblk == 1)                                                          \
      launch_instance<NL_, 1>(u, tr, cw, scal, wvol, wlift, out, E, nbr, s); \
    else if (nblk == 3)                                                     \
      launch_instance<NL_, 3>(u, tr, cw, scal, wvol, wlift, out, E, nbr, s); \
    else                                                                    \
      return (int)cudaErrorInvalidValue;                                    \
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
      return (int)cudaErrorInvalidValue;
  }
#undef D4EST_CASE
  return (int)cudaGetLastError();
}

}  // namespace d4est
