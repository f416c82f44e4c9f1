// Fused structured SIPG apply for NVIDIA Hopper (sm_90a), f32 on FFMA.
//
// Replaces the Pallas TPU kernel `_kernel_lex` of
// `disco4est_tpu/laplacian/structured.py` (the inner f32 apply of the
// mixed-precision solve on uniform bricks).  The Python side is
// `disco4est_tpu_torch/laplacian/structured.py` (`lex_apply_cuda`), which
// also holds the plain PyTorch version of the same function
// (`lex_apply_plain`).
//
// What it computes.  Elements are in lexicographic order (x fastest), so
// the neighbor across face f of element e is element e + delta[f] and its
// matching face is opp[f].  The whole apply is ONE matrix product
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
// neighbor's, tr[e + delta[f], opp[f], :].  On a boundary face (bnd = 1)
// u+ = 0, dn+ = -dn- and c2 = 2; otherwise c2 = 1.
//
// What bounds it on this card.  The apply costs ~2*E*nv*(nblk*nv + tw)
// flop (5.4 GFLOP at p = 7, E = 4096) against ~4*E*(2*nv + tw) bytes of
// streamed data (u, traces, Au): ~190 flop/byte at p = 7 and ~25 at p = 3.
// The card's f32 ridge is ~20 flop/byte (67 TFLOP/s on FFMA over
// 3.35 TB/s), so f32 FFMA throughput bounds it.  It must stay in IEEE f32
// (no TF32, no tensor cores): the inner CG diverges under reduced-precision
// products, and the kernel is held to 5e-6 relative against f64.
//
// What the design does about it.  A register-blocked SGEMM: a block owns a
// 64-element x 64-column output tile, each thread a 4 x 4 register tile,
// and K streams through shared memory 16 columns at a time.  The A tile is
// GENERATED while it is staged: volume columns as cw * u, face columns
// from four trace values and four per-face scalars, so the face block Z
// never exists in device memory.  Neighbor traces are read straight from
// device memory at row e + delta[f], only on interior faces and only
// inside 0 <= e + delta < E; there is no window, so any brick size works.
// W_vol and W_lift (2.5 MiB at p = 7) are tiled along K like any B
// operand and stay hot in the 50 MB L2.  Degrees 1-7 and nblk in {1, 3}
// are compiled as separate instances so every index is a constant.
// Making it fast (wgmma, TMA, a bf16/TF32 variant) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kFaces = 6;
constexpr int kBM = 64;  // elements per block tile
constexpr int kBN = 64;  // output columns per block tile
constexpr int kBK = 16;  // K columns staged per step
constexpr int kTM = 4;   // rows per thread
constexpr int kTN = 4;   // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;  // shared-row padding: spreads the A-tile stores

struct FaceShift {
  int delta[kFaces];  // lex offset of the neighbor across face f
  int opp[kFaces];    // the neighbor's face index
};

// Entry (e, k) of the generated operand A.
template <int NL, int NBLK>
__device__ __forceinline__ float a_entry(
    int e, int k, int E, const float* __restrict__ u,
    const float* __restrict__ tr, const float* __restrict__ cw,
    const float* __restrict__ scal, const FaceShift& fs) {
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
    const long long ne = (long long)e + fs.delta[f];
    if (ne >= 0 && ne < E) {
      const float* nb = tr + ne * TW + fs.opp[f] * (2 * NFL);
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

template <int NL, int NBLK>
__global__ void __launch_bounds__(kThreads) structured_apply_kernel(
    const float* __restrict__ u, const float* __restrict__ tr,
    const float* __restrict__ cw, const float* __restrict__ scal,
    const float* __restrict__ wvol, const float* __restrict__ wlift,
    float* __restrict__ out, int E, FaceShift fs) {
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
                      ? a_entry<NL, NBLK>(e, k, E, u, tr, cw, scal, fs)
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

template <int NL, int NBLK>
void launch(const float* u, const float* tr, const float* cw,
            const float* scal, const float* wvol, const float* wlift,
            float* out, int E, const FaceShift& fs, cudaStream_t stream) {
  constexpr int NV = NL * NL * NL;
  const dim3 grid((E + kBM - 1) / kBM, (NV + kBN - 1) / kBN);
  structured_apply_kernel<NL, NBLK><<<grid, kThreads, 0, stream>>>(
      u, tr, cw, scal, wvol, wlift, out, E, fs);
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers to contiguous f32 arrays: u [E, nv], tr [E, tw], cw [E, nblk],
// scal [E, 24], wvol [nv, nblk*nv], wlift [tw, nv], out [E, nv].  `delta`
// and `opp` are host arrays of 6 ints.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int d4est_structured_apply(
    const float* u, const float* tr, const float* cw, const float* scal,
    const float* wvol, const float* wlift, float* out, int E, int nl,
    int nblk, const int* delta, const int* opp, void* stream) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
  FaceShift fs;
  for (int f = 0; f < kFaces; ++f) {
    fs.delta[f] = delta[f];
    fs.opp[f] = opp[f];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define D4EST_CASE(NL_)                                                   \
  case NL_:                                                               \
    if (nblk == 1)                                                        \
      launch<NL_, 1>(u, tr, cw, scal, wvol, wlift, out, E, fs, s);        \
    else if (nblk == 3)                                                   \
      launch<NL_, 3>(u, tr, cw, scal, wvol, wlift, out, E, fs, s);        \
    else                                                                  \
      return (int)cudaErrorInvalidValue;                                  \
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
