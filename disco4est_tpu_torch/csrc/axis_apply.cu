// Three-axis tensor apply for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel `kern` of `tools/exp_kernel_design.py`
// (`e4_pallas_axis`, the round-3 design probe of a sum-factorised apply).
// The Python side is `disco4est_tpu_torch/tools/exp_kernel_design.py`
// (`axis_apply_cuda`), which also holds the plain PyTorch version of the
// same function (`axis_apply_plain`).
//
// What it computes.  For u [E, 8, 8, 8] and one matrix m [8, 8],
//     out[e, a, b, c] = sum_{i,j,k} u[e, i, j, k] m[i, a] m[j, b] m[k, c],
// as three passes, one per axis: v <- v @ m along axis 1, then 2, then 3.
//
// What bounds it on this card.  3 * 2 * E * 8^4 flop (100.7 MFLOP at
// E = 4096) against 2 * E * 512 * 4 bytes (16.8 MB): 6 flop per byte, far
// below the f32 ridge of ~20, so device-memory bandwidth bounds it (5.0 us
// at 3.35 TB/s; at E = 4096 the data also fits in the 50 MB L2).
//
// What the design does about it: each byte crosses device memory once.  A
// block of 256 threads owns 4 elements.  It stages their 2048 values in
// shared memory with coalesced 16-byte loads, runs the three axis passes in
// place there (each thread contracts one 8-long line per pass into 8
// registers and writes it back; the passes are separated by
// __syncthreads), and stores the result with coalesced 16-byte stores.  m
// sits in shared memory and is read as broadcast float4 rows, which keeps
// the register count, and so the number of blocks in flight on each SM,
// up.  Each element's slot is padded to 520 floats so the warps of the
// middle pass hit 32 distinct banks.  The ragged last block is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kNL = 8;
constexpr int kNV = kNL * kNL * kNL;  // 512 values per element
constexpr int kElems = 4;             // elements per block
constexpr int kThreads = kElems * kNL * kNL;  // one thread per line: 256
constexpr int kSlot = kNV + 8;        // padded per-element stride in smem

// out[a] = sum_i v[i] m[i][a] for one 8-line v; m's rows are read from
// shared memory as two float4 each (the same address across the warp, a
// broadcast), so m costs no registers.
__device__ __forceinline__ void line_times_m(const float (&v)[kNL],
                                             const float4 (*ms)[2],
                                             float (&r)[kNL]) {
#pragma unroll
  for (int a = 0; a < kNL; ++a) r[a] = 0.f;
#pragma unroll
  for (int i = 0; i < kNL; ++i) {
    const float4 lo = ms[i][0], hi = ms[i][1];
    r[0] = fmaf(v[i], lo.x, r[0]);
    r[1] = fmaf(v[i], lo.y, r[1]);
    r[2] = fmaf(v[i], lo.z, r[2]);
    r[3] = fmaf(v[i], lo.w, r[3]);
    r[4] = fmaf(v[i], hi.x, r[4]);
    r[5] = fmaf(v[i], hi.y, r[5]);
    r[6] = fmaf(v[i], hi.z, r[6]);
    r[7] = fmaf(v[i], hi.w, r[7]);
  }
}

// Contract the 8-line at `p` (stride `s` floats) with m, in place.
__device__ __forceinline__ void line_apply(float* p, int s,
                                           const float4 (*ms)[2]) {
  float v[kNL], r[kNL];
#pragma unroll
  for (int i = 0; i < kNL; ++i) v[i] = p[i * s];
  line_times_m(v, ms, r);
#pragma unroll
  for (int a = 0; a < kNL; ++a) p[a * s] = r[a];
}

__global__ void __launch_bounds__(kThreads) axis_apply_kernel(
    const float* __restrict__ u, const float* __restrict__ mg,
    float* __restrict__ out, int E) {
  __shared__ __align__(16) float vs[kElems * kSlot];
  __shared__ float4 ms[kNL][2];  // m, row i as two float4
  const int tid = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * kElems;
  const int n_here = (int)min((long long)kElems, E - e0);

  if (tid < kNL * 2)
    ms[tid / 2][tid % 2] = reinterpret_cast<const float4*>(mg)[tid];

  // stage: 4 elements = 512 float4, two per thread, neighbours contiguous
  const float4* u4 = reinterpret_cast<const float4*>(u + e0 * kNV);
#pragma unroll
  for (int l = 0; l < (kElems * kNV / 4) / kThreads; ++l) {
    const int q = tid + l * kThreads;
    const int el = q / (kNV / 4);
    const int off = (q % (kNV / 4)) * 4;
    if (el < n_here)
      *reinterpret_cast<float4*>(&vs[el * kSlot + off]) = u4[q];
  }
  __syncthreads();

  // axis 1 (i, stride 64): thread = (el, j, k), a warp spans 32 (j, k)
  {
    const int el = tid / 64, jk = tid % 64;
    line_apply(&vs[el * kSlot + jk], kNL * kNL, ms);
  }
  __syncthreads();
  // axis 2 (j, stride 8): thread = (i, el, k), a warp spans 4 el x 8 k
  {
    const int k = tid % kNL, el = (tid / kNL) % kElems, i = tid / 32;
    line_apply(&vs[el * kSlot + i * kNL * kNL + k], kNL, ms);
  }
  __syncthreads();
  // axis 3 (k, contiguous): thread = (el, i, j), its line as two float4
  {
    const int el = tid / 64, ij = tid % 64;
    float4* p = reinterpret_cast<float4*>(&vs[el * kSlot + ij * kNL]);
    const float4 lo = p[0], hi = p[1];
    const float v[kNL] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float r[kNL];
    line_times_m(v, ms, r);
    p[0] = make_float4(r[0], r[1], r[2], r[3]);
    p[1] = make_float4(r[4], r[5], r[6], r[7]);
  }
  __syncthreads();

  float4* o4 = reinterpret_cast<float4*>(out + e0 * kNV);
#pragma unroll
  for (int l = 0; l < (kElems * kNV / 4) / kThreads; ++l) {
    const int q = tid + l * kThreads;
    const int el = q / (kNV / 4);
    const int off = (q % (kNV / 4)) * 4;
    if (el < n_here)
      o4[q] = *reinterpret_cast<const float4*>(&vs[el * kSlot + off]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  u and out are device pointers
// to contiguous f32 [E, 8, 8, 8] arrays, m to a contiguous f32 [8, 8]
// array, all 16-byte aligned.  Returns the cudaError_t of the launch (0
// on success).
extern "C" int d4est_axis_apply(const float* u, const float* m, float* out,
                                int E, void* stream) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (E + kElems - 1) / kElems;
  axis_apply_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, m, out, E);
  return (int)cudaGetLastError();
}
