// Fused structured SIPG apply for NVIDIA Hopper (sm_90a), split-TF32
// products on the tensor cores, or bf16 products (precision="bf16").
//
// Replaces the Pallas TPU kernel `_kernel_lex` of
// `disco4est_tpu/laplacian/structured.py` (the inner f32 apply of the
// mixed-precision solve on uniform bricks).  The Python side is
// `disco4est_tpu_torch/laplacian/structured.py` (`lex_apply_cuda`), which
// also holds the plain PyTorch version of the same function
// (`lex_apply_plain`).
//
// What it computes: the fused pass of `sipg_gemm.cuh` (volume GEMM + face
// terms + lift GEMM as one GEMM with a generated A tile).  Elements are in
// lexicographic order (x fastest), so the neighbor across face f of
// element e is element e + delta[f] and its matching face is opp[f].
//
// What bounds it on this card.  The apply costs 2*E*nv*(nblk*nv + tw)
// flop against ~4*E*(2*nv + tw) bytes of streamed data (u, traces, Au):
// ~166 flop/byte at p = 7 and ~24 at p = 3.  With the products in split
// TF32 (three TF32 tensor-core products per f32 product, 495 TFLOP/s
// dense) the operations bound p = 7 (32.5 us at E = 4096) and the bytes
// bound p = 3 (13.5 us at E = 32768, the main path's solve).  The split
// keeps f32 accuracy: the kernel is held to 5e-6 relative against f64,
// and the inner CG keeps its iteration count.  In bf16 (one product per
// f32 product at 989 TFLOP/s dense, traces in 2 bytes) the bytes bound
// both sizes: 5.37 GFLOP (5.4 us) against ~24.8 MB (7.4 us) at p = 7, and
// 1.07 GFLOP (1.1 us) against ~32.7 MB (9.8 us) at p = 3.
//
// What the design does about it: see `sipg_gemm.cuh` (wgmma products, A
// generated once per element tile, bulk-copied B chunks and cp.async A
// sources in flight, a persistent grid).  Neighbor traces are read
// straight from device memory at row e + delta[f], only inside
// 0 <= e + delta < E; there is no window, so any brick size works.

#include "sipg_gemm.cuh"

namespace {

// Neighbor policy: lex offset and the neighbor's face index, per face.
// The face index f is computed at run time; the entries are picked with
// constant indices (a select chain in registers): indexing the
// kernel-parameter arrays with f made the whole kernel markedly slower on
// the card.
struct FaceShift {
  int delta[d4est::kFaces];
  int opp[d4est::kFaces];
  int E;
  __device__ __forceinline__ long long row(int e, int f) const {
    int d = delta[0], o = opp[0];
#pragma unroll
    for (int g = 1; g < d4est::kFaces; ++g) {
      if (f == g) {
        d = delta[g];
        o = opp[g];
      }
    }
    const int ne = e + d;
    return (ne >= 0 && ne < E) ? (long long)ne * d4est::kFaces + o : -1;
  }
};

}  // namespace

namespace {

template <bool BF16>
int structured_apply(const float* u, const void* tr, const float* meta,
                     const void* wpack, float* out, int E, int nl, int nblk,
                     const int* delta, const int* opp, void* stream) {
  FaceShift fs;
  for (int f = 0; f < d4est::kFaces; ++f) {
    fs.delta[f] = delta[f];
    fs.opp[f] = opp[f];
  }
  fs.E = E;
  return d4est::launch_sipg<BF16>(u, tr, meta, wpack, out, E, nl, nblk, fs,
                                  static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (bound with ctypes).  All pointers are device
// pointers to contiguous arrays: u [E, nv] (f32), tr [E, tw], meta [E, 28]
// (`fused.sipg_meta`: the per-face scalars and cw, f32), wpack (B packed by
// `fused.pack_sipg_weights`), out [E, nv] (f32).  `delta` and `opp` are
// host arrays of 6 ints.  Returns the cudaError_t of the launch (0 on
// success).  `d4est_structured_apply` takes f32 traces and the split-TF32
// pack; `d4est_structured_apply_bf16` (the TPU kernel's precision="bf16")
// bf16 traces and the bf16 pack of `fused.pack_sipg_weights_bf16`.
extern "C" int d4est_structured_apply(const float* u, const float* tr,
                                      const float* meta, const float* wpack,
                                      float* out, int E, int nl, int nblk,
                                      const int* delta, const int* opp,
                                      void* stream) {
  return structured_apply<false>(u, tr, meta, wpack, out, E, nl, nblk, delta,
                                 opp, stream);
}

extern "C" int d4est_structured_apply_bf16(const float* u, const void* tr,
                                           const float* meta,
                                           const void* wpack, float* out,
                                           int E, int nl, int nblk,
                                           const int* delta, const int* opp,
                                           void* stream) {
  return structured_apply<true>(u, tr, meta, wpack, out, E, nl, nblk, delta,
                                opp, stream);
}

// The bf16 kernel's launch plan at E elements: plan[0..2] = grid (CTAs),
// splits (CTAs sharing a tile's K chunks), K chunks the busiest CTA runs.
extern "C" int d4est_structured_apply_bf16_plan(int E, int nl, int nblk,
                                                int* plan) {
  return d4est::plan_sipg_bf16<FaceShift>(E, nl, nblk, plan);
}
