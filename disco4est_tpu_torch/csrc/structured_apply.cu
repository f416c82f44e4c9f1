// Fused structured SIPG apply for NVIDIA Hopper (sm_90a), split-TF32
// products on the tensor cores.
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
// and the inner CG keeps its iteration count.
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

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers to contiguous f32 arrays: u [E, nv], tr [E, tw], meta [E, 28]
// (`fused.sipg_meta`: the per-face scalars and cw), wpack (B split and
// packed by `fused.pack_sipg_weights`), out [E, nv].  `delta` and `opp`
// are host arrays of 6 ints.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int d4est_structured_apply(const float* u, const float* tr,
                                      const float* meta, const float* wpack,
                                      float* out, int E, int nl, int nblk,
                                      const int* delta, const int* opp,
                                      void* stream) {
  FaceShift fs;
  for (int f = 0; f < d4est::kFaces; ++f) {
    fs.delta[f] = delta[f];
    fs.opp[f] = opp[f];
  }
  fs.E = E;
  return d4est::launch_sipg(u, tr, meta, wpack, out, E, nl, nblk, fs,
                            static_cast<cudaStream_t>(stream));
}
