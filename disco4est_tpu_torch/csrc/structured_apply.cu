// Fused structured SIPG apply for NVIDIA Hopper (sm_90a), f32 on FFMA.
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
// What bounds it on this card.  The apply costs ~2*E*nv*(nblk*nv + tw)
// flop (5.4 GFLOP at p = 7, E = 4096) against ~4*E*(2*nv + tw) bytes of
// streamed data (u, traces, Au): ~190 flop/byte at p = 7 and ~25 at p = 3.
// The card's f32 ridge is ~20 flop/byte (67 TFLOP/s on FFMA over
// 3.35 TB/s), so f32 FFMA throughput bounds it.  It must stay in IEEE f32
// (no TF32, no tensor cores): the inner CG diverges under reduced-precision
// products, and the kernel is held to 5e-6 relative against f64.
//
// What the design does about it: see `sipg_gemm.cuh`.  Neighbor traces are
// read straight from device memory at row e + delta[f], only on interior
// faces and only inside 0 <= e + delta < E; there is no window, so any
// brick size works.  Making it fast (wgmma, TMA, a bf16/TF32 variant) is
// later work.

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
// pointers to contiguous f32 arrays: u [E, nv], tr [E, tw], cw [E, nblk],
// scal [E, 24], wvol [nv, nblk*nv], wlift [tw, nv], out [E, nv].  `delta`
// and `opp` are host arrays of 6 ints.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int d4est_structured_apply(
    const float* u, const float* tr, const float* cw, const float* scal,
    const float* wvol, const float* wlift, float* out, int E, int nl,
    int nblk, const int* delta, const int* opp, void* stream) {
  FaceShift fs;
  for (int f = 0; f < d4est::kFaces; ++f) {
    fs.delta[f] = delta[f];
    fs.opp[f] = opp[f];
  }
  fs.E = E;
  return d4est::launch_sipg(u, tr, cw, scal, wvol, wlift, out, E, nl, nblk,
                            fs, static_cast<cudaStream_t>(stream));
}
