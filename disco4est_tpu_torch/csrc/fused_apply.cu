// Fused SIPG apply on any conforming orthogonal affine mesh, for NVIDIA
// Hopper (sm_90a), split-TF32 products on the tensor cores.
//
// Replaces the Pallas TPU kernel `_kernel` of
// `disco4est_tpu/laplacian/pallas_sipg.py` (phase B of
// `apply_sipg_pallas`).  The Python side is
// `disco4est_tpu_torch/laplacian/fused.py` (`fused_apply_cuda`), which also
// holds the plain PyTorch version of the same function
// (`fused_apply_plain`).
//
// What it computes: the fused pass of `sipg_gemm.cuh` (volume GEMM + face
// terms + lift GEMM as one GEMM with a generated A tile), in any element
// order.  The neighbor across face f of element e is face row
// nbr_row[e, f] = nbr_elem * 6 + nbr_face of the traces seen as
// [E*6, 2*nfl].  Two choices differ from the TPU kernel:
//   - the element's OWN traces are read from phase A's output, not
//     recomputed as u @ W_tr: that GEMM is 3.2 GFLOP at p = 7, E = 4096
//     while reading the same 12.6 MB costs ~4 us, and reading keeps both
//     sides of every face bit-identical;
//   - the neighbor gather is an indexed load inside the kernel (cp.async
//     into the A source slots), so the gathered array never exists in
//     device memory.  Boundary faces point at the element itself, so every
//     index is in range; the bnd flag overrides their values.
//
// What bounds it on this card.  The fused pass costs
// 2*E*nv*(nblk*nv + tw) flop, 5.37 GFLOP at p = 7, E = 4096, against about
// 32.5 MB of traffic (u, traces, Au, the weights, the tables).  With the
// products in split TF32 (three TF32 tensor-core products per f32 product,
// 495 TFLOP/s dense) the operations bound p = 7 (32.5 us) and the bytes
// bound p = 3 at E = 32768 (13.8 us).  The design is that of
// `sipg_gemm.cuh`; only the neighbor policy differs from the structured
// kernel.

#include "sipg_gemm.cuh"

namespace {

// Neighbor policy: one face row per (element, face), from the mesh tables.
struct RowTable {
  const int* nbr_row;  // [E, 6]
  __device__ __forceinline__ long long row(int e, int f) const {
    return nbr_row[(long long)e * d4est::kFaces + f];
  }
};

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers to contiguous arrays: u [E, nv], tr [E, tw], meta [E, 28]
// (`fused.sipg_meta`: the per-face scalars and cw), wpack (B split and
// packed by `fused.pack_sipg_weights`), out [E, nv] (f32) and nbr_row
// [E, 6] (int32, each in [0, 6E)).  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int d4est_fused_apply(const float* u, const float* tr,
                                 const int* nbr_row, const float* meta,
                                 const float* wpack, float* out, int E,
                                 int nl, int nblk, void* stream) {
  RowTable t;
  t.nbr_row = nbr_row;
  return d4est::launch_sipg(u, tr, meta, wpack, out, E, nl, nblk, t,
                            static_cast<cudaStream_t>(stream));
}
