// The frozen-coefficient mass term of the Newton Jacobian for NVIDIA
// Hopper (sm_90a), f64 and f32:  y = Vᵀ (c ⊙ (V v)), per element.
//
// It replaces no Pallas TPU kernel: the JAX package's
// `apply_mass_fof_lin` (`disco4est_tpu/laplacian/nonlinear.py:47`) is
// plain jnp, which XLA fuses.  The Python side, with the plain PyTorch
// version of the same function (`apply_mass_coeff_plain`), is
// `disco4est_tpu_torch/laplacian/nonlinear.py` (`mass_apply_cuda`).  It was
// added because eager PyTorch runs each of the six one-axis contractions
// as a strided-batched GEMM of tens of thousands of 3 x 3 problems, each
// padded to a 32 x 64 tile, which at deg 2 took ~370x the bytes bound.
//
// What it computes.  For v [E, n, ..., n] (dim axes, x fastest), c
// [E, nq, ..., nq] and the 1-D Lobatto -> quadrature interpolation
// V [nq, n]:  u = (V ⊗ ... ⊗ V) v along x, then y, then z;  w = c ⊙ u;
// y = (Vᵀ ⊗ ... ⊗ Vᵀ) w along x, then y, then z: the sum-factorised
// order of `vol_interp`, each one-axis sum taken in index order.  The
// arithmetic type is the input's; f64 stays f64 throughout.
//
// What bounds it on this card.  It reads v and c and writes y once:
// (2 n^dim + nq^dim) * sizeof(T) bytes an element (21.2 MB, 6.3 us at
// 3.35 TB/s, at deg 2 / level 5 in f64) against 12 n^4 flop an element
// in 3D at nq = n: 1.5 flop a byte at deg 2, 4 at deg 7, below the ridge
// of f64 FMA outside the tensor cores (34 TFLOP/s over 3.35 TB/s, ~10),
// so device-memory bandwidth bounds it.
//
// What the design does about it: each byte crosses device memory once.  A
// block owns a tile of kElems whole elements.  It stages their v and c
// slices in shared memory with coalesced 16-byte asynchronous copies
// (cp.async), all in flight together before the first sum, runs the dim
// forward passes, the product and the dim transposed passes there (each
// thread contracts whole lines of one axis into registers and writes them
// back; passes are separated by __syncthreads), and stores y with
// coalesced 16-byte stores.  V is a kernel parameter, so it sits in the
// constant bank and the unrolled sums read it as immediate operands.  A
// tile fills ~8 KB of shared memory: many small blocks a multiprocessor,
// so that some blocks' copies overlap others' sums (on an H100, at deg 2 /
// level 5, tiles of 8-16 KB took 11.7-12.2 us from cold L2, one wave of
// 40 KB tiles 14.6 us).  kElems is a multiple of what keeps every tile's
// slices 16-byte aligned; the ragged last tile is masked.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

__host__ __device__ constexpr int ipow(int b, int p) {
  return p == 0 ? 1 : b * ipow(b, p - 1);
}
constexpr int igcd(int a, int b) { return b == 0 ? a : igcd(b, a % b); }
constexpr int imin(int a, int b) { return a < b ? a : b; }
constexpr int imax(int a, int b) { return a > b ? a : b; }

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// The interpolation V[a][i] (a < NQ quadrature points, i < N nodes), passed
// by value as a kernel parameter.
template <typename T, int N, int NQ>
struct Interp {
  T a[NQ][N];
};

template <typename T, int DIM, int N, int NQ>
struct Tile {
  static constexpr int kNv = ipow(N, DIM);   // nodal values an element
  static constexpr int kNq = ipow(NQ, DIM);  // quadrature values an element
  static constexpr int kLines = ipow(NQ, DIM - 1);  // most lines of a pass
  static constexpr int kVec = 16 / (int)sizeof(T);
  // elements a tile must be a multiple of for 16-byte aligned slices
  static constexpr int kAlign =
      imax(kVec / igcd(kNv, kVec), kVec / igcd(kNq, kVec));
  // shared memory an element: v staged (later y), c staged, the work slot
  static constexpr int kSlotBytes = (kNv + 2 * kNq) * (int)sizeof(T);
  static constexpr int kElems =
      imax(kAlign, 8192 / kSlotBytes / kAlign * kAlign);
  static constexpr int kThreads = imin(256, (kElems * kLines + 31) / 32 * 32);
  static_assert(kElems * kSlotBytes <= 48 * 1024, "static shared memory");
  static_assert(kThreads <= 1024, "threads a block");
};

// Start the asynchronous copy of `count` values from device to shared
// memory, 16 bytes a thread where they fill a vector, one value at a time
// for the rest; both sides are 16-byte aligned.
template <typename T, int THREADS>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int count) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int nvec = count / kVec;
  for (int q = threadIdx.x; q < nvec; q += THREADS)
    __pipeline_memcpy_async(dst + q * kVec, src + q * kVec, 16);
  for (int q = nvec * kVec + threadIdx.x; q < count; q += THREADS)
    __pipeline_memcpy_async(dst + q, src + q, sizeof(T));
}

// Copy `count` values from shared to device memory, 16 bytes a thread
// where they fill a vector, one value at a time for the rest.
template <typename T, int THREADS>
__device__ __forceinline__ void copy_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int count) {
  using V = typename Vec16<T>::type;
  constexpr int kVec = 16 / (int)sizeof(T);
  const int nvec = count / kVec;
  for (int q = threadIdx.x; q < nvec; q += THREADS)
    reinterpret_cast<V*>(dst)[q] = reinterpret_cast<const V*>(src)[q];
  for (int q = nvec * kVec + threadIdx.x; q < count; q += THREADS)
    dst[q] = src[q];
}

// One pass along axis D (0 = x, the fastest) over the tile's n_here
// elements.  Before it the axes below D have size LO and those above HI;
// each line reads IN values (stride SB^D in `src`, whose axis k has
// stride SB^k and elements `src_slot` apart) and writes OUT values to
// `dst` (DB, `dst_slot`).  Forward: out[a] = sum_i V[a][i] in[i];
// transposed (TRANS): out[i] = sum_a V[a][i] in[a].  With MUL each output
// is multiplied by `cs` at the same place (cs has dst's layout).  A line
// is read whole before it is written, and the lines of a pass are
// disjoint, so src may be dst.
template <typename T, int DIM, int N, int NQ, int THREADS, int D, int LO,
          int HI, int IN, int OUT, int SB, int DB, bool TRANS, bool MUL>
__device__ __forceinline__ void axis_pass(const T* src, int src_slot, T* dst,
                                          int dst_slot,
                                          const T* __restrict__ cs,
                                          const Interp<T, N, NQ>& V,
                                          int n_here) {
  constexpr int kL = ipow(LO, D) * ipow(HI, DIM - 1 - D);
  for (int l = threadIdx.x; l < n_here * kL; l += THREADS) {
    const int el = l / kL;
    int r = l - el * kL;
    int so = el * src_slot, d_o = el * dst_slot;
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      if (k == D) continue;
      const int size = k < D ? LO : HI;
      const int ck = r % size;
      r /= size;
      so += ck * ipow(SB, k);
      d_o += ck * ipow(DB, k);
    }
    T in[IN], out[OUT];
#pragma unroll
    for (int i = 0; i < IN; ++i) in[i] = src[so + i * ipow(SB, D)];
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      T acc = TRANS ? V.a[0][o] * in[0] : V.a[o][0] * in[0];
#pragma unroll
      for (int i = 1; i < IN; ++i)
        acc = TRANS ? fma(V.a[i][o], in[i], acc) : fma(V.a[o][i], in[i], acc);
      out[o] = acc;
    }
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      if (MUL) out[o] = cs[d_o + o * ipow(DB, D)] * out[o];
      dst[d_o + o * ipow(DB, D)] = out[o];
    }
  }
}

template <typename T, int DIM, int N, int NQ>
__global__ void __launch_bounds__(Tile<T, DIM, N, NQ>::kThreads)
    mass_apply_kernel(const T* __restrict__ v, const T* __restrict__ c,
                      T* __restrict__ y, const Interp<T, N, NQ> V,
                      long long E) {
  using L = Tile<T, DIM, N, NQ>;
  constexpr int kT = L::kThreads;
  constexpr int kNv = L::kNv, kNq = L::kNq;
  __shared__ __align__(16) T S[L::kElems * kNv];  // v, then y
  __shared__ __align__(16) T C[L::kElems * kNq];  // c
  __shared__ __align__(16) T W[L::kElems * kNq];  // the passes' work
  const long long e0 = (long long)blockIdx.x * L::kElems;
  const int n_here = (int)(E - e0 < L::kElems ? E - e0 : L::kElems);

  stage_tile<T, kT>(S, v + e0 * kNv, n_here * kNv);
  stage_tile<T, kT>(C, c + e0 * kNq, n_here * kNq);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // V along x, y(, z); the last forward pass multiplies by c
  axis_pass<T, DIM, N, NQ, kT, 0, NQ, N, N, NQ, N, NQ, false, false>(
      S, kNv, W, kNq, C, V, n_here);
  __syncthreads();
  if constexpr (DIM == 3) {
    axis_pass<T, DIM, N, NQ, kT, 1, NQ, N, N, NQ, NQ, NQ, false, false>(
        W, kNq, W, kNq, C, V, n_here);
    __syncthreads();
  }
  axis_pass<T, DIM, N, NQ, kT, DIM - 1, NQ, N, N, NQ, NQ, NQ, false, true>(
      W, kNq, W, kNq, C, V, n_here);
  __syncthreads();
  // Vᵀ along x, y(, z); the last transposed pass writes y's compact layout
  axis_pass<T, DIM, N, NQ, kT, 0, N, NQ, NQ, N, NQ, NQ, true, false>(
      W, kNq, W, kNq, C, V, n_here);
  __syncthreads();
  if constexpr (DIM == 3) {
    axis_pass<T, DIM, N, NQ, kT, 1, N, NQ, NQ, N, NQ, NQ, true, false>(
        W, kNq, W, kNq, C, V, n_here);
    __syncthreads();
  }
  axis_pass<T, DIM, N, NQ, kT, DIM - 1, N, NQ, NQ, N, NQ, N, true, false>(
      W, kNq, S, kNv, C, V, n_here);
  __syncthreads();

  copy_tile<T, kT>(y + e0 * kNv, S, n_here * kNv);
}

// The two operations of an instance: its launch, and its tile's element
// count (what a test needs to hit a tile's edge).
struct Launch {
  template <typename T, int DIM, int N, int NQ>
  static int run(const T* v, const T* c, T* y, const T* v_host, long long E,
                 cudaStream_t stream) {
    using L = Tile<T, DIM, N, NQ>;
    if (E <= 0) return (int)cudaErrorInvalidValue;
    Interp<T, N, NQ> V;
    for (int a = 0; a < NQ; ++a)
      for (int i = 0; i < N; ++i) V.a[a][i] = v_host[a * N + i];
    const long long grid = (E + L::kElems - 1) / L::kElems;
    if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
    mass_apply_kernel<T, DIM, N, NQ><<<(unsigned)grid, L::kThreads, 0,
                                       stream>>>(v, c, y, V, E);
    return (int)cudaGetLastError();
  }
};

struct TileElems {
  template <typename T, int DIM, int N, int NQ>
  static int run() {
    return Tile<T, DIM, N, NQ>::kElems;
  }
};

// Op::run<T, dim, n, nq>(args...) for the instance of (dim, n, nq); -1
// where there is none.
template <typename Op, typename T, int DIM, int N, typename... A>
int by_nq(int nq, A... a) {
  switch (nq - N) {
    case 0: return Op::template run<T, DIM, N, N>(a...);
    case 1: return Op::template run<T, DIM, N, N + 1>(a...);
    case 2: return Op::template run<T, DIM, N, N + 2>(a...);
  }
  return -1;
}

template <typename Op, typename T, int DIM, typename... A>
int by_n(int n, int nq, A... a) {
  switch (n) {
    case 2: return by_nq<Op, T, DIM, 2>(nq, a...);
    case 3: return by_nq<Op, T, DIM, 3>(nq, a...);
    case 4: return by_nq<Op, T, DIM, 4>(nq, a...);
    case 5: return by_nq<Op, T, DIM, 5>(nq, a...);
    case 6: return by_nq<Op, T, DIM, 6>(nq, a...);
    case 7: return by_nq<Op, T, DIM, 7>(nq, a...);
    case 8: return by_nq<Op, T, DIM, 8>(nq, a...);
  }
  return -1;
}

template <typename Op, typename T, typename... A>
int dispatch(int dim, int n, int nq, A... a) {
  if (dim == 2) return by_n<Op, T, 2>(n, nq, a...);
  if (dim == 3) return by_n<Op, T, 3>(n, nq, a...);
  return -1;
}

template <typename T>
int mass_apply(const T* v, const T* c, T* y, const T* v_host, long long E,
               int dim, int n, int nq, void* stream) {
  const int err = dispatch<Launch, T>(dim, n, nq, v, c, y, v_host, E,
                                      static_cast<cudaStream_t>(stream));
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

}  // namespace

// Plain C entry points (bound with ctypes), one a type.  v and y are
// device pointers to contiguous [E, n^dim] arrays, c to a contiguous
// [E, nq^dim] array, all 16-byte aligned; v_host is a host pointer to the
// row-major [nq, n] interpolation.  dim 2 or 3, n 2-8, nq n to n + 2.
// Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a size without an instance).
extern "C" int d4est_mass_apply_f64(const double* v, const double* c,
                                    double* y, const double* v_host,
                                    long long E, int dim, int n, int nq,
                                    void* stream) {
  return mass_apply<double>(v, c, y, v_host, E, dim, n, nq, stream);
}

extern "C" int d4est_mass_apply_f32(const float* v, const float* c, float* y,
                                    const float* v_host, long long E, int dim,
                                    int n, int nq, void* stream) {
  return mass_apply<float>(v, c, y, v_host, E, dim, n, nq, stream);
}

// The elements a block owns for (bytes of the type, dim, n, nq); -1 where
// there is no instance.
extern "C" int d4est_mass_tile_elems(int itemsize, int dim, int n, int nq) {
  if (itemsize == 8) return dispatch<TileElems, double>(dim, n, nq);
  if (itemsize == 4) return dispatch<TileElems, float>(dim, n, nq);
  return -1;
}
