// ell_spmv: y[r] = diag[r] * x[r] + sum_k vals[r, k] * x[cols[r, k]] over a
// padded ELL matrix in row-major (dim, K) layout, for float64 and float32.
// Padding entries point at their own row with value 0.
//
// Replaces the Pallas TPU kernel lanczosplusplus_tpu/ops/pallas_kernels.py
// ell_spmv_pallas (body _ell_kernel).  On the main path it is the diagonal
// plus the SuperHubbardExtended S+S- exchange part, K = number of J bonds.
// It does no arithmetic to speak of and is bound by memory: per row it
// reads K column indices (4 bytes), K values and K gathered x entries
// (8 bytes each in float64), plus diag, x and y: about 20 K + 24 bytes.
//
// Design.  The TPU version walked a (row block, source block) grid of
// lane-replicated source tiles with a masked take_along_axis, O(dim^2 /
// block) work, because Mosaic had no dynamic gather.  Hopper gathers
// directly: one thread per row, looping over K.  A warp's rows are
// contiguous in the (dim, K) layout, so the 32 * K indices and values it
// reads over its loop are one contiguous span that the L1 cache serves;
// the x gather goes through the read-only cache.  The off-diagonal sum is
// formed first and the diagonal term added last, the order of the plain
// version.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
ell_spmv_kernel(const T* __restrict__ diag, const int* __restrict__ cols,
                const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, int dim, int K) {
  const long long r = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (r >= dim) return;
  const int* c = cols + r * K;
  const T* v = vals + r * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) acc += v[k] * __ldg(x + c[k]);
  y[r] = diag[r] * x[r] + acc;
}

template <typename T>
int launch(const void* diag, const void* cols, const void* vals,
           const void* x, void* y, int dim, int K, void* stream) {
  const int blocks = (dim + THREADS - 1) / THREADS;
  ell_spmv_kernel<T><<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(diag), static_cast<const int*>(cols),
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), dim, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lpp_ell_spmv_f64(const void* diag, const void* cols,
                                const void* vals, const void* x, void* y,
                                int dim, int K, void* stream) {
  return launch<double>(diag, cols, vals, x, y, dim, K, stream);
}

extern "C" int lpp_ell_spmv_f32(const void* diag, const void* cols,
                                const void* vals, const void* x, void* y,
                                int dim, int K, void* stream) {
  return launch<float>(diag, cols, vals, x, y, dim, K, stream);
}
