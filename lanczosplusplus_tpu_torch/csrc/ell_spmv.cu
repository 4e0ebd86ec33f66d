// ell_spmv: y[r] = diag[r] * x[r] + sum_k vals[r, k] * x[cols[r, k]] over a
// padded ELL matrix of shape (dim, K), for float64 and float32.  Padding
// entries point at their own row with value 0.
//
// Replaces the Pallas TPU kernel lanczosplusplus_tpu/ops/pallas_kernels.py
// ell_spmv_pallas (body _ell_kernel).  On the main path it is the diagonal
// plus the SuperHubbardExtended S+S- exchange part, K = number of J bonds.
// It does no arithmetic to speak of and is bound by bytes: per row it
// reads K column indices (4 bytes) and K values, diag and x once, and
// writes y: 12 K + 24 bytes a row in float64 (8 K + 12 in float32).  The
// gathered x entries are re-reads of the one x vector, which the caches
// have to serve.
//
// Design.  The TPU version walked a (row block, source block) grid of
// lane-replicated source tiles with a masked take_along_axis, O(dim^2 /
// block) work, because Mosaic had no dynamic gather.  Hopper gathers
// directly: one thread per row.  cols and vals are addressed through a
// (row stride, k stride) pair.  The layout the port stores is K-major,
// strides (1, dim): thread r's k-th entry is base[k * dim + r], so each
// load instruction of a warp reads 128 contiguous bytes of indices and 256
// of values.  The row-major (K, 1) layout is taken too; there a warp's
// loads are strided and the L1 cache has to absorb them.  In the K-major
// layout every entry of a row lies in another cache line, so a thread
// that loaded them a few at a time would wait for device memory once per
// few: the kernel starts a row's index and value loads all at once (U at
// a time, U = 4, 8 or 16 chosen from K, predicated past K) and then all
// its gathers, through the read-only path.  With the loads issued so, both
// layouts take the same time on the H100.  (Skipping the gathers of the
// padding's zeros, 85 % of the 12-site J-ELL, was measured and changed
// nothing: they point at the thread's own row and coalesce.)  Offsets are
// 64-bit: k * dim passes 2^31 from 20 sites on.  The off-diagonal sum is
// formed first, in k order, and the diagonal term added last, the order
// of the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T, int U>
__global__ void __launch_bounds__(THREADS)
ell_spmv_kernel(const T* __restrict__ diag, const int* __restrict__ cols,
                const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, int dim, int K, long long row_stride,
                long long k_stride) {
  const long long r = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (r >= dim) return;
  const int* c = cols + r * row_stride;
  const T* v = vals + r * row_stride;
  T acc = T(0);
  for (int k0 = 0; k0 < K; k0 += U) {
    int ci[U];
    T vi[U], xi[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      ci[u] = k0 + u < K ? __ldg(c + (k0 + u) * k_stride) : 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      vi[u] = k0 + u < K ? __ldg(v + (k0 + u) * k_stride) : T(0);
#pragma unroll
    for (int u = 0; u < U; ++u)
      xi[u] = k0 + u < K ? __ldg(x + ci[u]) : T(0);
#pragma unroll
    for (int u = 0; u < U; ++u) acc += vi[u] * xi[u];
  }
  y[r] = diag[r] * x[r] + acc;
}

template <typename T, int U>
int launch_unrolled(const void* diag, const void* cols, const void* vals,
                    const void* x, void* y, int dim, int K,
                    long long row_stride, long long k_stride, void* stream) {
  const int blocks = (dim + THREADS - 1) / THREADS;
  ell_spmv_kernel<T, U><<<blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(diag), static_cast<const int*>(cols),
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), dim, K, row_stride, k_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* diag, const void* cols, const void* vals,
           const void* x, void* y, int dim, int K, long long row_stride,
           long long k_stride, void* stream) {
  auto go = K <= 4 ? launch_unrolled<T, 4>
                   : K <= 8 ? launch_unrolled<T, 8> : launch_unrolled<T, 16>;
  return go(diag, cols, vals, x, y, dim, K, row_stride, k_stride, stream);
}

}  // namespace

// row_stride and k_stride, in elements, address cols and vals alike:
// entry (r, k) is at base[r * row_stride + k * k_stride].
extern "C" int lpp_ell_spmv_f64(const void* diag, const void* cols,
                                const void* vals, const void* x, void* y,
                                int dim, int K, long long row_stride,
                                long long k_stride, void* stream) {
  return launch<double>(diag, cols, vals, x, y, dim, K, row_stride, k_stride,
                        stream);
}

extern "C" int lpp_ell_spmv_f32(const void* diag, const void* cols,
                                const void* vals, const void* x, void* y,
                                int dim, int K, long long row_stride,
                                long long k_stride, void* stream) {
  return launch<float>(diag, cols, vals, x, y, dim, K, row_stride, k_stride,
                       stream);
}
