// ell_spmv: y[b, r] = diag[r] * x[b, r] + sum_k vals[r, k] * x[b, cols[r, k]]
// over a padded ELL matrix of contiguous shape (dim, K) and a batch-major
// (batch, dim) block of vectors, for float64 and float32.  Padding entries
// point at their own row with value 0.  One vector is the case batch = 1.
//
// Replaces the Pallas TPU kernel lanczosplusplus_tpu/ops/pallas_kernels.py
// ell_spmv_pallas (body _ell_kernel).  On the main path it is the diagonal
// plus the SuperHubbardExtended S+S- exchange part, K = number of J bonds.
// It does no arithmetic to speak of and is bound by bytes: per row it
// reads K column indices (4 bytes) and K values and diag once, and per
// batch member x once and writes y: 12 K + 8 + 16 batch bytes a row in
// float64 (8 K + 4 + 8 batch in float32).  The gathered x entries are
// re-reads of the x block, which the caches have to serve.
//
// Design.  The TPU version walked a (row block, source block) grid of
// lane-replicated source tiles with a masked take_along_axis, O(dim^2 /
// block) work, because Mosaic had no dynamic gather.  Hopper gathers
// directly: one thread per row.  A thread reads its row's K entries from
// neighbouring addresses, entry (r, k) at base[r * K + k], and the L1
// cache serves the warp's strided loads.  The kernel starts a row's index
// and value loads all at once (U at a time, U = 4, 8 or 16 chosen from K,
// predicated past K) and then all its gathers, through the read-only
// path.  K-major storage, read through a runtime stride pair, was
// measured within 4 % of this layout on the H100, for one vector and for
// a block of 14, and the stride pair itself cost 5 % at one vector and 14
// % at 14, so the launcher takes the contiguous layout alone.  (Skipping
// the gathers of the padding's zeros, 85 % of the 12-site J-ELL, was
// measured, by value test and by a bit mask kept per row, and lost: they
// point at the thread's own row and coalesce.)  The off-diagonal sum is
// formed first, in k order, and the diagonal term added last, the order
// of the plain version.
//
// Batch.  A thread keeps its row and walks the batch: with K <= U (every
// model of the port so far) the row's indices and values are loaded once
// into registers and serve all batch members, so the matrix is read once
// however many vectors it multiplies; a longer row is re-read per member,
// from the caches.  Member b's gathers go to x + b * dim, its reads of
// x[b, r] and writes of y[b, r] are contiguous across a warp.  Two members
// are taken at a time (MEMBERS), so a thread has 2 U gathers in flight
// before its first multiply: on the 12-site J-ELL that made a block of 14
// a fifth faster on the H100; three at a time (176 registers at U = 16)
// lost it again.  Offsets are 64-bit: r * K and b * dim pass 2^31 at sizes
// the card holds.  Each member's sum is formed in the same order whatever
// the batch, so a row of a block equals its single-vector result bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

constexpr int MEMBERS = 2;  // batch members a thread takes at a time

// Start the loads of entries [k0, k0 + U) of one row, predicated past K.
template <typename T, int U>
__device__ __forceinline__ void load_entries(int (&ci)[U], T (&vi)[U],
                                             const int* __restrict__ c,
                                             const T* __restrict__ v, int k0,
                                             int K) {
#pragma unroll
  for (int u = 0; u < U; ++u) ci[u] = k0 + u < K ? __ldg(c + k0 + u) : 0;
#pragma unroll
  for (int u = 0; u < U; ++u) vi[u] = k0 + u < K ? __ldg(v + k0 + u) : T(0);
}

// Row r of batch members [b, b + B): all their gathers of a chunk of U
// entries are started before the first multiply.
template <typename T, int U, int B>
__device__ __forceinline__ void apply_members(
    const T* __restrict__ x, T* __restrict__ y, const int* __restrict__ c,
    const T* __restrict__ v, int (&ci)[U], T (&vi)[U], bool once, T d,
    long long r, int dim, int K, int b) {
  T acc[B];
#pragma unroll
  for (int j = 0; j < B; ++j) acc[j] = T(0);
  for (int k0 = 0; k0 < K; k0 += U) {
    if (!once) load_entries<T, U>(ci, vi, c, v, k0, K);
    T xi[B][U];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const T* xb = x + static_cast<long long>(b + j) * dim;
#pragma unroll
      for (int u = 0; u < U; ++u)
        xi[j][u] = k0 + u < K ? __ldg(xb + ci[u]) : T(0);
    }
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int u = 0; u < U; ++u) acc[j] += vi[u] * xi[j][u];
  }
#pragma unroll
  for (int j = 0; j < B; ++j) {
    const long long at = static_cast<long long>(b + j) * dim + r;
    y[at] = d * x[at] + acc[j];
  }
}

template <typename T, int U>
__global__ void __launch_bounds__(THREADS)
ell_spmv_kernel(const T* __restrict__ diag, const int* __restrict__ cols,
                const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, int dim, int K, int batch) {
  const long long r = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (r >= dim) return;
  const int* c = cols + r * K;
  const T* v = vals + r * K;
  const T d = diag[r];
  int ci[U];
  T vi[U];
  const bool once = K <= U;  // the whole row stays in registers
  if (once) load_entries<T, U>(ci, vi, c, v, 0, K);
  int b = 0;
  for (; b + MEMBERS <= batch; b += MEMBERS)
    apply_members<T, U, MEMBERS>(x, y, c, v, ci, vi, once, d, r, dim, K, b);
  for (; b < batch; ++b)
    apply_members<T, U, 1>(x, y, c, v, ci, vi, once, d, r, dim, K, b);
}

template <typename T, int U>
int launch_unrolled(const void* diag, const void* cols, const void* vals,
                    const void* x, void* y, int dim, int K, int batch,
                    void* stream) {
  const int blocks = (dim + THREADS - 1) / THREADS;
  ell_spmv_kernel<T, U><<<blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(diag), static_cast<const int*>(cols),
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), dim, K, batch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* diag, const void* cols, const void* vals,
           const void* x, void* y, int dim, int K, int batch, void* stream) {
  auto go = K <= 4 ? launch_unrolled<T, 4>
                   : K <= 8 ? launch_unrolled<T, 8> : launch_unrolled<T, 16>;
  return go(diag, cols, vals, x, y, dim, K, batch, stream);
}

}  // namespace

// cols and vals are contiguous (dim, K), x and y contiguous (batch, dim).
extern "C" int lpp_ell_spmv_f64(const void* diag, const void* cols,
                                const void* vals, const void* x, void* y,
                                int dim, int K, int batch, void* stream) {
  return launch<double>(diag, cols, vals, x, y, dim, K, batch, stream);
}

extern "C" int lpp_ell_spmv_f32(const void* diag, const void* cols,
                                const void* vals, const void* x, void* y,
                                int dim, int K, int batch, void* stream) {
  return launch<float>(diag, cols, vals, x, y, dim, K, batch, stream);
}
