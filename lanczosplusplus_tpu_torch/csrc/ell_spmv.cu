// ell_spmv: y[b, r] = diag[r] * x[b, r] + sum_k vals[r, k] * src[b, cols[r, k]]
// for a batch-major (batch, dim) block of vectors, one vector being the
// case batch = 1, in float64, float32, complex128 and complex64 (diag,
// values, x, src and y of the one type, indices int32), read from the
// sliced form of the padded (dim, K) ELL matrix (ops/kernels.py
// slice_ell).  src is x itself (src_pitch = dim), or for a row shard of a
// distributed matrix a longer source, member b's row at b * src_pitch:
// the all-gathered state, or the shard's rows followed by its halo.
//
// Replaces the Pallas TPU kernel lanczosplusplus_tpu/ops/pallas_kernels.py
// ell_spmv_pallas (body _ell_kernel).  It is the diagonal plus the
// SuperHubbardExtended S+S- exchange part (K = number of J bonds), the
// whole off-diagonal part of the flat models (Heisenberg, t-J, Kitaev,
// Rashba, FeAs spin-orbit: one slot per coupled pair, K from 16 to about
// 100), the interaction part of FeAs and every symmetry block.  It does no
// arithmetic to speak of and is bound by bytes, those of the nonzero
// entries and the vectors: per nonzero entry its column index (4 bytes)
// and value, per row diag once and per batch member x once and y written:
// 12 nnz + (8 + 16 batch) dim bytes in float64 (8 nnz + (4 + 8 batch) dim
// in float32, 20 nnz + (16 + 32 batch) dim in complex128).  The gathered x
// entries are re-reads of the x block, which the caches have to serve (x
// of the 24-site Heisenberg ring is 21.6 MB, in the 50 MB L2).
//
// Layout.  The padded ELL is mostly padding: three quarters of the
// 24-site Heisenberg ring's, 85 % of the 12-site SuperHubbardExtended
// J-ELL's, 9 of 24 slots on a momentum block.  A kernel over the padded
// arrays reads every padding entry's index and value, more bytes than the
// whole y = Hx needs, so none could reach the library's CSR product.  The
// sliced form (SELL-C-sigma) drops every entry whose value is 0, keeps
// each row's others in their k order, sorts the rows by their count of
// entries within windows of sigma rows and cuts them into slices of C =
// 32 rows, each as wide as its longest row, stored column-major: entry j
// of the slice's lane i at offsets[s] + 32 j + i, the slice's padding
// (its shorter rows' last slots) value 0.  perm[p] is the row at sorted
// position p = 32 s + i.  (Skipping the padding inside a padded row, by a
// value test or a bit mask, lost to reading it: the padding's index and
// value were read all the same, and its gathers pointed at the thread's
// own row and coalesced.  Skipped in the layout, its bytes are not read.)
//
// Design.  One warp a slice, one lane a row.  The warp walks to its
// slice's own width; each step loads 32 neighbouring indices (128 bytes)
// and 32 neighbouring values at once, U entries of the row together, and
// then starts all their gathers of x, through the read-only path, but
// none for a value of 0 (the slice's padding).  U is 4, 8 or 16 (8 at
// most in complex128), the smallest that holds the rows of the slices
// that carry 9 in 10 of the slots (the form's typical width): a larger U
// costs registers, so fewer warps hide the gathers' latency, and a
// smaller one re-reads a row's entries for every pair of members.  On the
// H100 the widest slice's U left the 12-site J-ELL (typical width 8,
// widest 12) slower at R = 14 than the padded kernel; the typical width's
// did not.  The off-diagonal sum is
// formed first, over the row's nonzero entries in k order, `acc += v * x`
// as the padded kernel formed it (which added a zero's product for each
// padding entry on top: the sum is the same, bit for bit), and the
// diagonal term added last; y is written at the row perm[p].
//
// Batch.  A lane keeps its row and walks the batch: in a slice no wider
// than U (the J-ELL) the row's indices and values are loaded once into
// registers and serve all batch members, so the matrix is read once
// however many vectors it multiplies; a wider slice goes chunk by chunk of
// U entries and is re-read per pair of members, from the caches.  Member
// b's gathers go to src + b * src_pitch.  Two members are taken at a time
// (MEMBERS), so a lane has 2 U gathers in flight before its first
// multiply.  Offsets are 64-bit: slots and b * dim pass 2^31 at sizes the
// card holds.  Each member's sum is formed in the same order whatever the
// batch, so a row of a block equals its single-vector result bit for bit.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int C = 32;           // rows a slice: one warp, one lane a row
constexpr int THREADS = 256;    // 8 slices a block

constexpr int MEMBERS = 2;  // batch members a lane takes at a time

// Complex scalar: the arithmetic ell_spmv needs and no more.
template <typename R>
struct Cplx {
  R re, im;
  __device__ __forceinline__ Cplx() {}
  __device__ __forceinline__ explicit Cplx(R r) : re(r), im(0) {}
  __device__ __forceinline__ Cplx(R r, R i) : re(r), im(i) {}
  __device__ __forceinline__ Cplx& operator+=(const Cplx& o) {
    re += o.re;
    im += o.im;
    return *this;
  }
};

template <typename R>
__device__ __forceinline__ Cplx<R> operator*(const Cplx<R>& a,
                                             const Cplx<R>& b) {
  return Cplx<R>(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}

template <typename R>
__device__ __forceinline__ Cplx<R> operator+(const Cplx<R>& a,
                                             const Cplx<R>& b) {
  return Cplx<R>(a.re + b.re, a.im + b.im);
}

__device__ __forceinline__ bool nonzero(double v) { return v != 0; }
__device__ __forceinline__ bool nonzero(float v) { return v != 0; }
template <typename R>
__device__ __forceinline__ bool nonzero(const Cplx<R>& v) {
  return v.re != 0 || v.im != 0;
}

// Loads through the read-only path; a complex value in one instruction.
__device__ __forceinline__ double ld(const double* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ Cplx<double> ld(const Cplx<double>* p) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(p));
  return Cplx<double>(t.x, t.y);
}
__device__ __forceinline__ Cplx<float> ld(const Cplx<float>* p) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  return Cplx<float>(t.x, t.y);
}

// The most entries of a row a lane keeps in flight, by value type.
template <typename T>
struct Tuning {
  static constexpr int MAX_U = 16;
};
template <>
struct Tuning<Cplx<double>> {
  static constexpr int MAX_U = 8;
};

// Start the loads of a lane's entries [j0, j0 + U), predicated past the
// slice's width w: entry j at c[C j], v[C j].
template <typename T, int U>
__device__ __forceinline__ void load_entries(int (&ci)[U], T (&vi)[U],
                                             const int* __restrict__ c,
                                             const T* __restrict__ v, int j0,
                                             int w) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    ci[u] = j0 + u < w ? __ldg(c + (j0 + u) * C) : 0;
#pragma unroll
  for (int u = 0; u < U; ++u)
    vi[u] = j0 + u < w ? ld(v + (j0 + u) * C) : T(0);
}

// Row r of batch members [b, b + B): all their gathers of a chunk of U
// entries are started before the first multiply.
template <typename T, int U, int B>
__device__ __forceinline__ void apply_members(
    const T* __restrict__ x, const T* __restrict__ src, long long src_pitch,
    T* __restrict__ y, const int* __restrict__ c, const T* __restrict__ v,
    int (&ci)[U], T (&vi)[U], bool once, T d, long long r, int dim, int w,
    int b) {
  T acc[B];
#pragma unroll
  for (int j = 0; j < B; ++j) acc[j] = T(0);
  for (int j0 = 0; j0 < w; j0 += U) {
    if (!once) load_entries<T, U>(ci, vi, c, v, j0, w);
    T xi[B][U];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const T* xb = src + static_cast<long long>(b + j) * src_pitch;
#pragma unroll
      for (int u = 0; u < U; ++u)
        xi[j][u] = nonzero(vi[u]) ? ld(xb + ci[u]) : T(0);
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
__device__ __forceinline__ void slice_rows(
    const T* __restrict__ diag, const int* __restrict__ perm,
    const long long* __restrict__ offsets, const int* __restrict__ widths,
    const int* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ x, const T* __restrict__ src, long long src_pitch,
    T* __restrict__ y, int dim, int slices, int batch) {
  const int s = blockIdx.x * (THREADS / C) + threadIdx.x / C;
  const int lane = threadIdx.x % C;
  const long long p = static_cast<long long>(s) * C + lane;
  if (s >= slices || p >= dim) return;
  const long long r = __ldg(perm + p);
  const int w = __ldg(widths + s);
  const long long first = __ldg(offsets + s) + lane;
  const int* c = cols + first;
  const T* v = vals + first;
  const T d = diag[r];
  int ci[U];
  T vi[U];
  const bool once = w <= U;  // the whole row stays in registers
  if (once) load_entries<T, U>(ci, vi, c, v, 0, w);
  int b = 0;
  for (; b + MEMBERS <= batch; b += MEMBERS)
    apply_members<T, U, MEMBERS>(x, src, src_pitch, y, c, v, ci, vi, once, d,
                                 r, dim, w, b);
  for (; b < batch; ++b)
    apply_members<T, U, 1>(x, src, src_pitch, y, c, v, ci, vi, once, d, r,
                           dim, w, b);
}

#define ELL_SPMV_PARAMS(T)                                                  \
  const T *__restrict__ diag, const int *__restrict__ perm,                \
      const long long *__restrict__ offsets, const int *__restrict__ widths, \
      const int *__restrict__ cols, const T *__restrict__ vals,             \
      const T *__restrict__ x, const T *__restrict__ src,                    \
      long long src_pitch, T *__restrict__ y, int dim, int slices, int batch

template <typename T, int U>
__global__ void __launch_bounds__(THREADS)
ell_spmv_kernel(ELL_SPMV_PARAMS(T)) {
  slice_rows<T, U>(diag, perm, offsets, widths, cols, vals, x, src,
                   src_pitch, y, dim, slices, batch);
}

// complex128: the compiler's own choice of registers at 8 entries spills;
// bounded to two blocks an SM it takes 128 and spills none
template <int U>
__global__ void __launch_bounds__(THREADS, 2)
ell_spmv_kernel(ELL_SPMV_PARAMS(Cplx<double>)) {
  slice_rows<Cplx<double>, U>(diag, perm, offsets, widths, cols, vals, x,
                              src, src_pitch, y, dim, slices, batch);
}

// The kernel of a type and unroll: the complex128 one of its own, so that
// the other template is never instantiated for complex128
template <typename T, int U>
auto kernel_of() {
  void (*kernel)(ELL_SPMV_PARAMS(T));
  if constexpr (std::is_same_v<T, Cplx<double>>)
    kernel = ell_spmv_kernel<U>;
  else
    kernel = ell_spmv_kernel<T, U>;
  return kernel;
}

template <typename T, int U>
int launch_unrolled(const void* diag, const void* perm, const void* offsets,
                    const void* widths, const void* cols, const void* vals,
                    const void* x, const void* src, long long src_pitch,
                    void* y, int dim, int slices, int batch, void* stream) {
  const int blocks = (slices + THREADS / C - 1) / (THREADS / C);
  kernel_of<T, U>()<<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(diag), static_cast<const int*>(perm),
      static_cast<const long long*>(offsets),
      static_cast<const int*>(widths), static_cast<const int*>(cols),
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<const T*>(src), src_pitch, static_cast<T*>(y), dim, slices,
      batch);
  return static_cast<int>(cudaGetLastError());
}

// U from the sliced form's typical width (slices no wider hold 9 in 10 of
// its slots): the smallest unroll that keeps those rows in registers
template <typename T>
int launch(const void* diag, const void* perm, const void* offsets,
           const void* widths, const void* cols, const void* vals,
           const void* x, const void* src, long long src_pitch, void* y,
           int dim, int slices, int width, int batch, void* stream) {
  auto go = width <= 4 ? launch_unrolled<T, 4> : launch_unrolled<T, 8>;
  // the 16-entry kernel is not even compiled for a type that caps at 8
  if constexpr (Tuning<T>::MAX_U >= 16) {
    if (width > 8) go = launch_unrolled<T, 16>;
  }
  return go(diag, perm, offsets, widths, cols, vals, x, src, src_pitch, y, dim,
            slices, batch, stream);
}

}  // namespace

// The sliced form (ops/kernels.py SlicedEll): perm (dim,) int32, offsets
// (slices,) int64, widths (slices,) int32, cols and vals by slot; width
// is its typical width; x and y contiguous (batch, dim); src member b's
// row at b * src_pitch (x and dim for a matrix's own rows).
#define LPP_ELL_SPMV(suffix, T)                                              \
  extern "C" int lpp_ell_spmv_##suffix(                                      \
      const void* diag, const void* perm, const void* offsets,               \
      const void* widths, const void* cols, const void* vals, const void* x, \
      const void* src, long long src_pitch, void* y, int dim, int slices,    \
      int width, int batch, void* stream) {                                  \
    return launch<T>(diag, perm, offsets, widths, cols, vals, x, src,        \
                     src_pitch, y, dim, slices, width, batch, stream);       \
  }

LPP_ELL_SPMV(f64, double)
LPP_ELL_SPMV(f32, float)
LPP_ELL_SPMV(c128, Cplx<double>)
LPP_ELL_SPMV(c64, Cplx<float>)
