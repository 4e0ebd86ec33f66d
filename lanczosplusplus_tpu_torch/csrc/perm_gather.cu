// perm_gather: Y[b, r, c] += sum_n a[n, r] * beta[n, c] * X[b, rs[n, r], cs[n, c]]
// for a batch of strided 2-D blocks X (batch, rows_src, cols_src) and Y
// (batch, rows, cols), int32 index tables rs (nb, rows) and cs (nb, cols),
// amplitude tables a (nb, rows) and beta (nb, cols) of the state's type,
// float64 or complex128.  Either side may be the identity with amplitude 1:
// a null rs reads row r, a null cs column c, a null a or beta multiplies by
// 1.  Destinations a channel does not reach carry amplitude 0 (at index 0
// or at their own index).
//
// No TPU kernel stands behind this one.  It applies every partial
// permutation of the block-Kronecker forms (lanczosplusplus_tpu/core/
// blockkron.py, PermCrossTerm: the t-J and Rashba cut-crossing bonds, the
// FeAs interaction channels, the FeAs spin-orbit moves) and the one-spin
// hop maps of a Hubbard-family sector too large to densify (core/sparse.py
// SpinFactorizedPart in gather form: up, rows identity and cs = up_cols^T;
// dn, rs = dn_cols^T and columns identity).  The JAX package runs both
// outside Pallas, as a loop of 1-D gathers over the bonds
// (blockkron.py _perm_cross_apply) that materializes a (rows, cols_src)
// row gather per channel group and a column gather per channel; here the
// function is one pass.
//
// It does little arithmetic and is bound by bytes: Y read and written once,
// X read once (the gathers re-read it from the caches), the tables once.
//
// Design, the simple one.  One thread per (b, r, c), c fastest, 256 to a
// block along c; blockIdx.y walks the (b, r) pairs.  A thread's a[., r] and
// rs[., r] are the same across its block (broadcast loads), its cs[., c]
// and beta[., c] loads are coalesced.  In the up form a warp's gathers fall
// in one row of X, which the L1 cache holds; in the dn form they are
// contiguous.  A channel whose row amplitude is 0 is skipped, a test that
// is uniform over the block.  The thread adds its channels to its element
// of Y in ascending order, (a x) beta, as the plain version does: one read
// and one write of Y, no atomics.  Offsets are 64-bit: a batch of 14
// states of the 20-site sector (35 M each) passes 2^31 elements.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

// Complex scalar: the arithmetic perm_gather needs and no more.
struct Cplx {
  double re, im;
  __device__ __forceinline__ Cplx() {}
  __device__ __forceinline__ explicit Cplx(double r) : re(r), im(0) {}
  __device__ __forceinline__ Cplx(double r, double i) : re(r), im(i) {}
  __device__ __forceinline__ Cplx& operator+=(const Cplx& o) {
    re += o.re;
    im += o.im;
    return *this;
  }
};

__device__ __forceinline__ Cplx operator*(const Cplx& a, const Cplx& b) {
  return Cplx(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}

__device__ __forceinline__ Cplx operator+(const Cplx& a, const Cplx& b) {
  return Cplx(a.re + b.re, a.im + b.im);
}

__device__ __forceinline__ double ld(const double* p) { return __ldg(p); }
__device__ __forceinline__ Cplx ld(const Cplx* p) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(p));
  return Cplx(t.x, t.y);
}

__device__ __forceinline__ bool is_zero(double v) { return v == 0.0; }
__device__ __forceinline__ bool is_zero(const Cplx& v) {
  return v.re == 0.0 && v.im == 0.0;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
perm_gather_kernel(const T* __restrict__ X, long long xsb, long long xs0,
                   long long xs1, T* __restrict__ Y, long long ysb,
                   long long ys0, long long ys1, const int* __restrict__ rs,
                   const T* __restrict__ ra, const int* __restrict__ cs,
                   const T* __restrict__ ca, int nb, int rows, int cols,
                   int batch) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= cols) return;
  const long long pairs = static_cast<long long>(batch) * rows;
  for (long long br = blockIdx.y; br < pairs; br += gridDim.y) {
    const long long b = br / rows;
    const int r = static_cast<int>(br % rows);
    const T* xb = X + b * xsb;
    T* p = Y + b * ysb + static_cast<long long>(r) * ys0 +
           static_cast<long long>(c) * ys1;
    T acc = *p;
    for (int n = 0; n < nb; ++n) {
      const T a = ra ? ld(ra + static_cast<long long>(n) * rows + r) : T(1);
      if (is_zero(a)) continue;
      const long long sr =
          rs ? __ldg(rs + static_cast<long long>(n) * rows + r) : r;
      const long long sc =
          cs ? __ldg(cs + static_cast<long long>(n) * cols + c) : c;
      const T be = ca ? ld(ca + static_cast<long long>(n) * cols + c) : T(1);
      acc += (a * ld(xb + sr * xs0 + sc * xs1)) * be;
    }
    *p = acc;
  }
}

template <typename T>
int launch(const void* x, long long xsb, long long xs0, long long xs1,
           void* y, long long ysb, long long ys0, long long ys1,
           const void* rs, const void* ra, const void* cs, const void* ca,
           int nb, int rows, int cols, int batch, void* stream) {
  const long long pairs = static_cast<long long>(batch) * rows;
  const dim3 grid((cols + THREADS - 1) / THREADS,
                  static_cast<unsigned>(pairs < MAX_GRID_Y ? pairs
                                                           : MAX_GRID_Y));
  perm_gather_kernel<T><<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), xsb, xs0, xs1, static_cast<T*>(y), ysb, ys0,
      ys1, static_cast<const int*>(rs), static_cast<const T*>(ra),
      static_cast<const int*>(cs), static_cast<const T*>(ca), nb, rows, cols,
      batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides in elements; xsb and ysb step from one batch member to the next.
// rs, ra, cs, ca: contiguous (nb, rows) / (nb, cols) tables or null (the
// identity, amplitude 1).  Returns the launch's cudaError (0 on success).
extern "C" int lpp_perm_gather_f64(const void* x, long long xsb,
                                   long long xs0, long long xs1, void* y,
                                   long long ysb, long long ys0,
                                   long long ys1, const void* rs,
                                   const void* ra, const void* cs,
                                   const void* ca, int nb, int rows, int cols,
                                   int batch, void* stream) {
  return launch<double>(x, xsb, xs0, xs1, y, ysb, ys0, ys1, rs, ra, cs, ca,
                        nb, rows, cols, batch, stream);
}

extern "C" int lpp_perm_gather_c128(const void* x, long long xsb,
                                    long long xs0, long long xs1, void* y,
                                    long long ysb, long long ys0,
                                    long long ys1, const void* rs,
                                    const void* ra, const void* cs,
                                    const void* ca, int nb, int rows,
                                    int cols, int batch, void* stream) {
  return launch<Cplx>(x, xsb, xs0, xs1, y, ysb, ys0, ys1, rs, ra, cs, ca, nb,
                      rows, cols, batch, stream);
}
