// perm_gather: Y[b, r, c] += sum_n a[n, r] * beta[n, c] * X[b, rs[n, r], cs[n, c]]
// for a batch of strided 2-D blocks X (batch, rows_src, cols_src) and Y
// (batch, rows, cols), int32 index tables rs (nb, rows) and cs (nb, cols),
// amplitude tables a (nb, rows) and beta (nb, cols) of the state's type:
// float64, float32, complex128 or complex64.  A bfloat16 source block X
// meets float32 or float64 amplitudes and Y (the bf16cross form below).
// Either side may be the identity with amplitude 1:
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
// What it moves beyond that is re-reading, and what it waits on is each
// thread's chain of dependent loads, a channel after another: a table
// entry, then the gather it names.  A design with one thread per output
// element reads a column's nb (cs, beta) pairs again for every (b, r)
// pair, 12 bytes a channel: at 28 channels many times the element's own
// traffic.
//
// Design.  The (b, r) pairs are flattened, p = b * rows + r.  A block of
// 128 threads covers 128 columns, one thread each, so a warp's loads of
// cs[n, c] and beta[n, c] are coalesced; blockIdx.y walks the groups of P
// consecutive pairs (gridDim.y apart, past 65 535).  A thread carries P
// pairs, their P sums in registers, started from Y, and walks the
// channels n in ascending order:
// - with row tables, it loads a[n, r] and rs[n, r] of its P pairs first
//   (the same across the warp: broadcast loads) and skips the channel,
//   column tables and all, if it reaches none of them (a test uniform
//   over the warp: in the FeAs and spin-orbit terms 79-80 % of the row
//   amplitudes are 0);
// - then it loads beta[n, c] and cs[n, c] once for its P pairs, and
//   gathers and adds (a x) beta into each pair's sum where neither
//   amplitude is 0 (the plain version adds a zero there; in the one-spin
//   up form 73 % of the column amplitudes are 0): the P gathers of a
//   channel are independent loads in flight together.
// Without row tables (the row side the identity, ROWS false) the loop body
// has no branch, and the compiler issues later channels' loads ahead.
// Each element adds its channels in ascending order with the plain
// version's expression, each product and sum rounded on its own, so the
// result is bit-equal to it: float64 through __dmul_rn and __dadd_rn,
// which are never fused; a complex128 sum likewise, while its product is
// written as torch's c10::complex multiply is, and nvcc contracts it into
// FMAs as it does torch's own, which the card tests hold bit for bit;
// float32 and complex64 the same way with the float intrinsics.
// P is fixed by the type of the sums: 16 bytes of them, float64 P = 2,
// complex128 P = 1, the fastest of P = 1, 2, 4 on chip_smoke.py phase
// 10's cases: more holds more registers and leaves fewer threads to hide
// the loads.  float32 takes P = 4 and complex64 P = 2 by the same rule:
// the same bytes of sums and of gathers in flight a thread, and the same
// register budget (a pair's row pointer is 8 bytes whatever the type).
//
// bf16cross.  The bfloat16 source form is the JAX package's state_cast
// "bf16" (core/blockkron.py _cross_state and _perm_cross_apply): the
// caller rounds the source block to bfloat16 once, the gathers read half
// the bytes, and each gathered value is widened exactly to the
// amplitudes' type before the products, which are rounded and summed in
// that type as above.  So it equals the plain version on the widened
// block bit for bit.
// Offsets are 64-bit: a batch of 14 states of the 20-site sector (35 M
// each) passes 2^31 elements, and a group may span two batch members; the
// pair count is within int32 and walked unsigned, so the step past the
// last group cannot wrap.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_GRID_Y = 65535;

// Complex scalar of real part type R: the arithmetic perm_gather needs
// and no more.
template <typename R>
struct Cplx {
  R re, im;
  __device__ __forceinline__ Cplx() {}
  __device__ __forceinline__ explicit Cplx(R r) : re(r), im(0) {}
  __device__ __forceinline__ Cplx(R r, R i) : re(r), im(i) {}
};

// As c10::complex multiplies, left to nvcc to contract into FMAs as it
// contracts torch's own complex product on the card.
template <typename R>
__device__ __forceinline__ Cplx<R> operator*(const Cplx<R>& a,
                                             const Cplx<R>& b) {
  return Cplx<R>(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}

// The plain version multiplies and adds in separate tensor operations,
// each rounded: so do these (the intrinsics are never fused; a complex
// product is rounded as torch's is, above).
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
template <typename R>
__device__ __forceinline__ Cplx<R> mul(const Cplx<R>& a, const Cplx<R>& b) {
  return a * b;
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
template <typename R>
__device__ __forceinline__ Cplx<R> add(const Cplx<R>& a, const Cplx<R>& b) {
  return Cplx<R>(add(a.re, b.re), add(a.im, b.im));
}

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

// A bfloat16 value, as its 16 bits: the high half of a float32.
struct Bf16 {
  unsigned short bits;
};

// A gathered source value in the sums' type T: as it is, or a bfloat16
// widened exactly (its bits are the high half of the float32).
template <typename T>
__device__ __forceinline__ T ldx(const T* p) {
  return ld(p);
}
template <typename T>
__device__ __forceinline__ T ldx(const Bf16* p) {
  const unsigned b = __ldg(reinterpret_cast<const unsigned short*>(p));
  return static_cast<T>(__uint_as_float(b << 16));
}

__device__ __forceinline__ bool is_zero(double v) { return v == 0.0; }
__device__ __forceinline__ bool is_zero(float v) { return v == 0.0f; }
template <typename R>
__device__ __forceinline__ bool is_zero(const Cplx<R>& v) {
  return v.re == R(0) && v.im == R(0);
}

// P, the (b, r) pairs a thread carries: 16 bytes of sums.
template <typename T>
__host__ __device__ constexpr int pairs_of() {
  return 16 / sizeof(T);
}

// Blocks an SM the compiler must leave room for: the registers are capped
// at 65 536 / (THREADS x MIN_BLOCKS) = 51.  The compiler takes what it is
// allowed, and every register fewer is more threads to hide the loads.
constexpr int MIN_BLOCKS = 10;

// T: the type of the amplitudes, the sums and Y; XT: the source block's
// (T, or Bf16 for the bf16cross form).
template <typename T, typename XT, bool ROWS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
perm_gather_kernel(const XT* __restrict__ X, long long xsb, long long xs0,
                   long long xs1, T* __restrict__ Y, long long ysb,
                   long long ys0, long long ys1, const int* __restrict__ rs,
                   const T* __restrict__ ra, const int* __restrict__ cs,
                   const T* __restrict__ ca, int nb, int rows, int cols,
                   unsigned pairs) {
  constexpr int P = pairs_of<T>();
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= cols) return;
  for (unsigned p0 = blockIdx.y * P; p0 < pairs; p0 += gridDim.y * P) {
    const int live = min(static_cast<int>(pairs - p0), P);
    int r[P];
    const XT* xb[P];  // the pair's batch member of X
    T acc[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      r[i] = 0;
      if (i < live) {
        const int b = (p0 + i) / rows;
        r[i] = static_cast<int>(p0 + i) - b * rows;
        xb[i] = X + b * xsb;
        acc[i] = Y[b * ysb + r[i] * ys0 + c * ys1];
      }
    }
    for (int n = 0; n < nb; ++n) {
      T a[P];
      int sr[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        a[i] = T(1);
        sr[i] = r[i];
      }
      if (ROWS) {
        // the row side first, both tables of all P pairs at once: a
        // channel that reaches none of the thread's rows is skipped,
        // column tables and all (a test that is uniform over the warp)
        bool reached = false;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const long long ar = static_cast<long long>(n) * rows + r[i];
          if (ra && i < live) a[i] = ld(ra + ar);
          if (rs && i < live) sr[i] = __ldg(rs + ar);
          reached |= i < live && !is_zero(a[i]);
        }
        if (!reached) continue;
      }
      // without row tables the body has no branch, and the compiler
      // issues the loads of later channels ahead
      const long long at = static_cast<long long>(n) * cols + c;
      const T be = ca ? ld(ca + at) : T(1);
      const int sc = cs ? __ldg(cs + at) : c;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (i < live && !is_zero(be) && !is_zero(a[i]))
          acc[i] = add(acc[i], mul(mul(a[i], ldx<T>(xb[i] + sr[i] * xs0 +
                                                    sc * xs1)),
                                   be));
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i < live) {
        const int b = (p0 + i) / rows;
        Y[b * ysb + r[i] * ys0 + c * ys1] = acc[i];
      }
    }
  }
}

template <typename T, typename XT, bool ROWS>
int launch_rows(const void* x, long long xsb, long long xs0, long long xs1,
                void* y, long long ysb, long long ys0, long long ys1,
                const void* rs, const void* ra, const void* cs,
                const void* ca, int nb, int rows, int cols, unsigned pairs,
                void* stream) {
  constexpr unsigned P = pairs_of<T>();
  const unsigned groups = (pairs + P - 1) / P;
  const dim3 grid((cols + THREADS - 1) / THREADS,
                  groups < MAX_GRID_Y ? groups : MAX_GRID_Y);
  perm_gather_kernel<T, XT, ROWS><<<grid, THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const XT*>(x), xsb, xs0, xs1, static_cast<T*>(y), ysb, ys0,
      ys1, static_cast<const int*>(rs), static_cast<const T*>(ra),
      static_cast<const int*>(cs), static_cast<const T*>(ca), nb, rows, cols,
      pairs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename XT = T>
int launch(const void* x, long long xsb, long long xs0, long long xs1,
           void* y, long long ysb, long long ys0, long long ys1,
           const void* rs, const void* ra, const void* cs, const void* ca,
           int nb, int rows, int cols, int batch, void* stream) {
  const long long pairs = static_cast<long long>(batch) * rows;
  if (pairs > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return rs != nullptr || ra != nullptr
             ? launch_rows<T, XT, true>(x, xsb, xs0, xs1, y, ysb, ys0, ys1,
                                        rs, ra, cs, ca, nb, rows, cols,
                                        static_cast<unsigned>(pairs), stream)
             : launch_rows<T, XT, false>(x, xsb, xs0, xs1, y, ysb, ys0, ys1,
                                         rs, ra, cs, ca, nb, rows, cols,
                                         static_cast<unsigned>(pairs),
                                         stream);
}

}  // namespace

// Strides in elements; xsb and ysb step from one batch member to the next.
// rs, ra, cs, ca: contiguous (nb, rows) / (nb, cols) tables or null (the
// identity, amplitude 1).  batch * rows within int32.  Returns the
// launch's cudaError (0 on success).  The suffix names the type of the
// amplitudes, sums and Y; bf16_ in front, a bfloat16 source block X.
#define LPP_PERM_GATHER(NAME, T, XT)                                        \
  extern "C" int NAME(const void* x, long long xsb, long long xs0,          \
                      long long xs1, void* y, long long ysb, long long ys0, \
                      long long ys1, const void* rs, const void* ra,        \
                      const void* cs, const void* ca, int nb, int rows,     \
                      int cols, int batch, void* stream) {                  \
    return launch<T, XT>(x, xsb, xs0, xs1, y, ysb, ys0, ys1, rs, ra, cs,    \
                         ca, nb, rows, cols, batch, stream);                \
  }

LPP_PERM_GATHER(lpp_perm_gather_f64, double, double)
LPP_PERM_GATHER(lpp_perm_gather_f32, float, float)
LPP_PERM_GATHER(lpp_perm_gather_c128, Cplx<double>, Cplx<double>)
LPP_PERM_GATHER(lpp_perm_gather_c64, Cplx<float>, Cplx<float>)
LPP_PERM_GATHER(lpp_perm_gather_bf16_f64, double, Bf16)
LPP_PERM_GATHER(lpp_perm_gather_bf16_f32, float, Bf16)

#undef LPP_PERM_GATHER
