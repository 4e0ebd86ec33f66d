// factor_matmul: Y[m, n] (+)= sum_k X[m, k] * A[n, k], an NT GEMM on
// strided operands, for float64 and float32.
//
// Replaces the Pallas TPU kernel lanczosplusplus_tpu/ops/pallas_kernels.py
// factor_matmul (body _matmul_kernel).  On the main path X is the
// (size_down, size_up) Hubbard state matrix and A a dense one-spin hop
// factor, 3432 x 3432 at 14 sites: every Lanczos matvec runs two of these
// GEMMs, 2 * 2 * 3432^3 = 1.6e11 flops, so in float64 the kernel is bound
// by the card's FP64 rate, not by memory (each operand is read once per
// 64-wide output tile).
//
// Design.  The TPU version walks a sequential (m, n, k) grid with a VMEM
// accumulator.  Here each 256-thread block owns one 64 x 64 output tile
// and loops over k itself in 16-deep slices staged through shared memory;
// each thread keeps a 4 x 4 register micro-tile, so one shared-memory read
// feeds four FMAs.  Every operand is addressed through its own
// (row stride, column stride) pair, which lets the caller run
// A_dn . X as (X^T . A_dn^T)^T on transposed views without copying.  The
// tile loader picks its thread order from the strides so that
// neighbouring threads read neighbouring addresses in either layout.
// Ragged edges are masked (zeros in, no stores out) instead of padded.
// The accumulator has the operands' type (float32 accumulates in float32).
// `accumulate` adds the product into Y so the diagonal term and both
// factor applies can write one output.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int TX = 16;   // threads along n
constexpr int TY = 16;   // threads along m
constexpr int NT = TX * TY;
constexpr int TM = BM / TY;  // micro-tile rows per thread
constexpr int TN = BN / TX;  // micro-tile columns per thread
constexpr int PAD = 1;       // breaks the power-of-two row stride in smem

// Stage the (ROWS x BK) slice [row0, row0 + ROWS) x [k0, k0 + BK) of a
// strided matrix M (element (r, k) at M[r * s0 + k * s1]) into
// tile[k][r].  Out-of-range elements are stored as zero.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(T (*tile)[ROWS + PAD],
                                          const T* __restrict__ M,
                                          long long s0, long long s1,
                                          int row0, int nrows, int k0,
                                          int kdim, int tid) {
  constexpr int N = ROWS * BK;
  if (s1 == 1) {
    // k is the contiguous axis: neighbouring threads walk k
#pragma unroll
    for (int idx = tid; idx < N; idx += NT) {
      const int r = idx / BK, kk = idx % BK;
      const int gr = row0 + r, gk = k0 + kk;
      tile[kk][r] = (gr < nrows && gk < kdim)
                        ? M[gr * s0 + static_cast<long long>(gk)]
                        : T(0);
    }
  } else {
    // rows are the contiguous axis (or neither is): walk rows
#pragma unroll
    for (int idx = tid; idx < N; idx += NT) {
      const int kk = idx / ROWS, r = idx % ROWS;
      const int gr = row0 + r, gk = k0 + kk;
      tile[kk][r] = (gr < nrows && gk < kdim)
                        ? M[gr * s0 + gk * s1]
                        : T(0);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
factor_matmul_kernel(const T* __restrict__ X, long long xs0, long long xs1,
                     const T* __restrict__ A, long long as0, long long as1,
                     T* __restrict__ Y, long long ys0, long long ys1,
                     int m, int n, int k, int accumulate) {
  __shared__ T Xs[BK][BM + PAD];
  __shared__ T As[BK][BN + PAD];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < k; k0 += BK) {
    load_tile<T, BM>(Xs, X, xs0, xs1, m0, m, k0, k, tid);
    load_tile<T, BN>(As, A, as0, as1, n0, n, k0, k, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T xr[TM], ar[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xr[i] = Xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) ar[j] = As[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += xr[i] * ar[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= n) continue;
      T* p = Y + gm * ys0 + gn * ys1;
      *p = accumulate ? *p + acc[i][j] : acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, int xs0, int xs1, const void* a, int as0, int as1,
           void* y, int ys0, int ys1, int m, int n, int k, int accumulate,
           void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  factor_matmul_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), xs0, xs1, static_cast<const T*>(a), as0, as1,
      static_cast<T*>(y), ys0, ys1, m, n, k, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lpp_factor_matmul_f64(const void* x, int xs0, int xs1,
                                     const void* a, int as0, int as1,
                                     void* y, int ys0, int ys1, int m, int n,
                                     int k, int accumulate, void* stream) {
  return launch<double>(x, xs0, xs1, a, as0, as1, y, ys0, ys1, m, n, k,
                        accumulate, stream);
}

extern "C" int lpp_factor_matmul_f32(const void* x, int xs0, int xs1,
                                     const void* a, int as0, int as1,
                                     void* y, int ys0, int ys1, int m, int n,
                                     int k, int accumulate, void* stream) {
  return launch<float>(x, xs0, xs1, a, as0, as1, y, ys0, ys1, m, n, k,
                       accumulate, stream);
}
