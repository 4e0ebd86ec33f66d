// factor_matmul: Y[m, n] (+)= sum_k X[m, k] * A[n, k], an NT GEMM on
// strided operands, for float64, float32 and bfloat16 operands.
//
// Replaces the Pallas TPU kernel lanczosplusplus_tpu/ops/pallas_kernels.py
// factor_matmul (body _matmul_kernel).  On the main path X is the
// (size_down, size_up) Hubbard state matrix and A a dense one-spin hop
// factor, 3432 x 3432 at 14 sites: every Lanczos matvec runs two of these
// GEMMs, 2 * 2 * 3432^3 = 1.6e11 flops, so in float64 the kernel is bound
// by operations: the card's FP64 tensor-core rate (67 TFLOP/s), twice what
// its ordinary FP64 units reach.
//
// float64 design.  The FP64 tensor cores have no warpgroup (wgmma) form;
// they are reached with the warp-level instruction
//   mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64   (DMMA).
// With g = lane / 4 and t = lane % 4, a thread holds
//   A (16 x 4, row):  a[j]       = A[g + 8 j][t]         j < 2
//   B (4 x 8, col):   b[0]       = B[t][g]
//   C (16 x 8):       c[2 j + i] = C[g + 8 j][2 t + i]   i < 2
// (the same table, for the tests, is ops/kernels.py dmma_fragment_map).
// Here the "A" operand of the instruction is a 16-row slab of X and its
// "B" operand an 8-row slab of the factor A, both indexed (row, k), so a
// fragment element is tile(row, k) for either operand.
//
// A block owns a BM x BN output tile (128 x 128 with 16 warps, or 64 x 64
// with 4 when the large tiles would not fill the card; the caller's plan
// says which) and walks k in 16-deep slices through a ring of four
// shared-memory stages filled with cp.async, so the loads of slice kt + 3
// are in flight while the DMMAs of slice kt run; one __syncthreads() per
// slice, and the ring is refilled after the slice's first k-step of DMMAs
// has been started, so the tensor cores restart at once after the barrier.
// Each warp owns a 32 x 32 part of the tile (shared memory, 16 doubles a
// clock, then keeps up with 128 FMAs a clock) as 2 x 4 m16n8k4
// accumulators, 64 accumulator registers a thread.  Deeper instructions
// (k8, k16), 64-row or 64-column warp tiles, three stages and a 128 x 64
// tile with two blocks an SM were all measured slower or spilled.
// The loop's copies come from FastStager, which works out a thread's
// addresses once; the general stager costs some 300 instructions a slice,
// more than the slice's 32 DMMAs and 32 fragment loads.
//
// Strides.  Every operand comes with its (row, k) strides, so the caller
// runs A_dn . X as (X^T . A_dn^T)^T on transposed views with no copy.  An
// operand is staged along whichever of its axes is contiguous: k-major
// tiles [row][k] with pitch 16 + 4 doubles, row-major tiles [k][row] with
// pitch rows + 4.  Both pitches are 4 mod 16, which spreads a fragment
// read (8 rows x 4 k) over all banks in either layout.  Copies are 16
// bytes where base pointer and pitch allow it and 8 bytes (any strides)
// otherwise; the caller's plan says which.  Edges and the k tail are
// zero-filled by cp.async's source size (0, 8 or 16 bytes), never read
// out of range; stores are guarded.
//
// The sum over k runs in the tensor cores' order within a 4-deep
// instruction and in k order across instructions, so results
// differ from a sequential FMA chain in the last bits.
//
// float32 has no exact tensor-core route (TF32 rounds the inputs) and is
// off the main path: it keeps the SIMT kernel, a 64 x 64 tile per
// 256-thread block with a 4 x 4 register micro-tile per thread.
//
// bfloat16 operands (the TPU kernel's own contract: bf16 X and A, float32
// accumulation, pallas_kernels.py preferred_element_type=jnp.float32) run
// on the tensor cores with the warp-level
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// whose fragments hold pairs of k-neighbours in one 32-bit register.  With
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row): a[0] = A[g][2t, 2t+1],     a[1] = A[g+8][2t, 2t+1],
//                     a[2] = A[g][2t+8, 2t+9],   a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8, col):  b[0] = B[2t, 2t+1][g],     b[1] = B[2t+8, 2t+9][g]
//   C (16 x 8, f32):  c[2 h + e] = C[g + 8 h][2 t + e]
// (ops/kernels.py bf16_fragment_map).  As for DMMA the instruction's "A" is
// a 16-row slab of X and its "B" an 8-row slab of the factor, both
// indexed (row, k), so each register is two k-neighbours of one row: both
// operands are staged k-major, [row][k] with a pitch of 40 bf16 (20
// words, which spreads a fragment load of 8 rows x 4 words over all 32
// banks).  A block of 256 threads owns a 128 x 128 output tile (8 warps,
// each 64 x 32: 4 x 4 m16n8 accumulators, 64 floats a thread) and walks k
// in 32-deep stages through two shared-memory buffers; the next stage's
// elements are loaded into registers while the tensor cores work on this
// one, one element a load along the operand's contiguous axis (any
// strides; ragged edges and the k tail read as zeros).  This is the
// simple form: it is bound by its loads and address arithmetic, not the
// tensor cores (989 TFLOP/s dense bf16); TMA and wgmma are the way to the
// card's rate.  The product of two bf16 values is exact in float32, so
// the result differs from a float32 product of the widened operands only
// by the order of the float32 sums.  The float32 sums are converted to Y's
// type (float32 or float64) and stored, or added to Y.
//
// `accumulate` adds the product into Y so the diagonal term and both
// factor applies can write one output.
//
// Batch.  Y[b] (+)= X[b] . A[b]^T for b < batch: X, A and Y each carry a
// batch stride besides their two strides, so the batched dn apply of a
// block of states runs on transposed views of every state at once.  A
// batch stride of 0 shares one operand: every caller of the one-spin
// factors shares A that way, and the block-Kronecker forms give a factor
// per batch member (a tier of same-shaped blocks, the cross couplings'
// stacked factors) or share X.  The float64 kernel folds the batch into its tile index (a block's
// number is b * tiles + tile), so one launch fills the card where a single
// state's tiles would not; the float32 kernel takes it as blockIdx.z.  A
// plain 2-D product is the case batch = 1.  16-byte copies then also need
// an even batch stride.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------
// float64: DMMA kernel
// ---------------------------------------------------------------------

constexpr int BK = 16;    // contraction depth of one shared-memory stage
constexpr int SKEW = 4;   // pitch padding in doubles, see above
constexpr int MMA_K = 4;  // k depth of one DMMA
constexpr int WM = 32;    // warp tile
constexpr int WN = 32;
constexpr int STAGES = 4; // shared-memory ring depth
// the k offset within a slice at which the ring is refilled
constexpr int REFILL_AT = MMA_K;

// plan bits, set by ops/kernels.py factor_matmul_plan
constexpr int PLAN_X_KMAJOR = 1, PLAN_X_VEC16 = 2, PLAN_A_KMAJOR = 4,
              PLAN_A_VEC16 = 8, PLAN_Y_VEC16 = 16, PLAN_TILE128 = 32;

__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[2],
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// doubles one staged ROWS x BK tile takes, and its element offset
template <int ROWS, bool KMAJOR>
struct Tile {
  static constexpr int PITCH = KMAJOR ? BK + SKEW : ROWS + SKEW;
  static constexpr int SIZE = KMAJOR ? ROWS * PITCH : BK * PITCH;
  static __device__ __forceinline__ int at(int r, int kk) {
    return KMAJOR ? r * PITCH + kk : kk * PITCH + r;
  }
};

// Start the copies of the slice [row0, row0 + ROWS) x [k0, k0 + BK) of the
// strided matrix M (element (r, k) at M[r * s0 + k * s1]) into `tile`.
// Out-of-range elements arrive as zeros (source size 0).
template <int ROWS, bool KMAJOR, int NT>
__device__ __forceinline__ void stage_tile(double* tile,
                                           const double* __restrict__ M,
                                           long long s0, long long s1,
                                           bool vec16, int row0, int nrows,
                                           int k0, int kdim, int tid) {
  using L = Tile<ROWS, KMAJOR>;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  if (vec16) {
    // two doubles a copy along the contiguous axis
    constexpr int CHUNKS = ROWS * BK / 2;
    static_assert(CHUNKS % NT == 0, "tile must divide among the threads");
    // not unrolled: this path is off the loop's steady state, and rolled
    // it keeps its address arithmetic out of the loop's register budget
#pragma unroll 1
    for (int q = 0; q < CHUNKS / NT; ++q) {
      const int c = tid + q * NT;
      int r, kk, valid;
      if (KMAJOR) {
        r = c / (BK / 2);
        kk = (c % (BK / 2)) * 2;
        valid = (row0 + r < nrows) ? min(max(kdim - (k0 + kk), 0), 2) : 0;
      } else {
        kk = c / (ROWS / 2);
        r = (c % (ROWS / 2)) * 2;
        valid = (k0 + kk < kdim) ? min(max(nrows - (row0 + r), 0), 2) : 0;
      }
      const double* src =
          valid ? M + static_cast<long long>(row0 + r) * s0 +
                      static_cast<long long>(k0 + kk) * s1
                : M;
      cp_async_16(base + 8u * L::at(r, kk), src, 8 * valid);
    }
  } else {
    // one double a copy, any strides; threads walk the staged layout's
    // fast axis, which the plan chose as the operand's nearer one
    constexpr int ELEMS = ROWS * BK;
    static_assert(ELEMS % NT == 0, "tile must divide among the threads");
#pragma unroll 1
    for (int q = 0; q < ELEMS / NT; ++q) {
      const int e = tid + q * NT;
      const int r = KMAJOR ? e / BK : e % ROWS;
      const int kk = KMAJOR ? e % BK : e / ROWS;
      const bool valid = row0 + r < nrows && k0 + kk < kdim;
      const double* src =
          valid ? M + static_cast<long long>(row0 + r) * s0 +
                      static_cast<long long>(k0 + kk) * s1
                : M;
      cp_async_8(base + 8u * L::at(r, kk), src, valid ? 8 : 0);
    }
  }
}

// The same copies for a slice that lies inside the matrix along k, by
// 16-byte chunks, with everything that does not change from slice to slice
// worked out once per thread: its first chunk's source address (advanced
// by one slice after every call), its offset in the staged tile, and the
// constant steps between its chunks.  This is the loop's path; stage_tile
// above serves the k tail, 8-byte operands and odd row counts.  A thread's
// chunks share their place along the contiguous axis and step along the
// other one.
template <int ROWS, bool KMAJOR, int NT>
struct FastStager {
  using L = Tile<ROWS, KMAJOR>;
  static constexpr int ALONG = (KMAJOR ? BK : ROWS) / 2;  // chunks per line
  static constexpr int CHUNKS = ROWS * BK / 2 / NT;       // per thread
  static constexpr int STEP = NT / ALONG;                 // lines per chunk
  static_assert(NT % ALONG == 0 && (ROWS * BK / 2) % NT == 0,
                "threads must tile the staged slice");
  const double* src;  // first chunk of the next slice
  long long chunk_step, slice_step;  // in elements
  uint32_t offset;    // bytes from the tile's start
  int row;            // first chunk's row within the tile
  bool usable;        // 16-byte copies, whole chunks only

  __device__ __forceinline__ FastStager(const double* M, long long s0,
                                        long long s1, bool vec16, int row0,
                                        int nrows, int tid) {
    const int line = tid / ALONG, along = (tid % ALONG) * 2;
    row = KMAJOR ? line : along;
    const int kk = KMAJOR ? along : line;
    src = M + static_cast<long long>(row0 + row) * s0 +
          static_cast<long long>(kk) * s1;
    chunk_step = STEP * (KMAJOR ? s0 : s1);
    slice_step = BK * s1;
    offset = 8u * L::at(row, kk);
    // row-major chunks pair two rows: the tile's last row must not be
    // the first of a pair
    usable = vec16 && (KMAJOR || nrows - row0 >= ROWS ||
                       (nrows - row0) % 2 == 0);
  }

  // rows_here: rows of the matrix inside this tile
  __device__ __forceinline__ void stage(uint32_t tile, int rows_here) {
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) {
      const int r = KMAJOR ? row + q * STEP : row;
      cp_async_16(tile + offset +
                      8u * (KMAJOR ? L::at(q * STEP, 0) : L::at(0, q * STEP)),
                  src + q * chunk_step, r < rows_here ? 16 : 0);
    }
  }
};

template <int BM, int BN, bool XK, bool AK>
struct DmmaConfig {
  static constexpr int WARPS_M = BM / WM;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = WARPS_M * WARPS_N * 32;
  // blocks an SM should hold: 128 registers a thread fill its file
  static constexpr int MIN_BLOCKS = NT >= 512 ? 1 : 512 / NT;
  static constexpr int MT = WM / 16;  // DMMA tiles along m per warp
  static constexpr int NTL = WN / 8;  // DMMA tiles along n per warp
  using XT = Tile<BM, XK>;
  using AT = Tile<BN, AK>;
  static constexpr int STAGE = XT::SIZE + AT::SIZE;  // doubles
  static constexpr int SMEM_BYTES = STAGES * STAGE * 8;
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 8 == 0,
                "warp tiles must tile the block tile in DMMA units");
};

template <int BM, int BN, bool XK, bool AK>
__global__ void __launch_bounds__(
    (DmmaConfig<BM, BN, XK, AK>::NT),
    (DmmaConfig<BM, BN, XK, AK>::MIN_BLOCKS))
factor_matmul_dmma_kernel(const double* __restrict__ X, long long xsb,
                          long long xs0, long long xs1,
                          const double* __restrict__ A, long long asb,
                          long long as0, long long as1,
                          double* __restrict__ Y, long long ysb,
                          long long ys0, long long ys1, int m, int n, int k,
                          int accumulate, int plan) {
  using C = DmmaConfig<BM, BN, XK, AK>;
  extern __shared__ __align__(16) double smem[];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // fragment k / column-pair index
  const int wm0 = (warp % C::WARPS_M) * WM;
  const int wn0 = (warp / C::WARPS_M) * WN;
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = tiles_n * ((m + BM - 1) / BM);
  const int b = blockIdx.x / tiles;        // batch member
  const int tile = blockIdx.x % tiles;
  X += b * xsb;
  A += b * asb;
  Y += b * ysb;
  const int m0 = (tile / tiles_n) * BM;
  const int n0 = (tile % tiles_n) * BN;
  const bool xvec = plan & PLAN_X_VEC16;
  const bool avec = plan & PLAN_A_VEC16;
  const int slices = (k + BK - 1) / BK;

  FastStager<BM, XK, C::NT> xfast(X, xs0, xs1, xvec, m0, m, tid);
  FastStager<BN, AK, C::NT> afast(A, as0, as1, avec, n0, n, tid);
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // slices are staged in order, so the fast stagers' addresses keep step
  auto stage = [&](int kt) {
    const int s = kt % STAGES;
    const bool inside = (kt + 1) * BK <= k;
    if (inside && xfast.usable)
      xfast.stage(ring + 8u * (s * C::STAGE), m - m0);
    else
      stage_tile<BM, XK, C::NT>(smem + s * C::STAGE, X, xs0, xs1, xvec, m0,
                                m, kt * BK, k, tid);
    if (inside && afast.usable)
      afast.stage(ring + 8u * (s * C::STAGE + C::XT::SIZE), n - n0);
    else
      stage_tile<BN, AK, C::NT>(smem + s * C::STAGE + C::XT::SIZE, A, as0,
                                as1, avec, n0, n, kt * BK, k, tid);
    xfast.src += xfast.slice_step;
    afast.src += afast.slice_step;
  };

  double acc[C::MT][C::NTL][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NTL; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0;

  // one commit per slot, empty past the end, so the group count is uniform
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices) stage(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<STAGES - 2>();  // slice kt has landed (this thread's part)
    __syncthreads();              // ... everyone's; stage kt - 1 is free
    const double* xs = smem + (kt % STAGES) * C::STAGE;
    const double* as = xs + C::XT::SIZE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += MMA_K) {
      if (kk == REFILL_AT) {
        // refill the stage that slice kt - 1 left, once this slice's
        // first DMMAs are under way
        if (kt + STAGES - 1 < slices) stage(kt + STAGES - 1);
        cp_async_commit();
      }
      double bf[C::NTL];
#pragma unroll
      for (int j = 0; j < C::NTL; ++j)
        bf[j] = as[C::AT::at(wn0 + 8 * j + g, kk + t)];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        double af[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          af[h] = xs[C::XT::at(wm0 + 16 * i + g + 8 * h, kk + t)];
#pragma unroll
        for (int j = 0; j < C::NTL; ++j) dmma(acc[i][j], af, bf[j]);
      }
    }
  }

  // c[2 h + e] = C[g + 8 h][2 t + e]
  const bool yvec = plan & PLAN_Y_VEC16;
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm0 + 16 * i + g + 8 * h;
      if (gm >= m) continue;
#pragma unroll
      for (int j = 0; j < C::NTL; ++j) {
        const int gn = n0 + wn0 + 8 * j + 2 * t;
        double* p = Y + gm * ys0 + gn * ys1;
        const double c0 = acc[i][j][2 * h], c1 = acc[i][j][2 * h + 1];
        if (yvec && gn + 1 < n) {
          double2* p2 = reinterpret_cast<double2*>(p);
          double2 v = make_double2(c0, c1);
          if (accumulate) {
            const double2 old = *p2;
            v.x += old.x;
            v.y += old.y;
          }
          *p2 = v;
        } else {
          if (gn < n) p[0] = accumulate ? p[0] + c0 : c0;
          if (gn + 1 < n) p[ys1] = accumulate ? p[ys1] + c1 : c1;
        }
      }
    }
  }
}

template <int BM, int BN, bool XK, bool AK>
cudaError_t launch_dmma(const double* x, long long xsb, long long xs0,
                        long long xs1, const double* a, long long asb,
                        long long as0, long long as1, double* y, long long ysb,
                        long long ys0, long long ys1, int batch, int m, int n,
                        int k, int accumulate, int plan, cudaStream_t stream) {
  using C = DmmaConfig<BM, BN, XK, AK>;
  auto kernel = factor_matmul_dmma_kernel<BM, BN, XK, AK>;
  // above 48 KB the dynamic shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>((n + BN - 1) / BN) * ((m + BM - 1) / BM);
  if (tiles * batch > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(tiles * batch), C::NT, C::SMEM_BYTES,
           stream>>>(x, xsb, xs0, xs1, a, asb, as0, as1, y, ysb, ys0, ys1, m,
                     n, k, accumulate, plan);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_dmma_layout(const double* x, long long xsb, long long xs0,
                               long long xs1, const double* a, long long asb,
                               long long as0, long long as1, double* y,
                               long long ysb,
                               long long ys0, long long ys1, int batch, int m,
                               int n, int k, int accumulate, int plan,
                               cudaStream_t stream) {
  const bool xk = plan & PLAN_X_KMAJOR, ak = plan & PLAN_A_KMAJOR;
#define LPP_GO(XK, AK)                                                     \
  return launch_dmma<BM, BN, XK, AK>(                                      \
      x, xsb, xs0, xs1, a, asb, as0, as1, y, ysb, ys0, ys1, batch, m, n,   \
      k, accumulate, plan, stream)
  if (xk && ak) LPP_GO(true, true);
  if (xk) LPP_GO(true, false);
  if (ak) LPP_GO(false, true);
  LPP_GO(false, false);
#undef LPP_GO
}

// A 16-byte copy was planned for an operand that cannot take one (`sb`:
// its batch stride, 0 for the shared factor).
bool misplanned(const void* p, long long sb, long long s0, long long s1,
                bool kmajor) {
  const long long contiguous = kmajor ? s1 : s0, pitch = kmajor ? s0 : s1;
  return reinterpret_cast<uintptr_t>(p) % 16 != 0 || contiguous != 1 ||
         pitch % 2 != 0 || sb % 2 != 0;
}

// ---------------------------------------------------------------------
// float32: SIMT kernel
// ---------------------------------------------------------------------

constexpr int SBM = 64;   // output rows per block
constexpr int SBN = 64;   // output columns per block
constexpr int SBK = 16;   // contraction depth per shared-memory stage
constexpr int TX = 16;    // threads along n
constexpr int TY = 16;    // threads along m
constexpr int SNT = TX * TY;
constexpr int TM = SBM / TY;  // micro-tile rows per thread
constexpr int TN = SBN / TX;  // micro-tile columns per thread
constexpr int PAD = 1;        // breaks the power-of-two row stride in smem

// Stage the (ROWS x SBK) slice [row0, row0 + ROWS) x [k0, k0 + SBK) of a
// strided matrix M (element (r, k) at M[r * s0 + k * s1]) into
// tile[k][r].  Out-of-range elements are stored as zero.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(T (*tile)[ROWS + PAD],
                                          const T* __restrict__ M,
                                          long long s0, long long s1,
                                          int row0, int nrows, int k0,
                                          int kdim, int tid) {
  constexpr int N = ROWS * SBK;
  if (s1 == 1) {
    // k is the contiguous axis: neighbouring threads walk k
#pragma unroll
    for (int idx = tid; idx < N; idx += SNT) {
      const int r = idx / SBK, kk = idx % SBK;
      const int gr = row0 + r, gk = k0 + kk;
      tile[kk][r] = (gr < nrows && gk < kdim)
                        ? M[gr * s0 + static_cast<long long>(gk)]
                        : T(0);
    }
  } else {
    // rows are the contiguous axis (or neither is): walk rows
#pragma unroll
    for (int idx = tid; idx < N; idx += SNT) {
      const int kk = idx / ROWS, r = idx % ROWS;
      const int gr = row0 + r, gk = k0 + kk;
      tile[kk][r] = (gr < nrows && gk < kdim)
                        ? M[gr * s0 + gk * s1]
                        : T(0);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(SNT)
factor_matmul_simt_kernel(const T* __restrict__ X, long long xsb,
                          long long xs0, long long xs1,
                          const T* __restrict__ A, long long asb,
                          long long as0, long long as1, T* __restrict__ Y,
                          long long ysb, long long ys0, long long ys1, int m,
                          int n, int k, int accumulate) {
  __shared__ T Xs[SBK][SBM + PAD];
  __shared__ T As[SBK][SBN + PAD];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * SBM;
  const int n0 = blockIdx.x * SBN;
  X += blockIdx.z * xsb;  // batch member
  A += blockIdx.z * asb;
  Y += blockIdx.z * ysb;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < k; k0 += SBK) {
    load_tile<T, SBM>(Xs, X, xs0, xs1, m0, m, k0, k, tid);
    load_tile<T, SBN>(As, A, as0, as1, n0, n, k0, k, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
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

// ---------------------------------------------------------------------
// bfloat16 operands, float32 accumulation: m16n8k16 tensor-core kernel
// ---------------------------------------------------------------------

constexpr int HBM = 128;  // output rows per block
constexpr int HBN = 128;  // output columns per block
constexpr int HBK = 32;   // contraction depth of one stage
constexpr int HWM = 64;   // warp tile
constexpr int HWN = 32;
constexpr int HWARPS_M = HBM / HWM;
constexpr int HNT = HWARPS_M * (HBN / HWN) * 32;  // 256 threads
constexpr int HPITCH = HBK + 8;                   // bf16 a staged row
constexpr int HMT = HWM / 16;                     // m16 tiles a warp
constexpr int HNTL = HWN / 8;                     // n8 tiles a warp
// elements of one operand's stage a thread loads (both operands: 128 rows)
constexpr int HLOADS = HBM * HBK / HNT;
static_assert(HBM == HBN && HBM * HBK % HNT == 0, "staging layout");

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The (row, k) of element q of a thread's share of a 128 x 32 stage: along
// k when k is the operand's contiguous axis (s1 == 1), else along rows, so
// neighbouring threads read neighbouring addresses either way.
__device__ __forceinline__ void stage_coords(bool kfast, int tid, int q,
                                             int& r, int& kk) {
  const int e = tid + q * HNT;
  if (kfast) {
    r = e / HBK;
    kk = e % HBK;
  } else {
    r = e % HBM;
    kk = e / HBM;
  }
}

// Load a thread's share of the stage [row0, row0 + 128) x [k0, k0 + 32) of
// the strided bf16 matrix M (element (r, k) at M[r * s0 + k * s1]) into
// registers, zeros outside it.
__device__ __forceinline__ void load_stage(unsigned short (&v)[HLOADS],
                                           const unsigned short* M,
                                           long long s0, long long s1,
                                           int row0, int nrows, int k0,
                                           int kdim, int tid) {
  const bool kfast = s1 == 1;
#pragma unroll
  for (int q = 0; q < HLOADS; ++q) {
    int r, kk;
    stage_coords(kfast, tid, q, r, kk);
    const int gr = row0 + r, gk = k0 + kk;
    v[q] = (gr < nrows && gk < kdim)
               ? __ldg(M + static_cast<long long>(gr) * s0 +
                       static_cast<long long>(gk) * s1)
               : static_cast<unsigned short>(0);
  }
}

__device__ __forceinline__ void store_stage(unsigned short* tile,
                                            const unsigned short (&v)[HLOADS],
                                            bool kfast, int tid) {
#pragma unroll
  for (int q = 0; q < HLOADS; ++q) {
    int r, kk;
    stage_coords(kfast, tid, q, r, kk);
    tile[r * HPITCH + kk] = v[q];
  }
}

template <typename OutT>
__global__ void __launch_bounds__(HNT)
factor_matmul_bf16_kernel(const unsigned short* __restrict__ X,
                          long long xsb, long long xs0, long long xs1,
                          const unsigned short* __restrict__ A,
                          long long asb, long long as0, long long as1,
                          OutT* __restrict__ Y, long long ysb, long long ys0,
                          long long ys1, int m, int n, int k,
                          int accumulate) {
  // two buffers a operand, [row][k] with pitch HPITCH
  __shared__ __align__(16) unsigned short Xs[2][HBM * HPITCH];
  __shared__ __align__(16) unsigned short As[2][HBN * HPITCH];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm0 = (warp % HWARPS_M) * HWM;
  const int wn0 = (warp / HWARPS_M) * HWN;
  const int m0 = blockIdx.y * HBM;
  const int n0 = blockIdx.x * HBN;
  X += blockIdx.z * xsb;  // batch member
  A += blockIdx.z * asb;
  Y += blockIdx.z * ysb;
  const bool xk = xs1 == 1, ak = as1 == 1;

  float acc[HMT][HNTL][4];
#pragma unroll
  for (int i = 0; i < HMT; ++i)
#pragma unroll
    for (int j = 0; j < HNTL; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  unsigned short xv[HLOADS], av[HLOADS];
  load_stage(xv, X, xs0, xs1, m0, m, 0, k, tid);
  load_stage(av, A, as0, as1, n0, n, 0, k, tid);
  store_stage(Xs[0], xv, xk, tid);
  store_stage(As[0], av, ak, tid);
  __syncthreads();

  const int stages = (k + HBK - 1) / HBK;
  for (int kt = 0; kt < stages; ++kt) {
    const int buf = kt % 2;
    const bool more = kt + 1 < stages;
    // the next stage's loads are in flight while this one's MMAs run
    if (more) {
      load_stage(xv, X, xs0, xs1, m0, m, (kt + 1) * HBK, k, tid);
      load_stage(av, A, as0, as1, n0, n, (kt + 1) * HBK, k, tid);
    }
    const unsigned short* xs = Xs[buf];
    const unsigned short* as = As[buf];
#pragma unroll
    for (int kk = 0; kk < HBK; kk += 16) {
      uint32_t bfrag[HNTL][2];
#pragma unroll
      for (int j = 0; j < HNTL; ++j) {
        const unsigned short* p = as + (wn0 + 8 * j + g) * HPITCH + kk + 2 * t;
        bfrag[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bfrag[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < HMT; ++i) {
        const unsigned short* p = xs + (wm0 + 16 * i + g) * HPITCH + kk + 2 * t;
        uint32_t afrag[4];
        afrag[0] = *reinterpret_cast<const uint32_t*>(p);
        afrag[1] = *reinterpret_cast<const uint32_t*>(p + 8 * HPITCH);
        afrag[2] = *reinterpret_cast<const uint32_t*>(p + 8);
        afrag[3] = *reinterpret_cast<const uint32_t*>(p + 8 * HPITCH + 8);
#pragma unroll
        for (int j = 0; j < HNTL; ++j) mma_bf16(acc[i][j], afrag, bfrag[j]);
      }
    }
    if (more) {
      // the other buffer was last read in stage kt - 1, before the
      // barrier that ended it
      store_stage(Xs[buf ^ 1], xv, xk, tid);
      store_stage(As[buf ^ 1], av, ak, tid);
    }
    __syncthreads();
  }

  // c[2 h + e] = C[g + 8 h][2 t + e]
#pragma unroll
  for (int i = 0; i < HMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm0 + 16 * i + g + 8 * h;
      if (gm >= m) continue;
#pragma unroll
      for (int j = 0; j < HNTL; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn0 + 8 * j + 2 * t + e;
          if (gn >= n) continue;
          OutT* p = Y + gm * ys0 + gn * ys1;
          const OutT v = static_cast<OutT>(acc[i][j][2 * h + e]);
          *p = accumulate ? *p + v : v;
        }
      }
    }
  }
}

template <typename OutT>
int launch_bf16(const void* x, long long xsb, long long xs0, long long xs1,
                const void* a, long long asb, long long as0, long long as1,
                void* y, long long ysb, long long ys0, long long ys1,
                int batch, int m, int n, int k, int accumulate,
                void* stream) {
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((n + HBN - 1) / HBN, (m + HBM - 1) / HBM, batch);
  factor_matmul_bf16_kernel<OutT>
      <<<grid, HNT, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const unsigned short*>(x), xsb, xs0, xs1,
          static_cast<const unsigned short*>(a), asb, as0, as1,
          static_cast<OutT*>(y), ysb, ys0, ys1, m, n, k, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides in elements; xsb, asb and ysb step from one batch member to the
// next (0 shares the operand; any value when batch is 1).  `plan` is the bit set of ops/kernels.py
// factor_matmul_plan: staging axis and copy width of X and of A, store
// width of Y, tile size.  Returns the launch's cudaError (0 on success).
extern "C" int lpp_factor_matmul_f64(const void* x, long long xsb,
                                     long long xs0, long long xs1,
                                     const void* a, long long asb,
                                     long long as0, long long as1, void* y,
                                     long long ysb, long long ys0,
                                     long long ys1, int batch, int m, int n,
                                     int k, int accumulate, int plan,
                                     void* stream) {
  if (batch == 1) xsb = asb = ysb = 0;
  if (((plan & PLAN_X_VEC16) &&
       misplanned(x, xsb, xs0, xs1, plan & PLAN_X_KMAJOR)) ||
      ((plan & PLAN_A_VEC16) &&
       misplanned(a, asb, as0, as1, plan & PLAN_A_KMAJOR)) ||
      ((plan & PLAN_Y_VEC16) && misplanned(y, ysb, ys0, ys1, true)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const double* xp = static_cast<const double*>(x);
  const double* ap = static_cast<const double*>(a);
  double* yp = static_cast<double*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (plan & PLAN_TILE128)
          ? launch_dmma_layout<128, 128>(xp, xsb, xs0, xs1, ap, asb, as0,
                                         as1, yp, ysb, ys0, ys1, batch, m, n,
                                         k, accumulate, plan, s)
          : launch_dmma_layout<64, 64>(xp, xsb, xs0, xs1, ap, asb, as0, as1,
                                       yp, ysb, ys0, ys1, batch, m, n, k,
                                       accumulate, plan, s);
  return static_cast<int>(err);
}

// Dynamic shared memory in bytes of the float64 kernel a plan selects.
extern "C" int lpp_factor_matmul_f64_smem_bytes(int plan) {
  const bool xk = plan & PLAN_X_KMAJOR, ak = plan & PLAN_A_KMAJOR;
  const int tile = (plan & PLAN_TILE128) ? 128 : 64;
  const int x = xk ? tile * (BK + SKEW) : BK * (tile + SKEW);
  const int a = ak ? tile * (BK + SKEW) : BK * (tile + SKEW);
  return STAGES * (x + a) * 8;
}

extern "C" int lpp_factor_matmul_f32(const void* x, long long xsb,
                                     long long xs0, long long xs1,
                                     const void* a, long long asb,
                                     long long as0, long long as1, void* y,
                                     long long ysb, long long ys0,
                                     long long ys1, int batch, int m, int n,
                                     int k, int accumulate, void* stream) {
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((n + SBN - 1) / SBN, (m + SBM - 1) / SBM, batch);
  factor_matmul_simt_kernel<float>
      <<<grid, SNT, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), xsb, xs0, xs1,
          static_cast<const float*>(a), asb, as0, as1,
          static_cast<float*>(y), ysb, ys0, ys1, m, n, k, accumulate);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 X and A (their 16 bits), float32 sums, Y float32 (_f32) or
// float64 (_f64); the arguments as for the float32 kernel.
extern "C" int lpp_factor_matmul_bf16_f32(
    const void* x, long long xsb, long long xs0, long long xs1, const void* a,
    long long asb, long long as0, long long as1, void* y, long long ysb,
    long long ys0, long long ys1, int batch, int m, int n, int k,
    int accumulate, void* stream) {
  return launch_bf16<float>(x, xsb, xs0, xs1, a, asb, as0, as1, y, ysb, ys0,
                            ys1, batch, m, n, k, accumulate, stream);
}

extern "C" int lpp_factor_matmul_bf16_f64(
    const void* x, long long xsb, long long xs0, long long xs1, const void* a,
    long long asb, long long as0, long long as1, void* y, long long ysb,
    long long ys0, long long ys1, int batch, int m, int n, int k,
    int accumulate, void* stream) {
  return launch_bf16<double>(x, xsb, xs0, xs1, a, asb, as0, as1, y, ysb, ys0,
                             ys1, batch, m, n, k, accumulate, stream);
}
