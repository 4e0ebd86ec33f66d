// factor_matmul: Y[m, n] (+)= sum_k X[m, k] * A[n, k], an NT GEMM on
// strided operands, for float64, float32 and bfloat16 operands.
//
// Replaces the Pallas TPU kernel lanczosplusplus_tpu/ops/pallas_kernels.py
// factor_matmul (body _matmul_kernel).  On the main path X is the
// (size_down, size_up) Hubbard state matrix and A a dense one-spin hop
// factor, 3432 x 3432 at 14 sites: every Lanczos matvec runs two of these
// GEMMs, 2 * 2 * 3432^3 = 1.6e11 flops, so the kernel is bound by
// operations: in float64 the card's FP64 tensor-core rate (67 TFLOP/s),
// twice what its ordinary FP64 units reach; in float32 its FP32 units
// (67 TFLOP/s); with bf16 operands its bf16 tensor cores (989 TFLOP/s).
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
// tiles [row][k] with pitch depth + 4 elements (a slice is 16 k deep in
// float64), row-major tiles [k][row] with pitch rows + 4.  In float64
// both pitches are 4 mod 16 doubles, which spreads a fragment read (8
// rows x 4 k) over all banks in either layout.
// Copies are 16 bytes (two doubles, four floats) where base pointer and
// pitch allow it and one element (any strides) otherwise; the caller's
// plan says which.  Edges and the k tail are zero-filled by cp.async's
// source size, never read out of range; stores are guarded.
//
// The sum over k runs in the tensor cores' order within a 4-deep
// instruction and in k order across instructions, so results
// differ from a sequential FMA chain in the last bits.
//
// float32 design.  float32 has no exact tensor-core route (TF32 rounds the
// inputs to 10 bits of mantissa), so it runs on the FP32 units, on the
// float64 kernel's staging: the same cp.async ring (three stages of 32 k
// here), FastStager and stage_tile, the staging axis and copy width of
// the same plan (16-byte copies need a pitch that is a multiple of 4
// floats).  Only the consumer differs: a block of 256 threads owns a
// 256 x 128 output tile, 16 x 8 sums a thread in registers, or a 64 x 64
// one (4 x 4) when large tiles would not fill the card.  A thread reads
// its rows of X and of A four k at a time in 16-byte shared-memory loads:
// along k from a k-major tile (rows 16 apart, pitch 36 floats), along rows
// from a row-major one (runs of 4 adjacent rows).  A warp is 4 x 8
// threads, so one load touches 4 rows of X or 8 of A, a chunk each on
// distinct banks: shared memory serves it in one pass, and 24 loads feed
// 512 FMAs.  Every output is one chain of FMAs in k order from zero, as
// the earlier SIMT kernel summed it, so the results are that kernel's and
// both tiles and a batch of one give the same bits.
//
// bfloat16 design.  bf16 X and A with float32 sums (the TPU kernel's
// low-precision form, pallas_kernels.py preferred_element_type=
// jnp.float32) run on the warpgroup tensor-core instruction
//   wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16
// with both operands in shared memory and the sums in registers: on this
// card only wgmma reaches the bf16 rate.  A block of 384 threads owns a
// 128 x 256 output tile (measured faster than 128 x 128 at every path's
// shape): two consumer warpgroups of 64 rows each and a producer
// warpgroup, which hands most of its registers to the consumers
// (setmaxnreg: 232 a consumer thread, 128 of them its sums).  One thread
// of the producer walks k in 64-deep stages (128 bytes of bf16, one
// swizzle row) through a ring of four
// shared-memory stages filled by TMA (cp.async.bulk.tensor) from tensor
// maps the host encodes with cuTensorMapEncodeTiled (libcuda is linked)
// in the 128-byte swizzle.  A stage has a "full" mbarrier that its copies
// complete and an "empty" one at which every consumer warp arrives when
// the wgmmas that read the stage have retired (one group of four k16
// wgmmas stays in flight while the next is issued).  TMA fills ragged
// edges and the k tail with zeros; the stores are guarded.
//
// The kernel is bound by what reaches shared memory: a 128 x 256 stage
// of 64 k is 48 KB for 4.2 MFLOP, and at the bf16 rate the card's blocks
// would want some 11 TB/s of it from L2.  So two blocks, one above the
// other, form a cluster and share the columns of A: each loads its own
// X rows and half of A's, and TMA multicasts that half into both blocks'
// stages (32 KB a block a stage); a slot is refilled once the consumers
// of both blocks have released it, and a block's producer waits for the
// release of its last stages before it leaves, so that no block leaves
// while the other may still arrive at its barriers.  The grid is
// persistent, the clusters
// that fit the card at once, each walking its share of the tile pairs,
// so a block's producer fills the next tile's stages while its consumers
// store the last one.  Y's old values are read 16 at a time, their loads
// in flight together.
//
// Operands are read where they lie.  A k-contiguous operand is staged as
// a k-major tile ([row][k], one box of 64 k by the rows); a row-contiguous
// one (the transposed views of the dn apply and of the Kitaev products)
// as an MN-major tile (boxes of 64 rows by 64 k, each [k][row]), which
// wgmma reads through its transpose immediate.  Their shared-memory
// descriptors:
//   k-major:  SBO 1024 B (8 rows of 128 B); a k16 step is +32 B
//   MN-major: LBO 8192 B (64-row boxes), SBO 1024 B (8 k-rows); a k16
//             step is +2048 B
// (ops/kernels.py wgmma_smem_offset models both against TMA's layout).
// TMA takes a 16-byte aligned base and a pitch (and batch stride) that
// are multiples of 16 bytes; ops/kernels.py copies an operand without
// them into a padded one before the launch.  An operand per batch member
// is a 3-D tensor map (the batch its outer dimension), a shared one
// (batch stride 0) a 2-D map.  L2 promotion is 128 bytes: rows of 3432
// bf16 do not start on 128-byte lines, and 256-byte promotion fetched
// more than the boxes needed.
//
// The m64n256k16 float32 accumulator puts register i of thread t of a
// warpgroup at row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (t % 4) + i % 2 of its 64 x 256 tile (ops/kernels.py
// wgmma_accumulator_map); each thread stores, or adds, its sums through
// Y's strides as float32 or float64.  The product of two bf16 values is
// exact in float32, so the result differs from a float32 product of the
// widened operands only by the order of the float32 sums.
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
// stacked factors) or share X.  Every form folds the batch into its tile
// index (b * tiles + tile), so one launch fills the card where a single
// state's tiles would not (the bf16 form walks tile pairs b * pairs +
// pair).  A plain 2-D product is the case batch = 1.  16-byte cp.async
// copies then also need a batch stride that is a multiple of 16 bytes.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------
// cp.async staging, shared by the float64 and float32 kernels
// ---------------------------------------------------------------------

constexpr int BK = 16;    // contraction depth of one shared-memory stage
constexpr int SKEW = 4;   // pitch padding in elements, see above
constexpr int MMA_K = 4;  // k depth of one DMMA, and of a float32 fragment
constexpr int STAGES = 4; // shared-memory ring depth
// the k offset within a slice at which the ring is refilled
constexpr int REFILL_AT = MMA_K;

// plan bits, set by ops/kernels.py factor_matmul_plan
constexpr int PLAN_X_KMAJOR = 1, PLAN_X_VEC16 = 2, PLAN_A_KMAJOR = 4,
              PLAN_A_VEC16 = 8, PLAN_Y_VEC16 = 16, PLAN_TILE128 = 32;

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

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one element, or zero when !valid
template <typename T>
__device__ __forceinline__ void cp_async_elem(uint32_t dst, const T* src,
                                              bool valid) {
  if constexpr (sizeof(T) == 8)
    cp_async_8(dst, src, valid ? 8 : 0);
  else
    cp_async_4(dst, src, valid ? 4 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// elements one staged ROWS x D tile takes (D: the slice's depth), and its
// element offset
template <typename T, int ROWS, bool KMAJOR, int D = BK>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int PITCH = KMAJOR ? D + SKEW : ROWS + SKEW;
  static constexpr int SIZE = KMAJOR ? ROWS * PITCH : D * PITCH;
  static __device__ __forceinline__ int at(int r, int kk) {
    return KMAJOR ? r * PITCH + kk : kk * PITCH + r;
  }
};

// Start the copies of the slice [row0, row0 + ROWS) x [k0, k0 + D) of the
// strided matrix M (element (r, k) at M[r * s0 + k * s1]) into `tile`.
// Out-of-range elements arrive as zeros (source size 0).
template <typename T, int ROWS, bool KMAJOR, int NT, int D = BK>
__device__ __forceinline__ void stage_tile(T* tile, const T* __restrict__ M,
                                           long long s0, long long s1,
                                           bool vec16, int row0, int nrows,
                                           int k0, int kdim, int tid) {
  using L = Tile<T, ROWS, KMAJOR, D>;
  constexpr int VEC = L::VEC;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  if (vec16) {
    // VEC elements a copy along the contiguous axis
    constexpr int CHUNKS = ROWS * D / VEC;
    static_assert(CHUNKS % NT == 0, "tile must divide among the threads");
    // not unrolled: this path is off the loop's steady state, and rolled
    // it keeps its address arithmetic out of the loop's register budget
#pragma unroll 1
    for (int q = 0; q < CHUNKS / NT; ++q) {
      const int c = tid + q * NT;
      int r, kk, valid;
      if (KMAJOR) {
        r = c / (D / VEC);
        kk = (c % (D / VEC)) * VEC;
        valid = (row0 + r < nrows) ? min(max(kdim - (k0 + kk), 0), VEC) : 0;
      } else {
        kk = c / (ROWS / VEC);
        r = (c % (ROWS / VEC)) * VEC;
        valid = (k0 + kk < kdim) ? min(max(nrows - (row0 + r), 0), VEC) : 0;
      }
      const T* src = valid ? M + static_cast<long long>(row0 + r) * s0 +
                                 static_cast<long long>(k0 + kk) * s1
                           : M;
      cp_async_16(base + sizeof(T) * L::at(r, kk), src,
                  static_cast<int>(sizeof(T)) * valid);
    }
  } else {
    // one element a copy, any strides; threads walk the staged layout's
    // fast axis, which the plan chose as the operand's nearer one
    constexpr int ELEMS = ROWS * D;
    static_assert(ELEMS % NT == 0, "tile must divide among the threads");
#pragma unroll 1
    for (int q = 0; q < ELEMS / NT; ++q) {
      const int e = tid + q * NT;
      const int r = KMAJOR ? e / D : e % ROWS;
      const int kk = KMAJOR ? e % D : e / ROWS;
      const bool valid = row0 + r < nrows && k0 + kk < kdim;
      const T* src = valid ? M + static_cast<long long>(row0 + r) * s0 +
                                 static_cast<long long>(k0 + kk) * s1
                           : M;
      cp_async_elem(base + sizeof(T) * L::at(r, kk), src, valid);
    }
  }
}

// The same copies for a slice that lies inside the matrix along k, by
// 16-byte chunks, with everything that does not change from slice to slice
// worked out once per thread: its first chunk's source address (advanced
// by one slice after every call), its offset in the staged tile, and the
// constant steps between its chunks.  This is the loop's path; stage_tile
// above serves the k tail, one-element operands and ragged row counts.  A
// thread's chunks share their place along the contiguous axis and step
// along the other one.
template <typename T, int ROWS, bool KMAJOR, int NT, int D = BK>
struct FastStager {
  using L = Tile<T, ROWS, KMAJOR, D>;
  static constexpr int VEC = L::VEC;
  static constexpr int ALONG = (KMAJOR ? D : ROWS) / VEC;  // chunks a line
  static constexpr int CHUNKS = ROWS * D / VEC / NT;       // per thread
  static constexpr int STEP = NT / ALONG;                   // lines a chunk
  static_assert(NT % ALONG == 0 && (ROWS * D / VEC) % NT == 0,
                "threads must tile the staged slice");
  const T* src;       // first chunk of the next slice
  long long chunk_step, slice_step;  // in elements
  uint32_t offset;    // bytes from the tile's start
  int row;            // first chunk's row within the tile
  bool usable;        // 16-byte copies, whole chunks only

  __device__ __forceinline__ FastStager(const T* M, long long s0,
                                        long long s1, bool vec16, int row0,
                                        int nrows, int tid) {
    const int line = tid / ALONG, along = (tid % ALONG) * VEC;
    row = KMAJOR ? line : along;
    const int kk = KMAJOR ? along : line;
    src = M + static_cast<long long>(row0 + row) * s0 +
          static_cast<long long>(kk) * s1;
    chunk_step = STEP * (KMAJOR ? s0 : s1);
    slice_step = D * s1;
    offset = sizeof(T) * L::at(row, kk);
    // row-major chunks span VEC rows: the tile's last row must end one
    usable = vec16 && (KMAJOR || nrows - row0 >= ROWS ||
                       (nrows - row0) % VEC == 0);
  }

  // rows_here: rows of the matrix inside this tile
  __device__ __forceinline__ void stage(uint32_t tile, int rows_here) {
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) {
      const int r = KMAJOR ? row + q * STEP : row;
      cp_async_16(tile + offset +
                      sizeof(T) * (KMAJOR ? L::at(q * STEP, 0)
                                          : L::at(0, q * STEP)),
                  src + q * chunk_step, r < rows_here ? 16 : 0);
    }
  }
};

// A 16-byte copy was planned for an operand that cannot take one (`sb`:
// its batch stride, 0 for the shared factor; `vec`: elements a copy).
bool misplanned(const void* p, long long sb, long long s0, long long s1,
                bool kmajor, int vec) {
  const long long contiguous = kmajor ? s1 : s0, pitch = kmajor ? s0 : s1;
  return reinterpret_cast<uintptr_t>(p) % 16 != 0 || contiguous != 1 ||
         pitch % vec != 0 || sb % vec != 0;
}

// ---------------------------------------------------------------------
// float64: DMMA kernel
// ---------------------------------------------------------------------

constexpr int WM = 32;    // warp tile
constexpr int WN = 32;

__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[2],
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

template <int BM, int BN, bool XK, bool AK>
struct DmmaConfig {
  static constexpr int WARPS_M = BM / WM;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = WARPS_M * WARPS_N * 32;
  // blocks an SM should hold: 128 registers a thread fill its file
  static constexpr int MIN_BLOCKS = NT >= 512 ? 1 : 512 / NT;
  static constexpr int MT = WM / 16;  // DMMA tiles along m per warp
  static constexpr int NTL = WN / 8;  // DMMA tiles along n per warp
  using XT = Tile<double, BM, XK>;
  using AT = Tile<double, BN, AK>;
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

  FastStager<double, BM, XK, C::NT> xfast(X, xs0, xs1, xvec, m0, m, tid);
  FastStager<double, BN, AK, C::NT> afast(A, as0, as1, avec, n0, n, tid);
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // slices are staged in order, so the fast stagers' addresses keep step
  auto stage = [&](int kt) {
    const int s = kt % STAGES;
    const bool inside = (kt + 1) * BK <= k;
    if (inside && xfast.usable)
      xfast.stage(ring + 8u * (s * C::STAGE), m - m0);
    else
      stage_tile<double, BM, XK, C::NT>(smem + s * C::STAGE, X, xs0, xs1,
                                        xvec, m0, m, kt * BK, k, tid);
    if (inside && afast.usable)
      afast.stage(ring + 8u * (s * C::STAGE + C::XT::SIZE), n - n0);
    else
      stage_tile<double, BN, AK, C::NT>(smem + s * C::STAGE + C::XT::SIZE,
                                        A, as0, as1, avec, n0, n, kt * BK, k,
                                        tid);
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

// ---------------------------------------------------------------------
// float32: FMA kernel on the same staging
// ---------------------------------------------------------------------

constexpr int SNT = 256;     // threads of a float32 block, 16 x 16
constexpr int SBK = 32;      // contraction depth of a float32 stage
constexpr int SSTAGES = 3;   // and its ring's depth

// A block's tile is BM x BN, each thread's BM / 16 x BN / 16 sums.
template <int BM, int BN, bool XK, bool AK>
struct SimtConfig {
  static constexpr int TM = BM / 16;  // a thread's rows of X
  static constexpr int TN = BN / 16;  // and of A
  // blocks an SM should hold: the small tile needs few registers
  static constexpr int MIN_BLOCKS = BM * BN >= 128 * 128 ? 1 : 2;
  using XT = Tile<float, BM, XK, SBK>;
  using AT = Tile<float, BN, AK, SBK>;
  static constexpr int STAGE = XT::SIZE + AT::SIZE;  // floats
  static constexpr int SMEM_BYTES = SSTAGES * STAGE * 4;
  static_assert(TM % 4 == 0 && TN % 4 == 0,
                "row-major fragments are runs of 4 rows");
};

// The tile row of a thread's i-th row along one axis (t: the thread's
// coordinate on that axis, 0..15): 16 apart in a k-major tile, runs of 4
// adjacent rows 64 apart in a row-major one.
template <bool KMAJOR>
__device__ __forceinline__ int frag_row(int t, int i) {
  return KMAJOR ? t + 16 * i : 4 * t + (i % 4) + 64 * (i / 4);
}

// f[i][q] = tile(frag_row(t, i0 + i), kk + q) for q < 4, in 16-byte
// loads: along k in a k-major tile, along rows in a row-major one
template <int ROWS, bool KMAJOR, int TR>
__device__ __forceinline__ void load_frag(float (&f)[TR][MMA_K],
                                          const float* tile, int t, int kk,
                                          int i0 = 0) {
  using L = Tile<float, ROWS, KMAJOR, SBK>;
  if (KMAJOR) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          tile + L::at(frag_row<true>(t, i0 + i), kk));
      f[i][0] = v.x;
      f[i][1] = v.y;
      f[i][2] = v.z;
      f[i][3] = v.w;
    }
  } else {
#pragma unroll
    for (int h = 0; h < TR; h += 4)
#pragma unroll
      for (int q = 0; q < MMA_K; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            tile + L::at(frag_row<false>(t, i0 + h), kk + q));
        f[h][q] = v.x;
        f[h + 1][q] = v.y;
        f[h + 2][q] = v.z;
        f[h + 3][q] = v.w;
      }
  }
}

template <int BM, int BN, bool XK, bool AK>
__global__ void __launch_bounds__(SNT,
                                  (SimtConfig<BM, BN, XK, AK>::MIN_BLOCKS))
factor_matmul_simt_kernel(const float* __restrict__ X, long long xsb,
                          long long xs0, long long xs1,
                          const float* __restrict__ A, long long asb,
                          long long as0, long long as1,
                          float* __restrict__ Y, long long ysb,
                          long long ys0, long long ys1, int m, int n, int k,
                          int accumulate, int plan) {
  using C = SimtConfig<BM, BN, XK, AK>;
  extern __shared__ __align__(16) float fsmem[];

  const int tid = threadIdx.x;
  // a warp is 4 x 8 threads: its loads of X's rows touch 4 of them, of
  // A's 8, each one 16-byte chunk a load, on distinct banks
  const int tx = (tid / 32) % 2 * 8 + tid % 8;  // along n: A's rows
  const int ty = tid / 64 * 4 + tid % 32 / 8;   // along m: X's rows
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
  const int slices = (k + SBK - 1) / SBK;

  FastStager<float, BM, XK, SNT, SBK> xfast(X, xs0, xs1, xvec, m0, m, tid);
  FastStager<float, BN, AK, SNT, SBK> afast(A, as0, as1, avec, n0, n, tid);
  const uint32_t ring =
      static_cast<uint32_t>(__cvta_generic_to_shared(fsmem));

  auto stage = [&](int kt) {
    const int s = kt % SSTAGES;
    const bool inside = (kt + 1) * SBK <= k;
    if (inside && xfast.usable)
      xfast.stage(ring + 4u * (s * C::STAGE), m - m0);
    else
      stage_tile<float, BM, XK, SNT, SBK>(fsmem + s * C::STAGE, X, xs0, xs1,
                                         xvec, m0, m, kt * SBK, k, tid);
    if (inside && afast.usable)
      afast.stage(ring + 4u * (s * C::STAGE + C::XT::SIZE), n - n0);
    else
      stage_tile<float, BN, AK, SNT, SBK>(fsmem + s * C::STAGE + C::XT::SIZE,
                                         A, as0, as1, avec, n0, n, kt * SBK,
                                         k, tid);
    xfast.src += xfast.slice_step;
    afast.src += afast.slice_step;
  };

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < SSTAGES - 1; ++s) {
    if (s < slices) stage(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<SSTAGES - 2>();
    __syncthreads();
    const float* xs = fsmem + (kt % SSTAGES) * C::STAGE;
    const float* as = xs + C::XT::SIZE;
#pragma unroll
    for (int kk = 0; kk < SBK; kk += MMA_K) {
      if (kk == REFILL_AT) {
        if (kt + SSTAGES - 1 < slices) stage(kt + SSTAGES - 1);
        cp_async_commit();
      }
      float xf[C::TM][MMA_K], af[C::TN][MMA_K];
      load_frag<BM, XK>(xf, xs, ty, kk);
      load_frag<BN, AK>(af, as, tx, kk);
      // one FMA a step, k in order
#pragma unroll
      for (int q = 0; q < MMA_K; ++q)
#pragma unroll
        for (int i = 0; i < C::TM; ++i)
#pragma unroll
          for (int j = 0; j < C::TN; ++j)
            acc[i][j] = fmaf(xf[i][q], af[j][q], acc[i][j]);
    }
  }

  // a row's old values of Y are loaded together, then the row is stored
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int gm = m0 + frag_row<XK>(ty, i);
    if (gm >= m) continue;
    float old[C::TN];
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int gn = n0 + frag_row<AK>(tx, j);
      old[j] = accumulate && gn < n ? Y[gm * ys0 + gn * ys1] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int gn = n0 + frag_row<AK>(tx, j);
      if (gn < n)
        Y[gm * ys0 + gn * ys1] = accumulate ? old[j] + acc[i][j] : acc[i][j];
    }
  }
}

template <int BM, int BN, bool XK, bool AK>
cudaError_t launch_simt(const float* x, long long xsb, long long xs0,
                        long long xs1, const float* a, long long asb,
                        long long as0, long long as1, float* y, long long ysb,
                        long long ys0, long long ys1, int batch, int m, int n,
                        int k, int accumulate, int plan, cudaStream_t stream) {
  using C = SimtConfig<BM, BN, XK, AK>;
  auto kernel = factor_matmul_simt_kernel<BM, BN, XK, AK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>((n + BN - 1) / BN) * ((m + BM - 1) / BM);
  if (tiles * batch > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(tiles * batch), SNT, C::SMEM_BYTES,
           stream>>>(x, xsb, xs0, xs1, a, asb, as0, as1, y, ysb, ys0, ys1, m,
                     n, k, accumulate, plan);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_simt_layout(const float* x, long long xsb, long long xs0,
                               long long xs1, const float* a, long long asb,
                               long long as0, long long as1, float* y,
                               long long ysb, long long ys0, long long ys1,
                               int batch, int m, int n, int k, int accumulate,
                               int plan, cudaStream_t stream) {
  const bool xk = plan & PLAN_X_KMAJOR, ak = plan & PLAN_A_KMAJOR;
#define LPP_GO(XK, AK)                                                     \
  return launch_simt<BM, BN, XK, AK>(x, xsb, xs0, xs1, a, asb, as0, as1,   \
                                     y, ysb, ys0, ys1, batch, m, n, k,     \
                                     accumulate, plan, stream)
  if (xk && ak) LPP_GO(true, true);
  if (xk) LPP_GO(true, false);
  if (ak) LPP_GO(false, true);
  LPP_GO(false, false);
#undef LPP_GO
}

// ---------------------------------------------------------------------
// bfloat16 operands, float32 sums: wgmma fed by TMA
// ---------------------------------------------------------------------

constexpr int GBM = 128;              // output rows of a block
constexpr int GBK = 64;               // k of a stage: 128 bytes of bf16
constexpr int GSTAGES = 4;            // shared-memory ring depth
constexpr int GCONSUMERS = 256;       // two consumer warpgroups
constexpr int GNT = GCONSUMERS + 128; // and a producer warpgroup
// registers a thread, set with setmaxnreg: the producer gives up most of
// its share to the consumers' sums (128 + 128 + 256 threads' worth fill
// the SM's 64 K)
constexpr int GPRODUCER_REGS = 40, GCONSUMER_REGS = 232;
constexpr int GBOX = 64 * GBK * 2;    // 64 rows x 64 k: 8 KB
constexpr int GCLUSTER = 2;           // blocks a cluster, sharing A's tile
constexpr int GX_BYTES = GBM * GBK * 2;  // X's part of a stage

constexpr int GBN = 256;              // output columns of a block
// a stage: X's 128 rows and A's 256, 64 k each
constexpr int GSTAGE_BYTES = (GBM + GBN) * GBK * 2;
// the ring, aligned to 1024 bytes for the swizzle, then its barriers
constexpr int GSMEM_BYTES = 1024 + GSTAGES * GSTAGE_BYTES + 2 * GSTAGES * 8;
constexpr int GACC = GBN / 2;         // float32 sums a consumer thread holds

// plan bits, set by ops/kernels.py factor_matmul_bf16_plan
constexpr int BPLAN_X_KMAJOR = 1, BPLAN_A_KMAJOR = 2, BPLAN_X_3D = 4,
              BPLAN_A_3D = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// until the phase of parity `parity` has completed; a wait that has not
// completed after 2^32 polls (tens of seconds) traps, a launch error,
// rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1ll << 32)) __trap();
  }
}

// one TMA box at coordinates (c0, c1[, c2]) of the map, innermost first,
// into this block's shared memory, or with `mask` into the same offset of
// every block of the cluster that the mask names (each block's barrier at
// `bar` counts the bytes that reach it)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, bool three,
                                         uint16_t mask = 0) {
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
  if (mask && three)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], "
        "[%5], %6;\n" ::"r"(dst),
        "l"(desc), "r"(c0), "r"(c1), "r"(c2), "r"(bar), "h"(mask)
        : "memory");
  else if (mask)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], "
        "%5;\n" ::"r"(dst),
        "l"(desc), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
        : "memory");
  else if (three)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
        "l"(desc), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(desc), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
}

// The rows [row0, row0 + ROWS) x [k0, k0 + 64) of batch member b: one box
// of a k-major map (ROWS rows), or ROWS / 64 boxes of an MN-major one,
// GBOX apart; multicast to the blocks of `mask` when it is not 0.
template <bool KMAJOR, int ROWS>
__device__ __forceinline__ void load_operand(uint32_t dst,
                                             const CUtensorMap* map,
                                             bool three, uint32_t bar,
                                             int row0, int k0, int b,
                                             uint16_t mask = 0) {
  if (KMAJOR) {
    tma_load(dst, map, bar, k0, row0, b, three, mask);
  } else {
#pragma unroll
    for (int c = 0; c < ROWS / 64; ++c)
      tma_load(dst + c * GBOX, map, bar, row0 + 64 * c, k0, b, three, mask);
  }
}

// arrive at the barrier at shared-memory offset `bar` of block `cta` of
// the cluster
__device__ __forceinline__ void mbar_arrive_in(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      ::"r"(bar), "r"(cta)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of both blocks of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// the k16 step q of a staged operand tile
template <bool KMAJOR>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int q) {
  return KMAJOR ? smem_desc(tile + 32 * q, 16, 1024)
                : smem_desc(tile + 2048 * q, GBOX, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to the sums across a wgmma
// fence, commit or wait
template <int R>
__device__ __forceinline__ void fence_sums(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A . B for the m64n256k16 step; TA / TB: the operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <bool XK, bool AK, typename OutT>
__global__ void __cluster_dims__(GCLUSTER, 1, 1) __launch_bounds__(GNT, 1)
factor_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap amap,
                           OutT* __restrict__ Y, long long ysb, long long ys0,
                           long long ys1, int batch, int m, int n, int k,
                           int accumulate, int plan) {
  extern __shared__ __align__(1024) unsigned char gsmem[];
  const uint32_t ring = (smem_u32(gsmem) + 1023) & ~1023u;
  const uint32_t full = ring + GSTAGES * GSTAGE_BYTES;  // a barrier a stage
  const uint32_t empty = full + GSTAGES * 8;

  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster_rank());
  const int tiles_n = (n + GBN - 1) / GBN;
  // a cluster's work item: GCLUSTER tiles one above the other, one per
  // block, that share their columns of A
  const int pairs = (m + GCLUSTER * GBM - 1) / (GCLUSTER * GBM) * tiles_n;
  const int work = pairs * batch;
  const int stages = (k + GBK - 1) / GBK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      // a consumer warp of each block of the cluster
      mbar_init(empty + 8 * s, GCLUSTER * GCONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  // A cluster walks the items blockIdx.x / GCLUSTER, + gridDim.x /
  // GCLUSTER, ..., and each block's ring runs on across them: `use`
  // counts the stages it has filled (producer) or consumed (consumers).
  if (tid >= GCONSUMERS) {
    // the producer warpgroup: one thread issues every copy, running ahead
    // into the next item while the consumers store this one
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        GPRODUCER_REGS));
    if (tid == GCONSUMERS) {
      const bool x3 = plan & BPLAN_X_3D, a3 = plan & BPLAN_A_3D;
      int use = 0;
      for (int w = blockIdx.x / GCLUSTER; w < work;
           w += gridDim.x / GCLUSTER) {
        const int b = w / pairs, pair = w % pairs;
        const int m0 = ((pair / tiles_n) * GCLUSTER + rank) * GBM;
        const int n0 = (pair % tiles_n) * GBN;
        for (int kt = 0; kt < stages; ++kt, ++use) {
          const int s = use % GSTAGES;
          // both blocks' consumers have retired this slot's last use: the
          // other block writes into it too
          if (use >= GSTAGES)
            mbar_wait(empty + 8 * s, (use / GSTAGES - 1) & 1);
          const uint32_t bar = full + 8 * s;
          const uint32_t dst = ring + s * GSTAGE_BYTES;
          mbar_expect_tx(bar, GSTAGE_BYTES);
          load_operand<XK, GBM>(dst, &xmap, x3, bar, m0, kt * GBK, b);
          // this block's share of A's rows, to every block of the cluster
          constexpr int SHARE = GBN / GCLUSTER;
          load_operand<AK, SHARE>(dst + GX_BYTES + rank * SHARE * 128, &amap,
                                  a3, bar, n0 + rank * SHARE, kt * GBK, b,
                                  (1u << GCLUSTER) - 1);
        }
      }
      // The block leaves only when both blocks' consumers have released
      // its last stages: the other block's consumers arrive at its
      // barriers, and its multicasts have all landed once this block's
      // own consumers are past them.
      for (int i = 0; i < GSTAGES; ++i, ++use)
        if (use >= GSTAGES)
          mbar_wait(empty + 8 * (use % GSTAGES), (use / GSTAGES - 1) & 1);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        GCONSUMER_REGS));
    const int wg = tid / 128;  // this warpgroup's rows: 64 wg .. 64 wg + 63
    const int t = tid % 128;
    const bool signals = tid % 32 == 0;
    // a slot is free again: tell the producer of every block of the
    // cluster, which all write into it
    auto release = [&](int slot) {
      if (signals)
#pragma unroll
        for (int c = 0; c < GCLUSTER; ++c)
          mbar_arrive_in(empty + 8 * slot, c);
    };
    int use = 0;
    for (int w = blockIdx.x / GCLUSTER; w < work; w += gridDim.x / GCLUSTER) {
      const int b = w / pairs, pair = w % pairs;
      const int m0 = ((pair / tiles_n) * GCLUSTER + rank) * GBM;
      const int n0 = (pair % tiles_n) * GBN;
      float acc[GACC];
#pragma unroll
      for (int i = 0; i < GACC; ++i) acc[i] = 0.0f;
      fence_sums(acc);
      for (int kt = 0; kt < stages; ++kt, ++use) {
        const int s = use % GSTAGES;
        mbar_wait(full + 8 * s, (use / GSTAGES) & 1);
        // a warpgroup's 64 rows are one 64-row box in either layout
        const uint32_t xt = ring + s * GSTAGE_BYTES + wg * GBOX;
        const uint32_t at = ring + s * GSTAGE_BYTES + GX_BYTES;
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < GBK / 16; ++q)
          wgmma_n256<XK ? 0 : 1, AK ? 0 : 1>(acc, operand_desc<XK>(xt, q),
                                            operand_desc<AK>(at, q));
        wgmma_commit();
        fence_sums(acc);
        // the previous stage's wgmmas have retired: its slot is free
        wgmma_wait<1>();
        if (kt > 0) release((use - 1) % GSTAGES);
      }
      wgmma_wait<0>();
      fence_sums(acc);
      if (stages > 0) release((use - 1) % GSTAGES);

      // Y's old values are read a chunk of sums at a time, all loads of a
      // chunk in flight together, then the chunk is stored
      OutT* y = Y + b * ysb;
      const int row0 = m0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4;
      const int col0 = n0 + 2 * (t % 4);
      constexpr int CHUNK = 16;
#pragma unroll
      for (int i0 = 0; i0 < GACC; i0 += CHUNK) {
        OutT old[CHUNK];
#pragma unroll
        for (int q = 0; q < CHUNK; ++q) {
          const int i = i0 + q;
          const int r = row0 + 8 * ((i / 2) % 2);
          const int c = col0 + 8 * (i / 4) + i % 2;
          old[q] = accumulate && r < m && c < n ? y[r * ys0 + c * ys1]
                                                : OutT(0);
        }
#pragma unroll
        for (int q = 0; q < CHUNK; ++q) {
          const int i = i0 + q;
          const int r = row0 + 8 * ((i / 2) % 2);
          const int c = col0 + 8 * (i / 4) + i % 2;
          const OutT v = static_cast<OutT>(acc[i]);
          if (r < m && c < n)
            y[r * ys0 + c * ys1] = accumulate ? old[q] + v : v;
        }
      }
    }
  }
}

// TMA cannot address the (rows, k) operand as the plan says: a base or a
// pitch (or, for a map per member, a batch stride) off 16 bytes, a pitch
// shorter than a row, members that overlap.
bool tma_unaddressable(const void* p, bool kmajor, bool three, int rows,
                       int k, long long s0, long long s1, long long sb) {
  const long long pitch = kmajor ? s0 : s1, inner = kmajor ? k : rows;
  const long long outer = kmajor ? rows : k;
  return reinterpret_cast<uintptr_t>(p) % 16 != 0 || (kmajor ? s1 : s0) != 1
         || pitch % 8 != 0 || pitch < inner ||
         (three && (sb % 8 != 0 || sb < pitch * outer));
}

// The tensor map of a (rows, k) bf16 operand: innermost its contiguous
// axis; boxes of 64 k by box_rows rows (k-major) or 64 rows by 64 k.
bool encode_map(CUtensorMap* map, const void* p, bool kmajor, bool three,
                int rows, int k, int batch, long long s0, long long s1,
                long long sb, int box_rows) {
  const cuuint64_t kk = k > 0 ? k : 1;  // a map has no empty dimension
  cuuint64_t dims[3] = {kmajor ? kk : cuuint64_t(rows),
                        kmajor ? cuuint64_t(rows) : kk, cuuint64_t(batch)};
  cuuint64_t strides[2] = {cuuint64_t(kmajor ? s0 : s1) * 2,
                           cuuint64_t(sb) * 2};
  cuuint32_t box[3] = {64, cuuint32_t(kmajor ? box_rows : 64), 1};
  cuuint32_t ones[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, three ? 3 : 2,
             const_cast<void*>(p), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool XK, bool AK, typename OutT>
cudaError_t launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& amap,
                         OutT* y, long long ysb, long long ys0, long long ys1,
                         int batch, int m, int n, int k, int accumulate,
                         int plan, cudaStream_t stream) {
  auto kernel = factor_matmul_wgmma_kernel<XK, AK, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long work = static_cast<long long>((n + GBN - 1) / GBN) *
                         ((m + GCLUSTER * GBM - 1) / (GCLUSTER * GBM)) * batch;
  if (work > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // the clusters that fit the card at once (a cluster of blocks shares a
  // GPC), each walking its share of the work
  static int resident = 0;
  if (resident == 0) {
    int device, sms;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return err;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(sms / GCLUSTER * GCLUSTER);
    config.blockDim = dim3(GNT);
    config.dynamicSmemBytes = GSMEM_BYTES;
    if ((err = cudaOccupancyMaxActiveClusters(&resident, kernel, &config)) !=
        cudaSuccess)
      return err;
    if (resident <= 0) return cudaErrorInvalidConfiguration;
  }
  const long long clusters = work < resident ? work : resident;
  kernel<<<static_cast<unsigned>(clusters * GCLUSTER), GNT, GSMEM_BYTES,
           stream>>>(xmap, amap, y, ysb, ys0, ys1, batch, m, n, k,
                     accumulate, plan);
  return cudaGetLastError();
}

template <typename OutT>
int launch_bf16(const void* x, long long xsb, long long xs0, long long xs1,
                const void* a, long long asb, long long as0, long long as1,
                void* y, long long ysb, long long ys0, long long ys1,
                int batch, int m, int n, int k, int accumulate, int plan,
                void* stream) {
  const bool xk = plan & BPLAN_X_KMAJOR, ak = plan & BPLAN_A_KMAJOR;
  const bool x3 = plan & BPLAN_X_3D, a3 = plan & BPLAN_A_3D;
  if (tma_unaddressable(x, xk, x3, m, k, xs0, xs1, xsb) ||
      tma_unaddressable(a, ak, a3, n, k, as0, as1, asb))
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap xmap, amap;
  if (!encode_map(&xmap, x, xk, x3, m, k, batch, xs0, xs1, xsb, GBM) ||
      !encode_map(&amap, a, ak, a3, n, k, batch, as0, as1, asb,
                  GBN / GCLUSTER))
    return static_cast<int>(cudaErrorInvalidValue);
  OutT* yp = static_cast<OutT*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 1) ysb = 0;
#define LPP_GO(XK, AK)                                                      \
  return static_cast<int>(launch_wgmma<XK, AK, OutT>(                       \
      xmap, amap, yp, ysb, ys0, ys1, batch, m, n, k, accumulate, plan, s))
  if (xk && ak) LPP_GO(true, true);
  if (xk) LPP_GO(true, false);
  if (ak) LPP_GO(false, true);
  LPP_GO(false, false);
#undef LPP_GO
}

}  // namespace

// Strides in elements; xsb, asb and ysb step from one batch member to the
// next (0 shares the operand; any value when batch is 1).  `plan` is the
// bit set of ops/kernels.py factor_matmul_plan: staging axis and copy
// width of X and of A, store width of Y, tile size.  Returns the launch's
// cudaError (0 on success).
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
       misplanned(x, xsb, xs0, xs1, plan & PLAN_X_KMAJOR, 2)) ||
      ((plan & PLAN_A_VEC16) &&
       misplanned(a, asb, as0, as1, plan & PLAN_A_KMAJOR, 2)) ||
      ((plan & PLAN_Y_VEC16) && misplanned(y, ysb, ys0, ys1, true, 2)))
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

// As the float64 one, with the plan of factor_matmul_plan at 4-byte
// elements (its store-width bit is not read).
extern "C" int lpp_factor_matmul_f32(const void* x, long long xsb,
                                     long long xs0, long long xs1,
                                     const void* a, long long asb,
                                     long long as0, long long as1, void* y,
                                     long long ysb, long long ys0,
                                     long long ys1, int batch, int m, int n,
                                     int k, int accumulate, int plan,
                                     void* stream) {
  if (batch == 1) xsb = asb = ysb = 0;
  if (((plan & PLAN_X_VEC16) &&
       misplanned(x, xsb, xs0, xs1, plan & PLAN_X_KMAJOR, 4)) ||
      ((plan & PLAN_A_VEC16) &&
       misplanned(a, asb, as0, as1, plan & PLAN_A_KMAJOR, 4)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const float* xp = static_cast<const float*>(x);
  const float* ap = static_cast<const float*>(a);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (plan & PLAN_TILE128)
          ? launch_simt_layout<256, 128>(xp, xsb, xs0, xs1, ap, asb, as0,
                                         as1, yp, ysb, ys0, ys1, batch, m, n,
                                         k, accumulate, plan, s)
          : launch_simt_layout<64, 64>(xp, xsb, xs0, xs1, ap, asb, as0, as1,
                                       yp, ysb, ys0, ys1, batch, m, n, k,
                                       accumulate, plan, s);
  return static_cast<int>(err);
}

// bfloat16 X and A (their 16 bits), float32 sums, Y float32 (_f32) or
// float64 (_f64); `plan` is the bit set of ops/kernels.py
// factor_matmul_bf16_plan (majorness and map rank of X and of A, tile
// width), the other arguments as for the float64 kernel.
extern "C" int lpp_factor_matmul_bf16_f32(
    const void* x, long long xsb, long long xs0, long long xs1, const void* a,
    long long asb, long long as0, long long as1, void* y, long long ysb,
    long long ys0, long long ys1, int batch, int m, int n, int k,
    int accumulate, int plan, void* stream) {
  return launch_bf16<float>(x, xsb, xs0, xs1, a, asb, as0, as1, y, ysb, ys0,
                            ys1, batch, m, n, k, accumulate, plan, stream);
}

extern "C" int lpp_factor_matmul_bf16_f64(
    const void* x, long long xsb, long long xs0, long long xs1, const void* a,
    long long asb, long long as0, long long as1, void* y, long long ysb,
    long long ys0, long long ys1, int batch, int m, int n, int k,
    int accumulate, int plan, void* stream) {
  return launch_bf16<double>(x, xsb, xs0, xs1, a, asb, as0, as1, y, ysb, ys0,
                             ys1, batch, m, n, k, accumulate, plan, stream);
}
