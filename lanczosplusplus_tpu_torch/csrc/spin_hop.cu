// spin_hop: the one-spin hops of a Hubbard-family sector in one pass,
//   y[b, d, u] = diag[d szu + u] x[b, d, u]            (or y[b, d, u] as it is)
//              + sum_k vu[k, u] x[b, d, cu[k, u]]       k < nu[u]
//              + sum_k vd[k, d] x[b, cd[k, d], u]       k < nd[d]
// for a contiguous batch-major block x viewed as (batch, size_down, size_up)
// and y of the same shape, in float64 or float32.  (cu, vu, nu) and (cd,
// vd, nd) are a one-spin hop map's nonzero entries, compacted (ops/
// kernels.py compact_hops): entry k of row i at [k, i] of a (K, size)
// table, k below the row's count, in ascending bond order, no padding
// channel; either map may be absent.  With a diagonal (a Hamiltonian with
// no ELL part) y is written; without one y holds ell_spmv's diagonal and
// ELL sum and the hops are added into it.
//
// No TPU kernel stands behind this one: the JAX package applies these
// maps as dense GEMMs on the MXU (ops/pallas_kernels.py factor_matmul) or
// as 1-D gathers outside Pallas.  It replaces, for a real state on the
// card, the two factor_matmul GEMMs of a densified sector (3432 multiply-
// adds a row of the 14-site chain's factors, which hold about 7.5
// nonzeros a row) and perm_gather's two launches over the 28 padded bond
// channels (73 % of whose column amplitudes are 0), and the diagonal's
// elementwise pass with them.
//
// Bound.  Bytes: x read once, y written once, and diag read once (or y
// read once), 24 bytes an element in float64; the tables are small (the
// 14-site chain's up map 3432 x 14 slots) and stay in L2.  What can cost
// more than that is re-reading: the up sum gathers within a row, the dn
// sum reads whole other rows, about 7.5 of them a row.
//
// Design.  A block of THREADS threads owns GROUP consecutive rows r = b
// size_down + d of the block, two where two fit
// kernels.SPIN_HOP_STAGE_BYTES (four or eight rows a block held their sums
// and gathers in flight past the 64 registers a thread has at two blocks
// an SM, spilled, and ran no faster at 3432^2).  It stages the rows of x
// in shared memory with asynchronous copies, all in flight at once, and
// the rows' dn entries beside them; the up sums gather from that copy.  A
// thread owns a column u at a time: it loads u's up entries once, each
// (column, value) serving all the group's rows, and reads x[b, cd, u] for
// each of the rows' dn entries, a whole row a warp, coalesced, DN_BATCH of
// them in flight.  A row too long to stage is gathered from device memory
// through the read-only path instead (STAGE false, one row a block).  Two
// orders of the grid meant to keep the rows the dn sums read again in L2
// longer, strips of columns walked one after another and a Cuthill-McKee
// order of the rows, measured no faster on the 14-site chain (PERF.md §6).
//
// Bit-equality.  Each element adds its terms in the plain version's order,
// each product and sum rounded on its own (__dmul_rn and __dadd_rn, never
// fused; the float intrinsics in float32): the diagonal's product first
// (or y as it is), then the up entries ascending, then the dn entries
// ascending, as perm_gather's plain version adds the maps' channels (the
// padding channels it adds are zeros).  So the kernel equals its plain
// version, kernels.spin_hop_ref, bit for bit.
//
// Offsets are 64-bit (a block of 183 states of the 14-site sector, 11.8 M
// elements each, passes 2^31 elements); the rows, the sizes and the
// tables' slots are within int32.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
// dn gathers a thread keeps in flight: GROUP rows times DN_BATCH / GROUP
// entries of each
constexpr int DN_BATCH = 8;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// One element from device memory into shared memory, asynchronously
// (cp.async, 8 or 4 bytes): a thread's copies are all in flight at once.
__device__ __forceinline__ void copy_async(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// GROUP rows a block, staged in shared memory (STAGE) or read where they
// lie; DIAG: y written from the diagonal's product, else added to.  kd:
// the most dn entries a row holds (the dn table's K).
template <typename T, int GROUP, bool DIAG, bool STAGE>
__global__ void __launch_bounds__(THREADS, 2)
spin_hop_kernel(const T* __restrict__ X, T* __restrict__ Y,
                const T* __restrict__ diag, const int* __restrict__ ucols,
                const T* __restrict__ uvals, const int* __restrict__ ucount,
                const int* __restrict__ dcols, const T* __restrict__ dvals,
                const int* __restrict__ dcount, int kd, int szd, int szu,
                int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the staged rows, then the group's dn entries: values, then columns
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* dv = xs + (STAGE ? GROUP * szu : 0);
  int* dc = reinterpret_cast<int*>(dv + GROUP * kd);
  const int r0 = blockIdx.x * GROUP;
  const int live = min(GROUP, rows - r0);
  const long long row0 = static_cast<long long>(r0) * szu;
  int d[GROUP];  // row r0 + g's index in size_down
  d[0] = r0 % szd;
#pragma unroll
  for (int g = 1; g < GROUP; ++g) d[g] = d[g - 1] + 1 == szd ? 0 : d[g - 1] + 1;
  if (STAGE) {
    const int n = live * szu;
    for (int i = threadIdx.x; i < n; i += THREADS)
      copy_async(xs + i, X + row0 + i);
  }
  if (dcount) {
    for (int i = threadIdx.x; i < live * kd; i += THREADS) {
      const int g = i / kd, k = i - g * kd;
      int dg = d[0] + g;
      while (dg >= szd) dg -= szd;
      const long long at = static_cast<long long>(k) * szd + dg;
      dv[i] = __ldg(dvals + at);
      dc[i] = __ldg(dcols + at);
    }
  }
  if (STAGE) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  for (int u = threadIdx.x; u < szu; u += THREADS) {
    T acc[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (g < live) {
        const long long at = row0 + static_cast<long long>(g) * szu + u;
        if (DIAG) {
          const T xv = STAGE ? xs[g * szu + u] : __ldg(X + at);
          acc[g] = mul(__ldg(diag + static_cast<long long>(d[g]) * szu + u),
                       xv);
        } else {
          acc[g] = Y[at];
        }
      }
    }
    if (ucount) {
      const int n = __ldg(ucount + u);
#pragma unroll 2
      for (int k = 0; k < n; ++k) {
        const int c = __ldg(ucols + static_cast<long long>(k) * szu + u);
        const T v = __ldg(uvals + static_cast<long long>(k) * szu + u);
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          if (g < live) {
            const T xv = STAGE ? xs[g * szu + c]
                               : __ldg(X + row0 + static_cast<long long>(g) *
                                                     szu + c);
            acc[g] = add(acc[g], mul(v, xv));
          }
        }
      }
    }
    if (dcount) {
      // DN_BATCH gathers in flight: E entries of each of the GROUP rows,
      // added in each row's own order, the entries from shared memory
      constexpr int E = DN_BATCH / GROUP > 0 ? DN_BATCH / GROUP : 1;
      int n[GROUP];
      int most = 0;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        n[g] = g < live ? __ldg(dcount + d[g]) : 0;
        most = max(most, n[g]);
      }
      for (int k0 = 0; k0 < most; k0 += E) {
        T xv[GROUP][E];
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          // the row's batch member at (c, u): row r0 + g less d, plus c
          const long long base =
              static_cast<long long>(r0 + g - d[g]) * szu + u;
#pragma unroll
          for (int j = 0; j < E; ++j) {
            if (k0 + j < n[g])
              xv[g][j] = __ldg(X + base + static_cast<long long>(
                                              dc[g * kd + k0 + j]) * szu);
          }
        }
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
#pragma unroll
          for (int j = 0; j < E; ++j) {
            if (k0 + j < n[g])
              acc[g] = add(acc[g], mul(dv[g * kd + k0 + j], xv[g][j]));
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (g < live) Y[row0 + static_cast<long long>(g) * szu + u] = acc[g];
    }
  }
}

template <typename T, int GROUP, bool DIAG, bool STAGE>
int launch_form(const void* x, void* y, const void* diag, const void* ucols,
                const void* uvals, const void* ucount, const void* dcols,
                const void* dvals, const void* dcount, int kd, int szd,
                int szu, int rows, cudaStream_t stream) {
  auto kernel = spin_hop_kernel<T, GROUP, DIAG, STAGE>;
  const int smem =
      static_cast<int>(sizeof(T)) * ((STAGE ? GROUP * szu : 0) + GROUP * kd) +
      4 * GROUP * kd;
  // above 48 KB the dynamic shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + GROUP - 1) / GROUP;
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const T*>(diag), static_cast<const int*>(ucols),
      static_cast<const T*>(uvals), static_cast<const int*>(ucount),
      static_cast<const int*>(dcols), static_cast<const T*>(dvals),
      static_cast<const int*>(dcount), kd, szd, szu, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DIAG>
int launch_diag(const void* x, void* y, const void* diag, const void* ucols,
                const void* uvals, const void* ucount, const void* dcols,
                const void* dvals, const void* dcount, int kd, int szd,
                int szu, int rows, int group, int stage, cudaStream_t s) {
#define LPP_FORM(G, STAGED)                                                   \
  launch_form<T, G, DIAG, STAGED>(x, y, diag, ucols, uvals, ucount, dcols,    \
                                  dvals, dcount, kd, szd, szu, rows, s)
  if (!stage) return group == 1 ? LPP_FORM(1, false) : cudaErrorInvalidValue;
  switch (group) {
    case 1: return LPP_FORM(1, true);
    case 2: return LPP_FORM(2, true);
    default: return cudaErrorInvalidValue;
  }
#undef LPP_FORM
}

template <typename T>
int launch(const void* x, void* y, const void* diag, const void* ucols,
           const void* uvals, const void* ucount, const void* dcols,
           const void* dvals, const void* dcount, int kd, int szd, int szu,
           int batch, int group, int stage, void* stream) {
  const long long rows = static_cast<long long>(batch) * szd;
  if (rows > 2147483647LL || kd < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || szu == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(rows);
  if (!dcount) kd = 0;
  return diag ? launch_diag<T, true>(x, y, diag, ucols, uvals, ucount, dcols,
                                     dvals, dcount, kd, szd, szu, n, group,
                                     stage, s)
              : launch_diag<T, false>(x, y, diag, ucols, uvals, ucount,
                                      dcols, dvals, dcount, kd, szd, szu, n,
                                      group, stage, s);
}

}  // namespace

// x, y: contiguous (batch, szd, szu); diag: (szd szu,) or null (y is then
// added to); ucols, uvals: (Ku, szu), ucount: (szu,), or all null (no up
// map); dcols, dvals: (kd, szd), dcount: (szd,), or all null.  group: rows
// a block owns (1 or 2; 1 where the rows are not staged); stage: the
// rows go through shared memory (group szu elements of it, beside the
// group's dn entries).  Returns the launch's cudaError (0 on success).
#define LPP_SPIN_HOP(NAME, T)                                                \
  extern "C" int NAME(const void* x, void* y, const void* diag,              \
                      const void* ucols, const void* uvals,                  \
                      const void* ucount, const void* dcols,                 \
                      const void* dvals, const void* dcount, int kd,         \
                      int szd, int szu, int batch, int group, int stage,     \
                      void* stream) {                                        \
    return launch<T>(x, y, diag, ucols, uvals, ucount, dcols, dvals, dcount, \
                     kd, szd, szu, batch, group, stage, stream);             \
  }

LPP_SPIN_HOP(lpp_spin_hop_f64, double)
LPP_SPIN_HOP(lpp_spin_hop_f32, float)

#undef LPP_SPIN_HOP
