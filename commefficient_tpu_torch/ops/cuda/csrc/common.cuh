// What the CountSketch kernels (countsketch.cu) and their attribution probes
// share: the per-row constants, division by multiplier, the median network,
// and the persistent grid of a kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <type_traits>

#define CS_MAX_ROWS 8

// Per-row constants, one row of CS_NP int64 each (filled by
// CountSketch.kernel_row_params on the host, same order).
enum {
  RP_KEY_SLOT = 0,   // fmix32 key of the slot hash
  RP_KEY_SIGN = 1,   // fmix32 key of the sign hash
  RP_CSLOT = 2,      // 4 poly4 coefficients of the slot hash
  RP_CSIGN = 6,      // 4 poly4 coefficients of the sign hash
  RP_F = 10,         // riffle factor f
  RP_G = 11,         // G = L / f
  RP_M = 12,         // chunk size m
  RP_S = 13,         // stride s
  RP_V = 14,         // window V = u * s
  RP_NC = 15,        // chunks nc = L / m
  RP_ROWLEN = 16,    // realized row length (nc + u - 1) * s
  RP_PTR = 17,       // this row's base in the CSR slot pointers
  RP_OFF = 18,       // this row's base in the CSR offsets
  RP_SBLOCK = 19,    // scramble block (0: no scramble), the same in every row
  // (multiplier, shift) of each divisor, CountSketch.DIVISORS order
  RP_DIV_G = 20,
  RP_DIV_F = 22,
  RP_DIV_M = 24,
  RP_DIV_V = 26,
  RP_DIV_S = 28,
  RP_DIV_MQ1 = 30,   // m div f + 1
  RP_DIV_MQ = 32,    // max(m div f, 1)
  RP_DIV_SBLOCK = 34,
  CS_NP = 36
};

struct CsRows {
  long long v[CS_MAX_ROWS][CS_NP];
};

// Shared-memory windows of K2 and K4's range form: rows with wlen 0 read
// the table in place. Windows hold the table's stored type.
struct CsWindows {
  int woff[CS_MAX_ROWS];  // the row's window offset in shared memory, entries
  int wlen[CS_MAX_ROWS];  // its length, entries
};

static inline int cs_load_rows(CsRows* P, const long long* rows, int r) {
  if (r < 1 || r > CS_MAX_ROWS) return (int)cudaErrorInvalidValue;
  memset(P, 0, sizeof(CsRows));
  memcpy(P->v, rows, sizeof(long long) * CS_NP * (size_t)r);
  return 0;
}

// n div d for the divisor whose (multiplier, shift) pair starts at g[which]:
// (n * mul) >> shift with a 32-bit mul, or the high word of n * mul with a
// 64-bit mul when shift is 64 (index_math.fast_divisor, which also proves
// exactness up to the divisor's largest dividend).
__device__ __forceinline__ uint32_t cs_udiv(uint32_t n, const long long* g, int which) {
  const uint32_t sh = (uint32_t)g[which + 1];
  if (sh == 64) return (uint32_t)__umul64hi((unsigned long long)n, (unsigned long long)g[which]);
  return (uint32_t)(((unsigned long long)n * (uint32_t)g[which]) >> sh);
}

// n div d for a divisor d that is 2^shift (shift >= 0), else by d's
// multiplier pair at g[which].
__device__ __forceinline__ uint32_t cs_div_pow2_or(uint32_t n, int shift, const long long* g,
                                                   int which) {
  return shift >= 0 ? n >> shift : cs_udiv(n, g, which);
}

// min/max that propagate NaN like torch.minimum / jnp.minimum (fminf would
// hide a diverged estimate).
__device__ __forceinline__ float cs_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float cs_max(float a, float b) { return (a > b || a != a) ? a : b; }

// Median of R values by the all-pairs compare-exchange network of
// median_rows_pallas (countsketch_kernels.py:329-339): exact middle element
// for odd R, 0.5 * (a + b) of the middle two for even R.
template <int R>
__device__ __forceinline__ float cs_median(float* e) {
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = a + 1; b < R; ++b) {
      const float lo = cs_min(e[a], e[b]);
      const float hi = cs_max(e[a], e[b]);
      e[a] = lo;
      e[b] = hi;
    }
  }
  if constexpr (R % 2) {
    return e[R / 2];
  } else {
    return 0.5f * (e[R / 2 - 1] + e[R / 2]);
  }
}

__host__ __device__ __forceinline__ uint32_t cs_align16(uint32_t bytes) { return (bytes + 15u) & ~15u; }

// Table entries of either storage type (f32 or bf16): a read-only load in
// the stored type, its value widened to f32 (exact), the stored type's zero,
// and an f32 value rounded to bf16 (to nearest, ties to even) and widened
// back.
__device__ __forceinline__ float cs_ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 cs_ldg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ float cs_f32(float v) { return v; }
__device__ __forceinline__ float cs_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T cs_zero() {
  if constexpr (std::is_same<T, float>::value) {
    return 0.0f;
  } else {
    return __ushort_as_bfloat16((unsigned short)0);
  }
}
__device__ __forceinline__ float cs_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The stored type of K2's table kind TK (0: f32, 1: f32 read rounded to
// bf16, 2: bf16).
template <int TK>
using CsTable = typename std::conditional<TK == 2, __nv_bfloat16, float>::type;

// The persistent grid of kernel fn at `threads` threads and `smem` bytes of
// dynamic shared memory on the current device: as many blocks as fit the
// card at once. The occupancy is asked once per (kernel, device, threads,
// smem) and kept, and the kernel's dynamic shared-memory limit is only ever
// raised (to the largest smem asked so far), so a launch after the first
// only reads the cache.
template <typename Kernel>
static cudaError_t cs_persistent_grid(Kernel* fn, int threads, int smem, long long* grid) {
  struct Entry {
    const void* fn;
    int dev, threads, smem;  // threads < 0: the kernel's smem limit on dev
    long long grid;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int n = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  Entry* limit = nullptr;
  for (int k = 0; k < n; ++k) {
    Entry& c = cache[k];
    if (c.fn != (const void*)fn || c.dev != dev) continue;
    if (c.threads == threads && c.smem == smem) {
      *grid = c.grid;
      return cudaSuccess;
    }
    if (c.threads < 0) limit = &c;
  }
  if (limit == nullptr || limit->smem < smem) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (limit != nullptr) {
      limit->smem = smem;
    } else if (n < 64) {
      cache[n++] = Entry{(const void*)fn, dev, -1, smem, 0};
    }
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (e != cudaSuccess) return e;
  *grid = (long long)(per_sm > 1 ? per_sm : 1) * sms;
  if (n < 64) cache[n++] = Entry{(const void*)fn, dev, threads, smem, *grid};
  return cudaSuccess;
}
