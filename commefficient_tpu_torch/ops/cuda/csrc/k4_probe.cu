// Attribution variants of the arbitrary-index K4 kernel as it stood before
// the redesign (one thread per index, 64-bit row constants, hardware
// divisions), for ops/cuda/k4_attribution.py. Not part of the kernels'
// library and not on any training path. MODE bits:
//   1  read a fixed column of each row instead of the computed one (the
//      column is still computed and kept live), so the table's sector
//      traffic drops out;
//   2  the divisions by G, m, V and sblock by the host's multipliers
//      (cs_udiv) in 32-bit arithmetic, as the redesigned K4 does;
//   4  streaming hints on the index reads and output writes.
// Row constants use the same layout as countsketch.cu.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hash.cuh"

#define PR_NP 36
enum {
  PR_KEY_SLOT = 0, PR_KEY_SIGN = 1, PR_CSLOT = 2, PR_CSIGN = 6, PR_F = 10, PR_G = 11, PR_M = 12,
  PR_S = 13, PR_V = 14, PR_SBLOCK = 19, PR_DIV_G = 20, PR_DIV_M = 24, PR_DIV_V = 26,
  PR_DIV_SBLOCK = 34
};

struct ProbeRows {
  long long v[5][PR_NP];
};

__device__ __forceinline__ uint32_t pr_udiv(uint32_t n, const long long* g, int which) {
  const uint32_t sh = (uint32_t)g[which + 1];
  if (sh == 64) return (uint32_t)__umul64hi((unsigned long long)n, (unsigned long long)g[which]);
  return (uint32_t)(((unsigned long long)n * (uint32_t)g[which]) >> sh);
}

__device__ __forceinline__ float pr_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float pr_max(float a, float b) { return (a > b || a != a) ? a : b; }

template <int MODE>
__global__ void k4_probe_kernel(const float* __restrict__ table, long long c_actual,
                                const long long* __restrict__ idx, long long n,
                                const int* __restrict__ inv_perm, uint32_t sblock,
                                float* __restrict__ out, const __grid_constant__ ProbeRows P) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const unsigned long long x =
      (MODE & 4) ? (unsigned long long)__ldcs(idx + t) : (unsigned long long)__ldg(idx + t);
  const uint32_t xi = (uint32_t)x;
  uint32_t i;
  if constexpr (MODE & 2) {
    const uint32_t blk = pr_udiv(xi, P.v[0], PR_DIV_SBLOCK);
    i = (uint32_t)__ldg(inv_perm + blk) * sblock + (xi - blk * sblock);
  } else {
    i = (uint32_t)__ldg(inv_perm + xi / sblock) * sblock + xi % sblock;
  }
  float e[5];
#pragma unroll
  for (int row = 0; row < 5; ++row) {
    const long long* g = P.v[row];
    const uint32_t f = (uint32_t)g[PR_F], G = (uint32_t)g[PR_G], m = (uint32_t)g[PR_M];
    long long col;
    if constexpr (MODE & 2) {
      const uint32_t hi = pr_udiv(i, g, PR_DIV_G);
      const uint32_t p = (i - hi * G) * f + hi;
      const uint32_t q = pr_udiv(p, g, PR_DIV_M);
      const uint32_t h = cs_mix32(p - q * m, (uint32_t)g[PR_KEY_SLOT]);
      col = q * (uint32_t)g[PR_S] + (h - pr_udiv(h, g, PR_DIV_V) * (uint32_t)g[PR_V]);
    } else {
      const uint32_t p = (i % G) * f + i / G;
      const uint32_t h = cs_mix32(p % m, (uint32_t)g[PR_KEY_SLOT]);
      col = (long long)(p / m) * g[PR_S] + h % (uint32_t)g[PR_V];
    }
    if constexpr (MODE & 1) col = col > 4 * c_actual ? col : 0;  // keeps col live
    const float sign = (cs_mix32(i, (uint32_t)g[PR_KEY_SIGN]) & 1u) ? -1.0f : 1.0f;
    e[row] = __ldg(table + row * c_actual + col) * sign;
  }
#pragma unroll
  for (int a = 0; a < 5; ++a) {
#pragma unroll
    for (int b = a + 1; b < 5; ++b) {
      const float lo = pr_min(e[a], e[b]);
      const float hi = pr_max(e[a], e[b]);
      e[a] = lo;
      e[b] = hi;
    }
  }
  if (MODE & 4)
    __stcs(out + t, e[2]);
  else
    out[t] = e[2];
}

extern "C" int k4_probe(int mode, const float* table, long long c_actual, const long long* idx,
                        long long n, const int* inv_perm, long long sblock, float* out,
                        const long long* rows, void* stream) {
  ProbeRows P;
  memcpy(P.v, rows, sizeof(P.v));
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t b = (uint32_t)sblock;
  switch (mode) {
    case 0: k4_probe_kernel<0><<<blocks, 256, 0, st>>>(table, c_actual, idx, n, inv_perm, b, out, P); break;
    case 1: k4_probe_kernel<1><<<blocks, 256, 0, st>>>(table, c_actual, idx, n, inv_perm, b, out, P); break;
    case 2: k4_probe_kernel<2><<<blocks, 256, 0, st>>>(table, c_actual, idx, n, inv_perm, b, out, P); break;
    case 3: k4_probe_kernel<3><<<blocks, 256, 0, st>>>(table, c_actual, idx, n, inv_perm, b, out, P); break;
    case 6: k4_probe_kernel<6><<<blocks, 256, 0, st>>>(table, c_actual, idx, n, inv_perm, b, out, P); break;
    case 7: k4_probe_kernel<7><<<blocks, 256, 0, st>>>(table, c_actual, idx, n, inv_perm, b, out, P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
