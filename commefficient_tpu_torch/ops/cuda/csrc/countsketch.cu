// CountSketch kernels for Hopper (sm_90a): the CUDA C++ replacements of the
// Pallas TPU kernels in commefficient_tpu/ops/pallas/countsketch_kernels.py.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (commefficient_tpu_torch/ops/cuda/build.py). Every entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// The sketch layout is the reference's banded layout, which is semantics,
// not an optimization (commefficient_tpu/ops/countsketch.py docstring). In
// scrambled space i in [0, d_eff), row `row` with riffle factor f, padded
// length L = f * G, chunk size m, stride s and window V = u * s:
//   riffled index   p    = (i mod G) * f + i div G
//   chunk, offset   q    = p div m,  o = p mod m
//   column          col  = q * s + slot(o),  slot(o) = hash(o) mod V
//   sign            sign = 1 - 2 * (hash'(i) & 1)
// and the inverse map i = (p mod f) * G + p div f.
//
// No kernel here uses float atomics: each output element is owned by one
// thread and summed in a fixed order, so a table is bit-identical from run
// to run (the reference pins bit-exact replay of resumed/rolled-back runs).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hash.cuh"

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
  CS_NP = 20
};

struct CsRows {
  long long v[CS_MAX_ROWS][CS_NP];
};

__device__ __forceinline__ uint32_t cs_slot(const long long* g, int family, uint32_t off) {
  const uint32_t h = family ? cs_poly4(off, g + RP_CSLOT) : cs_mix32(off, (uint32_t)g[RP_KEY_SLOT]);
  return h % (uint32_t)g[RP_V];
}

__device__ __forceinline__ float cs_sign(const long long* g, int family, uint32_t spos) {
  const uint32_t h = family ? cs_poly4(spos, g + RP_CSIGN) : cs_mix32(spos, (uint32_t)g[RP_KEY_SIGN]);
  return (h & 1u) ? -1.0f : 1.0f;
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

// ---------------------------------------------------------------------------
// K1 cs_sketch_rows
//
// Replaces: _sketch_row (commefficient_tpu/ops/pallas/countsketch_kernels.py
// :168, pallas_call at :221; entry sketch_vec_pallas :244). The [r, c_actual]
// f32 table of the scrambled [d_eff] vector, all rows in one launch.
//
// Bound on the H100: bytes. It reads the 4*d_eff-byte vector once per row
// (26 MB at ResNet-9, L2-resident after the first row) and writes
// 4*r*c_actual bytes (10 MB); the adds are ~r*d_eff, far below any peak.
//
// Design: a gather, not a scatter. The TPU kernel contracts a generated
// one-hot on the MXU; a scatter translation would need float atomics, whose
// order changes from run to run. Here one thread owns one (row, column j)
// and gathers every coordinate that hashes to it: chunks q whose window
// [q*s, q*s + V) covers j (at most u of them), slot t = j - q*s, and the
// offsets o with slot(o) = t from a per-row CSR (slot -> offsets, built once
// per spec from the same hash, ~m/V offsets per slot). Sums run in a fixed
// order (q ascending, o ascending) in f32, so tables are bit-identical from
// run to run. Columns past the row's (nc + u - 1) * s are 0.
// ---------------------------------------------------------------------------
__global__ void cs_sketch_rows_kernel(const float* __restrict__ v_s, uint32_t d_eff,
                                      const int* __restrict__ csr_ptr,
                                      const int* __restrict__ csr_off,
                                      float* __restrict__ table, long long c_actual,
                                      const __grid_constant__ CsRows P, int family) {
  const int row = blockIdx.y;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= c_actual) return;
  const long long* g = P.v[row];
  float acc = 0.0f;
  if (j < g[RP_ROWLEN]) {
    const uint32_t f = (uint32_t)g[RP_F], G = (uint32_t)g[RP_G], m = (uint32_t)g[RP_M];
    const long long s = g[RP_S], V = g[RP_V], nc = g[RP_NC];
    long long q_hi = j / s;
    if (q_hi > nc - 1) q_hi = nc - 1;
    const long long lo_num = j - V + 1;
    const long long q_lo = lo_num <= 0 ? 0 : (lo_num + s - 1) / s;
    const int* ptr = csr_ptr + g[RP_PTR];
    const int* offs = csr_off + g[RP_OFF];
    for (long long q = q_lo; q <= q_hi; ++q) {
      const long long t = j - q * s;
      const int e_end = ptr[t + 1];
      for (int e = ptr[t]; e < e_end; ++e) {
        const uint32_t p = (uint32_t)q * m + (uint32_t)offs[e];
        const uint32_t spos = (p % f) * G + p / f;
        if (spos < d_eff) acc += cs_sign(g, family, spos) * __ldg(v_s + spos);
      }
    }
  }
  table[(long long)row * c_actual + j] = acc;
}

// ---------------------------------------------------------------------------
// K2 cs_estimate_median
//
// Replaces: _estimate_row (countsketch_kernels.py:260, pallas_call at :306)
// and median_rows_pallas (:317, pallas_call at :341) as composed by
// estimate_all_pallas (:352). For each scrambled position, the median of its
// r signed bucket values, written to [d_eff]; the [r, d_eff] stack of
// per-row estimates never exists.
//
// Bound on the H100: bytes. It reads the 4*r*c_actual-byte table (10 MB,
// L2-resident) and writes 4*d_eff bytes (26 MB).
//
// Design: a gather with no reduction at all: one thread owns one position
// i and reads exactly one bucket per row (col = (p div m) * s + slot(p mod
// m)), times its sign, then takes the median in registers by the same
// compare-exchange network as the TPU kernel. This is estimate_at(spec,
// table, arange(d)), which the reference pins equal to its matmul path; no
// atomics, and the result is bit-identical to the plain gather version.
// ---------------------------------------------------------------------------
template <int R>
__global__ void cs_estimate_median_kernel(const float* __restrict__ table, long long c_actual,
                                          float* __restrict__ out, uint32_t d_eff,
                                          const __grid_constant__ CsRows P,
                                          int family) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d_eff) return;
  float e[R];
#pragma unroll
  for (int row = 0; row < R; ++row) {
    const long long* g = P.v[row];
    const uint32_t f = (uint32_t)g[RP_F], G = (uint32_t)g[RP_G], m = (uint32_t)g[RP_M];
    const uint32_t p = (i % G) * f + i / G;
    const long long col = (long long)(p / m) * g[RP_S] + cs_slot(g, family, p % m);
    e[row] = __ldg(table + row * c_actual + col) * cs_sign(g, family, i);
  }
  out[i] = cs_median<R>(e);
}

// ---------------------------------------------------------------------------
// K3 cs_median_rows
//
// Replaces: median_rows_pallas (countsketch_kernels.py:317, pallas_call at
// :341) as a standalone kernel: the median over axis 0 of any [R, n] f32
// stack. The FetchSGD main path uses the fused K2 instead; this one serves
// estimate_at and the table statistics.
//
// Bound on the H100: bytes (reads 4*R*n, writes 4*n).
//
// Design: one thread per column, the R values in registers, the same
// compare-exchange network; coalesced loads along n, no atomics.
// ---------------------------------------------------------------------------
template <int R>
__global__ void cs_median_rows_kernel(const float* __restrict__ x, long long n,
                                      float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float e[R];
#pragma unroll
  for (int row = 0; row < R; ++row) e[row] = __ldg(x + row * n + i);
  out[i] = cs_median<R>(e);
}

// Raw 32-bit hashes of x[i] with one row's keys/coefficients (which = 0:
// slot hash before mod V, 1: sign hash before & 1), for holding the device
// hash functions bit-for-bit against the host ones.
__global__ void cs_hash_bits_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                                    long long n, const __grid_constant__ CsRows P,
                                    int which, int family) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long* g = P.v[0];
  const uint32_t v = x[i];
  if (which == 0)
    out[i] = family ? cs_poly4(v, g + RP_CSLOT) : cs_mix32(v, (uint32_t)g[RP_KEY_SLOT]);
  else
    out[i] = family ? cs_poly4(v, g + RP_CSIGN) : cs_mix32(v, (uint32_t)g[RP_KEY_SIGN]);
}

static const int kThreads = 256;

static int cs_load_rows(CsRows* P, const long long* rows, int r) {
  if (r < 1 || r > CS_MAX_ROWS) return (int)cudaErrorInvalidValue;
  memset(P, 0, sizeof(CsRows));
  memcpy(P->v, rows, sizeof(long long) * CS_NP * (size_t)r);
  return 0;
}

extern "C" {

int cs_sketch_rows(const float* v_s, long long d_eff, const int* csr_ptr, const int* csr_off,
                   float* table, long long c_actual, const long long* rows, int r, int family,
                   void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  const dim3 grid((unsigned)((c_actual + kThreads - 1) / kThreads), (unsigned)r);
  cs_sketch_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      v_s, (uint32_t)d_eff, csr_ptr, csr_off, table, c_actual, P, family);
  return (int)cudaGetLastError();
}

int cs_estimate_median(const float* table, long long c_actual, float* out, long long d_eff,
                       const long long* rows, int r, int family, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  const unsigned blocks = (unsigned)((d_eff + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t n = (uint32_t)d_eff;
  switch (r) {
    case 1: cs_estimate_median_kernel<1><<<blocks, kThreads, 0, st>>>(table, c_actual, out, n, P, family); break;
    case 2: cs_estimate_median_kernel<2><<<blocks, kThreads, 0, st>>>(table, c_actual, out, n, P, family); break;
    case 3: cs_estimate_median_kernel<3><<<blocks, kThreads, 0, st>>>(table, c_actual, out, n, P, family); break;
    case 4: cs_estimate_median_kernel<4><<<blocks, kThreads, 0, st>>>(table, c_actual, out, n, P, family); break;
    case 5: cs_estimate_median_kernel<5><<<blocks, kThreads, 0, st>>>(table, c_actual, out, n, P, family); break;
    case 6: cs_estimate_median_kernel<6><<<blocks, kThreads, 0, st>>>(table, c_actual, out, n, P, family); break;
    case 7: cs_estimate_median_kernel<7><<<blocks, kThreads, 0, st>>>(table, c_actual, out, n, P, family); break;
    case 8: cs_estimate_median_kernel<8><<<blocks, kThreads, 0, st>>>(table, c_actual, out, n, P, family); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int cs_median_rows(const float* x, long long n, int r, float* out, void* stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 1: cs_median_rows_kernel<1><<<blocks, kThreads, 0, st>>>(x, n, out); break;
    case 2: cs_median_rows_kernel<2><<<blocks, kThreads, 0, st>>>(x, n, out); break;
    case 3: cs_median_rows_kernel<3><<<blocks, kThreads, 0, st>>>(x, n, out); break;
    case 4: cs_median_rows_kernel<4><<<blocks, kThreads, 0, st>>>(x, n, out); break;
    case 5: cs_median_rows_kernel<5><<<blocks, kThreads, 0, st>>>(x, n, out); break;
    case 6: cs_median_rows_kernel<6><<<blocks, kThreads, 0, st>>>(x, n, out); break;
    case 7: cs_median_rows_kernel<7><<<blocks, kThreads, 0, st>>>(x, n, out); break;
    case 8: cs_median_rows_kernel<8><<<blocks, kThreads, 0, st>>>(x, n, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int cs_hash_bits(const uint32_t* x, uint32_t* out, long long n, const long long* row, int which,
                 int family, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, row, 1);
  if (rc) return rc;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cs_hash_bits_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, out, n, P, which, family);
  return (int)cudaGetLastError();
}

}  // extern "C"
