// CountSketch kernels for Hopper (sm_90a): the CUDA C++ replacements of the
// Pallas TPU kernels in commefficient_tpu/ops/pallas/countsketch_kernels.py
// and commefficient_tpu/ops/pallas/decode_kernels.py.
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
//
// Runtime divisions in the redesigned kernels (K1's tiles, K4) go through
// cs_udiv: a multiplier and shift per divisor, computed on the host by
// index_math.fast_divisor and exact for every dividend the kernel admits.

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

__device__ __forceinline__ uint32_t cs_slot(const long long* g, int family, uint32_t off) {
  const uint32_t h = family ? cs_poly4(off, g + RP_CSLOT) : cs_mix32(off, (uint32_t)g[RP_KEY_SLOT]);
  return h % (uint32_t)g[RP_V];
}

__device__ __forceinline__ uint32_t cs_sign_hash(const long long* g, int family, uint32_t spos) {
  return family ? cs_poly4(spos, g + RP_CSIGN) : cs_mix32(spos, (uint32_t)g[RP_KEY_SIGN]);
}

__device__ __forceinline__ float cs_sign(const long long* g, int family, uint32_t spos) {
  return (cs_sign_hash(g, family, spos) & 1u) ? -1.0f : 1.0f;
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

// The column of scrambled position i in row g, in 32-bit arithmetic
// (col < c_actual < 2^32) with the divisions by G, m and V by multiplier.
__device__ __forceinline__ uint32_t cs_col(const long long* g, int family, uint32_t i) {
  const uint32_t f = (uint32_t)g[RP_F], G = (uint32_t)g[RP_G], m = (uint32_t)g[RP_M];
  const uint32_t hi = cs_udiv(i, g, RP_DIV_G);
  const uint32_t p = (i - hi * G) * f + hi;
  const uint32_t q = cs_udiv(p, g, RP_DIV_M);
  const uint32_t o = p - q * m;
  const uint32_t h = family ? cs_poly4(o, g + RP_CSLOT) : cs_mix32(o, (uint32_t)g[RP_KEY_SLOT]);
  return q * (uint32_t)g[RP_S] + (h - cs_udiv(h, g, RP_DIV_V) * (uint32_t)g[RP_V]);
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
// order changes from run to run. Each column j of a row is summed by one
// thread, over the chunks q whose window [q*s, q*s + V) covers j (q
// ascending) and, within a chunk, over the offsets o with slot(o) = j - q*s
// (ascending, from a per-row CSR slot -> offsets built once per spec). Sums
// run in f32 in that fixed order, so tables are bit-identical from run to
// run. Columns past the row's (nc + u - 1) * s are 0.
//
// cs_sketch_tiles_kernel (the main path): a block owns a tile of W strides
// (W*s consecutive columns) of one row and walks the W + u - 1 chunks that
// reach it in ascending q. Each chunk's values are staged in shared memory
// in the row's CSR order (slot-major, offsets ascending), signed, so a
// column's contributions from one chunk are one contiguous run
// [ptr[t], ptr[t+1]) of the stage, and the slots that land in the tile are
// one contiguous range of it: only that range is loaded, so v is read once
// per row in all (not (W + u - 1) / W times). The chunk's riffled positions
// p = q*m + o are a strip of v_s seen as an [f, G] matrix
// (i = (p mod f) * G + p div f); thread slot k of the staging walk takes
// them residue by residue (the first mr = m mod f residues, rotated to
// start at the chunk's own first residue, hold m div f + 1 positions, the
// rest m div f), so neighbouring threads read neighbouring i. Each thread
// works out its slots' (residue, step, CSR position) once per block; per
// chunk it loads the next chunk's values into registers while the block
// sums this one, hashes their signs, and stores them signed after the
// summation's barrier. Positions >= d_eff stage as +0. The CSR pointers
// (uint16) stay in shared memory for the whole block. Each thread owns
// groups of 4 consecutive columns (stride, window and table widths are
// multiples of 8, so a group is wholly inside a chunk's window or wholly
// outside) and keeps their sums in shared memory. Adding a staged +0
// leaves a sum unchanged (a sum that starts at +0 never becomes -0), so
// the table equals the gather kernel's bit for bit.
//
// What bounds it on the card: not bytes. The 5 rows' tiles at ResNet-9
// (255 blocks) are one wave of two blocks per SM (64 registers a thread),
// so one block's walk of 47 chunk steps, each a load, a barrier, a
// summation and a barrier, is the kernel's time
// (ops/cuda/k1_attribution.py times one row's tiles alone beside all five
// rows, and the tile widths).
//
// cs_sketch_gather_kernel: one thread per column, reading v_s in place.
// Kept for geometries whose tile does not fit (m above 8192, or shared
// memory); the host picks (index_math.sketch_tile_strides).
// ---------------------------------------------------------------------------
static const int kThreadsK1 = 512;

// Shared memory of a tile block: the CSR pointers (V+1 uint16, padded to
// 8 bytes), the stage (m f32; the inverse CSR order, m uint16, lives there
// while the block sets up) and the tile's f32 sums
// (index_math.sketch_smem_bytes is the same).
__host__ __device__ __forceinline__ uint32_t cs_tile_smem(uint32_t m, uint32_t V, uint32_t cols) {
  return cs_align16(2 * (V + 4)) + cs_align16(4 * m) + cs_align16(4 * cols);
}

// Load one chunk's values for this thread's E staging slots into v, with
// their sign bits in neg (bit x: slot x is negative); only slots whose CSR
// position lies in [e_lo, e_hi), the entries that reach the tile.
template <int E>
__device__ __forceinline__ void cs_load_chunk(const float* __restrict__ v_s, uint32_t d_eff,
                                              const long long* g, int family, uint32_t q,
                                              const uint32_t* rj, const uint32_t* pos,
                                              uint32_t e_lo, uint32_t e_hi, float* v,
                                              uint32_t& neg) {
  const uint32_t f = (uint32_t)g[RP_F], G = (uint32_t)g[RP_G], m = (uint32_t)g[RP_M];
  const uint32_t P0 = q * m;
  const uint32_t c0 = cs_udiv(P0, g, RP_DIV_F);
  const uint32_t a0 = P0 - c0 * f;
  neg = 0;
#pragma unroll
  for (int x = 0; x < E; ++x) {
    v[x] = 0.0f;
    if (pos[x] >= e_lo && pos[x] < e_hi) {
      uint32_t a = a0 + (rj[x] & 0xffffu), cw = c0;
      if (a >= f) {
        a -= f;
        cw += 1;
      }
      const uint32_t i = a * G + cw + (rj[x] >> 16);
      if (i < d_eff) {
        v[x] = __ldg(v_s + i);
        neg |= (cs_sign_hash(g, family, i) & 1u) << x;
      }
    }
  }
}

template <int E>
__global__ void __launch_bounds__(kThreadsK1, E <= 8 ? 2 : 1)
    cs_sketch_tiles_kernel(const float* __restrict__ v_s, uint32_t d_eff,
                           const int* __restrict__ csr_ptr, const int* __restrict__ csr_off,
                           float* __restrict__ table, uint32_t c_actual,
                           const __grid_constant__ CsRows P, int family, uint32_t W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.y;
  const long long* g = P.v[row];
  const uint32_t s = (uint32_t)g[RP_S], V = (uint32_t)g[RP_V], nc = (uint32_t)g[RP_NC];
  const uint32_t m = (uint32_t)g[RP_M], f = (uint32_t)g[RP_F];
  const uint32_t j0 = blockIdx.x * W * s;
  if (j0 >= c_actual) return;
  const uint32_t ncols = min(W * s, c_actual - j0);  // a multiple of 8
  float* out = table + (size_t)row * c_actual + j0;
  uint16_t* ptr_s = reinterpret_cast<uint16_t*>(smem);
  float* stage = reinterpret_cast<float*>(smem + cs_align16(2 * (V + 4)));
  float4* acc = reinterpret_cast<float4*>(smem + cs_align16(2 * (V + 4)) + cs_align16(4 * m));
  const uint32_t ngroups = ncols / 4;
  // thread tid owns the column groups c4 = tid (mod kThreadsK1)
  for (uint32_t c4 = threadIdx.x; c4 < ngroups; c4 += kThreadsK1)
    acc[c4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const uint32_t q_hi = min(nc - 1, cs_udiv(j0 + ncols - 1, g, RP_DIV_S));
  const uint32_t q_lo = j0 + 1 <= V ? 0 : cs_udiv(j0 + s - V, g, RP_DIV_S);
  if (q_lo <= q_hi) {
    // set-up: the CSR pointers, and the CSR position of every offset
    uint16_t* pos_s = reinterpret_cast<uint16_t*>(stage);
    const int* ptr_g = csr_ptr + g[RP_PTR];
    const int* off_g = csr_off + g[RP_OFF];
    for (uint32_t t = threadIdx.x; t <= V; t += kThreadsK1) ptr_s[t] = (uint16_t)__ldg(ptr_g + t);
    for (uint32_t e = threadIdx.x; e < m; e += kThreadsK1) pos_s[__ldg(off_g + e)] = (uint16_t)e;
    __syncthreads();
    const uint32_t mq = m / f, mr = m - mq * f, nbig = mr * (mq + 1);
    uint32_t rj[E];   // residue | step << 16 of each staging slot
    uint32_t pos[E];  // its position in the CSR-ordered stage (m: none)
#pragma unroll
    for (int x = 0; x < E; ++x) {
      const uint32_t k = threadIdx.x + x * kThreadsK1;
      uint32_t r = 0, j = 0;
      if (k < nbig) {
        r = cs_udiv(k, g, RP_DIV_MQ1);
        j = k - r * (mq + 1);
      } else if (k < m) {
        const uint32_t t = cs_udiv(k - nbig, g, RP_DIV_MQ);
        r = mr + t;
        j = k - nbig - t * mq;
      }
      rj[x] = r | (j << 16);
      pos[x] = k < m ? pos_s[r + j * f] : m;
    }
    // the stage range [e_lo, e_hi) of chunk q's slots inside the tile
    auto range = [&](uint32_t q, uint32_t& e_lo, uint32_t& e_hi) {
      const uint32_t w0 = q * s;
      e_lo = ptr_s[w0 < j0 ? j0 - w0 : 0];
      e_hi = ptr_s[min(V, j0 + ncols - w0)];
    };
    uint32_t e_lo, e_hi;
    range(q_lo, e_lo, e_hi);
    __syncthreads();  // the stage overwrites pos_s from here on
    float v[E];
    uint32_t neg;
    cs_load_chunk<E>(v_s, d_eff, g, family, q_lo, rj, pos, e_lo, e_hi, v, neg);
    for (uint32_t q = q_lo; q <= q_hi; ++q) {
#pragma unroll
      for (int x = 0; x < E; ++x)
        if (pos[x] >= e_lo && pos[x] < e_hi) stage[pos[x]] = ((neg >> x) & 1u) ? -v[x] : v[x];
      __syncthreads();  // chunk q staged
      const uint32_t w0 = q * s;  // the chunk's window [w0, w0 + V) meets the tile
      const uint32_t g_lo = (w0 > j0 ? w0 - j0 : 0) / 4;
      const uint32_t g_hi = min(ncols, w0 + V - j0) / 4;
      if (q < q_hi) {
        range(q + 1, e_lo, e_hi);
        cs_load_chunk<E>(v_s, d_eff, g, family, q + 1, rj, pos, e_lo, e_hi, v, neg);
      }
      for (uint32_t c4 = g_lo + ((threadIdx.x - g_lo) & (kThreadsK1 - 1)); c4 < g_hi;
           c4 += kThreadsK1) {
        const uint32_t t = j0 + 4 * c4 - w0;  // a multiple of 4
        const uint2 pp = *reinterpret_cast<const uint2*>(ptr_s + t);
        const uint32_t p1 = pp.x >> 16, p2 = pp.y & 0xffffu, p3 = pp.y >> 16;
        const uint32_t p4 = ptr_s[t + 4];
        float4 a = acc[c4];
        uint32_t e = pp.x & 0xffffu;
        for (; e < p1; ++e) a.x += stage[e];
        for (; e < p2; ++e) a.y += stage[e];
        for (; e < p3; ++e) a.z += stage[e];
        for (; e < p4; ++e) a.w += stage[e];
        acc[c4] = a;
      }
      __syncthreads();  // the stage is free for chunk q + 1
    }
  }
  for (uint32_t c4 = threadIdx.x; c4 < ngroups; c4 += kThreadsK1)
    reinterpret_cast<float4*>(out)[c4] = acc[c4];
}

__global__ void cs_sketch_gather_kernel(const float* __restrict__ v_s, uint32_t d_eff,
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
// K4 cs_estimate_at
//
// Replaces: estimate_at_pallas (commefficient_tpu/ops/pallas/decode_kernels.py
// :132), both of its branches: the single-block kernel (pallas_call at :164)
// and the blockwise one (pallas_call at :227). The median-of-rows point
// estimate at ORIGINAL coordinates: the sharded decode's slice estimate and
// the momentum dampening's estimate at the update's support. The TPU's VMEM
// budget (one resident block, or column blocks streamed through VMEM with an
// [r, TS] scratch carried across the grid) has no counterpart here: the
// table is read from global memory (L2-resident at 10 MB) or, in the range
// form, from windows staged in shared memory, so one kernel serves both
// branches, with no atomics and nothing shared between blocks. Each value
// is one signed table entry and the median is K2's network, so both forms
// are bit-identical to the plain gather version and to K2.
//
// Bound on the H100: bytes (the table, the inverse block permutation, the
// output, and the indices in the arbitrary form). What sets the time in
// practice (ops/cuda/k4_attribution.py): the scattered table reads, one
// 32-byte L2 sector per row and coordinate where a row is not staged, and
// instruction issue, ~400 instructions per coordinate for the riffle, two
// hashes per row and the median network.
//
// cs_estimate_at_kernel, the arbitrary-index form, for the dampening's
// <= k support: one thread per index, streamed (__ldcs / __stcs, evicted
// first so the table stays in L2); the scramble lookup in the kernel
// (spos = inv_perm[x div sblock] * sblock + x mod sblock), then per row
// the column and sign and one table read, and the median in registers. An
// index outside [0, d) writes NaN and sets *err, which the wrapper turns
// into an error.
//
// cs_estimate_range_kernel, the range form, for the slice
// min(start + arange(n), d - 1): no index array. A block takes a run of the
// slice's scramble blocks sorted by scrambled position (built on the host),
// so its coordinates are near each other in scrambled space, and in each
// row with a small riffle factor they meet one narrow table window, which
// the block first copies into shared memory with coalesced loads (the host
// picks the rows whose windows fit; the others read the table in place,
// where the scrambled order still makes L1 hits of many reads). Outputs go
// out in runs of sblock floats (out[x - start]); the clipped tail past
// d - 1 repeats d - 1's estimate.
// ---------------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(256)
    cs_estimate_at_kernel(const float* __restrict__ table, uint32_t c_actual,
                          const long long* __restrict__ idx, long long n, unsigned long long d,
                          const int* __restrict__ inv_perm, float* __restrict__ out,
                          int* __restrict__ err, const __grid_constant__ CsRows P, int family) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const unsigned long long x = (unsigned long long)__ldcs(idx + t);
  if (x >= d) {
    *err = 1;
    __stcs(out + t, __int_as_float(0x7fc00000));
    return;
  }
  const uint32_t xi = (uint32_t)x;
  uint32_t i = xi;
  if (inv_perm) {
    const long long* g0 = P.v[0];
    const uint32_t b = (uint32_t)g0[RP_SBLOCK];
    const uint32_t blk = cs_udiv(xi, g0, RP_DIV_SBLOCK);
    i = (uint32_t)__ldg(inv_perm + blk) * b + (xi - blk * b);
  }
  float e[R];
#pragma unroll
  for (int row = 0; row < R; ++row) {
    const long long* g = P.v[row];
    e[row] = __ldg(table + (size_t)row * c_actual + cs_col(g, family, i)) * cs_sign(g, family, i);
  }
  __stcs(out + t, cs_median<R>(e));
}

// Shared-memory windows of the range form: rows with wlen 0 read the table
// in place.
struct CsWindows {
  int woff[CS_MAX_ROWS];  // the row's window offset in shared memory, floats
  int wlen[CS_MAX_ROWS];  // its length, floats
};

static const int kThreadsK4r = 1024;

template <int R>
__global__ void __launch_bounds__(kThreadsK4r)
    cs_estimate_range_kernel(const float* __restrict__ table, uint32_t c_actual, long long start,
                             long long n, uint32_t d, uint32_t xa, uint32_t xb, uint32_t b,
                             const int* __restrict__ inv_perm, const int* __restrict__ blocks,
                             int nlist, int per_block, const int* __restrict__ wstart,
                             const CsWindows W, float* __restrict__ out,
                             const __grid_constant__ CsRows P, int family) {
  extern __shared__ __align__(16) float win[];
  uint32_t w0[R];
#pragma unroll
  for (int row = 0; row < R; ++row) {
    w0[row] = (uint32_t)__ldg(wstart + (size_t)blockIdx.x * R + row);
    if (W.wlen[row]) {
      const float* trow = table + (size_t)row * c_actual;
      for (int c = threadIdx.x; c < W.wlen[row]; c += kThreadsK4r)
        win[W.woff[row] + c] = w0[row] + c < c_actual ? __ldg(trow + w0[row] + c) : 0.0f;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e_end = min(nlist, (int)blockIdx.x * per_block + per_block);
  for (int k = blockIdx.x * per_block + warp; k < e_end; k += kThreadsK4r / 32) {
    const uint32_t B = (uint32_t)__ldg(blocks + k);
    const uint32_t bs = inv_perm ? (uint32_t)__ldg(inv_perm + B) : B;
    for (uint32_t w = lane; w < b; w += 32) {
      const uint32_t x = B * b + w;
      if (x < xa || x > xb) continue;
      const uint32_t i = bs * b + w;
      float e[R];
#pragma unroll
      for (int row = 0; row < R; ++row) {
        const long long* g = P.v[row];
        const uint32_t col = cs_col(g, family, i);
        const float v = W.wlen[row] ? win[W.woff[row] + (col - w0[row])]
                                    : __ldg(table + (size_t)row * c_actual + col);
        e[row] = v * cs_sign(g, family, i);
      }
      const float med = cs_median<R>(e);
      if (x == d - 1) {
        for (long long t = x >= start ? x - start : 0; t < n; ++t) __stcs(out + t, med);
      } else {
        __stcs(out + (x - start), med);
      }
    }
  }
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

// tile_strides W > 0 selects the tile kernel (W strides per block), 0 the
// gather kernel.
int cs_sketch_rows(const float* v_s, long long d_eff, const int* csr_ptr, const int* csr_off,
                   float* table, long long c_actual, const long long* rows, int r, int family,
                   int tile_strides, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (tile_strides <= 0) {
    const dim3 grid((unsigned)((c_actual + kThreads - 1) / kThreads), (unsigned)r);
    cs_sketch_gather_kernel<<<grid, kThreads, 0, st>>>(v_s, (uint32_t)d_eff, csr_ptr, csr_off,
                                                       table, c_actual, P, family);
    return (int)cudaGetLastError();
  }
  const uint32_t W = (uint32_t)tile_strides;
  uint32_t smem = 0, m_max = 0;
  long long tiles = 0;
  for (int row = 0; row < r; ++row) {
    const long long* g = P.v[row];
    const uint32_t cols = W * (uint32_t)g[RP_S];
    const uint32_t need = cs_tile_smem((uint32_t)g[RP_M], (uint32_t)g[RP_V], cols);
    if (need > smem) smem = need;
    if ((uint32_t)g[RP_M] > m_max) m_max = (uint32_t)g[RP_M];
    const long long t = (c_actual + cols - 1) / cols;
    if (t > tiles) tiles = t;
  }
  const dim3 grid((unsigned)tiles, (unsigned)r);
  cudaError_t e = cudaSuccess;
#define CS_K1(E)                                                                              \
  e = cudaFuncSetAttribute(cs_sketch_tiles_kernel<E>,                                         \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);           \
  if (e != cudaSuccess) return (int)e;                                                        \
  cs_sketch_tiles_kernel<E><<<grid, kThreadsK1, smem, st>>>(                                  \
      v_s, (uint32_t)d_eff, csr_ptr, csr_off, table, (uint32_t)c_actual, P, family, W)
  const uint32_t per = (m_max + kThreadsK1 - 1) / kThreadsK1;
  if (per <= 1) { CS_K1(1); }
  else if (per <= 2) { CS_K1(2); }
  else if (per <= 4) { CS_K1(4); }
  else if (per <= 8) { CS_K1(8); }
  else if (per <= 16) { CS_K1(16); }
  else return (int)cudaErrorInvalidValue;
#undef CS_K1
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

int cs_estimate_at(const float* table, long long c_actual, const long long* idx, long long n,
                   long long d, const int* inv_perm, float* out, int* err,
                   const long long* rows, int r, int family, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned long long dd = (unsigned long long)d;
  const uint32_t c = (uint32_t)c_actual;
#define CS_K4(R)                                                                          \
  cs_estimate_at_kernel<R><<<blocks, kThreads, 0, st>>>(table, c, idx, n, dd, inv_perm, out, \
                                                        err, P, family)
  switch (r) {
    case 1: CS_K4(1); break;
    case 2: CS_K4(2); break;
    case 3: CS_K4(3); break;
    case 4: CS_K4(4); break;
    case 5: CS_K4(5); break;
    case 6: CS_K4(6); break;
    case 7: CS_K4(7); break;
    case 8: CS_K4(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CS_K4
  return (int)cudaGetLastError();
}

// The range form over the host-built block list (nlist original scramble
// blocks of b positions, per_block of them per CUDA block) and per-block
// window starts wstart [nblk, r]; woff/wlen [r] place the staged windows.
int cs_estimate_range(const float* table, long long c_actual, long long start, long long n,
                      long long d, long long xa, long long xb, long long b, const int* inv_perm,
                      const int* blocks, int nlist, int per_block, const int* wstart,
                      const int* woff, const int* wlen, float* out, const long long* rows,
                      int r, int family, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  if (n <= 0 || nlist <= 0) return 0;
  CsWindows W;
  memset(&W, 0, sizeof(W));
  int smem = 0;
  for (int row = 0; row < r; ++row) {
    W.woff[row] = woff[row];
    W.wlen[row] = wlen[row];
    if (woff[row] + wlen[row] > smem) smem = woff[row] + wlen[row];
  }
  smem *= (int)sizeof(float);
  const unsigned grid = (unsigned)((nlist + per_block - 1) / per_block);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define CS_K4R(R)                                                                             \
  e = cudaFuncSetAttribute(cs_estimate_range_kernel<R>,                                       \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                \
  if (e != cudaSuccess) return (int)e;                                                        \
  cs_estimate_range_kernel<R><<<grid, kThreadsK4r, smem, st>>>(                               \
      table, (uint32_t)c_actual, start, n, (uint32_t)d, (uint32_t)xa, (uint32_t)xb,           \
      (uint32_t)b, inv_perm, blocks, nlist, per_block, wstart, W, out, P, family)
  switch (r) {
    case 1: CS_K4R(1); break;
    case 2: CS_K4R(2); break;
    case 3: CS_K4R(3); break;
    case 4: CS_K4R(4); break;
    case 5: CS_K4R(5); break;
    case 6: CS_K4R(6); break;
    case 7: CS_K4R(7); break;
    case 8: CS_K4R(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CS_K4R
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
