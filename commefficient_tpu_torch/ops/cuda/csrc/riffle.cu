// K1 and K2 in each row's riffled order: the CountSketch kernels for
// geometries whose vector and table outgrow the H100's 50 MB L2 (GPT-2's:
// a 498 MB vector, a 100 MB table), beside countsketch.cu's tile kernel
// and walk, which the host keeps where both fit
// (index_math.sketch_design, index_math.k2_design). Built into the same
// library by its own nvcc (build.SOURCES); the same conventions: the
// caller's stream, nothing allocated (the wrapper passes the scratch),
// cudaGetLastError() returned, no float atomics.
//
// Why a row's riffled order. Row r sees the scrambled vector as an [f, G]
// matrix, i = a * G + c, and its riffled positions p = c * f + a run over
// the transpose: chunk q of m riffled positions reads m values of v_s
// strided G apart, and one coordinate's r columns lie in r unrelated parts
// of the table. At ResNet-9's geometry both the vector (26 MB) and the
// table (10 MB) sit in L2 and the strides cost L2 sectors; at GPT-2's they
// cost HBM sectors, 32 bytes for each 4-byte value, and the tile kernel
// and the walk ran at 2% of their bounds there (ops/cuda/k1_attribution.py
// and k2_attribution.py split their time). Here each row is walked in an
// order that makes its own reads contiguous, and the [r] values of a
// coordinate meet through one streamed scratch copy.

#include "layout.cuh"

__device__ __forceinline__ void cs_cp_async16(void* dst, const void* src, uint32_t bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cs_cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cs_cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// K1 cs_sketch_chunks
//
// Replaces: _sketch_row (commefficient_tpu/ops/pallas/countsketch_kernels.py
// :168, pallas_call at :221; entry sketch_vec_pallas :244), as the tile
// kernel of countsketch.cu does; the same [r, c_actual] table in every
// form, bit for bit.
//
// Bound on the H100: bytes, 4*d_eff read once and the table written once
// (0.18 ms at GPT-2's geometry). This design moves 4*d_eff three times a
// row past the first (read, riffled copy written, copy read): the price of
// reading each row's values in order, which no gather without float
// atomics avoids.
//
// Two kernels a launch:
//  * cs_riffle_kernel, once for each row past row 0 (f > 1): the signed
//    values of v_s in the row's riffled order, w[p] = sign(i) * v_s[i]
//    (rounded to bf16 first in the ROUND form, +0 for i >= d_eff), for
//    every p < L. It is the transpose of v_s's [f, G] view into [G, f],
//    through a 32 x 32 tile in shared memory: coalesced 128-byte reads
//    along c and writes along a (a 32 x 128 tile, 512-byte reads, was
//    slower). Row 0 (f = 1) needs no copy: p = i.
//    The a-tiles of a c-tile are neighbours in the grid, so each run of f
//    riffled floats is written while it is in L2 (in the other order the
//    copies ran at 1.5 TB/s: partial sectors left L2 to be merged in HBM).
//  * cs_sketch_chunks_kernel: a block owns W strides of one row (as the
//    tile kernel did) and walks the W + u - 1 chunks that reach it in
//    ascending q. A chunk is now m consecutive floats of the row's
//    riffled values (v_s itself in row 0), so it lands in shared memory by
//    cp.async, 16 bytes a copy, double-buffered: chunk q + 1 is in flight
//    while chunk q is summed, and no thread holds staged values in
//    registers (the tile kernel held 16 a thread at m = 8192 and ran one
//    block a multiprocessor); the tile's sums are, KG float4 a thread, so
//    shared memory holds only the CSR tables and the two chunks (90 KB at
//    m = 8192: two blocks a multiprocessor at W = 32). Row 0's chunk is
//    signed and rounded in place, each thread over the pieces it copied,
//    before the barrier that publishes the chunk, from row 0's packed
//    sign bits (a pass of its own behind a second barrier, hashing each
//    sign, cost 0.5 ms at GPT-2's geometry; signing each value as the
//    summation reads it, 1.8 ms).
//    Each column's entries are read through the row's CSR offsets
//    (slot-major, offsets ascending) in shared memory: the column sums
//    over q ascending and, within a chunk, over offsets ascending, in f32,
//    which is the tile kernel's order, so the tables are the same bit for
//    bit.
// ---------------------------------------------------------------------------
static const int kThreadsK1c = 512;

// Dynamic shared memory of a chunk block (index_math.chunk_smem_bytes is
// the same): the CSR pointers (V+1 uint16, padded), the CSR offsets (m
// uint16) and two chunk buffers (m f32 each). The tile's sums are in
// registers: KG float4 groups of 4 columns a thread.
__host__ __device__ __forceinline__ uint32_t cs_chunk_smem(uint32_t m, uint32_t V) {
  return cs_align16(2 * (V + 4)) + cs_align16(2 * m) + 2 * cs_align16(4 * m);
}
static const int kChunkGroups = 6;  // KG at most: W * s <= 4 * 6 * kThreadsK1c

template <bool ROUND>
__global__ void __launch_bounds__(256)
    cs_riffle_kernel(const float* __restrict__ v_s, uint32_t d_eff, float* __restrict__ w,
                     const __grid_constant__ CsRows P, int row, int family, uint32_t na) {
  __shared__ float tile[32][33];
  const long long* g = P.v[row];
  const uint32_t f = (uint32_t)g[RP_F], G = (uint32_t)g[RP_G];
  // the a-tiles of one c-tile are neighbours in the grid, so the f
  // consecutive floats of each riffled run c * f + [0, f) are written by
  // blocks that run together and leave L2 as whole sectors
  const uint32_t ct = blockIdx.x / na;
  const uint32_t c0 = ct * 32, a0 = (blockIdx.x - ct * na) * 32;
  const uint32_t tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a = a0 + ty + 8 * j, c = c0 + tx;
    float x = 0.0f;
    if (a < f && c < G) {
      const uint32_t i = a * G + c;
      if (i < d_eff) {
        x = __ldg(v_s + i);
        if (ROUND) x = cs_round_bf16(x);
        if (cs_sign_hash(g, family, i) & 1u) x = -x;
      }
    }
    tile[ty + 8 * j][tx] = x;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t c = c0 + ty + 8 * j, a = a0 + tx;
    if (a < f && c < G) w[(size_t)c * f + a] = tile[tx][ty + 8 * j];
  }
}

// Chunk q (m floats from src + q*m) into buf by cp.async, 16 bytes a copy,
// as one commit group; values at or past `avail` are zero-filled, never
// read.
__device__ __forceinline__ void cs_chunk_async(float* buf, const float* src, uint32_t q, uint32_t m,
                                               uint32_t avail) {
  const uint32_t base = q * m;
  for (uint32_t k = 4 * threadIdx.x; k < m; k += 4 * kThreadsK1c) {
    const uint32_t p = base + k;
    const uint32_t n = p >= avail ? 0u : min(4u, avail - p);
    cs_cp_async16(buf + k, n ? src + p : src, 4 * n);
  }
  cs_cp_commit();
}

// Row 0's chunk (riffled positions p0 + [0, m), which are its scrambled
// positions) signed and rounded in place, each thread over the 16-byte
// pieces it copied itself (cs_chunk_async), so no barrier separates the
// copy from this pass. The signs are row 0's packed sign bits (a 16-byte
// piece lies in one word: p0 and m are multiples of 4); +0 past d_eff
// (zero-filled, no sign bit) stays +0.
template <bool ROUND>
__device__ __forceinline__ void cs_chunk_sign(float* buf, uint32_t p0, uint32_t m, uint32_t d_eff,
                                              const uint32_t* __restrict__ signs0) {
  for (uint32_t k = 4 * threadIdx.x; k < m; k += 4 * kThreadsK1c) {
    const uint32_t p = p0 + k;
    if (p >= d_eff) continue;
    float4 x = *reinterpret_cast<float4*>(buf + k);
    float* v = reinterpret_cast<float*>(&x);
    const uint32_t bits = __ldg(signs0 + (p >> 5)) >> (p & 31u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ROUND) v[j] = cs_round_bf16(v[j]);
      if ((bits >> j) & 1u) v[j] = -v[j];
    }
    *reinterpret_cast<float4*>(buf + k) = x;
  }
}

template <int KG, bool ROUND, typename T>
__global__ void __launch_bounds__(kThreadsK1c, 2)
    cs_sketch_chunks_kernel(const float* __restrict__ v_s, uint32_t d_eff,
                            const float* __restrict__ riffled, size_t pitch,
                            const int* __restrict__ csr_ptr, const int* __restrict__ csr_off,
                            T* __restrict__ table, uint32_t c_actual,
                            const uint32_t* __restrict__ signs0,
                            const __grid_constant__ CsRows P, uint32_t W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.y;
  const long long* g = P.v[row];
  const uint32_t s = (uint32_t)g[RP_S], V = (uint32_t)g[RP_V], nc = (uint32_t)g[RP_NC];
  const uint32_t m = (uint32_t)g[RP_M], f = (uint32_t)g[RP_F];
  const uint32_t j0 = blockIdx.x * W * s;
  if (j0 >= c_actual) return;
  const uint32_t ncols = min(W * s, c_actual - j0);  // a multiple of 8
  T* out = table + (size_t)row * c_actual + j0;
  uint16_t* ptr_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* off_s = reinterpret_cast<uint16_t*>(smem + cs_align16(2 * (V + 4)));
  float* buf0 = reinterpret_cast<float*>(smem + cs_align16(2 * (V + 4)) + cs_align16(2 * m));
  float* buf1 = buf0 + cs_align16(4 * m) / 4;
  const uint32_t ngroups = ncols / 4;
  // thread tid owns the column groups c4 = tid + k * kThreadsK1c, k < KG
  float4 acc[KG];
#pragma unroll
  for (int k = 0; k < KG; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const uint32_t q_hi = min(nc - 1, cs_udiv(j0 + ncols - 1, g, RP_DIV_S));
  const uint32_t q_lo = j0 + 1 <= V ? 0 : cs_udiv(j0 + s - V, g, RP_DIV_S);
  if (q_lo <= q_hi) {
    // the row's values in riffled order: v_s itself in row 0 (f = 1,
    // unsigned, d_eff of them), else its riffled copy (signed, nc*m)
    const bool direct = f == 1;
    const float* src = direct ? v_s : riffled + (size_t)(row - 1) * pitch;
    const uint32_t avail = direct ? d_eff : nc * m;
    cs_chunk_async(buf0, src, q_lo, m, avail);
    const int* ptr_g = csr_ptr + g[RP_PTR];
    const int* off_g = csr_off + g[RP_OFF];
    for (uint32_t t = threadIdx.x; t <= V; t += kThreadsK1c) ptr_s[t] = (uint16_t)__ldg(ptr_g + t);
    for (uint32_t e = threadIdx.x; e < m; e += kThreadsK1c) off_s[e] = (uint16_t)__ldg(off_g + e);
    for (uint32_t q = q_lo; q <= q_hi; ++q) {
      float* cur = ((q - q_lo) & 1u) ? buf1 : buf0;
      cs_cp_wait_all();  // this thread's copies of chunk q have landed
      if (direct) cs_chunk_sign<ROUND>(cur, q * m, m, d_eff, signs0);
      if (q < q_hi) cs_chunk_async(((q - q_lo) & 1u) ? buf0 : buf1, src, q + 1, m, avail);
      __syncthreads();  // chunk q (and the CSR tables) in shared memory
      const uint32_t w0 = q * s;  // the chunk's window [w0, w0 + V) meets the tile
      const uint32_t g_lo = (w0 > j0 ? w0 - j0 : 0) / 4;
      const uint32_t g_hi = min(ncols, w0 + V - j0) / 4;
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const uint32_t c4 = threadIdx.x + k * kThreadsK1c;
        if (c4 < g_lo || c4 >= g_hi) continue;
        const uint32_t t = j0 + 4 * c4 - w0;  // a multiple of 4
        const uint2 pp = *reinterpret_cast<const uint2*>(ptr_s + t);
        const uint32_t p1 = pp.x >> 16, p2 = pp.y & 0xffffu, p3 = pp.y >> 16;
        const uint32_t p4 = ptr_s[t + 4];
        float4 a = acc[k];
        uint32_t e = pp.x & 0xffffu;
        for (; e < p1; ++e) a.x += cur[off_s[e]];
        for (; e < p2; ++e) a.y += cur[off_s[e]];
        for (; e < p3; ++e) a.z += cur[off_s[e]];
        for (; e < p4; ++e) a.w += cur[off_s[e]];
        acc[k] = a;
      }
      __syncthreads();  // cur is free for chunk q + 2
    }
  }
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    const uint32_t c4 = threadIdx.x + k * kThreadsK1c;
    if (c4 >= ngroups) continue;
    if constexpr (std::is_same<T, float>::value) {
      reinterpret_cast<float4*>(out)[c4] = acc[k];
    } else {
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * c4;
      o[0] = __floats2bfloat162_rn(acc[k].x, acc[k].y);
      o[1] = __floats2bfloat162_rn(acc[k].z, acc[k].w);
    }
  }
}

// ---------------------------------------------------------------------------
// K2 cs_estimate_rows
//
// Replaces: estimate_all_pallas (countsketch_kernels.py:352) as a whole,
// as countsketch.cu's walk does: _estimate_row (:260, pallas_call at
// :306), median_rows_pallas (:317, pallas_call at :341) and the
// unscramble. The same [d] estimates in original order, bit for bit.
//
// Bound on the H100: bytes, the table and the block permutation read and
// the [d] output written (0.18 ms at GPT-2's geometry). This design also
// writes and reads a [r - nt, d_eff] f32 scratch of per-row estimates once
// (2 GB at GPT-2's geometry): the price of reading each row's table in
// order.
//
// Two kernels a launch:
//  * cs_estimate_rows_kernel, the per-row pass over rows nt..r-1: a block
//    takes kc consecutive c of one row's [f, G] view and every a, so its
//    riffled positions p = c * f + a are one contiguous run and its
//    columns one narrow window of the row, which it copies into shared
//    memory (with the row's slot table, uint16, where V < 2^16). A warp
//    takes one a and 32 consecutive c, so it writes its 32 signed
//    estimates est[k][a * G + c] as 128 contiguous bytes. kc is a power of
//    two times 32, the largest whose window fits index_math's budget.
//  * cs_estimate_final_kernel: the walk of countsketch.cu's K2 over tiles
//    of per_tile consecutive scrambled positions (persistent blocks): row
//    0 (f = 1, so a tile's columns are one window, nt = 1) from its staged
//    window, rows nt..r-1 from the scratch, streamed; the same median
//    network in row order, and the fused unscramble: out[x] for x < d.
// The sign of row r at i is its packed sign bit, the estimate the table
// entry (read as the table kind says) times +-1.0f: each value, and so
// each median, is the walk's.
// ---------------------------------------------------------------------------
static const int kThreadsK2r = 1024;

// The pass's rows: pass row k is sketch row nt + k; its first block in the
// grid, its tile width kc = 32 << lg c values.
struct CsPass {
  int first[CS_MAX_ROWS + 1];
  int lg[CS_MAX_ROWS];
  int n, nt;
};

template <int TK, bool SLOT_SMEM>
__global__ void __launch_bounds__(kThreadsK2r, 2)
    cs_estimate_rows_kernel(const CsTable<TK>* __restrict__ table, uint32_t c_actual,
                            uint32_t d_eff, const int* __restrict__ slots,
                            const uint32_t* __restrict__ signs, uint32_t nw,
                            float* __restrict__ est, size_t pitch, const CsPass Q,
                            const __grid_constant__ CsRows P) {
  extern __shared__ __align__(16) unsigned char smem[];
  using T = CsTable<TK>;
  int k = 0;
  while (k + 1 < Q.n && (int)blockIdx.x >= Q.first[k + 1]) ++k;
  const int row = Q.nt + k;
  const long long* g = P.v[row];
  const uint32_t f = (uint32_t)g[RP_F], G = (uint32_t)g[RP_G], m = (uint32_t)g[RP_M];
  const uint32_t s = (uint32_t)g[RP_S], V = (uint32_t)g[RP_V];
  const uint32_t lg = (uint32_t)Q.lg[k], kc = 32u << lg;
  const uint32_t c0 = ((uint32_t)blockIdx.x - (uint32_t)Q.first[k]) * kc;
  const uint32_t c1 = min(c0 + kc, G);
  const uint32_t q_lo = cs_udiv(c0 * f, g, RP_DIV_M);
  const uint32_t q_hi = cs_udiv(c1 * f - 1, g, RP_DIV_M);
  const uint32_t w0 = q_lo * s, wlen = (q_hi - q_lo) * s + V;
  uint16_t* slot_s = reinterpret_cast<uint16_t*>(smem);
  T* win = reinterpret_cast<T*>(smem + (SLOT_SMEM ? cs_align16(2 * m) : 0));
  const int* slot_g = slots + (size_t)row * m;
  if constexpr (SLOT_SMEM) {
    for (uint32_t o = threadIdx.x; o < m; o += kThreadsK2r) slot_s[o] = (uint16_t)__ldg(slot_g + o);
  }
  const T* trow = table + (size_t)row * c_actual;
  for (uint32_t c = threadIdx.x; c < wlen; c += kThreadsK2r)
    win[c] = w0 + c < c_actual ? cs_ldg(trow + w0 + c) : cs_zero<T>();
  __syncthreads();
  const uint32_t lane = threadIdx.x & 31u, nb = 1u << lg;
  float* erow = est + (size_t)k * pitch;
  const uint32_t* srow = signs + (size_t)row * nw;
  const uint32_t npairs = f << lg;  // (a, 32-lane group of c) pairs
  for (uint32_t pair = threadIdx.x >> 5; pair < npairs; pair += kThreadsK2r / 32) {
    const uint32_t a = pair >> lg;
    const uint32_t c = c0 + ((pair & (nb - 1u)) << 5) + lane;
    if (c >= c1) continue;
    const uint32_t i = a * G + c;
    if (i >= d_eff) continue;
    const uint32_t p = c * f + a;
    const uint32_t q = cs_udiv(p, g, RP_DIV_M);
    const uint32_t o = p - q * m;
    const uint32_t slot = SLOT_SMEM ? (uint32_t)slot_s[o] : (uint32_t)__ldg(slot_g + o);
    float v = cs_f32(win[q * s + slot - w0]);
    if constexpr (TK == 1) v = cs_round_bf16(v);
    const uint32_t word = __ldg(srow + (i >> 5));
    __stcs(erow + i, v * (((word >> (i & 31u)) & 1u) ? -1.0f : 1.0f));
  }
}

template <int R, int NT, int TK>
__global__ void __launch_bounds__(kThreadsK2r, 2)
    cs_estimate_final_kernel(const CsTable<TK>* __restrict__ table, uint32_t c_actual,
                             float* __restrict__ out, uint32_t d, uint32_t d_eff,
                             const int* __restrict__ perm, uint32_t b, int b_shift,
                             uint32_t per_tile, uint32_t ntiles, const int* __restrict__ slots,
                             uint32_t m, int m_shift, const uint32_t* __restrict__ signs,
                             const float* __restrict__ est, size_t pitch,
                             const __grid_constant__ CsRows P) {
  extern __shared__ __align__(16) unsigned char smem[];
  using T = CsTable<TK>;
  const uint32_t per_block = per_tile / b;  // scramble blocks a tile
  const long long* g0 = P.v[0];
  const uint32_t s0 = (uint32_t)g0[RP_S], V0 = (uint32_t)g0[RP_V];
  uint16_t* slot_s = reinterpret_cast<uint16_t*>(smem);
  uint32_t* xoff = reinterpret_cast<uint32_t*>(smem + (NT ? cs_align16(2 * m) : 0));
  T* win = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(xoff) + cs_align16(4 * per_block));
  if constexpr (NT == 1) {
    for (uint32_t o = threadIdx.x; o < m; o += kThreadsK2r) slot_s[o] = (uint16_t)__ldg(slots + o);
  }
  for (uint32_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const uint32_t i0 = tile * per_tile;
    const uint32_t i_end = d_eff - i0 < per_tile ? d_eff : i0 + per_tile;
    __syncthreads();  // every read of the previous tile's shared memory is done
    uint32_t w0 = 0;
    if constexpr (NT == 1) {  // row 0: p = i, so the tile's columns are one window
      const uint32_t q_lo = cs_div_pow2_or(i0, m_shift, g0, RP_DIV_M);
      const uint32_t q_hi = cs_div_pow2_or(i_end - 1, m_shift, g0, RP_DIV_M);
      w0 = q_lo * s0;
      const uint32_t wlen = (q_hi - q_lo) * s0 + V0;
      for (uint32_t c = threadIdx.x; c < wlen; c += kThreadsK2r)
        win[c] = w0 + c < c_actual ? cs_ldg(table + w0 + c) : cs_zero<T>();
    }
    if (perm) {  // x - i of each scramble block, mod 2^32
      const uint32_t sb0 = tile * per_block;
      const uint32_t n = min(per_block, d_eff / b - sb0);
      for (uint32_t j = threadIdx.x; j < n; j += kThreadsK2r)
        xoff[j] = ((uint32_t)__ldg(perm + sb0 + j) - (sb0 + j)) * b;
    }
    __syncthreads();
#pragma unroll 1
    for (uint32_t i = i0 + threadIdx.x; i < i_end; i += kThreadsK2r) {
      const uint32_t x = perm ? i + xoff[cs_div_pow2_or(i - i0, b_shift, g0, RP_DIV_SBLOCK)] : i;
      if (x >= d) continue;  // the padding past d
      float e[R];
      if constexpr (NT == 1) {
        const uint32_t q = cs_div_pow2_or(i, m_shift, g0, RP_DIV_M);
        float v = cs_f32(win[q * s0 + slot_s[i - q * m] - w0]);
        if constexpr (TK == 1) v = cs_round_bf16(v);
        const uint32_t word = __ldg(signs + (i >> 5));
        e[0] = v * (((word >> (i & 31u)) & 1u) ? -1.0f : 1.0f);
      }
#pragma unroll
      for (int row = NT; row < R; ++row) e[row] = __ldcs(est + (size_t)(row - NT) * pitch + i);
      out[x] = cs_median<R>(e);
    }
  }
}

extern "C" {

// K1 over the chunk design: tile width W = tile_strides strides (W * s at
// most 4 * kChunkGroups * kThreadsK1c columns); riffled [r - 1, pitch] f32
// scratch for rows 1..r-1 (each row's f > 1, L <= pitch; row 0's f = 1);
// v_s 16-byte aligned and m a multiple of 4 (cp.async); signs0 row 0's
// packed sign bits (ops/cuda/countsketch.py packed_sign_bits).
// round_operand rounds each value to bf16; bf16_table writes a bf16 table.
int cs_sketch_chunks(const float* v_s, long long d_eff, const int* csr_ptr, const int* csr_off,
                     void* table, long long c_actual, const long long* rows, int r, int family,
                     int tile_strides, int round_operand, int bf16_table, float* riffled,
                     long long pitch, const int* signs0, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  if (tile_strides <= 0 || !signs0 || (reinterpret_cast<uintptr_t>(v_s) & 15u) ||
      (r > 1 && ((reinterpret_cast<uintptr_t>(riffled) & 15u) || (pitch & 3))))
    return (int)cudaErrorInvalidValue;
  const uint32_t W = (uint32_t)tile_strides;
  uint32_t smem = 0, cols_max = 0;
  long long tiles = 0;
  for (int row = 0; row < r; ++row) {
    const long long* g = P.v[row];
    const long long f = g[RP_F], L = f * g[RP_G];
    if ((g[RP_M] & 3) || (row == 0) != (f == 1) || (row > 0 && L > pitch))
      return (int)cudaErrorInvalidValue;
    const uint32_t cols = W * (uint32_t)g[RP_S];
    const uint32_t need = cs_chunk_smem((uint32_t)g[RP_M], (uint32_t)g[RP_V]);
    if (need > smem) smem = need;
    if (cols > cols_max) cols_max = cols;
    const long long t = (c_actual + cols - 1) / cols;
    if (t > tiles) tiles = t;
  }
  const uint32_t kg = (cols_max + 4 * kThreadsK1c - 1) / (4 * kThreadsK1c);
  if (kg > (uint32_t)kChunkGroups) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  for (int row = 1; row < r; ++row) {
    const long long* g = P.v[row];
    const long long na = (g[RP_F] + 31) / 32, blocks = na * ((g[RP_G] + 31) / 32);
    if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    float* w = riffled + (size_t)(row - 1) * (size_t)pitch;
    if (round_operand) {
      cs_riffle_kernel<true><<<(unsigned)blocks, 256, 0, st>>>(v_s, (uint32_t)d_eff, w, P, row,
                                                               family, (uint32_t)na);
    } else {
      cs_riffle_kernel<false><<<(unsigned)blocks, 256, 0, st>>>(v_s, (uint32_t)d_eff, w, P, row,
                                                                family, (uint32_t)na);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)tiles, (unsigned)r);
#define CS_K1C(KG, RND, T)                                                                    \
  e = cudaFuncSetAttribute(cs_sketch_chunks_kernel<KG, RND, T>,                               \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);           \
  if (e != cudaSuccess) return (int)e;                                                        \
  cs_sketch_chunks_kernel<KG, RND, T><<<grid, kThreadsK1c, smem, st>>>(                       \
      v_s, (uint32_t)d_eff, riffled, (size_t)pitch, csr_ptr, csr_off, (T*)table,              \
      (uint32_t)c_actual, (const uint32_t*)signs0, P, W)
#define CS_K1CF(KG)                        \
  if (round_operand) {                     \
    if (bf16_table) {                      \
      CS_K1C(KG, true, __nv_bfloat16);     \
    } else {                               \
      CS_K1C(KG, true, float);             \
    }                                      \
  } else {                                 \
    if (bf16_table) {                      \
      CS_K1C(KG, false, __nv_bfloat16);    \
    } else {                               \
      CS_K1C(KG, false, float);            \
    }                                      \
  }
  if (kg <= 1) {
    CS_K1CF(1);
  } else if (kg <= 2) {
    CS_K1CF(2);
  } else if (kg <= 4) {
    CS_K1CF(4);
  } else {
    CS_K1CF(6);
  }
#undef CS_K1CF
#undef CS_K1C
  return (int)cudaGetLastError();
}

// K2 over the row design (ops/cuda/countsketch.py _k2_plan): rows nt..r-1
// (nt 0 or 1) through the per-row pass into est [r - nt, pitch] f32, row
// nt + k's tiles kc = 32 << lg[nt + k] c values wide, each with a window
// of at most (ceil(kc * f / m) + 1) * s + V entries of the table's type
// (index_math.k2_rows_window); then the final walk over ntiles tiles
// of per_tile positions with the forward block permutation perm (null: no
// scramble) of blocks of b, row 0's slot table in shared memory when nt
// is 1 (which needs slot_smem). slot_smem: the slot tables [r, m] go to
// shared memory as uint16. signs: the packed sign bits [r, nw]. table_kind
// as cs_estimate_median's.
int cs_estimate_rows(const void* table, long long c_actual, float* out, long long d,
                     long long d_eff, const int* perm, long long b, long long per_tile,
                     long long ntiles, const int* slots, long long m, int slot_smem,
                     const int* signs, long long nw, int nt, const int* lg, float* est,
                     long long pitch, const long long* rows, int r, int table_kind,
                     void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  if (r < 2 || !(nt == 0 || (nt == 1 && slot_smem)) || table_kind < 0 || table_kind > 2 ||
      pitch < d_eff)
    return (int)cudaErrorInvalidValue;
  if (d_eff <= 0) return 0;
  CsPass Q;
  memset(&Q, 0, sizeof(Q));
  Q.n = r - nt;
  Q.nt = nt;
  long long blocks = 0, wmax = 0;
  for (int k = 0; k < Q.n; ++k) {
    const long long* g = P.v[nt + k];
    if (lg[nt + k] < 0 || lg[nt + k] > 20) return (int)cudaErrorInvalidValue;
    const long long kc = 32ll << lg[nt + k];
    Q.first[k] = (int)blocks;
    Q.lg[k] = lg[nt + k];
    blocks += (g[RP_G] + kc - 1) / kc;
    if (g[RP_F] * kc / 32 >= (1ll << 32) || blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    const long long wlen = ((kc * g[RP_F] + m - 1) / m + 1) * g[RP_S] + g[RP_V];
    if (wlen > wmax) wmax = wlen;
  }
  Q.first[Q.n] = (int)blocks;
  const int isz = table_kind == 2 ? 2 : 4;
  const uint32_t mm = (uint32_t)m, bb = (uint32_t)b;
  const int smem_rows = (slot_smem ? (int)cs_align16(2u * mm) : 0) + isz * (int)wmax;
  // row 0's window at per_tile positions: at most ceil(per_tile / m) + 1 chunks
  const long long w0max =
      nt ? ((per_tile + m - 1) / m + 1) * P.v[0][RP_S] + P.v[0][RP_V] : 0;
  const int smem_final = (nt ? (int)cs_align16(2u * mm) : 0) +
                         (int)cs_align16(4u * (uint32_t)(per_tile / b)) + isz * (int)w0max;
  const int m_shift = (mm & (mm - 1)) == 0 ? __builtin_ctz(mm) : -1;
  const int b_shift = (bb & (bb - 1)) == 0 ? __builtin_ctz(bb) : -1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define CS_K2P(TK, S)                                                                          \
  e = cudaFuncSetAttribute(cs_estimate_rows_kernel<TK, S>,                                     \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_rows);            \
  if (e != cudaSuccess) return (int)e;                                                         \
  cs_estimate_rows_kernel<TK, S><<<(unsigned)blocks, kThreadsK2r, smem_rows, st>>>(            \
      (const CsTable<TK>*)table, (uint32_t)c_actual, (uint32_t)d_eff, slots,                   \
      (const uint32_t*)signs, (uint32_t)nw, est, (size_t)pitch, Q, P)
#define CS_K2PS(TK)     \
  if (slot_smem) {      \
    CS_K2P(TK, true);   \
  } else {              \
    CS_K2P(TK, false);  \
  }
  if (table_kind == 0) {
    CS_K2PS(0);
  } else if (table_kind == 1) {
    CS_K2PS(1);
  } else {
    CS_K2PS(2);
  }
#undef CS_K2PS
#undef CS_K2P
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (ntiles <= 0) return 0;
  long long grid = 0;
#define CS_K2F(R, NT, TK)                                                                      \
  e = cs_persistent_grid(cs_estimate_final_kernel<R, NT, TK>, kThreadsK2r, smem_final, &grid); \
  if (e != cudaSuccess) return (int)e;                                                         \
  cs_estimate_final_kernel<R, NT, TK><<<(unsigned)(grid < ntiles ? grid : ntiles),             \
                                        kThreadsK2r, smem_final, st>>>(                        \
      (const CsTable<TK>*)table, (uint32_t)c_actual, out, (uint32_t)d, (uint32_t)d_eff, perm,  \
      bb, b_shift, (uint32_t)per_tile, (uint32_t)ntiles, slots, mm, m_shift,                   \
      (const uint32_t*)signs, est, (size_t)pitch, P)
#define CS_K2FT(R)                  \
  if (nt == 0) {                    \
    CS_K2F(R, 0, 0);                \
  } else if (table_kind == 0) {     \
    CS_K2F(R, 1, 0);                \
  } else if (table_kind == 1) {     \
    CS_K2F(R, 1, 1);                \
  } else {                          \
    CS_K2F(R, 1, 2);                \
  }
  switch (r) {
    case 2: CS_K2FT(2); break;
    case 3: CS_K2FT(3); break;
    case 4: CS_K2FT(4); break;
    case 5: CS_K2FT(5); break;
    case 6: CS_K2FT(6); break;
    case 7: CS_K2FT(7); break;
    case 8: CS_K2FT(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CS_K2FT
#undef CS_K2F
  return (int)cudaGetLastError();
}

}  // extern "C"
