// K2's walk over every coordinate for Hopper (sm_90a): the CUDA C++
// replacement of the Pallas TPU kernels _estimate_row and
// median_rows_pallas of commefficient_tpu/ops/pallas/countsketch_kernels.py
// (estimate_all_pallas as a whole), where the table fits the L2 and the
// walk's slot tables shared memory (index_math.k2_design: ResNet-9's
// geometry); riffle.cu holds K2's row design for the others. Built into
// the kernels' library by its own nvcc (build.SOURCES), beside
// countsketch.cu, whose conventions it shares: the caller's stream,
// nothing allocated, cudaGetLastError() returned, no float atomics.

#include "layout.cuh"

// ---------------------------------------------------------------------------
// K2 cs_estimate_median
//
// Replaces: estimate_all_pallas (countsketch_kernels.py:352) as a whole:
// _estimate_row (:260, pallas_call at :306), median_rows_pallas (:317,
// pallas_call at :341) and the unscramble that ends it. For every original
// coordinate x < d, the median of its r signed bucket values, written to
// out[x]: neither the [r, d_eff] stack of per-row estimates nor the
// scrambled [d_eff] vector exists.
//
// Bound on the H100: bytes. It reads the 4*r*c_actual-byte table (10 MB at
// ResNet-9, L2-resident), the packed sign bits (r*d_eff/8 bytes, 4.1 MB),
// the block permutation and the slot tables, and writes 4*d bytes (26 MB).
//
// Design. Each value is one signed table entry and the median is the
// compare-exchange network, so the result is bit-identical to the plain
// gather version and to K4's range form at every coordinate. What costs
// time is scattered table reads and per-coordinate instructions, so:
//  * the walk: a block takes tiles of per_tile consecutive scrambled
//    positions (4096 on the main path, 64 scramble blocks of 64),
//    consecutive threads on consecutive positions; persistent blocks, as
//    many as fit the card, stride over the tiles;
//  * staged windows: in a row with a small riffle factor a tile's
//    positions meet one narrow table window (index_math.range_windows, the
//    walk of K4's range form at every coordinate), which the block copies
//    into shared memory with coalesced loads before the tile. Rows 0 and 1
//    (f = 1 and 7 on the main path) are staged when their windows fit
//    (NS = 2, else 0, fixed at compile time so no row pays for both
//    paths); the others read the table in place, one 32-byte L2 sector a
//    coordinate, which no walk makes local for all rows at once;
//  * per tile, not per coordinate: each row's (i0 div G, i0 mod G) at the
//    tile's first position, so a coordinate's riffle needs a division only
//    where the tile crosses a multiple of G (never on the main path); and
//    the tile's scramble blocks as offsets x - i in shared memory;
//  * slot tables: slot(o) for every offset o < m and every row, copied
//    into shared memory as uint16 once per block (40 KB on the main path),
//    so no slot hash and no mod V runs in the kernel; where they do not
//    fit (SLOT_SMEM false: m = 32768, or V >= 65536) they are read in
//    place;
//  * packed sign bits: one bit per scrambled position and row, built once
//    per spec on the host side; a warp's 32 positions share one word per
//    row, so no sign hash runs either, and the kernel is the same for
//    both hash families;
//  * divisions by m and b as shifts where they are powers of two (the main
//    path's 4096 and 64), else by the host's multipliers;
//  * the unscramble, fused: position i of scramble block i div b holds
//    coordinate perm[i div b] * b + i mod b, so a warp writes its 32
//    estimates to one run of 128 bytes of out; positions at or past d are
//    the padding and are skipped. A spec that does not scramble (perm
//    null) writes in place.
// What bounds it (ops/cuda/k2_attribution.py, at ResNet-9): a third is the
// three unstaged rows' L2 sectors; two thirds is the rest: the loop over
// a tile's coordinates (354 static SASS instructions at r = 5), the
// per-tile staging and barriers, and a tail (1605 tiles on 264 resident
// blocks: the seventh round is 8% full).
//
// The table types (TK, the reference's _estimate_row reading its window
// as spec.dtype at countsketch_kernels.py:292-294): 0, an f32 table read
// as it is; 1, an f32 table with each entry rounded to bf16 at the read
// (spec.dtype bfloat16); 2, a bf16 table, each entry widened at the read.
// Windows are staged in the stored type, so a bf16 table stages twice the
// entries in the same budget (index_math.k2_staged_rows counts bytes). At
// the GPT-2 geometry (m = 8192, V = 5248) neither rows 0-1's windows nor
// the slot tables fit (NS = 0, SLOT_SMEM false): every row reads the table
// in place and the slot tables from global memory (L2), at 2% of the
// bound; so that geometry, and every one whose table outgrows the L2 or
// whose slot tables leave shared memory, takes the row design of
// riffle.cu. The walk's other instantiations stay reachable (the tests and
// chip_smoke.py hold the designs against each other).
// ---------------------------------------------------------------------------
static const int kThreadsK2 = 1024;

template <int R, int NS, bool SLOT_SMEM, int TK>
__global__ void __launch_bounds__(kThreadsK2, 2)
    cs_estimate_median_kernel(const CsTable<TK>* __restrict__ table, uint32_t c_actual,
                              float* __restrict__ out, uint32_t d, uint32_t d_eff,
                              const int* __restrict__ perm, uint32_t b, int b_shift,
                              uint32_t per_tile, uint32_t ntiles,
                              const int* __restrict__ slots, uint32_t m, int m_shift,
                              const uint32_t* __restrict__ signs, uint32_t nw,
                              const int* __restrict__ wstart, const CsWindows W,
                              const __grid_constant__ CsRows P) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wbase[CS_MAX_ROWS];  // the row's window offset minus its first column
  __shared__ uint2 rif[CS_MAX_ROWS];  // (i0 div G, i0 mod G) of the tile's first position
  const uint32_t per_block = per_tile / b;  // scramble blocks a tile
  uint16_t* slot_s = reinterpret_cast<uint16_t*>(smem);
  uint32_t* xoff = reinterpret_cast<uint32_t*>(smem + (SLOT_SMEM ? cs_align16(2 * R * m) : 0));
  using T = CsTable<TK>;
  T* win = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(xoff) + cs_align16(4 * per_block));
  if constexpr (SLOT_SMEM) {
    for (uint32_t t = threadIdx.x; t < R * m; t += kThreadsK2) slot_s[t] = (uint16_t)__ldg(slots + t);
  }
  for (uint32_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const uint32_t i0 = tile * per_tile;
    __syncthreads();  // every read of the previous tile's shared memory is done
#pragma unroll
    for (int row = 0; row < NS; ++row) {
      const uint32_t w0 = (uint32_t)__ldg(wstart + (size_t)tile * R + row);
      const T* trow = table + (size_t)row * c_actual;
      for (int c = threadIdx.x; c < W.wlen[row]; c += kThreadsK2)
        win[W.woff[row] + c] = w0 + c < c_actual ? cs_ldg(trow + w0 + c) : cs_zero<T>();
      if (threadIdx.x == 0) wbase[row] = W.woff[row] - (int)w0;
    }
    if (threadIdx.x < R) {
      const long long* g = P.v[threadIdx.x];
      const uint32_t hi = cs_udiv(i0, g, RP_DIV_G);
      rif[threadIdx.x] = make_uint2(hi, i0 - hi * (uint32_t)g[RP_G]);
    }
    if (perm) {  // x - i of each scramble block, mod 2^32
      const uint32_t sb0 = tile * per_block;
      const uint32_t n = min(per_block, d_eff / b - sb0);
      for (uint32_t j = threadIdx.x; j < n; j += kThreadsK2)
        xoff[j] = ((uint32_t)__ldg(perm + sb0 + j) - (sb0 + j)) * b;
    }
    __syncthreads();
    const uint32_t i_end = d_eff - i0 < per_tile ? d_eff : i0 + per_tile;
#pragma unroll 1
    for (uint32_t i = i0 + threadIdx.x; i < i_end; i += kThreadsK2) {
      const uint32_t k = i - i0;
      const uint32_t x = perm ? i + xoff[cs_div_pow2_or(k, b_shift, P.v[0], RP_DIV_SBLOCK)] : i;
      if (x >= d) continue;  // the padding past d
      float e[R];
#pragma unroll
      for (int row = 0; row < R; ++row) {
        const long long* g = P.v[row];
        const uint32_t G = (uint32_t)g[RP_G];
        const uint2 t = rif[row];
        uint32_t hi = t.x, r = t.y + k;
        if (r >= G) {  // the tile crosses a multiple of G
          hi = cs_udiv(i, g, RP_DIV_G);
          r = i - hi * G;
        }
        const uint32_t p = r * (uint32_t)g[RP_F] + hi;
        const uint32_t q = cs_div_pow2_or(p, m_shift, g, RP_DIV_M);
        const uint32_t o = p - q * m;
        const uint32_t slot = SLOT_SMEM ? (uint32_t)slot_s[row * m + o]
                                        : (uint32_t)__ldg(slots + row * m + o);
        const uint32_t col = q * (uint32_t)g[RP_S] + slot;
        float v = cs_f32(row < NS ? win[wbase[row] + (int)col]
                                  : cs_ldg(table + (size_t)row * c_actual + col));
        if constexpr (TK == 1) v = cs_round_bf16(v);
        const uint32_t word = __ldg(signs + (size_t)row * nw + (i >> 5));
        e[row] = v * (((word >> (i & 31u)) & 1u) ? -1.0f : 1.0f);
      }
      out[x] = cs_median<R>(e);
    }
  }
}


extern "C" {

// K2 over the host-built plan (ops/cuda/countsketch.py _k2_plan): the
// forward block permutation perm (null: no scramble) of blocks of b
// positions; ntiles tiles of per_tile positions (whole blocks) with their
// window starts wstart [ntiles, r]; rows 0..ns-1 staged, placed by
// woff/wlen; the slot tables slots [r, m] int32, copied to shared memory
// as uint16 when slot_smem; the packed sign bits signs [r, nw]. The
// persistent grid is sized once per instantiation and device
// (cs_persistent_grid). table_kind: 0 an f32 table, 1 an f32 table read
// rounded to bf16, 2 a bf16 table; woff/wlen count entries of its type.
int cs_estimate_median(const void* table, long long c_actual, float* out, long long d,
                       long long d_eff, const int* perm, long long b, long long per_tile,
                       long long ntiles, const int* slots, long long m, int slot_smem,
                       const int* signs, long long nw, const int* wstart, int ns,
                       const int* woff, const int* wlen, const long long* rows, int r,
                       int table_kind, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  if (ntiles <= 0) return 0;
  if (!(ns == 0 || (ns == 2 && r >= 2))) return (int)cudaErrorInvalidValue;
  if (table_kind < 0 || table_kind > 2) return (int)cudaErrorInvalidValue;
  CsWindows W;
  memset(&W, 0, sizeof(W));
  int wfloats = 0;
  for (int row = 0; row < ns; ++row) {
    W.woff[row] = woff[row];
    W.wlen[row] = wlen[row];
    if (woff[row] + wlen[row] > wfloats) wfloats = woff[row] + wlen[row];
  }
  const uint32_t mm = (uint32_t)m, bb = (uint32_t)b;
  const int smem = (slot_smem ? (int)cs_align16(2u * (uint32_t)r * mm) : 0) +
                   (int)cs_align16(4u * (uint32_t)(per_tile / b)) +
                   (table_kind == 2 ? 2 : 4) * wfloats;
  const int m_shift = (mm & (mm - 1)) == 0 ? __builtin_ctz(mm) : -1;
  const int b_shift = (bb & (bb - 1)) == 0 ? __builtin_ctz(bb) : -1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  long long grid = 0;
#define CS_K2(R, NS, S, TK)                                                                    \
  e = cs_persistent_grid(cs_estimate_median_kernel<R, NS, S, TK>, kThreadsK2, smem, &grid);    \
  if (e != cudaSuccess) return (int)e;                                                         \
  cs_estimate_median_kernel<R, NS, S, TK><<<(unsigned)(grid < ntiles ? grid : ntiles),         \
                                            kThreadsK2, smem, st>>>(                           \
      (const CsTable<TK>*)table, (uint32_t)c_actual, out, (uint32_t)d, (uint32_t)d_eff, perm,  \
      bb, b_shift, (uint32_t)per_tile, (uint32_t)ntiles, slots, mm, m_shift,                   \
      (const uint32_t*)signs, (uint32_t)nw, wstart, W, P)
#define CS_K2S(R, NS, TK)    \
  if (slot_smem) {           \
    CS_K2(R, NS, true, TK);  \
  } else {                   \
    CS_K2(R, NS, false, TK); \
  }
#define CS_K2R(R, TK)      \
  if (ns == 2) {           \
    CS_K2S(R, 2, TK);      \
  } else {                 \
    CS_K2S(R, 0, TK);      \
  }
#define CS_K2T(TK)                          \
  switch (r) {                              \
    case 1: CS_K2S(1, 0, TK); break;        \
    case 2: CS_K2R(2, TK); break;           \
    case 3: CS_K2R(3, TK); break;           \
    case 4: CS_K2R(4, TK); break;           \
    case 5: CS_K2R(5, TK); break;           \
    case 6: CS_K2R(6, TK); break;           \
    case 7: CS_K2R(7, TK); break;           \
    case 8: CS_K2R(8, TK); break;           \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (table_kind == 0) {
    CS_K2T(0);
  } else if (table_kind == 1) {
    CS_K2T(1);
  } else {
    CS_K2T(2);
  }
#undef CS_K2T
#undef CS_K2R
#undef CS_K2S
#undef CS_K2
  return (int)cudaGetLastError();
}

}  // extern "C"
