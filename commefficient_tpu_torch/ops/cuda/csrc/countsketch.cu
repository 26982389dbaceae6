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
// not an optimization (commefficient_tpu/ops/countsketch.py docstring);
// layout.cuh gives a scrambled position's column and sign in a row.
//
// No kernel here uses float atomics: each output element is owned by one
// thread and summed in a fixed order, so a table is bit-identical from run
// to run (the reference pins bit-exact replay of resumed/rolled-back runs).
// K1's segment form, which adds one parameter leaf into a table, is in
// segment.cu.
//
// K2's walk is in walk.cu; K1's chunk design and K2's row design, which the
// geometries whose vector or table outgrows the L2 take, are in riffle.cu.
//
// Runtime divisions in the redesigned kernels (K1's tiles, K2, K4) go through
// cs_udiv (common.cuh): a multiplier and shift per divisor, computed on the host by
// index_math.fast_divisor and exact for every dividend the kernel admits.

#include "layout.cuh"

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
// The bf16 forms (the reference's spec.dtype and spec.table_dtype,
// _sketch_row's operand rounding at countsketch_kernels.py:188-191 and
// sketch_vec_pallas's table cast at :244-252), two independent template
// switches of the tile kernel: ROUND rounds each loaded value to bf16
// (__float2bfloat16_rn, then widened) on the staging load, which equals
// rounding the signed value, since rounding to nearest is symmetric; T is
// the table's type, the f32 tile sums rounded to bf16 at the final write
// only. The sums stay f32 in shared memory, in the same order, so each
// form equals the f32 kernel on rounded input or with its table rounded,
// bit for bit. A bf16 table halves the bytes written (the bound's 4*r*c
// becomes 2*r*c); the rounding costs an instruction a value.
//
// cs_sketch_gather_kernel: one thread per column, reading v_s in place.
// Kept for geometries whose tile does not fit (m above 8192, or shared
// memory); the host picks (index_math.sketch_tile_strides). It is f32
// only: no path of the port runs it, and it refuses the bf16 forms.
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
template <int E, bool ROUND>
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
        v[x] = ROUND ? cs_round_bf16(__ldg(v_s + i)) : __ldg(v_s + i);
        neg |= (cs_sign_hash(g, family, i) & 1u) << x;
      }
    }
  }
}

// Four consecutive f32 sums to the table, in its type.
__device__ __forceinline__ void cs_store4(float* out, uint32_t c4, float4 a) {
  reinterpret_cast<float4*>(out)[c4] = a;
}
__device__ __forceinline__ void cs_store4(__nv_bfloat16* out, uint32_t c4, float4 a) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * c4;
  o[0] = __floats2bfloat162_rn(a.x, a.y);
  o[1] = __floats2bfloat162_rn(a.z, a.w);
}

template <int E, bool ROUND, typename T>
__global__ void __launch_bounds__(kThreadsK1, E <= 8 ? 2 : 1)
    cs_sketch_tiles_kernel(const float* __restrict__ v_s, uint32_t d_eff,
                           const int* __restrict__ csr_ptr, const int* __restrict__ csr_off,
                           T* __restrict__ table, uint32_t c_actual,
                           const __grid_constant__ CsRows P, int family, uint32_t W) {
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
    cs_load_chunk<E, ROUND>(v_s, d_eff, g, family, q_lo, rj, pos, e_lo, e_hi, v, neg);
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
        cs_load_chunk<E, ROUND>(v_s, d_eff, g, family, q + 1, rj, pos, e_lo, e_hi, v, neg);
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
  for (uint32_t c4 = threadIdx.x; c4 < ngroups; c4 += kThreadsK1) cs_store4(out, c4, acc[c4]);
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
//
// Both forms take the table in either stored type T: a bf16 table (the
// reference's spec.table_dtype) is widened to f32 at the read and never
// rounded to spec.dtype (decode_kernels.py:146-149, :160), and the range
// form stages its windows in bf16, twice the entries in the same budget.
// No whole-table f32 copy is made: the table's bytes halve.
// ---------------------------------------------------------------------------
template <int R, typename T>
__global__ void __launch_bounds__(256)
    cs_estimate_at_kernel(const T* __restrict__ table, uint32_t c_actual,
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
    e[row] = cs_f32(cs_ldg(table + (size_t)row * c_actual + cs_col(g, family, i))) *
             cs_sign(g, family, i);
  }
  __stcs(out + t, cs_median<R>(e));
}

static const int kThreadsK4r = 1024;

template <int R, typename T>
__global__ void __launch_bounds__(kThreadsK4r)
    cs_estimate_range_kernel(const T* __restrict__ table, uint32_t c_actual, long long start,
                             long long n, uint32_t d, uint32_t xa, uint32_t xb, uint32_t b,
                             const int* __restrict__ inv_perm, const int* __restrict__ blocks,
                             int nlist, int per_block, const int* __restrict__ wstart,
                             const CsWindows W, float* __restrict__ out,
                             const __grid_constant__ CsRows P, int family) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  uint32_t w0[R];
#pragma unroll
  for (int row = 0; row < R; ++row) {
    w0[row] = (uint32_t)__ldg(wstart + (size_t)blockIdx.x * R + row);
    if (W.wlen[row]) {
      const T* trow = table + (size_t)row * c_actual;
      for (int c = threadIdx.x; c < W.wlen[row]; c += kThreadsK4r)
        win[W.woff[row] + c] = w0[row] + c < c_actual ? cs_ldg(trow + w0[row] + c) : cs_zero<T>();
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
        const float v = cs_f32(W.wlen[row] ? win[W.woff[row] + (col - w0[row])]
                                           : cs_ldg(table + (size_t)row * c_actual + col));
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

extern "C" {

// tile_strides W > 0 selects the tile kernel (W strides per block), 0 the
// gather kernel (f32 only). round_operand rounds each value to bf16;
// bf16_table writes a bf16 table (else f32).
int cs_sketch_rows(const float* v_s, long long d_eff, const int* csr_ptr, const int* csr_off,
                   void* table, long long c_actual, const long long* rows, int r, int family,
                   int tile_strides, int round_operand, int bf16_table, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (tile_strides <= 0) {
    if (round_operand || bf16_table) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((c_actual + kThreads - 1) / kThreads), (unsigned)r);
    cs_sketch_gather_kernel<<<grid, kThreads, 0, st>>>(v_s, (uint32_t)d_eff, csr_ptr, csr_off,
                                                       (float*)table, c_actual, P, family);
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
#define CS_K1(E, RND, T)                                                                      \
  e = cudaFuncSetAttribute(cs_sketch_tiles_kernel<E, RND, T>,                                 \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);           \
  if (e != cudaSuccess) return (int)e;                                                        \
  cs_sketch_tiles_kernel<E, RND, T><<<grid, kThreadsK1, smem, st>>>(                          \
      v_s, (uint32_t)d_eff, csr_ptr, csr_off, (T*)table, (uint32_t)c_actual, P, family, W)
#define CS_K1F(E)                                                                             \
  if (round_operand) {                                                                        \
    if (bf16_table) {                                                                         \
      CS_K1(E, true, __nv_bfloat16);                                                          \
    } else {                                                                                  \
      CS_K1(E, true, float);                                                                  \
    }                                                                                         \
  } else {                                                                                    \
    if (bf16_table) {                                                                         \
      CS_K1(E, false, __nv_bfloat16);                                                         \
    } else {                                                                                  \
      CS_K1(E, false, float);                                                                 \
    }                                                                                         \
  }
  const uint32_t per = (m_max + kThreadsK1 - 1) / kThreadsK1;
  if (per <= 1) { CS_K1F(1); }
  else if (per <= 2) { CS_K1F(2); }
  else if (per <= 4) { CS_K1F(4); }
  else if (per <= 8) { CS_K1F(8); }
  else if (per <= 16) { CS_K1F(16); }
  else return (int)cudaErrorInvalidValue;
#undef CS_K1F
#undef CS_K1
  return (int)cudaGetLastError();
}

// bf16_table: the table is bf16 (else f32), widened at the read.
int cs_estimate_at(const void* table, long long c_actual, const long long* idx, long long n,
                   long long d, const int* inv_perm, float* out, int* err,
                   const long long* rows, int r, int family, int bf16_table, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned long long dd = (unsigned long long)d;
  const uint32_t c = (uint32_t)c_actual;
#define CS_K4(R, T)                                                                      \
  cs_estimate_at_kernel<R, T><<<blocks, kThreads, 0, st>>>((const T*)table, c, idx, n, dd,  \
                                                           inv_perm, out, err, P, family)
#define CS_K4T(T)                                \
  switch (r) {                                   \
    case 1: CS_K4(1, T); break;                  \
    case 2: CS_K4(2, T); break;                  \
    case 3: CS_K4(3, T); break;                  \
    case 4: CS_K4(4, T); break;                  \
    case 5: CS_K4(5, T); break;                  \
    case 6: CS_K4(6, T); break;                  \
    case 7: CS_K4(7, T); break;                  \
    case 8: CS_K4(8, T); break;                  \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (bf16_table) {
    CS_K4T(__nv_bfloat16);
  } else {
    CS_K4T(float);
  }
#undef CS_K4T
#undef CS_K4
  return (int)cudaGetLastError();
}

// The range form over the host-built block list (nlist original scramble
// blocks of b positions, per_block of them per CUDA block) and per-block
// window starts wstart [nblk, r]; woff/wlen [r] place the staged windows,
// in entries of the table's type (bf16_table: bf16, else f32).
int cs_estimate_range(const void* table, long long c_actual, long long start, long long n,
                      long long d, long long xa, long long xb, long long b, const int* inv_perm,
                      const int* blocks, int nlist, int per_block, const int* wstart,
                      const int* woff, const int* wlen, float* out, const long long* rows,
                      int r, int family, int bf16_table, void* stream) {
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
  smem *= bf16_table ? 2 : 4;
  const unsigned grid = (unsigned)((nlist + per_block - 1) / per_block);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define CS_K4R(R, T)                                                                          \
  e = cudaFuncSetAttribute(cs_estimate_range_kernel<R, T>,                                    \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                \
  if (e != cudaSuccess) return (int)e;                                                        \
  cs_estimate_range_kernel<R, T><<<grid, kThreadsK4r, smem, st>>>(                            \
      (const T*)table, (uint32_t)c_actual, start, n, (uint32_t)d, (uint32_t)xa, (uint32_t)xb, \
      (uint32_t)b, inv_perm, blocks, nlist, per_block, wstart, W, out, P, family)
#define CS_K4RT(T)                               \
  switch (r) {                                   \
    case 1: CS_K4R(1, T); break;                 \
    case 2: CS_K4R(2, T); break;                 \
    case 3: CS_K4R(3, T); break;                 \
    case 4: CS_K4R(4, T); break;                 \
    case 5: CS_K4R(5, T); break;                 \
    case 6: CS_K4R(6, T); break;                 \
    case 7: CS_K4R(7, T); break;                 \
    case 8: CS_K4R(8, T); break;                 \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (bf16_table) {
    CS_K4RT(__nv_bfloat16);
  } else {
    CS_K4RT(float);
  }
#undef CS_K4RT
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
