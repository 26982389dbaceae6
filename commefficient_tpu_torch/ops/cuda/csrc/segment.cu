// K1's segment form cs_sketch_segment for Hopper (sm_90a).
//
// Replaces: sketch_segment (commefficient_tpu/ops/countsketch.py:898), the
// per-leaf building block of the sketch-fused backward, which the reference
// runs as an XLA scatter through sketch_sparse (:878); it has no Pallas
// kernel. Adds the n f32 values of one parameter leaf, at the original
// coordinates [offset, offset + n), into an existing f32 [r, c_actual] table.
//
// Contract: no [d] or [d_eff] buffer is created (scattering the leaf into a
// dense vector and running K1 is what the fused backward exists to avoid);
// no float atomics, so two launches on the same inputs give bit-identical
// tables (what checkpoint/resume holds a run to); an entry that no value of
// the leaf reaches is not written; the scratch has a fixed size, allocated
// once per (spec, device) by the wrapper (ops/cuda/countsketch.py).
//
// Bound on the H100: bytes. The leaf is read once (4 n bytes) and each
// table entry it touches is read and written once; the adds are r * n.
//
// Design: the work follows the leaf, O(r n), with no walk of the table. A
// value x goes, in row `row`, to column cs_col(i) with sign hash'(i) of its
// scrambled position i = inv[x div b] * b + x mod b (layout.cuh). Every
// column's contributions of a window (below) are summed in f32 left to
// right in the leaf's order, starting from -0 (so the first add is exact
// and an untouched entry stays -0), and the sum is added into the table
// entry once a window: a sum of -0 is not written, since adding -0 changes
// no value. That order does not depend on the kernels' block sizes, only
// on the windows; tests/test_torch_kernel_index_math.py mirrors it in numpy.
//
// * A small leaf (n <= kSegPiece = 8192, the pairs one block's radix sort
//   holds: 512 threads x 16, ~40 KB of the sort's shared memory and 64 KB
//   for the sorted pairs) is one launch of cs_segment_small_kernel: one
//   block a row computes its n (column, signed value) pairs, sorts them by
//   column with cub::BlockRadixSort (stable, so a column's run keeps the
//   leaf's order), and the first thread of each run sums it and adds it to
//   the table. No scratch, no second pass. n <= 256 and n <= 1024 take
//   64- and 256-thread instantiations.
// * A larger leaf goes through two passes a window: its rows in as few
//   groups as the scratch holds with the whole leaf, or, where not even one
//   row's pairs fit (GPT-2's wte), each row alone in windows of as many
//   values as the scratch holds (index_math.segment_windows):
//   - cs_segment_scatter_kernel, one block a (piece of kSegPiece values,
//     row), the rows of a piece side by side so they share its loads in
//     L2: the piece's pairs, bucketed by tile (T = 2^tile_shift consecutive
//     columns of the row) with a stable counting sort in shared memory
//     (per-warp counts per tile, a scan over tiles and warps, then each
//     warp places its pairs in order, the lanes of one tile ranked by
//     __match_any_sync), written out coalesced to the piece's region of the
//     scratch as (column in the tile: uint16, signed value: f32), with the
//     piece's tile starts;
//   - cs_segment_owner_kernel, one block a (row, tile): it gathers its
//     bucket, the pieces' runs in piece order (so the leaf's order), in
//     sub-batches of kSegBatch pairs into shared memory; sorts each
//     sub-batch stably by bin (cub::BlockRadixSort, 8 bits; thread t owns
//     the T / 256 columns of bin t); thread t then adds the pairs of bin t
//     in order into the tile's f32 sums in shared memory, which no other
//     thread touches; last, the touched sums go into the table.
// A block with an empty bucket exits at once. Integer shared-memory
// atomics count pairs (their order does not change a count); no float is
// summed by an atomic.
//
// What bounds it (ops/cuda/segment_attribution.py times each kernel):
// not bytes. Both passes are bound by their blocks' serial phases (the
// pairs' hashes, the ranking, the sorts and the barriers between them),
// and the scatter by __match_any_sync's low issue rate.
// ---------------------------------------------------------------------------

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "layout.cuh"

static const int kSegThreads = 512;
static const int kSegWarps = kSegThreads / 32;
static const int kSegItems = 16;                         // values a thread holds
static const int kSegPiece = kSegThreads * kSegItems;    // 8192: a piece, and the small limit
static const int kOwnThreads = 256;                      // an owner block: thread t owns
                                                         // the columns of bin t, T / 256
static const int kSegBatch = 2048;                       // an owner's sub-batch of pairs
static const int kSegMaxTiles = 1024;                    // tiles a row
static const int kSegMaxPieces = 2048;                   // piece-rows of the scratch
static const int kSegRuns = kSegMaxPieces / kOwnThreads; // a window's pieces a thread reads
static const uint32_t kNegZero = 0x80000000u;            // the bits of -0.0f

// Whether any of four sums is not -0 (a column that a pair reached).
__device__ __forceinline__ bool cs_touched(float4 a) {
  return (__float_as_uint(a.x) & __float_as_uint(a.y) & __float_as_uint(a.z) &
          __float_as_uint(a.w)) != kNegZero ||
         ((__float_as_uint(a.x) | __float_as_uint(a.y) | __float_as_uint(a.z) |
           __float_as_uint(a.w)) != kNegZero);
}

// The pairs (column, signed value) in row g of ITEMS leaf values k = kof(j)
// (at original coordinates x0 + k; none where k >= cnt: column ~0). Every
// load is issued before any key is computed: a value's scramble-block
// entry and the value itself, each one load.
template <int FAMILY, int ITEMS, typename KOf>
__device__ __forceinline__ void cs_segment_pairs(const float* __restrict__ vals, uint32_t x0,
                                                 uint32_t cnt, const int* __restrict__ inv,
                                                 const long long* g0, const long long* g,
                                                 KOf kof, uint32_t (&col)[ITEMS],
                                                 float (&sv)[ITEMS]) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const uint32_t k = kof(j);
    col[j] = 0;
    sv[j] = 0.0f;
    if (k < cnt) {
      if (inv) col[j] = (uint32_t)__ldg(inv + cs_udiv(x0 + k, g0, RP_DIV_SBLOCK));
      sv[j] = __ldg(vals + k);
    }
  }
  const uint32_t b = (uint32_t)g0[RP_SBLOCK];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const uint32_t k = kof(j);
    if (k < cnt) {
      const uint32_t x = x0 + k;
      // the scrambled position: inv[x div b] * b + x mod b
      const uint32_t i = inv ? col[j] * b + (x - cs_udiv(x, g0, RP_DIV_SBLOCK) * b) : x;
      if (cs_sign_hash(g, FAMILY, i) & 1u) sv[j] = -sv[j];
      col[j] = cs_col(g, FAMILY, i);
    } else {
      col[j] = 0xffffffffu;
    }
  }
}

// The small path: one block a row; sorted pairs in blocked order, then each
// column's run summed by its first thread.
template <int FAMILY, int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
    cs_segment_small_kernel(const float* __restrict__ vals, uint32_t x0, uint32_t n,
                            const int* __restrict__ inv, float* __restrict__ table,
                            uint32_t c_actual, int key_bits, const __grid_constant__ CsRows P) {
  using Sort = cub::BlockRadixSort<uint32_t, THREADS, ITEMS, float>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const long long* g = P.v[row];
  const uint32_t pad = (1u << key_bits) - 1;  // above every column: sorts last
  uint32_t key[ITEMS];
  float sv[ITEMS];
  // blocked: thread t holds values t * ITEMS + j, the leaf's order
  cs_segment_pairs<FAMILY, ITEMS>(vals, x0, n, inv, P.v[0], g,
                                  [&](int j) { return threadIdx.x * ITEMS + j; }, key, sv);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (key[j] == 0xffffffffu) key[j] = pad;
  Sort(*reinterpret_cast<typename Sort::TempStorage*>(smem)).Sort(key, sv, 0, key_bits);
  __syncthreads();  // the sort's storage becomes the sorted pairs
  uint32_t* skey = reinterpret_cast<uint32_t*>(smem);
  float* sval = reinterpret_cast<float*>(smem + 4 * THREADS * ITEMS);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    skey[threadIdx.x * ITEMS + j] = key[j];
    sval[threadIdx.x * ITEMS + j] = sv[j];
  }
  __syncthreads();
  // each run's first pair sums the run; the table reads are issued
  // together, then the writes
  float* trow = table + (size_t)row * c_actual;
  float s[ITEMS], t[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const uint32_t e = threadIdx.x * ITEMS + j;
    key[j] = e < n && (e == 0 || skey[e - 1] != skey[e]) ? skey[e] : pad;
    s[j] = -0.0f;
    if (key[j] != pad)
      for (uint32_t k = e; k < n && skey[k] == key[j]; ++k) s[j] += sval[k];
    if (__float_as_uint(s[j]) == kNegZero) key[j] = pad;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (key[j] != pad) t[j] = trow[key[j]];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (key[j] != pad) trow[key[j]] = t[j] + s[j];
}

// Dynamic shared memory of the small kernel: the sort's storage, then the
// sorted pairs in the same bytes.
template <int THREADS, int ITEMS>
static int cs_segment_small_smem() {
  const int sort = (int)sizeof(typename cub::BlockRadixSort<uint32_t, THREADS, ITEMS, float>::TempStorage);
  const int pairs = 8 * THREADS * ITEMS;
  return sort > pairs ? sort : pairs;
}

__host__ __device__ __forceinline__ uint32_t cs_scatter_smem(uint32_t ntiles) {
  return cs_align16(4 * kSegWarps * ntiles) + cs_align16(2 * kSegPiece) + 4 * kSegPiece;
}

// One (piece, row) of a window of rows [row0, row0 + g): the piece's pairs
// bucketed by tile, stable, to its piece-row pr = (row - row0) * np +
// piece of the scratch; starts[t * cap + pr] is the first pair of tile t
// in it, starts[ntiles * cap + pr] the piece's pairs (tile-major, so an
// owner reads its tile's starts of every piece in one run).
template <int FAMILY>
__global__ void __launch_bounds__(kSegThreads, 2)
    cs_segment_scatter_kernel(const float* __restrict__ vals, uint32_t x0, uint32_t wn,
                              const int* __restrict__ inv, uint16_t* __restrict__ keys,
                              float* __restrict__ svals, int* __restrict__ starts, uint32_t cap,
                              int tile_shift, uint32_t ntiles, int row0, int g, uint32_t np,
                              const __grid_constant__ CsRows P) {
  using Scan = cub::BlockScan<uint32_t, kSegThreads>;
  __shared__ typename Scan::TempStorage scan_temp;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* wbase = reinterpret_cast<uint32_t*>(smem);  // [warp][tile]: counts, then places
  uint16_t* skey = reinterpret_cast<uint16_t*>(smem + cs_align16(4 * kSegWarps * ntiles));
  float* sval = reinterpret_cast<float*>(smem + cs_align16(4 * kSegWarps * ntiles) +
                                         cs_align16(2 * kSegPiece));
  const int rg = blockIdx.x % g;
  const uint32_t piece = blockIdx.x / g;
  const size_t pr = (size_t)rg * np + piece;
  const uint32_t k0 = piece * kSegPiece;
  const uint32_t cnt = min((uint32_t)kSegPiece, wn - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t lt = (1u << lane) - 1;
  for (uint32_t t = threadIdx.x; t < kSegWarps * ntiles; t += kSegThreads) wbase[t] = 0;
  __syncthreads();
  // warp w holds values [w * 512, w * 512 + 512) of the piece, 32 a step
  uint32_t col[kSegItems];
  float sv[kSegItems];
  cs_segment_pairs<FAMILY, kSegItems>(
      vals + k0, x0 + k0, cnt, inv, P.v[0], P.v[row0 + rg],
      [&](int j) { return warp * (kSegItems * 32) + j * 32 + lane; }, col, sv);
#pragma unroll
  for (int j = 0; j < kSegItems; ++j)
    if (col[j] != 0xffffffffu) atomicAdd(&wbase[warp * ntiles + (col[j] >> tile_shift)], 1u);
  __syncthreads();
  // per tile: the warps' exclusive prefix, then the tiles' scan
  uint32_t tot[2], excl[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint32_t t = 2 * threadIdx.x + q;
    tot[q] = 0;
    if (t < ntiles) {
      for (int w = 0; w < kSegWarps; ++w) {
        const uint32_t c = wbase[w * ntiles + t];
        wbase[w * ntiles + t] = tot[q];
        tot[q] += c;
      }
    }
  }
  Scan(scan_temp).ExclusiveSum(tot, excl);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint32_t t = 2 * threadIdx.x + q;
    if (t < ntiles) {
      starts[(size_t)t * cap + pr] = (int)excl[q];
#pragma unroll
      for (int w = 0; w < kSegWarps; ++w) wbase[w * ntiles + t] += excl[q];
    }
  }
  if (threadIdx.x == 0) starts[(size_t)ntiles * cap + pr] = (int)cnt;
  __syncthreads();
  // each warp places its values in order: the lanes of one tile
  // (__match_any_sync) ranked by lane
  const uint32_t in_tile = (1u << tile_shift) - 1;
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    const bool ok = col[j] != 0xffffffffu;
    const uint32_t tile = ok ? col[j] >> tile_shift : 0xffffffffu;
    const uint32_t peers = __match_any_sync(0xffffffffu, tile);
    const uint32_t rank = __popc(peers & lt);
    if (ok) {
      const uint32_t pos = wbase[warp * ntiles + tile] + rank;
      skey[pos] = (uint16_t)(col[j] & in_tile);
      sval[pos] = sv[j];
    }
    __syncwarp();
    if (ok && rank == 0) wbase[warp * ntiles + tile] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  const size_t region = pr * kSegPiece;
  for (uint32_t e = threadIdx.x; e < cnt; e += kSegThreads) {
    keys[region + e] = skey[e];
    svals[region + e] = sval[e];
  }
}

// The owner block's stable sort of a sub-batch by bin: keys the bin,
// values the pair's place in the sub-batch.
static const int kOwnItems = kSegBatch / kOwnThreads;
using CsOwnerSort = cub::BlockRadixSort<uint32_t, kOwnThreads, kOwnItems, uint32_t>;

__host__ __device__ __forceinline__ uint32_t cs_owner_smem(int tile_shift, uint32_t np) {
  return cs_align16((uint32_t)sizeof(typename CsOwnerSort::TempStorage)) +
         cs_align16(4u << tile_shift) + 2 * cs_align16(4 * (np + 1)) +
         cs_align16(2 * kSegBatch) + cs_align16(4 * kSegBatch) + 2 * cs_align16(2 * kSegBatch) +
         4 * kOwnThreads;
}

// One (row, tile) of a window of rows [row0, row0 + g): its bucket, summed
// column by column in the leaf's order, added into the table.
__global__ void __launch_bounds__(kOwnThreads, 3)
    cs_segment_owner_kernel(const uint16_t* __restrict__ keys, const float* __restrict__ svals,
                            const int* __restrict__ starts, uint32_t cap, uint32_t np,
                            int tile_shift, uint32_t ntiles, int row0, float* __restrict__ table,
                            uint32_t c_actual) {
  using Scan = cub::BlockScan<uint32_t, kOwnThreads>;
  __shared__ typename Scan::TempStorage scan_temp;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t T = 1u << tile_shift;
  unsigned char* at = smem;
  auto& sort_temp = *reinterpret_cast<typename CsOwnerSort::TempStorage*>(at);
  at += cs_align16((uint32_t)sizeof(typename CsOwnerSort::TempStorage));
  float* acc = reinterpret_cast<float*>(at);  // the tile's sums
  at += cs_align16(4 * T);
  uint32_t* runa = reinterpret_cast<uint32_t*>(at);  // the run's start in each piece-row
  at += cs_align16(4 * (np + 1));
  uint32_t* offs = reinterpret_cast<uint32_t*>(at);  // the run's start in the bucket
  at += cs_align16(4 * (np + 1));
  uint16_t* stash_key = reinterpret_cast<uint16_t*>(at);  // the sub-batch, in its order
  at += cs_align16(2 * kSegBatch);
  float* stash_val = reinterpret_cast<float*>(at);
  at += cs_align16(4 * kSegBatch);
  uint16_t* order = reinterpret_cast<uint16_t*>(at);  // its places sorted by bin
  at += cs_align16(2 * kSegBatch);
  uint16_t* piece_of = reinterpret_cast<uint16_t*>(at);  // each place's piece
  at += cs_align16(2 * kSegBatch);
  uint32_t* hist = reinterpret_cast<uint32_t*>(at);  // pairs a bin
  const uint32_t rg = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const size_t pr0 = (size_t)rg * np;

  // the bucket: each piece's run of this tile, in piece order
  uint32_t cnt[kSegRuns], excl[kSegRuns], total;
#pragma unroll
  for (int q = 0; q < kSegRuns; ++q) {
    const uint32_t p = kSegRuns * threadIdx.x + q;
    cnt[q] = 0;
    if (p < np) {
      const uint32_t a = (uint32_t)__ldg(starts + (size_t)tile * cap + pr0 + p);
      runa[p] = a;
      cnt[q] = (uint32_t)__ldg(starts + (size_t)(tile + 1) * cap + pr0 + p) - a;
    }
  }
  Scan(scan_temp).ExclusiveSum(cnt, excl, total);
  if (total == 0) return;  // the block aggregate: the same in every thread
#pragma unroll
  for (int q = 0; q < kSegRuns; ++q)
    if (kSegRuns * threadIdx.x + q < np) offs[kSegRuns * threadIdx.x + q] = excl[q];
  if (threadIdx.x == 0) offs[np] = total;
  for (uint32_t c = threadIdx.x; c < T; c += kOwnThreads) acc[c] = -0.0f;
  const int bshift = tile_shift - 8;  // thread t owns the T / 256 columns of bin t
  for (uint32_t s0 = 0; s0 < total; s0 += kSegBatch) {
    const uint32_t nb = min((uint32_t)kSegBatch, total - s0);
    hist[threadIdx.x] = 0;
    __syncthreads();  // offs, hist, and the previous sub-batch is done
    // gather, blocked: thread t takes places [8 t, 8 t + 8) of the
    // sub-batch; a pair's piece is the last whose run starts at or before
    // it, searched once and then walked forward
    // the piece of each place of the sub-batch, from the runs that meet it
    for (uint32_t p = threadIdx.x; p < np; p += kOwnThreads) {
      const uint32_t a = max(offs[p], s0), b = min(offs[p + 1], s0 + nb);
      for (uint32_t e = a; e < b; ++e) piece_of[e - s0] = (uint16_t)p;
    }
    __syncthreads();
    // gather, striped (thread t: places t, t + 256, ...), so a warp's loads
    // are neighbours; every load in flight before any is used
    {
      uint16_t key[kOwnItems];
      float val[kOwnItems];
#pragma unroll
      for (int j = 0; j < kOwnItems; ++j) {
        const uint32_t e = threadIdx.x + j * kOwnThreads;
        size_t a = 0;
        if (e < nb) {
          const uint32_t p = piece_of[e];
          a = (pr0 + p) * kSegPiece + runa[p] + (s0 + e - offs[p]);
        }
        key[j] = keys[a];
        val[j] = svals[a];
      }
#pragma unroll
      for (int j = 0; j < kOwnItems; ++j) {
        const uint32_t e = threadIdx.x + j * kOwnThreads;
        if (e < nb) {
          stash_key[e] = key[j];
          stash_val[e] = val[j];
        }
      }
    }
    __syncthreads();
    // blocked for the sort (thread t: places [8 t, 8 t + 8)), the bins counted
    uint32_t bin[kOwnItems], place[kOwnItems];
#pragma unroll
    for (int j = 0; j < kOwnItems; ++j) {
      place[j] = threadIdx.x * kOwnItems + j;
      bin[j] = 255;  // the last bin: a pad sorts after every pair
      if (place[j] < nb) {
        bin[j] = (uint32_t)stash_key[place[j]] >> bshift;
        atomicAdd(&hist[bin[j]], 1u);  // a count: the order does not matter
      }
    }
    __syncthreads();
    uint32_t first;
    const uint32_t mine = hist[threadIdx.x];
    Scan(scan_temp).ExclusiveSum(mine, first);
    // the stable sort by bin: bin t's places are order[first, first + mine)
    CsOwnerSort(sort_temp).Sort(bin, place, 0, 8);
#pragma unroll
    for (int j = 0; j < kOwnItems; ++j) order[threadIdx.x * kOwnItems + j] = (uint16_t)place[j];
    __syncthreads();
    // thread t adds the pairs of bin t in order: it alone owns their
    // columns; the next pair is loaded while this one is added
    if (mine) {
      uint32_t p = order[first], k = stash_key[p];
      float v = stash_val[p];
      for (uint32_t e = first + 1; e < first + mine; ++e) {
        p = order[e];
        const uint32_t kn = stash_key[p];
        const float vn = stash_val[p];
        acc[k] += v;
        k = kn;
        v = vn;
      }
      acc[k] += v;
    }
  }
  __syncthreads();
  // the touched sums into the table: four columns a thread and step, the
  // table read as float4 (16-byte aligned: c_actual and T are multiples of
  // 8) and each touched entry written alone; two steps' reads in flight
  const uint32_t j0 = tile << tile_shift;
  const uint32_t n4 = min(T, c_actual - j0) / 4;
  float* trow = table + (size_t)(row0 + rg) * c_actual + j0;
  const float4* acc4 = reinterpret_cast<const float4*>(acc);
  const float4* t4 = reinterpret_cast<const float4*>(trow);
  for (uint32_t c0 = threadIdx.x; c0 < n4; c0 += 2 * kOwnThreads) {
    float4 a[2], t[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t c = c0 + u * kOwnThreads;
      a[u] = c < n4 ? acc4[c] : make_float4(-0.0f, -0.0f, -0.0f, -0.0f);
      if (cs_touched(a[u])) t[u] = t4[c];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!cs_touched(a[u])) continue;
      float* o = trow + 4 * (c0 + u * kOwnThreads);
      if (__float_as_uint(a[u].x) != kNegZero) o[0] = t[u].x + a[u].x;
      if (__float_as_uint(a[u].y) != kNegZero) o[1] = t[u].y + a[u].y;
      if (__float_as_uint(a[u].z) != kNegZero) o[2] = t[u].z + a[u].z;
      if (__float_as_uint(a[u].w) != kNegZero) o[3] = t[u].w + a[u].w;
    }
  }
}

// Raise fn's dynamic shared-memory limit to at least `bytes` on the current
// device, once: the limits set so far are kept per (kernel, device).
template <typename Kernel>
static cudaError_t cs_raise_smem(Kernel* fn, int bytes) {
  struct Entry {
    const void* fn;
    int dev, bytes;
  };
  static std::mutex mu;
  static Entry cache[32];
  static int n = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  Entry* hit = nullptr;
  for (int k = 0; k < n; ++k)
    if (cache[k].fn == (const void*)fn && cache[k].dev == dev) hit = &cache[k];
  if (hit != nullptr && hit->bytes >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  if (hit != nullptr) {
    hit->bytes = bytes;
  } else if (n < 32) {
    cache[n++] = Entry{(const void*)fn, dev, bytes};
  }
  return cudaSuccess;
}

extern "C" {

// The n values at original coordinates [offset, offset + n) added into the
// f32 table in place. inv_perm: the inverse block permutation (original
// block -> scrambled block; null: no scramble). scratch: the wrapper's
// fixed buffer of `capacity` piece-rows with tile starts for up to
// `max_tiles` tiles (index_math.segment_scratch_bytes lays it out: uint16
// columns in the tile, f32 signed values, int32 tile starts); shifts[g - 1]
// is the tile shift when g rows go together (index_math.segment_shifts);
// the windows are index_math.segment_windows's.
int cs_sketch_segment(const float* vals, long long offset, long long n, const int* inv_perm,
                      void* scratch, long long capacity, long long max_tiles, const int* shifts,
                      float* table, long long c_actual, const long long* rows, int r, int family,
                      void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  const uint32_t c = (uint32_t)c_actual;
  if (n <= kSegPiece) {
    const int key_bits = 32 - __builtin_clz(c);
#define CS_SMALL(F, TH, IT)                                                                     \
  {                                                                                             \
    const int smem = cs_segment_small_smem<TH, IT>();                                           \
    e = cs_raise_smem(cs_segment_small_kernel<F, TH, IT>, smem);                                \
    if (e != cudaSuccess) return (int)e;                                                        \
    cs_segment_small_kernel<F, TH, IT><<<r, TH, smem, st>>>(vals, (uint32_t)offset, (uint32_t)n, \
                                                            inv_perm, table, c, key_bits, P);   \
  }
    if (n <= 256) {
      if (family) CS_SMALL(1, 64, 4) else CS_SMALL(0, 64, 4)
    } else if (n <= 1024) {
      if (family) CS_SMALL(1, 256, 4) else CS_SMALL(0, 256, 4)
    } else {
      if (family) CS_SMALL(1, kSegThreads, kSegItems) else CS_SMALL(0, kSegThreads, kSegItems)
    }
#undef CS_SMALL
    return (int)cudaGetLastError();
  }
  if (capacity < 1 || capacity > kSegMaxPieces || max_tiles > kSegMaxTiles)
    return (int)cudaErrorInvalidValue;
  const size_t pairs = (size_t)capacity * kSegPiece;
  uint16_t* keys = (uint16_t*)scratch;
  float* svals = (float*)((char*)scratch + 2 * pairs);
  int* starts = (int*)((char*)scratch + 6 * pairs);
  // index_math.segment_windows: the rows in as few, as even groups as
  // hold the whole leaf, else each row alone in windows of `capacity`
  // pieces
  const long long pieces = (n + kSegPiece - 1) / kSegPiece;
  const int most = (int)(capacity / pieces < r ? capacity / pieces : r);
  const int g = most ? (r + (r + most - 1) / most - 1) / ((r + most - 1) / most) : 0;
  const long long wmax = g ? n : capacity * kSegPiece;
  for (int row0 = 0; row0 < r; row0 += g ? g : 1) {
    const int rows_g = g ? (r - row0 < g ? r - row0 : g) : 1;
    const int shift = shifts[rows_g - 1];
    if (shift < 8 || shift > 13) return (int)cudaErrorInvalidValue;
    const uint32_t ntiles = (c + (1u << shift) - 1) >> shift;
    if (ntiles > (uint32_t)max_tiles) return (int)cudaErrorInvalidValue;
    for (long long k0 = 0; k0 < n; k0 += wmax) {
      const uint32_t wn = (uint32_t)(n - k0 < wmax ? n - k0 : wmax);
      const uint32_t np = (wn + kSegPiece - 1) / kSegPiece;
      const int smem_s = (int)cs_scatter_smem(ntiles);
      const int smem_o = (int)cs_owner_smem(shift, np);
      const uint32_t cap = (uint32_t)capacity;
      auto scatter = family ? cs_segment_scatter_kernel<1> : cs_segment_scatter_kernel<0>;
      e = cs_raise_smem(scatter, smem_s);
      if (e == cudaSuccess) e = cs_raise_smem(cs_segment_owner_kernel, smem_o);
      if (e != cudaSuccess) return (int)e;
      scatter<<<np * rows_g, kSegThreads, smem_s, st>>>(
          vals + k0, (uint32_t)(offset + k0), wn, inv_perm, keys, svals, starts, cap, shift,
          ntiles, row0, rows_g, np, P);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      cs_segment_owner_kernel<<<rows_g * ntiles, kOwnThreads, smem_o, st>>>(
          keys, svals, starts, cap, np, shift, ntiles, row0, table, c);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

}  // extern "C"
