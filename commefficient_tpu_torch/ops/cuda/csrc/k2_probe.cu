// Attribution variants of K2 for ops/cuda/k2_attribution.py. Not part of the
// kernels' library and not on any training path. r = 5; the row constants,
// the divisions by multiplier, the median network and the persistent grid
// are the library's (common.cuh).
//
// k2_old_kernel: K2 as it stood before its redesign (fmix32): one thread per
// scrambled position in 256-thread blocks, hardware divisions, the slot and
// sign hashes in the kernel, the [d_eff] output in scrambled order (a torch
// gather unscrambles it afterwards).
//
// k2_walk_kernel<MODE>: the redesign's walk (persistent 1024-thread blocks
// over tiles of consecutive scrambled positions; the table windows of the
// rows that the host lists are staged in shared memory per tile), with each
// of its other cuts behind a MODE bit:
//   1  divisions by the host's multipliers, and by m as a shift (m is a
//      power of two at the geometry timed); else hardware / and %;
//   2  slot tables in shared memory as uint16; else the slot hash and mod V;
//   4  packed sign bits; else the sign hash;
//   8  the unscramble fused: out[x] for x < d in original order; else
//      out[i] for every scrambled i < d_eff;
//  16  read a fixed column of each row instead of the computed one (the
//      column is still computed and kept live): no table traffic. The host
//      stages no window with it;
//  32  the library's per-tile work: each row's (i0 div G, i0 mod G) and
//      the scramble blocks' offsets x - i computed once per tile, and rows
//      0 and 1 staged as a compile-time choice (the host stages exactly
//      those two);
//  64  the hashes that bits 2 and 4 leave in the kernel are poly4's, not
//      fmix32's.

#include "common.cuh"
#include "hash.cuh"

#define PR_R 5

static const int kProbeThreads = 1024;

__global__ void k2_old_kernel(const float* __restrict__ table, long long c_actual,
                              float* __restrict__ out, uint32_t d_eff,
                              const __grid_constant__ CsRows P) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d_eff) return;
  float e[PR_R];
#pragma unroll
  for (int row = 0; row < PR_R; ++row) {
    const long long* g = P.v[row];
    const uint32_t f = (uint32_t)g[RP_F], G = (uint32_t)g[RP_G], m = (uint32_t)g[RP_M];
    const uint32_t p = (i % G) * f + i / G;
    const uint32_t h = cs_mix32(p % m, (uint32_t)g[RP_KEY_SLOT]);
    const long long col = (long long)(p / m) * g[RP_S] + h % (uint32_t)g[RP_V];
    const float sign = (cs_mix32(i, (uint32_t)g[RP_KEY_SIGN]) & 1u) ? -1.0f : 1.0f;
    e[row] = __ldg(table + row * c_actual + col) * sign;
  }
  out[i] = cs_median<PR_R>(e);
}

template <int MODE>
__global__ void __launch_bounds__(kProbeThreads, 2)
    k2_walk_kernel(const float* __restrict__ table, uint32_t c_actual, float* __restrict__ out,
                   uint32_t d, uint32_t d_eff, const int* __restrict__ perm, uint32_t b,
                   const int* __restrict__ slots, uint32_t m, int m_shift,
                   const uint32_t* __restrict__ signs, uint32_t nw, uint32_t per_tile,
                   uint32_t ntiles, const int* __restrict__ wstart, const CsWindows W,
                   const __grid_constant__ CsRows P) {
  constexpr bool LEAN = (MODE & 32) != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wbase[PR_R];
  __shared__ uint2 rif[PR_R];
  const uint32_t per_block = per_tile / b;
  uint16_t* slot_s = reinterpret_cast<uint16_t*>(smem);
  uint32_t* xoff = reinterpret_cast<uint32_t*>(smem + ((MODE & 2) ? ((2 * PR_R * m + 15u) & ~15u) : 0));
  float* win = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(xoff) +
                                        (LEAN ? ((4 * per_block + 15u) & ~15u) : 0));
  if constexpr ((MODE & 2) != 0) {
    for (uint32_t t = threadIdx.x; t < PR_R * m; t += kProbeThreads) slot_s[t] = (uint16_t)__ldg(slots + t);
  }
  for (uint32_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const uint32_t i0 = tile * per_tile;
    __syncthreads();
#pragma unroll
    for (int row = 0; row < PR_R; ++row) {
      if (LEAN ? row < 2 : W.wlen[row] != 0) {
        const uint32_t w0 = (uint32_t)__ldg(wstart + (size_t)tile * PR_R + row);
        const float* trow = table + (size_t)row * c_actual;
        for (int c = threadIdx.x; c < W.wlen[row]; c += kProbeThreads)
          win[W.woff[row] + c] = w0 + c < c_actual ? __ldg(trow + w0 + c) : 0.0f;
        if (threadIdx.x == 0) wbase[row] = W.woff[row] - (int)w0;
      }
    }
    if constexpr (LEAN) {
      if (threadIdx.x < PR_R) {
        const long long* g = P.v[threadIdx.x];
        const uint32_t hi = cs_udiv(i0, g, RP_DIV_G);
        rif[threadIdx.x] = make_uint2(hi, i0 - hi * (uint32_t)g[RP_G]);
      }
      const uint32_t sb0 = tile * per_block;
      const uint32_t n = min(per_block, d_eff / b - sb0);
      for (uint32_t j = threadIdx.x; j < n; j += kProbeThreads)
        xoff[j] = ((uint32_t)__ldg(perm + sb0 + j) - (sb0 + j)) * b;
    }
    __syncthreads();
    const uint32_t i_end = d_eff - i0 < per_tile ? d_eff : i0 + per_tile;
#pragma unroll 1
    for (uint32_t i = i0 + threadIdx.x; i < i_end; i += kProbeThreads) {
      const uint32_t k = i - i0;
      uint32_t x = i;
      if ((MODE & 8) && perm) {
        if constexpr (LEAN) {
          x = i + xoff[k >> (__ffs(b) - 1)];  // b a power of two here
        } else {
          const uint32_t sb = (MODE & 1) ? cs_udiv(i, P.v[0], RP_DIV_SBLOCK) : i / b;
          x = (uint32_t)__ldg(perm + sb) * b + (i - sb * b);
        }
      }
      if ((MODE & 8) && x >= d) continue;
      float e[PR_R];
#pragma unroll
      for (int row = 0; row < PR_R; ++row) {
        const long long* g = P.v[row];
        const uint32_t f = (uint32_t)g[RP_F], G = (uint32_t)g[RP_G];
        uint32_t q, o;
        if constexpr (LEAN) {
          const uint2 t = rif[row];
          uint32_t hi = t.x, r = t.y + k;
          if (r >= G) {
            hi = cs_udiv(i, g, RP_DIV_G);
            r = i - hi * G;
          }
          const uint32_t p = r * f + hi;
          q = p >> m_shift;
          o = p & (m - 1);
        } else if constexpr ((MODE & 1) != 0) {
          const uint32_t hi = cs_udiv(i, g, RP_DIV_G);
          const uint32_t p = (i - hi * G) * f + hi;
          q = p >> m_shift;
          o = p & (m - 1);
        } else {
          const uint32_t p = (i % G) * f + i / G;
          q = p / m;
          o = p % m;
        }
        uint32_t slot;
        if constexpr ((MODE & 2) != 0) {
          slot = slot_s[row * m + o];
        } else {
          const uint32_t h = (MODE & 64) ? cs_poly4(o, g + RP_CSLOT)
                                         : cs_mix32(o, (uint32_t)g[RP_KEY_SLOT]);
          const uint32_t V = (uint32_t)g[RP_V];
          slot = (MODE & 1) ? h - cs_udiv(h, g, RP_DIV_V) * V : h % V;
        }
        uint32_t col = q * (uint32_t)g[RP_S] + slot;
        // with bit 16, column 0 of the table or of the window; col kept live
        if constexpr ((MODE & 16) != 0) col = col > 4 * c_actual ? col : 0;
        const bool staged = LEAN ? row < 2 : W.wlen[row] != 0;
        const float v =
            staged ? win[((MODE & 16) ? W.woff[row] : wbase[row]) + (int)col]
                   : __ldg(table + (size_t)row * c_actual + col);
        bool neg;
        if constexpr ((MODE & 4) != 0) {
          neg = (__ldg(signs + (size_t)row * nw + (i >> 5)) >> (i & 31u)) & 1u;
        } else {
          neg = ((MODE & 64) ? cs_poly4(i, g + RP_CSIGN) : cs_mix32(i, (uint32_t)g[RP_KEY_SIGN])) & 1u;
        }
        e[row] = v * (neg ? -1.0f : 1.0f);
      }
      out[(MODE & 8) ? x : i] = cs_median<PR_R>(e);
    }
  }
}

extern "C" {

int k2_probe_old(const float* table, long long c_actual, float* out, long long d_eff,
                 const long long* rows, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, PR_R);
  if (rc) return rc;
  const unsigned blocks = (unsigned)((d_eff + 255) / 256);
  k2_old_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(table, c_actual, out, (uint32_t)d_eff, P);
  return (int)cudaGetLastError();
}

int k2_probe_walk(int mode, const float* table, long long c_actual, float* out, long long d,
                  long long d_eff, const int* perm, long long b, const int* slots, long long m,
                  const int* signs, long long nw, long long per_tile, long long ntiles,
                  const int* wstart, const int* woff, const int* wlen, const long long* rows,
                  void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, PR_R);
  if (rc) return rc;
  CsWindows W;
  memset(&W, 0, sizeof(W));
  int wfloats = 0;
  for (int row = 0; row < PR_R; ++row) {
    W.woff[row] = woff[row];
    W.wlen[row] = wlen[row];
    if (woff[row] + wlen[row] > wfloats) wfloats = woff[row] + wlen[row];
  }
  const uint32_t mm = (uint32_t)m;
  if (mm & (mm - 1)) return (int)cudaErrorInvalidValue;  // m a power of two here
  const uint32_t per_block = (uint32_t)(per_tile / b);
  if ((mode & 32) && (!perm || (b & (b - 1)) || wlen[0] == 0 || wlen[1] == 0 || wlen[2] ||
                      wlen[3] || wlen[4]))
    return (int)cudaErrorInvalidValue;  // lean: scrambled, b a power of two, rows 0-1 staged
  const int smem = ((mode & 2) ? (int)((2 * PR_R * mm + 15u) & ~15u) : 0) +
                   ((mode & 32) ? (int)((4 * per_block + 15u) & ~15u) : 0) + 4 * wfloats;
  cudaStream_t st = (cudaStream_t)stream;
  long long grid = 0;
  cudaError_t e = cudaSuccess;
#define K2P(MODE)                                                                             \
  e = cs_persistent_grid(k2_walk_kernel<MODE>, kProbeThreads, smem, &grid);                   \
  if (e != cudaSuccess) return (int)e;                                                        \
  k2_walk_kernel<MODE><<<(unsigned)(grid < ntiles ? grid : ntiles), kProbeThreads, smem,      \
                         st>>>(table, (uint32_t)c_actual, out, (uint32_t)d, (uint32_t)d_eff,  \
                               perm, (uint32_t)b, slots, mm, __builtin_ctz(mm),               \
                               (const uint32_t*)signs, (uint32_t)nw, (uint32_t)per_tile,      \
                               (uint32_t)ntiles, wstart, W, P)
  switch (mode) {
    case 0: K2P(0); break;
    case 1: K2P(1); break;
    case 3: K2P(3); break;
    case 7: K2P(7); break;
    case 11: K2P(11); break;
    case 13: K2P(13); break;
    case 15: K2P(15); break;
    case 31: K2P(31); break;
    case 43: K2P(43); break;
    case 47: K2P(47); break;
    case 63: K2P(63); break;
    case 107: K2P(107); break;
    case 109: K2P(109); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2P
  return (int)cudaGetLastError();
}

}  // extern "C"
