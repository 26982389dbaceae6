// Attribution variants of K1's tile kernel for ops/cuda/k1_attribution.py.
// Not part of the kernels' library and not on any training path. The f32
// form of countsketch.cu's cs_sketch_tiles_kernel (the design ResNet-9
// takes, beside riffle.cu's chunk design), with each part of a chunk step
// behind a MODE bit:
//   1  no load: each staged slot takes 1.0f, with no read of v and no sign
//      hash (the staging stores, ranges and barriers stay);
//   2  no sign hash: values are loaded and staged unsigned;
//   4  no summation: the columns' runs of the stage are not added (the
//      barriers and the accumulators' final store stay).
// MODE 0 is the library's tile kernel. k1_probe_occupancy gives the
// blocks per multiprocessor of a variant at a dynamic shared-memory size.
//
// k1_chunk_probe_kernel<MODE>: riffle.cu's chunk sums (f32, KG = 6, rows
// past the first only, from a riffled copy the caller made), with
//   4  no summation (the copies, the waits and the barriers stay);
//   8  no copy: every chunk step sums a buffer that holds stale values;
// which splits the chunk sums into the copies and the summation.

#include "layout.cuh"

static const int kProbeThreadsK1 = 512;

template <int E, int MODE>
__device__ __forceinline__ void k1p_load(const float* __restrict__ v_s, uint32_t d_eff,
                                         const long long* g, int family, uint32_t q,
                                         const uint32_t* rj, const uint32_t* pos, uint32_t e_lo,
                                         uint32_t e_hi, float* v, uint32_t& neg) {
  const uint32_t f = (uint32_t)g[RP_F], G = (uint32_t)g[RP_G], m = (uint32_t)g[RP_M];
  const uint32_t P0 = q * m;
  const uint32_t c0 = cs_udiv(P0, g, RP_DIV_F);
  const uint32_t a0 = P0 - c0 * f;
  neg = 0;
#pragma unroll
  for (int x = 0; x < E; ++x) {
    v[x] = 0.0f;
    if (pos[x] >= e_lo && pos[x] < e_hi) {
      if constexpr ((MODE & 1) != 0) {
        v[x] = 1.0f;
      } else {
        uint32_t a = a0 + (rj[x] & 0xffffu), cw = c0;
        if (a >= f) {
          a -= f;
          cw += 1;
        }
        const uint32_t i = a * G + cw + (rj[x] >> 16);
        if (i < d_eff) {
          v[x] = __ldg(v_s + i);
          if constexpr ((MODE & 2) == 0) neg |= (cs_sign_hash(g, family, i) & 1u) << x;
        }
      }
    }
  }
}

template <int E, int MODE>
__global__ void __launch_bounds__(kProbeThreadsK1, E <= 8 ? 2 : 1)
    k1_probe_kernel(const float* __restrict__ v_s, uint32_t d_eff, const int* __restrict__ csr_ptr,
                    const int* __restrict__ csr_off, float* __restrict__ table, uint32_t c_actual,
                    const __grid_constant__ CsRows P, int family, uint32_t W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.y;
  const long long* g = P.v[row];
  const uint32_t s = (uint32_t)g[RP_S], V = (uint32_t)g[RP_V], nc = (uint32_t)g[RP_NC];
  const uint32_t m = (uint32_t)g[RP_M], f = (uint32_t)g[RP_F];
  const uint32_t j0 = blockIdx.x * W * s;
  if (j0 >= c_actual) return;
  const uint32_t ncols = min(W * s, c_actual - j0);
  float* out = table + (size_t)row * c_actual + j0;
  uint16_t* ptr_s = reinterpret_cast<uint16_t*>(smem);
  float* stage = reinterpret_cast<float*>(smem + cs_align16(2 * (V + 4)));
  float4* acc = reinterpret_cast<float4*>(smem + cs_align16(2 * (V + 4)) + cs_align16(4 * m));
  const uint32_t ngroups = ncols / 4;
  for (uint32_t c4 = threadIdx.x; c4 < ngroups; c4 += kProbeThreadsK1)
    acc[c4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const uint32_t q_hi = min(nc - 1, cs_udiv(j0 + ncols - 1, g, RP_DIV_S));
  const uint32_t q_lo = j0 + 1 <= V ? 0 : cs_udiv(j0 + s - V, g, RP_DIV_S);
  if (q_lo <= q_hi) {
    uint16_t* pos_s = reinterpret_cast<uint16_t*>(stage);
    const int* ptr_g = csr_ptr + g[RP_PTR];
    const int* off_g = csr_off + g[RP_OFF];
    for (uint32_t t = threadIdx.x; t <= V; t += kProbeThreadsK1) ptr_s[t] = (uint16_t)__ldg(ptr_g + t);
    for (uint32_t e = threadIdx.x; e < m; e += kProbeThreadsK1) pos_s[__ldg(off_g + e)] = (uint16_t)e;
    __syncthreads();
    const uint32_t mq = m / f, mr = m - mq * f, nbig = mr * (mq + 1);
    uint32_t rj[E];
    uint32_t pos[E];
#pragma unroll
    for (int x = 0; x < E; ++x) {
      const uint32_t k = threadIdx.x + x * kProbeThreadsK1;
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
    auto range = [&](uint32_t q, uint32_t& e_lo, uint32_t& e_hi) {
      const uint32_t w0 = q * s;
      e_lo = ptr_s[w0 < j0 ? j0 - w0 : 0];
      e_hi = ptr_s[min(V, j0 + ncols - w0)];
    };
    uint32_t e_lo, e_hi;
    range(q_lo, e_lo, e_hi);
    __syncthreads();
    float v[E];
    uint32_t neg;
    k1p_load<E, MODE>(v_s, d_eff, g, family, q_lo, rj, pos, e_lo, e_hi, v, neg);
    for (uint32_t q = q_lo; q <= q_hi; ++q) {
#pragma unroll
      for (int x = 0; x < E; ++x)
        if (pos[x] >= e_lo && pos[x] < e_hi) stage[pos[x]] = ((neg >> x) & 1u) ? -v[x] : v[x];
      __syncthreads();
      const uint32_t w0 = q * s;
      const uint32_t g_lo = (w0 > j0 ? w0 - j0 : 0) / 4;
      const uint32_t g_hi = min(ncols, w0 + V - j0) / 4;
      if (q < q_hi) {
        range(q + 1, e_lo, e_hi);
        k1p_load<E, MODE>(v_s, d_eff, g, family, q + 1, rj, pos, e_lo, e_hi, v, neg);
      }
      if constexpr ((MODE & 4) == 0) {
        for (uint32_t c4 = g_lo + ((threadIdx.x - g_lo) & (kProbeThreadsK1 - 1)); c4 < g_hi;
             c4 += kProbeThreadsK1) {
          const uint32_t t = j0 + 4 * c4 - w0;
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
      }
      __syncthreads();
    }
  }
  for (uint32_t c4 = threadIdx.x; c4 < ngroups; c4 += kProbeThreadsK1)
    reinterpret_cast<float4*>(out)[c4] = acc[c4];
}

__device__ __forceinline__ void k1c_cp_async16(void* dst, const void* src, uint32_t bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

template <int MODE>
__device__ __forceinline__ void k1c_chunk(float* buf, const float* src, uint32_t q, uint32_t m) {
  if constexpr ((MODE & 8) == 0) {
    for (uint32_t k = 4 * threadIdx.x; k < m; k += 4 * kProbeThreadsK1)
      k1c_cp_async16(buf + k, src + q * m + k, 16);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int MODE>
__global__ void __launch_bounds__(kProbeThreadsK1, 2)
    k1_chunk_probe_kernel(const float* __restrict__ riffled, size_t pitch,
                          const int* __restrict__ csr_ptr, const int* __restrict__ csr_off,
                          float* __restrict__ table, uint32_t c_actual,
                          const __grid_constant__ CsRows P, uint32_t W) {
  constexpr int KG = 6;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.y + 1;
  const long long* g = P.v[row];
  const uint32_t s = (uint32_t)g[RP_S], V = (uint32_t)g[RP_V], nc = (uint32_t)g[RP_NC];
  const uint32_t m = (uint32_t)g[RP_M];
  const uint32_t j0 = blockIdx.x * W * s;
  if (j0 >= c_actual) return;
  const uint32_t ncols = min(W * s, c_actual - j0);
  float* out = table + (size_t)blockIdx.y * c_actual + j0;
  uint16_t* ptr_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* off_s = reinterpret_cast<uint16_t*>(smem + cs_align16(2 * (V + 4)));
  float* buf0 = reinterpret_cast<float*>(smem + cs_align16(2 * (V + 4)) + cs_align16(2 * m));
  float* buf1 = buf0 + cs_align16(4 * m) / 4;
  const uint32_t ngroups = ncols / 4;
  float4 acc[KG];
#pragma unroll
  for (int k = 0; k < KG; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const uint32_t q_hi = min(nc - 1, cs_udiv(j0 + ncols - 1, g, RP_DIV_S));
  const uint32_t q_lo = j0 + 1 <= V ? 0 : cs_udiv(j0 + s - V, g, RP_DIV_S);
  if (q_lo <= q_hi) {
    const float* src = riffled + (size_t)(row - 1) * pitch;
    k1c_chunk<MODE>(buf0, src, q_lo, m);
    const int* ptr_g = csr_ptr + g[RP_PTR];
    const int* off_g = csr_off + g[RP_OFF];
    for (uint32_t t = threadIdx.x; t <= V; t += kProbeThreadsK1) ptr_s[t] = (uint16_t)__ldg(ptr_g + t);
    for (uint32_t e = threadIdx.x; e < m; e += kProbeThreadsK1) off_s[e] = (uint16_t)__ldg(off_g + e);
    for (uint32_t q = q_lo; q <= q_hi; ++q) {
      float* cur = ((q - q_lo) & 1u) ? buf1 : buf0;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      if (q < q_hi) k1c_chunk<MODE>(((q - q_lo) & 1u) ? buf0 : buf1, src, q + 1, m);
      __syncthreads();
      const uint32_t w0 = q * s;
      const uint32_t g_lo = (w0 > j0 ? w0 - j0 : 0) / 4;
      const uint32_t g_hi = min(ncols, w0 + V - j0) / 4;
      if constexpr ((MODE & 4) == 0) {
#pragma unroll
        for (int k = 0; k < KG; ++k) {
          const uint32_t c4 = threadIdx.x + k * kProbeThreadsK1;
          if (c4 < g_lo || c4 >= g_hi) continue;
          const uint32_t t = j0 + 4 * c4 - w0;
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
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    const uint32_t c4 = threadIdx.x + k * kProbeThreadsK1;
    if (c4 < ngroups) reinterpret_cast<float4*>(out)[c4] = acc[k];
  }
}

extern "C" {

// riffle.cu's chunk sums of rows 1..r-1 (f32) from the caller's riffled
// copy, variant `mode` (0, 4 or 8), into table [r - 1, c_actual].
int k1_chunk_probe(int mode, const float* riffled, long long pitch, const int* csr_ptr,
                   const int* csr_off, float* table, long long c_actual, const long long* rows,
                   int r, int W, int smem, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  long long tiles = 0;
  for (int row = 1; row < r; ++row) {
    const long long cols = (long long)W * P.v[row][RP_S];
    if (cols > 6ll * 4 * kProbeThreadsK1) return (int)cudaErrorInvalidValue;
    const long long t = (c_actual + cols - 1) / cols;
    if (t > tiles) tiles = t;
  }
  const dim3 grid((unsigned)tiles, (unsigned)(r - 1));
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define K1C_LAUNCH(MM)                                                                        \
  if (mode == MM) {                                                                           \
    e = cudaFuncSetAttribute(k1_chunk_probe_kernel<MM>,                                       \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);              \
    if (e != cudaSuccess) return (int)e;                                                      \
    k1_chunk_probe_kernel<MM><<<grid, kProbeThreadsK1, smem, st>>>(                           \
        riffled, (size_t)pitch, csr_ptr, csr_off, table, (uint32_t)c_actual, P, (uint32_t)W); \
    return (int)cudaGetLastError();                                                           \
  }
  K1C_LAUNCH(0)
  K1C_LAUNCH(4)
  K1C_LAUNCH(8)
#undef K1C_LAUNCH
  return (int)cudaErrorInvalidValue;
}

#define K1P_MODES(X, E) X(E, 0) X(E, 1) X(E, 2) X(E, 4) X(E, 5)

// The tile kernel's variant `mode` at E = `per` values a thread over all r
// rows, tile width W strides, `smem` bytes of dynamic shared memory.
int k1_probe(int mode, int per, const float* v_s, long long d_eff, const int* csr_ptr,
             const int* csr_off, float* table, long long c_actual, const long long* rows, int r,
             int family, int W, int smem, void* stream) {
  CsRows P;
  const int rc = cs_load_rows(&P, rows, r);
  if (rc) return rc;
  long long tiles = 0;
  for (int row = 0; row < r; ++row) {
    const long long cols = (long long)W * P.v[row][RP_S];
    const long long t = (c_actual + cols - 1) / cols;
    if (t > tiles) tiles = t;
  }
  const dim3 grid((unsigned)tiles, (unsigned)r);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define K1P_LAUNCH(EE, MM)                                                                   \
  if (per == EE && mode == MM) {                                                             \
    e = cudaFuncSetAttribute(k1_probe_kernel<EE, MM>,                                        \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);             \
    if (e != cudaSuccess) return (int)e;                                                     \
    k1_probe_kernel<EE, MM><<<grid, kProbeThreadsK1, smem, st>>>(                            \
        v_s, (uint32_t)d_eff, csr_ptr, csr_off, table, (uint32_t)c_actual, P, family,        \
        (uint32_t)W);                                                                        \
    return (int)cudaGetLastError();                                                          \
  }
  K1P_MODES(K1P_LAUNCH, 8)
  K1P_MODES(K1P_LAUNCH, 16)
#undef K1P_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Resident blocks a multiprocessor of variant (per, mode) at `smem` bytes.
int k1_probe_occupancy(int mode, int per, int smem, int* blocks) {
  cudaError_t e = cudaSuccess;
#define K1P_OCC(EE, MM)                                                                      \
  if (per == EE && mode == MM) {                                                             \
    e = cudaFuncSetAttribute(k1_probe_kernel<EE, MM>,                                        \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);             \
    if (e == cudaSuccess)                                                                    \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k1_probe_kernel<EE, MM>,     \
                                                        kProbeThreadsK1, smem);              \
    return (int)e;                                                                           \
  }
  K1P_MODES(K1P_OCC, 8)
  K1P_MODES(K1P_OCC, 16)
#undef K1P_OCC
  return (int)cudaErrorInvalidValue;
}

#undef K1P_MODES

}  // extern "C"
