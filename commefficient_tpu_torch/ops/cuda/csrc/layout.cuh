// Where a scrambled position lands in a row of the sketch table: its column
// and its sign, as the host computes them (CountSketch.scrambled_cols_signs),
// shared by the kernels of countsketch.cu and segment.cu.
//
// In scrambled space i in [0, d_eff), row `row` with riffle factor f, padded
// length L = f * G, chunk size m, stride s and window V = u * s:
//   riffled index   p    = (i mod G) * f + i div G
//   chunk, offset   q    = p div m,  o = p mod m
//   column          col  = q * s + slot(o),  slot(o) = hash(o) mod V
//   sign            sign = 1 - 2 * (hash'(i) & 1)
// and the inverse map i = (p mod f) * G + p div f.
#pragma once

#include "common.cuh"
#include "hash.cuh"

__device__ __forceinline__ uint32_t cs_sign_hash(const long long* g, int family, uint32_t spos) {
  return family ? cs_poly4(spos, g + RP_CSIGN) : cs_mix32(spos, (uint32_t)g[RP_KEY_SIGN]);
}

__device__ __forceinline__ float cs_sign(const long long* g, int family, uint32_t spos) {
  return (cs_sign_hash(g, family, spos) & 1u) ? -1.0f : 1.0f;
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
