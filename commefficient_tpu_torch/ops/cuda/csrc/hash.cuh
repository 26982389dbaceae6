// CountSketch hash functions, bit-identical to the host versions in
// commefficient_tpu_torch/ops/countsketch.py (and to the reference's
// _mix32 / _poly4_eval / _poly4_u32 in commefficient_tpu/ops/countsketch.py).
//
// The TPU kernels evaluate the Mersenne-31 polynomial in 16-bit limbs
// because the TPU has no 64-bit integers; CUDA has native uint64, so Horner
// runs in uint64 with every product below 2^62 and the reduction mod
// p = 2^31 - 1 done by two folds (2^31 == 1 mod p) and one conditional
// subtract, which equals the host's `% p` exactly.
#pragma once

#include <stdint.h>

#define CS_M1 0x85EBCA6Bu
#define CS_M2 0xC2B2AE35u
#define CS_P31 2147483647ull

// murmur3 fmix32 with a key fold: uint32 in, uint32 out.
__host__ __device__ __forceinline__ uint32_t cs_mix32(uint32_t x, uint32_t key) {
  x ^= key;
  x ^= x >> 16;
  x *= CS_M1;
  x ^= x >> 13;
  x *= CS_M2;
  x ^= x >> 16;
  return x;
}

// y mod (2^31 - 1) for y < 2^62 + 2^31.
__host__ __device__ __forceinline__ uint64_t cs_mod_p31(uint64_t y) {
  y = (y & CS_P31) + (y >> 31);
  y = (y & CS_P31) + (y >> 31);
  return y >= CS_P31 ? y - CS_P31 : y;
}

// ((c0 x^3 + c1 x^2 + c2 x + c3) mod p) for x < p, coefficients in [1, p).
__host__ __device__ __forceinline__ uint32_t cs_poly4(uint32_t x, const long long* c) {
  uint64_t acc = (uint64_t)c[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) acc = cs_mod_p31(acc * (uint64_t)x + (uint64_t)c[i]);
  return (uint32_t)acc;
}
