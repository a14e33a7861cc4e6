// Counter-seeded per-lane PCG chains on u32, the device counterparts of
// tpu_pathtracer_torch/utils/rng.py (which holds each u32 in an int64
// tensor and masks it back to 32 bits after every operation).
//
// Each function does its plain version's operations in the same order,
// and the sources that include this header are built with -fmad=false, so
// a uniform draw, a seed hash and a rejection-sampled point are the plain
// version's bits.  Shared by unit_sphere.cu, bounce.cu and camera.cu.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ptrng {

constexpr float kInvU32 = 2.3283064365386963e-10f;  // 2^-32, exact in float32

// One round of the PCG-RXS-M-XS output permutation (utils/rng.py: pcg_hash).
__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

// Advance the chain once; u in [0, 1]: the u32 to float32 by round to
// nearest even (the plain version's int64 -> float32), times 2^-32.
__device__ __forceinline__ float uniform(uint32_t& s) {
  s = pcg_hash(s);
  return __uint2float_rn(s) * kInvU32;
}

// make_seeds: hash(pixel, sample, subframe), each counter modulo 2^32.
__device__ __forceinline__ uint32_t make_seed(uint32_t pixel, uint32_t sample, uint32_t subframe) {
  uint32_t h = pcg_hash(pixel ^ 0x9E3779B9u);
  h = pcg_hash(h + sample * 0x85EBCA6Bu);
  h = pcg_hash(h + subframe * 0xC2B2AE35u);
  return h | 1u;
}

// One uniform draw mapped to [-1, 1]: 2u - 1, two rounded operations.
__device__ __forceinline__ float signed_unit(uint32_t& s) {
  const float u = uniform(s);
  return 2.f * u - 1.f;
}

// Rejection sampling in the unit ball (random_in_unit_sphere_plain): three
// draws until the squared length, summed left to right, is below 1.  No
// cap, as the JAX package's while_loop has none.
__device__ __forceinline__ void unit_sphere(uint32_t& s, float& x, float& y, float& z) {
  do {
    x = signed_unit(s);
    y = signed_unit(s);
    z = signed_unit(s);
  } while (!((x * x + y * y) + z * z < 1.f));
}

}  // namespace ptrng
