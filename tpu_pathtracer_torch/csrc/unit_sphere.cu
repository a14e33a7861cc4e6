// Rejection sampling of points in the unit ball, one lane a thread, for
// Hopper.
//
// Replaces no TPU kernel: the JAX package samples with a masked
// lax.while_loop inside its jitted render (random_in_unit_sphere,
// tpu_pathtracer/utils/rng.py), which XLA keeps on the device.  Its plain
// PyTorch version, random_in_unit_sphere_plain in
// tpu_pathtracer_torch/utils/rng.py, is an eager loop that must read the
// device to learn whether every lane has accepted; this kernel is the
// while_loop as one launch, with no host read.  Every _shade calls it once.
//
// What it computes.  Each thread draws for its lane until the lane
// accepts, with no cap (the JAX loop has none): three PCG steps on u32
// (pcg_hash, as utils/rng.py), each value to float32 by __uint2float_rn
// (round to nearest even, as the plain version's int64 -> float32) times
// 2^-32, then 2u - 1 as two rounded operations, then the squared length
// left to right, (x*x + y*y) + z*z, and < 1.  Built with -fmad=false, so
// no product is contracted into a sum and the point and the seed chain
// (the same draw count per lane) are the plain version's bits.
//
// What bounds it.  Bytes: a lane reads its seed (8 B) and writes the seed
// and the point (20 B), 3.7 MB at 131,072 lanes, 1.1 us at 3.35 TB/s.  The
// arithmetic is ~15 float operations and three hashes a draw, 1.91 draws a
// lane on average.  A warp runs as long as its slowest lane (the expected
// most of 32 geometric counts at p = pi/6 is 6-7 draws), which is still
// far below a launch's own latency, so one plain thread a lane is the
// whole design.  The draw loop is ptrng::unit_sphere of rng.cuh, which the
// bounce kernel (bounce.cu) runs inline; this kernel is the plain shade's
// sampler and the one its tests hold.

#include <cstdint>

#include <cuda_runtime.h>

#include "rng.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) unit_sphere_kernel(
    const long long* __restrict__ seed_in,  // [n] u32 in int64
    long long* __restrict__ seed_out,       // [n]
    float* __restrict__ p_out,              // [n,3]
    int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t s = static_cast<uint32_t>(seed_in[i]);
  float x, y, z;
  ptrng::unit_sphere(s, x, y, z);
  seed_out[i] = static_cast<long long>(s);
  p_out[3 * i] = x;
  p_out[3 * i + 1] = y;
  p_out[3 * i + 2] = z;
}

}  // namespace

// Launches one thread a lane on `stream`.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int unit_sphere_launch(const long long* seed_in, long long* seed_out, float* p_out, int n,
                                  void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  unit_sphere_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(seed_in, seed_out, p_out, n);
  return static_cast<int>(cudaGetLastError());
}
