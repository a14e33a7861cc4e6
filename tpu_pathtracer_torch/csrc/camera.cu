// Fresh camera paths, one lane a thread, for Hopper: the seed hash and the
// primary ray of each lane of a mask, written in place.
//
// Replaces no TPU kernel: in the JAX package this is a fusion that XLA
// makes under jax.jit of make_seeds and generate_camera_rays
// (tpu_pathtracer/render/integrator.py :57) wherever a schedule spawns a
// camera path.  Its plain version is the port's eager chain
// (utils/rng.py: make_seeds, render/camera.py: generate_camera_rays, and
// the selects of integrator._respawn / _regen_step), some 80 device
// kernels a respawn when run op by op.
//
// What it computes, per lane i of the mask (every lane without one):
// * the lane's pixel: pix[min(i / per, n_ids - 1)] from an id table, else
//   base + i / per (an affine range; the identity without a base), and its
//   sample: min(sample[i], sample_max) from a table, else i % per;
// * make_seeds(pixel, sample_offset + sample, subframe), the two counters
//   read from 0-d int64 device buffers (a captured graph replays with the
//   frame's values);
// * generate_camera_rays: the jitter draw, the target on the image plane
//   (/ width and / height as products with float32 reciprocals, as on the
//   card), and under DOF the thin-lens offset from the discarded local
//   chain (two draws on a copy of the seed).
// Bit-equality with the plain version: see shade_math.cuh.  Built with
// -fmad=false; the float32 constants arrive from the host.
//
// What bounds it.  Bytes: a lane reads its pixel id, sample and mask byte
// (9 B) and writes origin, direction and seed (32 B): 5.4 MB at 131,072
// lanes, ~0.002 ms at 3.35 TB/s; a few tens of float operations and three
// hashes a lane.  Bound by bytes on paper, and on the card by the launch
// and a lane's chain of loads: one thread a lane, the grid one wave.
//
// Its design: a programmatic dependent of the launch before it
// (launch_order.cuh), which on the main path is kernel 7 or the path step
// (fused_schedule.cu; itself a dependent of the bounce or NEE kernel).
// The lane's mask byte, pixel and sample are what that launch writes; the
// camera's vectors, the seed counters and an affine range's base are a
// frame's inputs, written at its set-up, before the nearest launch made
// without the attribute began.  So the kernel reads those and the
// constants before its wait, while the step drains, and after it issues
// the mask, pix and sample loads together (every index is in range on
// every lane) before it branches on the mask.  Nothing is stored before
// the wait.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch_order.cuh"
#include "rng.cuh"
#include "shade_math.cuh"

using shade::V3;

namespace {

constexpr int kThreads = 256;

}  // namespace

// The launch's arguments (mirrored by ops/camera.py: CameraParams).
struct CameraParams {
  const float* eye;               // [3]
  const float* u;                 // [3]
  const float* v;                 // [3]
  const float* w;                 // [3]
  const int* pix;                 // [n_ids] pixel ids, or null (base + slot)
  const long long* base;          // 0-d: the affine range's first pixel, or null (0)
  const int* sample;              // [n] sample indices, or null (i % per)
  const unsigned char* mask;      // [n] bool, or null (every lane)
  const long long* sample_offset; // 0-d
  const long long* subframe;      // 0-d
  float* origin;                  // [n,3]
  float* direction;               // [n,3]
  long long* seeds;               // [n] u32 in int64
  int n;
  int per;                        // lanes a slot (spp for one lane per sample)
  int n_ids;                      // entries of pix
  int sample_max;
  int width;
  int dof;
  float inv_width;                // 1 / float32(width) in float32
  float inv_height;
  float two_pi;                   // float32(2 pi)
  float blur;                     // float32(cfg.dof_blurriness)
  float focus;                    // float32(cfg.focus_distance)
  float eps2;                     // normalize's floor
};

namespace {

__global__ void __launch_bounds__(kThreads) camera_kernel(const __grid_constant__ CameraParams p) {
  using namespace shade;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  // A frame's inputs, which the launch just before never writes.
  const V3 uv = load3(p.u), vv = load3(p.v), wv = load3(p.w), eye = load3(p.eye);
  const long long sample_offset = *p.sample_offset;
  const long long subframe = *p.subframe;
  const long long base = p.base != nullptr ? *p.base : 0ll;
  // The lane's mask byte, pixel and sample, which it may write: read after
  // it has completed, all three before the branch.
  launch_order::wait_for_launch_before();
  const int slot = i / p.per;
  const bool spawn = p.mask == nullptr || p.mask[i];
  const int pixel = p.pix != nullptr ? p.pix[min(slot, p.n_ids - 1)] : static_cast<int>(base + slot);
  const int sample = p.sample != nullptr ? min(p.sample[i], p.sample_max) : i % p.per;
  if (!spawn) return;
  uint32_t s = ptrng::make_seed(static_cast<uint32_t>(pixel), static_cast<uint32_t>(sample_offset + sample),
                                static_cast<uint32_t>(subframe));

  // generate_camera_rays
  const float jx = ptrng::uniform(s);
  const float jy = ptrng::uniform(s);
  const int px = pixel % p.width;  // pixel >= 0: the floor-mod and floor division
  const int py = pixel / p.width;
  const float dx = 2.f * (static_cast<float>(px) + jx) * p.inv_width - 1.f;
  const float dy = 2.f * (static_cast<float>(py) + jy) * p.inv_height - 1.f;
  const V3 target = add(add(scale(uv, dx), scale(vv, dy)), wv);
  ShadeConsts c;
  c.eps2 = p.eps2;
  V3 origin, direction;
  if (p.dof) {
    // The reference passes the seed by value to its defocus sampler, so
    // these two draws come from a discarded local chain.
    uint32_t local = s;
    const float r_u = ptrng::uniform(local);
    const float theta_u = ptrng::uniform(local);
    const float r = sqrtf(r_u);
    const float theta = p.two_pi * theta_u;
    // radius ~ u^(1/4): the reference applies sqrt twice.
    const float radius = p.blur * sqrtf(r);
    const V3 off = add(scale(uv, radius * cosf(theta)), scale(vv, radius * sinf(theta)));
    direction = normalize(sub(scale(target, p.focus), off), c);
    origin = add(off, eye);
  } else {
    direction = normalize(target, c);
    origin = eye;
  }
  store3(p.origin + 3ll * i, origin);
  store3(p.direction + 3ll * i, direction);
  p.seeds[i] = static_cast<long long>(s);
}

}  // namespace

// Launches one thread a lane on `stream`, as a programmatic dependent of
// the launch before it where `dependent` (the caller vouches that that
// launch writes none of the camera's vectors, counters and base: a
// schedule step); returns the launch's error, or cudaGetLastError() after
// it (0 = launched).
extern "C" int camera_launch(const CameraParams* p, int dependent, void* stream) {
  if (p->n <= 0) return 0;
  const int blocks = (p->n + kThreads - 1) / kThreads;
  const cudaError_t err = launch_order::launch(camera_kernel, blocks, kThreads, static_cast<cudaStream_t>(stream),
                                               dependent != 0, *p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// sizeof(CameraParams), which the wrapper checks against its mirror.
extern "C" int camera_params_size() { return static_cast<int>(sizeof(CameraParams)); }
