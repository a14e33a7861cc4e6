// Brute-force closest hit and any hit for Hopper: every ray against every
// triangle, with no acceleration structure.
//
// Replaces the JAX package's brute-force traversal, the lax.scan over
// blocks of triangles that XLA fuses (tpu_pathtracer/ops/intersect.py):
// intersect_brute (:117) with its finalize_hit (:171), and occluded_brute
// (:215).  Its plain PyTorch versions are intersect_brute_plain and
// occluded_brute_plain in tpu_pathtracer_torch/ops/intersect.py; built with
// -fmad=false and IEEE division, each kernel and its plain version give the
// same bits.  Scenes without an accel take this path: the bench's presets
// at --accel auto on the procedural scenes, the CLI without --scene, the
// NEE quality study and any scene given --accel brute.
//
// What it computes.  Closest hit: for each ray the least t over all T
// triangles with t_min < t < t_max by the Moller-Trumbore test of
// _mt_block (cluster_common.cuh's mt_test, the same operations in the same
// order), equal t going to the lowest triangle id, and the Hit written
// directly: t (t_max on a miss), prim (-1 on a miss), the winner's u and v
// as bary (0 on a miss) and the hit byte.  The plain version's finalize_hit
// gathers the winner and tests it again (_mt_single); that test is the
// loop's own sequence of operations on the same inputs, so the u and v the
// loop kept are its bits, and the finalize is no launch at all.  Any hit:
// for each ray whether some triangle gives t_min < t < t_max, stored as the
// torch.bool output; a ray outside `active` (when given) tests nothing and
// stores false, which occluded_scene's contract allows (its answer there
// is unspecified).
//
// What bounds it.  Operations: N x T tests of 46 float operations (27
// multiplications, 18 additions, one IEEE division; -fmad=false keeps each
// its own instruction); nothing is read twice from device memory but the
// triangles (36 B each, in the L2).  No result depends on how the
// triangles are cut: the TPU's [N, block] layout, its zero padding and its
// per-block carry are not carried over.
//
// The design.
//   * A block of 256 threads stages the triangles into shared memory in
//     tiles of 256 (v0, e1 = v1 - v0, e2 = v2 - v0 as three float4, the
//     row layout of mt_test), so every ray of the block reads the same
//     triangle by broadcast; each thread loads the next tile's triangle
//     into registers while the current tile is tested.  T runs to 200,002
//     on the 200k scene under --accel brute.
//   * P threads a ray (lanes of one warp; P a power of two up to 32),
//     chosen by N so that the launch holds about four waves of the card's
//     resident threads, and the SMs' shares of the blocks differ by a
//     quarter of a wave at most: on an H100 (132 SMs, 5 blocks an SM at 48
//     and 51 registers a thread) P = 32 at 19,200 rays (the NEE study), 8
//     at the headline's 131,072, 2 at 345,600, 1 from 675,840.  Thread s of
//     a ray tests the tile's triangles s, s + P, ...; closest hit merges
//     the P partial winners by smaller t, then lower id, which is the
//     sequential winner whatever the split; any hit ORs the P flags after
//     every tile.
//   * Any hit: a ray stops testing once it is occluded, and the block stops
//     after the tile where none of its rays is left (one barrier vote a
//     tile).
//   * The any-hit kernel lets its dependent (the NEE kernel) start at its
//     entry, as the cluster any-hit kernels do (launch_order.cuh); it is
//     launched without the attribute and never waits.
// Row offsets are 64-bit: render_rays can hand it 20,736,000 rays.

#include <cuda_runtime.h>

#include "cluster_common.cuh"
#include "launch_order.cuh"

namespace brute_force {

using cluster_traversal::Best;
using cluster_traversal::kMissPrim;
using cluster_traversal::mt_test;
using cluster_traversal::Ray;

constexpr int kThreads = 256;  // threads of a block, and triangles of a tile
constexpr int kMinBlocks = 4;  // blocks an SM holds at least (at most 64 registers a thread)
constexpr int kWaves = 4;      // resident threads' worth of threads a launch aims for
constexpr int kMaxThreadsPerRay = 32;

struct Tile {
  float4 r0[kThreads];  // v0.xyz, e1.x
  float4 r1[kThreads];  // e1.yz, e2.xy
  float4 r2[kThreads];  // e2.z
};

// Triangle k's three vertices, or zeros past the end.
__device__ __forceinline__ void load_triangle(const float* __restrict__ vertices, long long k, long long t_count,
                                              float (&v)[9]) {
  if (k < t_count) {
    const float* p = vertices + 9 * k;
#pragma unroll
    for (int i = 0; i < 9; ++i) v[i] = __ldg(p + i);
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) v[i] = 0.0f;
  }
}

// Row j of the tile: v0 and the edges as _mt_block computes them.
__device__ __forceinline__ void stage_triangle(Tile& tile, int j, const float (&v)[9]) {
  const float e1x = v[3] - v[0], e1y = v[4] - v[1], e1z = v[5] - v[2];
  const float e2x = v[6] - v[0], e2y = v[7] - v[1], e2z = v[8] - v[2];
  tile.r0[j] = make_float4(v[0], v[1], v[2], e1x);
  tile.r1[j] = make_float4(e1y, e1z, e2x, e2y);
  tile.r2[j] = make_float4(e2z, 0.0f, 0.0f, 0.0f);
}

// One launch: rays [n] (3 floats each), triangles [t_count] (9 floats
// each), 2^log_p threads a ray.  Closest hit writes t_out, prim_out,
// bary_out and hit_out; any hit writes hit_out (the occluded flags) and
// reads `active` (null: every ray).
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    brute_kernel(const float* __restrict__ vertices, long long t_count, const float* __restrict__ origins,
                 const float* __restrict__ dirs, const unsigned char* __restrict__ active, long long n, int log_p,
                 float t_min, float t_max, float* __restrict__ t_out, int* __restrict__ prim_out,
                 float* __restrict__ bary_out, unsigned char* __restrict__ hit_out) {
  if constexpr (kAnyHit) launch_order::let_dependents_start();
  __shared__ Tile tile;
  const int p = 1 << log_p;
  const int sub = threadIdx.x & (p - 1);
  const int group = (threadIdx.x & 31) & ~(p - 1);  // the ray's first lane in the warp
  const unsigned group_mask = p == 32 ? 0xffffffffu : ((1u << p) - 1u) << group;
  const long long ray = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> log_p;
  const bool in_range = ray < n;

  Ray r = {};
  if (in_range) {
    r.ox = origins[3 * ray];
    r.oy = origins[3 * ray + 1];
    r.oz = origins[3 * ray + 2];
    r.dx = dirs[3 * ray];
    r.dy = dirs[3 * ray + 1];
    r.dz = dirs[3 * ray + 2];
  }
  Best best = {t_max, kMissPrim, 0.0f, 0.0f};
  bool occluded = false;
  bool alive = in_range && (active == nullptr || active[ray] != 0);

  float v[9];
  load_triangle(vertices, threadIdx.x, t_count, v);
  for (long long base = 0; base < t_count; base += kThreads) {
    stage_triangle(tile, threadIdx.x, v);
    load_triangle(vertices, base + kThreads + threadIdx.x, t_count, v);  // the next tile's, while this one runs
    __syncthreads();
    const int count = static_cast<int>(t_count - base < kThreads ? t_count - base : kThreads);
    if (!kAnyHit || alive) {
      for (int j = sub; j < count; j += p) {
        float t, u, w;
        bool ok;
        mt_test(tile.r0[j], tile.r1[j], tile.r2[j], r, t_min, t_max, t, u, w, ok);
        if constexpr (kAnyHit) {
          if (ok) {
            occluded = true;
            break;
          }
        } else if (ok && t < best.t) {  // strictly: equal t keeps the lower id
          best.t = t;
          best.prim = static_cast<int>(base) + j;
          best.u = u;
          best.v = w;
        }
      }
    }
    if constexpr (kAnyHit) {
      // the ray is occluded when one of its threads found a triangle
      occluded = (__ballot_sync(0xffffffffu, occluded) & group_mask) != 0;
      alive = alive && !occluded;
      if (!__syncthreads_or(alive)) break;  // no ray of the block is left
    } else {
      __syncthreads();  // every thread is done with the tile before it is restaged
    }
  }

  if constexpr (kAnyHit) {
    if (in_range && sub == 0) hit_out[ray] = occluded ? 1 : 0;
  } else {
    // the P partial winners: smaller t, then lower id
#pragma unroll
    for (int offset = 1; offset < kMaxThreadsPerRay; offset <<= 1) {
      if (offset >= p) break;
      const float t = __shfl_xor_sync(0xffffffffu, best.t, offset);
      const int prim = __shfl_xor_sync(0xffffffffu, best.prim, offset);
      const float u = __shfl_xor_sync(0xffffffffu, best.u, offset);
      const float w = __shfl_xor_sync(0xffffffffu, best.v, offset);
      if (t < best.t || (t == best.t && prim < best.prim)) {
        best.t = t;
        best.prim = prim;
        best.u = u;
        best.v = w;
      }
    }
    if (in_range && sub == 0) cluster_traversal::store_hit(best, ray, t_out, prim_out, bary_out, hit_out);
  }
}

struct Plan {
  void (*kernel)(const float*, long long, const float*, const float*, const unsigned char*, long long, int, float,
                 float, float*, int*, float*, unsigned char*);
  int log_p;
  long long blocks;
};

// The launch of n rays: the kernel, log2 of the threads a ray (the least
// power of two up to 32 that puts kWaves x the card's resident threads in
// the launch) and the blocks.
inline int plan(long long n, bool any_hit, Plan& out) {
  out.kernel = any_hit ? &brute_kernel<true> : &brute_kernel<false>;
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, out.kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long target = static_cast<long long>(kWaves) * sms * resident * kThreads;
  out.log_p = 0;
  while ((1 << out.log_p) < kMaxThreadsPerRay && (n << out.log_p) < target) ++out.log_p;
  out.blocks = ((n << out.log_p) + kThreads - 1) / kThreads;
  return out.blocks > 0x7fffffffLL ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

}  // namespace brute_force

// any_hit 0: closest hit into t_out, prim_out, bary_out and hit_out (the
// Hit; `active` must be null).  any_hit 1: the occluded flags into hit_out
// (t_out, prim_out and bary_out null), rays outside `active` (null: none)
// false.  vertices [t_count,3,3], origins and dirs [n,3], all float32 and
// contiguous.  Launches on `stream`, without the programmatic attribute.
// Returns the launch's error (0 = launched).
extern "C" int brute_launch(int any_hit, const float* vertices, long long t_count, const float* origins,
                            const float* dirs, const unsigned char* active, long long n, float t_min, float t_max,
                            float* t_out, int* prim_out, float* bary_out, unsigned char* hit_out, void* stream) {
  if (n <= 0) return 0;
  if (!any_hit && active != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  brute_force::Plan plan;
  const int planned = brute_force::plan(n, any_hit != 0, plan);
  if (planned) return planned;
  const dim3 blocks(static_cast<unsigned>(plan.blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    brute_force::brute_kernel<true><<<blocks, brute_force::kThreads, 0, st>>>(
        vertices, t_count, origins, dirs, active, n, plan.log_p, t_min, t_max, t_out, prim_out, bary_out, hit_out);
  } else {
    brute_force::brute_kernel<false><<<blocks, brute_force::kThreads, 0, st>>>(
        vertices, t_count, origins, dirs, active, n, plan.log_p, t_min, t_max, t_out, prim_out, bary_out, hit_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of n rays, into out[5]: threads a ray, blocks, threads
// a block, registers a thread, blocks an SM holds at once.
extern "C" int brute_shape(long long n, int any_hit, int* out) {
  brute_force::Plan plan;
  const int planned = brute_force::plan(n > 0 ? n : 1, any_hit != 0, plan);
  if (planned) return planned;
  cudaFuncAttributes attributes;
  int resident = 0;
  cudaError_t err = cudaFuncGetAttributes(&attributes, plan.kernel);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, plan.kernel, brute_force::kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = 1 << plan.log_p;
  out[1] = static_cast<int>(n > 0 ? plan.blocks : 0);
  out[2] = brute_force::kThreads;
  out[3] = attributes.numRegs;
  out[4] = resident;
  return 0;
}
