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
// _mt_block (cluster_common.cuh's mt_front and mt_tail, the same
// operations in the same order), equal t going to the lowest triangle id,
// and the Hit written directly: t (t_max on a miss), prim (-1 on a miss),
// the winner's u and v as bary (0 on a miss) and the hit byte.  The plain
// version's finalize_hit gathers the winner and tests it again
// (_mt_single); that test is the loop's own sequence of operations on the
// same inputs, so the u and v the loop kept are its bits, and the finalize
// is no launch at all.  Any hit: for each ray whether some triangle gives
// t_min < t < t_max, stored as the torch.bool output; a ray outside
// `active` (when given) tests nothing and stores false, which
// occluded_scene's contract allows (its answer there is unspecified).
//
// What bounds it.  Operations: N x T tests of 46 float operations (27
// multiplications, 18 additions, one IEEE division; -fmad=false keeps each
// its own instruction); nothing is read twice from device memory but the
// triangles (36 B each, in the L2).  Yet a ray's line meets only a handful
// of the T triangles, so nearly every pair fails the barycentric tests
// whatever t is: the division, u, v and t are wasted on it.  No result
// depends on how the triangles are cut: the TPU's [N, block] layout, its
// zero padding and its per-block carry are not carried over.
//
// The design.
//   * The gate.  Every pair computes the test's front (mt_front: p, det,
//     the t-vector, a = t.p, q, b = d.q, as mt_test computes them) and a
//     division-free gate on it (warp_may_hit, proof below) that is false
//     only where the whole test certainly fails.  The tail (mt_tail: 1/det, u,
//     v, t, the compares) runs behind one vote of the warp, so a warp pays
//     for it only when one of its 32 pairs is a near hit; every value kept
//     comes from the tail, bit for bit what mt_test gives.
//   * Closest hit.  A block of 256 threads stages the triangles into
//     shared memory in tiles of 256 (v0, e1 = v1 - v0, e2 = v2 - v0 as
//     three float4, the row layout of mt_test), so every ray of the block
//     reads the same triangle by broadcast; each thread loads the next
//     tile's triangle into registers while the current tile is tested.  T
//     runs to 200,002 on the 200k scene under --accel brute.  P threads a
//     ray (lanes of one warp; P a power of two up to 32, a template
//     argument, so the tile loop has a constant stride and is unrolled),
//     at least 8, more where N is too small to give the launch two waves
//     of the card's resident threads; each thread holds kRays rays (two),
//     which share each staged triangle's registers.  Thread s of a ray
//     tests the tile's triangles s, s + P, ..., past the tile's last
//     triangle the zero rows of the last tile (det 0: no hit), so that
//     every lane of a warp runs the same trip count and can vote; the P
//     partial winners merge by smaller t, then lower id, which is the
//     sequential winner whatever the split.
//   * Any hit: only live rays hold threads.  A block owns a slice of up to
//     256 rays, sized by N at plan time (about two waves of blocks), and
//     interleaved: block b of B holds rays b, b + B, b + 2B, ..., so that
//     every block gets its share of the active rays, which cluster by lane
//     (whole sky regions have none).  It lists the slice's rays in
//     `active` into shared memory, in lane order (one ballot a warp, the
//     warps' counts summed in shared memory: no global atomic, no host
//     read).  Each thread takes one
//     triangle of the tile into registers and tests it against every
//     listed ray in turn (the ray read by broadcast): every listed ray is
//     tested by all 256 threads, and every thread of the block works on
//     listed rays.  A thread that finds a hit sets the ray's flag in
//     shared memory; after each tile the rays not yet occluded are listed
//     again, and the block exits when none is left.  A ray's flag is the
//     OR over the threads that tested it, so it does not depend on the
//     spread; a warp whose 32 triangles are all past the end skips the
//     tile.  The kernel lets its dependent (the NEE kernel) start at its
//     entry, as the cluster any-hit kernels do (launch_order.cuh); it is
//     launched without the attribute and never waits.
// Row offsets are 64-bit: render_rays can hand it 20,736,000 rays.
//
// The gate's proof (float32, round to nearest even, subnormals kept, no
// contraction: -fmad=false, no -ftz).  Write D = |det|, s the sign of det,
// A = s.a and B = s.b (sign flips, exact), I = RN(1/D) > 0, e = 2^-24.  As
// 1/det = s.I after rounding, the tail's u = RN(A.I) and v = RN(B.I).  For
// every real y, |RN(y) - y| <= e|y| + 2^-150 short of overflow, and RN is
// monotone.  The gate is false in exactly these cases:
//  1. !(D > 1e-12): the test's own first condition; NaN det lands here.
//  2. A < -m or B < -m, with m = RN(D.2^-80).  Past case 1 D > 1e-12 >
//     2^-40, so D.2^-80 >= 2^-120 is normal and m = D.2^-80 exactly; if D
//     is inf, m is inf and nothing is rejected.  Else D <= 2^128, and
//     I >= 1/D - e/D - 2^-150 >= (1 - 5e)/D (as 2^-150.D <= 2^-22 = 4e).
//     So A < -m gives A.I < -2^-80 (1 - 5e) < -2^-150, and u = RN(A.I) <=
//     -2^-149 < 0 (-inf where it overflows or A is -inf): u >= 0 fails.
//     The margin is what keeps a product that underflows to -0.0, which
//     passes u >= 0.0f, out of the rejected set.  Likewise B and v.
//  3. RN(A + B) > RN(D.k), with k = 1 + 2^-20, neither 2 holding.  RN is
//     monotone, so the exact X = A + B > D.k (whether or not either side
//     overflowed), and D is finite (else RN(D.k) = inf).  If A.I or B.I
//     overflows, it is +inf (A, B >= -m), u + v = +inf and u + v <= 1
//     fails.  Else, as A, B >= -m, |A| + |B| <= X + 4m, and
//       u + v >= (X - e(X + 4m)) I - 2^-149
//             >= X (1 - e)(1 - 5e)/D - 4e 2^-80 (1 + 5e) - 2^-149
//             >  k (1 - 6e) - 2^-100 = (1 + 16e)(1 - 6e) - 2^-100 > 1 + 9e,
//     so RN(u + v) >= 1 + 2^-23 > 1 and u + v <= 1.0f fails.
// NaN anywhere in a or b makes every compare of 2 and 3 false: the pair
// falls through to the full test.  An inf a or b is covered by 2 and 3 as
// written (A = -inf < -m; A = +inf makes RN(A + B) = +inf, NaN if B = -inf,
// which 2 rejected).  tests/test_torch_brute_design.py checks the gate
// against the whole test in a numpy float32 model over 10^6 random and
// adversarial pairs, and that the gate without its margins fails there.
//
// Switches for sweep_brute.py's ablation builds, each 1 here: BRUTE_GATE 0
// tests every pair in full; BRUTE_STATIC_P 0 makes P a runtime value (one
// instantiation, the tile loop's stride unknown to the compiler);
// BRUTE_COMPACT 0 lists every ray of the slice once and never drops one.
// BRUTE_RAYS_PER_THREAD is the closest hit's kRays.

#include <cuda_runtime.h>

#include "cluster_common.cuh"
#include "launch_order.cuh"

#ifndef BRUTE_GATE
#define BRUTE_GATE 1
#endif
#ifndef BRUTE_STATIC_P
#define BRUTE_STATIC_P 1
#endif
#ifndef BRUTE_COMPACT
#define BRUTE_COMPACT 1
#endif
#ifndef BRUTE_RAYS_PER_THREAD
#define BRUTE_RAYS_PER_THREAD 2
#endif

namespace brute_force {

using cluster_traversal::Best;
using cluster_traversal::kMissPrim;
using cluster_traversal::MtFront;
using cluster_traversal::mt_front;
using cluster_traversal::mt_tail;
using cluster_traversal::Ray;

constexpr int kThreads = 256;  // threads of a block, and triangles of a tile
constexpr int kMinBlocks = 4;  // blocks an SM holds at least (at most 64 registers a thread)
constexpr int kWaves = 2;      // closest hit: resident threads' worth of threads a launch aims for
constexpr int kAnyWaves = 2;   // any hit: resident blocks' worth of blocks a launch aims for
constexpr int kMinThreadsPerRay = 8;
constexpr int kMaxThreadsPerRay = 32;
constexpr int kRays = BRUTE_RAYS_PER_THREAD;  // closest hit: rays a thread
constexpr int kMinSlice = 32;                 // any hit: rays a block, at least
constexpr float kSumMargin = 1.00000095367431640625f;  // 1 + 2^-20, the gate's k

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

// A triangle's rows: v0 and the edges as _mt_block computes them.
__device__ __forceinline__ void triangle_rows(const float (&v)[9], float4& r0, float4& r1, float4& r2) {
  const float e1x = v[3] - v[0], e1y = v[4] - v[1], e1z = v[5] - v[2];
  const float e2x = v[6] - v[0], e2y = v[7] - v[1], e2z = v[8] - v[2];
  r0 = make_float4(v[0], v[1], v[2], e1x);
  r1 = make_float4(e1y, e1z, e2x, e2y);
  r2 = make_float4(e2z, 0.0f, 0.0f, 0.0f);
}

// Whether the warp runs the tail: where the gate on some lane's front f
// may pass.  The gate is false only where mt_tail certainly fails (the
// proof above); no division, and no branch (& in place of &&) ahead of the
// vote.  Every lane of the warp must call it.
__device__ __forceinline__ bool warp_may_hit(const MtFront& f) {
#if BRUTE_GATE
  const float d = fabsf(f.det);
  const unsigned s = __float_as_uint(f.det) & 0x80000000u;
  const float a = __uint_as_float(__float_as_uint(f.a) ^ s);
  const float b = __uint_as_float(__float_as_uint(f.b) ^ s);
  const float m = d * 0x1p-80f;
  return __any_sync(0xffffffffu, (d > 1e-12f) & !(a < -m) & !(b < -m) & !(a + b > d * kSumMargin));
#else
  return true;
#endif
}

__host__ __device__ constexpr int log2_of(int p) { return p <= 1 ? 0 : 1 + log2_of(p / 2); }

// Closest hit with kP threads a ray (0: 2^log_p, a runtime value), rays
// [n] (3 floats each), triangles [t_count] (9 floats each): writes t_out,
// prim_out, bary_out and hit_out.
template <int kP>
__device__ __forceinline__ void closest_hit(const float* __restrict__ vertices, long long t_count,
                                            const float* __restrict__ origins, const float* __restrict__ dirs,
                                            long long n, int log_p, float t_min, float t_max,
                                            float* __restrict__ t_out, int* __restrict__ prim_out,
                                            float* __restrict__ bary_out, unsigned char* __restrict__ hit_out) {
  __shared__ Tile tile;
  const int lg = kP > 0 ? log2_of(kP) : log_p;
  const int p = 1 << lg;
  const int sub = threadIdx.x & (p - 1);
  const long long group = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> lg;

  Ray r[kRays];
  Best best[kRays];
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    const long long ray = group * kRays + i;
    r[i] = {};
    if (ray < n) {
      r[i].ox = origins[3 * ray];
      r[i].oy = origins[3 * ray + 1];
      r[i].oz = origins[3 * ray + 2];
      r[i].dx = dirs[3 * ray];
      r[i].dy = dirs[3 * ray + 1];
      r[i].dz = dirs[3 * ray + 2];
    }
    best[i] = {t_max, kMissPrim, 0.0f, 0.0f};
  }

  float v[9];
  load_triangle(vertices, threadIdx.x, t_count, v);
  for (long long base = 0; base < t_count; base += kThreads) {
    triangle_rows(v, tile.r0[threadIdx.x], tile.r1[threadIdx.x], tile.r2[threadIdx.x]);
    load_triangle(vertices, base + kThreads + threadIdx.x, t_count, v);  // the next tile's, while this one runs
    __syncthreads();
    const int count = static_cast<int>(t_count - base < kThreads ? t_count - base : kThreads);
    // j0 is the same in every lane, so every lane runs the same trip count
    // and reaches each vote; rows count..255 of the last tile are zeros
    const float4 *rows0 = tile.r0 + sub, *rows1 = tile.r1 + sub, *rows2 = tile.r2 + sub;
#pragma unroll 2
    for (int j0 = 0; j0 < count; j0 += p) {
      const float4 r0 = rows0[j0], r1 = rows1[j0], r2 = rows2[j0];
#pragma unroll
      for (int i = 0; i < kRays; ++i) {
        const MtFront f = mt_front(r0, r1, r2, r[i]);
        if (warp_may_hit(f)) {
          float t, u, w;
          bool ok;
          mt_tail(f, r1.z, r1.w, r2.x, t_min, t_max, t, u, w, ok);
          if (ok && t < best[i].t) {  // strictly: equal t keeps the lower id
            best[i].t = t;
            best[i].prim = static_cast<int>(base) + j0 + sub;
            best[i].u = u;
            best[i].v = w;
          }
        }
      }
    }
    __syncthreads();  // every thread is done with the tile before it is restaged
  }

  // the P partial winners of each ray: smaller t, then lower id
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
#pragma unroll
    for (int offset = 1; offset < kMaxThreadsPerRay; offset <<= 1) {
      if (offset >= p) break;
      const float t = __shfl_xor_sync(0xffffffffu, best[i].t, offset);
      const int prim = __shfl_xor_sync(0xffffffffu, best[i].prim, offset);
      const float u = __shfl_xor_sync(0xffffffffu, best[i].u, offset);
      const float w = __shfl_xor_sync(0xffffffffu, best[i].v, offset);
      if (t < best[i].t || (t == best[i].t && prim < best[i].prim)) {
        best[i].t = t;
        best[i].prim = prim;
        best[i].u = u;
        best[i].v = w;
      }
    }
    const long long ray = group * kRays + i;
    if (ray < n && sub == 0) cluster_traversal::store_hit(best[i], ray, t_out, prim_out, bary_out, hit_out);
  }
}

// Lists the threads whose `live` is set, in thread order: the listed ray
// k's origin and direction into ray_a[k], ray_b[k] and its place in the
// slice into slot[k].  Returns how many, the same in every thread.  Every
// thread of the block calls it; before it returns no thread reads the
// list, after it every thread may.
__device__ __forceinline__ int list_rays(bool live, const float (&ray)[6], float4* ray_a, float2* ray_b, int* slot,
                                         int* warp_live) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_live[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int c = warp_live[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (live) {
    const int k = before + __popc(ballot & ((1u << lane) - 1u));
    ray_a[k] = make_float4(ray[0], ray[1], ray[2], ray[3]);
    ray_b[k] = make_float2(ray[4], ray[5]);
    slot[k] = threadIdx.x;
  }
  __syncthreads();
  return total;
}

// Any hit of the slice of `slice` rays blockIdx.x + k gridDim.x of [n]:
// writes hit_out (the occluded flags) and reads `active` (null: every ray).
__device__ __forceinline__ void any_hit(const float* __restrict__ vertices, long long t_count,
                                        const float* __restrict__ origins, const float* __restrict__ dirs,
                                        const unsigned char* __restrict__ active, long long n, int slice,
                                        float t_min, float t_max, unsigned char* __restrict__ hit_out) {
  __shared__ float4 ray_a[kThreads];  // listed ray k: origin, dir.x
  __shared__ float2 ray_b[kThreads];  // dir.y, dir.z
  __shared__ int slot[kThreads];      // listed ray k's place in the slice
  __shared__ unsigned char occluded[kThreads];  // by place in the slice
  __shared__ int warp_live[kThreads / 32];
  const long long ray = blockIdx.x + static_cast<long long>(threadIdx.x) * gridDim.x;  // this thread's ray
  const bool in_slice = static_cast<int>(threadIdx.x) < slice && ray < n;
  const bool wanted = in_slice && (active == nullptr || active[ray] != 0);
  bool live = BRUTE_COMPACT ? wanted : in_slice;
  float mine[6] = {};
  if (live) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mine[i] = origins[3 * ray + i];
      mine[3 + i] = dirs[3 * ray + i];
    }
  }
  occluded[threadIdx.x] = 0;
  int count = list_rays(live, mine, ray_a, ray_b, slot, warp_live);

  float v[9];
  load_triangle(vertices, threadIdx.x, t_count, v);
  for (long long base = 0; count > 0 && base < t_count; base += kThreads) {
    float4 r0, r1, r2;
    triangle_rows(v, r0, r1, r2);  // triangle base + threadIdx.x (zeros past the end)
    load_triangle(vertices, base + kThreads + threadIdx.x, t_count, v);  // the next tile's
    if (base + (threadIdx.x & ~31u) < t_count) {  // the warp holds a triangle
#pragma unroll 2
      for (int k = 0; k < count; ++k) {
        const float4 a = ray_a[k];
        const float2 b = ray_b[k];
        Ray r = {};
        r.ox = a.x;
        r.oy = a.y;
        r.oz = a.z;
        r.dx = a.w;
        r.dy = b.x;
        r.dz = b.y;
        const MtFront f = mt_front(r0, r1, r2, r);
        if (warp_may_hit(f)) {
          float t, u, w;
          bool ok;
          mt_tail(f, r1.z, r1.w, r2.x, t_min, t_max, t, u, w, ok);
          if (ok) occluded[slot[k]] = 1;
        }
      }
    }
    __syncthreads();  // every flag of the tile is set, and every test has read the list
    if (BRUTE_COMPACT) live = live && !occluded[threadIdx.x];
    count = list_rays(live, mine, ray_a, ray_b, slot, warp_live);
  }
  if (in_slice) hit_out[ray] = wanted && occluded[threadIdx.x] ? 1 : 0;
}

// One launch: rays [n] (3 floats each), triangles [t_count] (9 floats
// each).  Closest hit (kP threads a ray; 0: 2^shape) writes t_out,
// prim_out, bary_out and hit_out; any hit (`shape` rays a block) writes
// hit_out (the occluded flags) and reads `active` (null: every ray).
template <bool kAnyHit, int kP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    brute_kernel(const float* __restrict__ vertices, long long t_count, const float* __restrict__ origins,
                 const float* __restrict__ dirs, const unsigned char* __restrict__ active, long long n, int shape,
                 float t_min, float t_max, float* __restrict__ t_out, int* __restrict__ prim_out,
                 float* __restrict__ bary_out, unsigned char* __restrict__ hit_out) {
  if constexpr (kAnyHit) launch_order::let_dependents_start();
  if constexpr (kAnyHit) {
    any_hit(vertices, t_count, origins, dirs, active, n, shape, t_min, t_max, hit_out);
  } else {
    closest_hit<kP>(vertices, t_count, origins, dirs, n, shape, t_min, t_max, t_out, prim_out, bary_out, hit_out);
  }
}

using Kernel = void (*)(const float*, long long, const float*, const float*, const unsigned char*, long long, int,
                        float, float, float*, int*, float*, unsigned char*);

struct Plan {
  Kernel kernel;
  int shape;       // closest hit: log2 of the threads a ray; any hit: rays a block
  long long rays;  // rays a block
  long long blocks;
};

// The closest-hit kernel of 2^log_p threads a ray.
inline Kernel closest_kernel(int log_p) {
#if BRUTE_STATIC_P
  switch (log_p) {
    case 0: return &brute_kernel<false, 1>;
    case 1: return &brute_kernel<false, 2>;
    case 2: return &brute_kernel<false, 4>;
    case 3: return &brute_kernel<false, 8>;
    case 4: return &brute_kernel<false, 16>;
    default: return &brute_kernel<false, 32>;
  }
#else
  return &brute_kernel<false, 0>;
#endif
}

// The launch of n rays.  Closest hit: the least power of two from 8 to 32
// threads a ray that puts kWaves x the card's resident threads in the
// launch, kRays rays a thread (fewer threads a ray run slower even with
// more waves: 2 and 4 at 345,600 rays, 16 and 32 at 131,072).  Any hit:
// slices of kMinSlice to kThreads rays that put about kAnyWaves x the
// resident blocks in the launch.
inline int plan(long long n, bool any_hit, Plan& out) {
  out.kernel = any_hit ? &brute_kernel<true, 0> : closest_kernel(0);
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, out.kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (any_hit) {
    const long long blocks = static_cast<long long>(kAnyWaves) * sms * resident;
    long long slice = (n + blocks - 1) / blocks;
    slice = slice < kMinSlice ? kMinSlice : (slice > kThreads ? kThreads : slice);
    out.shape = static_cast<int>(slice);
    out.rays = slice;
    out.blocks = (n + slice - 1) / slice;
  } else {
    const long long groups = (n + kRays - 1) / kRays;
    const long long target = static_cast<long long>(kWaves) * sms * resident * kThreads;
    out.shape = log2_of(kMinThreadsPerRay);
    while ((1 << out.shape) < kMaxThreadsPerRay && (groups << out.shape) < target) ++out.shape;
    out.kernel = closest_kernel(out.shape);
    out.rays = static_cast<long long>(kThreads >> out.shape) * kRays;
    out.blocks = ((groups << out.shape) + kThreads - 1) / kThreads;
  }
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
  plan.kernel<<<dim3(static_cast<unsigned>(plan.blocks)), brute_force::kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(vertices, t_count, origins, dirs, active, n, plan.shape, t_min,
                                                     t_max, t_out, prim_out, bary_out, hit_out);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of n rays, into out[6]: threads a ray (any hit: the
// block's, as each listed ray is tested by all of them), blocks, threads a
// block, registers a thread, blocks an SM holds at once, rays a block.
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
  out[0] = any_hit ? brute_force::kThreads : 1 << plan.shape;
  out[1] = static_cast<int>(n > 0 ? plan.blocks : 0);
  out[2] = brute_force::kThreads;
  out[3] = attributes.numRegs;
  out[4] = resident;
  out[5] = static_cast<int>(plan.rays);
  return 0;
}
