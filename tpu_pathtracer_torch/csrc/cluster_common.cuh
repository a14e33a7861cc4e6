// Device code shared by the cluster traversal kernels, closest hit
// (cluster_intersect.cu, cluster_hier.cu, cluster_streamed.cu) and any hit
// (cluster_occluded.cu, cluster_occluded_hier.cu,
// cluster_occluded_streamed.cu): the counterparts of _packet_rays,
// _octant_of, _slab_hits, _bw_tests, _mt_tests and _mt_best in
// tpu_pathtracer/ops/intersect_pallas.py.  The one body of every route
// (flat, hier and streamed) is in cluster_streamed.cuh.
//
// Every kernel builds with -fmad=false and IEEE division, and computes in
// the operation order of its plain PyTorch version
// (tpu_pathtracer_torch/ops/intersect_cluster.py), so the two give the same
// bits.
//
// Packet semantics, the same in every kernel: rays are cut into packets of
// rays_per_packet consecutive rays.  Per box, every ray slab-tests the box
// against its own running best t, and the packet skips the box when none of
// its rays overlaps it (the counterpart of the TPU kernels'
// pl.when(jnp.any(overlap))).  A cluster that is not skipped is staged into
// shared memory and every ray of the packet, including those whose own
// slab test failed, tests all K triangles.  Within a cluster the smallest t
// wins and equal t goes to the lowest triangle id; across clusters a
// strictly smaller t wins, in visit order.
//
// Any hit keeps an occluded flag per ray instead of a winner.  A box is
// voted on by the rays not yet occluded, against t_max; a staged cluster
// sets the flag of every ray of the packet that meets one of its
// triangles.  The TPU kernels' "stop once every ray is occluded" is a
// packet decision taken at one loop point by every thread: a thread that is
// done keeps reaching every barrier.  Padding and parked rays are never
// occluded, so a packet holding one never exits early; that changes no
// flag, only the work.
//
// Triangle rows ([C,K,16] f32, four float4 per triangle):
//   Baldwin-Weber: n (0:3), d0 = n.v0 (3), p1 (4:7), c1 = -p1.v0 (7),
//                  p2 (8:11), c2 = -p2.v0 (11), 12..15 unused;
//   Moller-Trumbore: v0 (0:3), e1 (3:6), e2 (6:9), 9..15 unused.
// Padding rows are all zero and fail the den / det test.

#pragma once

#include <type_traits>

#include <cuda_runtime.h>

namespace cluster_traversal {

constexpr int kMissPrim = 0x7FFFFFFF;
// The tri_test argument of every launch function.
constexpr int kBaldwinWeber = 0;
constexpr int kMollerTrumbore = 1;

// XLA's minimum/maximum propagate NaN; fminf/fmaxf would drop it.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // guarded inverse direction
};

// The most rays whose every float offset of an [n,3] row fits an int
// (3 n - 1 < 2^31); above, a launch takes 64-bit offsets (RowOffset).
constexpr int kIntRowsMax = 715827882;
// A row's float offsets: int32 up to kIntRowsMax rays (the main path's
// pools measured fastest so), 64-bit above.
template <bool kWide>
using RowOffset = typename std::conditional<kWide, long long, int>::type;

// Ray i, its floats at offsets of type Off; past the end (i >= n) a
// padding ray that starts far out on +x and points away, so it overlaps
// no box.
template <typename Off>
__device__ __forceinline__ Ray load_ray(const float* origins, const float* dirs, int i, int n) {
  Ray r;
  r.ox = 3.0e37f;
  r.oy = 0.0f;
  r.oz = 0.0f;
  r.dx = 1.0f;
  r.dy = 0.0f;
  r.dz = 0.0f;
  if (i < n) {
    r.ox = origins[Off{3} * i];
    r.oy = origins[Off{3} * i + 1];
    r.oz = origins[Off{3} * i + 2];
    r.dx = dirs[Off{3} * i];
    r.dy = dirs[Off{3} * i + 1];
    r.dz = dirs[Off{3} * i + 2];
  }
  const float big = 3.4e38f;
  r.ix = fabsf(r.dx) > 1e-12f ? 1.0f / r.dx : big;
  r.iy = fabsf(r.dy) > 1e-12f ? 1.0f / r.dy : big;
  r.iz = fabsf(r.dz) > 1e-12f ? 1.0f / r.dz : big;
  return r;
}

__device__ __forceinline__ int octant_of(const Ray& r) {
  return (r.dx > 0.0f ? 1 : 0) + (r.dy > 0.0f ? 2 : 0) + (r.dz > 0.0f ? 4 : 0);
}

// Does the ray's segment [t_min, t_limit] overlap box b (min xyz, max xyz)?
__device__ __forceinline__ bool slab_hits(const float* b, const Ray& r, float t_min, float t_limit) {
  const float tx0 = (b[0] - r.ox) * r.ix;
  const float tx1 = (b[3] - r.ox) * r.ix;
  const float ty0 = (b[1] - r.oy) * r.iy;
  const float ty1 = (b[4] - r.oy) * r.iy;
  const float tz0 = (b[2] - r.oz) * r.iz;
  const float tz1 = (b[5] - r.oz) * r.iz;
  const float tnear = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)), min_nan(tz0, tz1));
  const float tfar = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)), max_nan(tz0, tz1));
  return (tnear <= tfar) && (tfar >= t_min) && (tnear <= t_limit);
}

// One ray against one triangle's rows r0 (n.xyz, d0), r1 (p1.xyz, c1) and
// r2 (p2.xyz, c2); `ok` is false where the test fails.
__device__ __forceinline__ void bw_test(const float4 r0, const float4 r1, const float4 r2,
                                        const Ray& r, float t_min, float t_max, float& t, float& u,
                                        float& v, bool& ok) {
  const float den = r0.x * r.dx + r0.y * r.dy + r0.z * r.dz;
  const float num = r0.w - (r0.x * r.ox + r0.y * r.oy + r0.z * r.oz);
  const float rcp = fabsf(den) > 1e-12f ? 1.0f / den : 0.0f;
  t = num * rcp;
  const float hx = r.ox + t * r.dx;
  const float hy = r.oy + t * r.dy;
  const float hz = r.oz + t * r.dz;
  u = r1.x * hx + r1.y * hy + r1.z * hz + r1.w;
  v = r2.x * hx + r2.y * hy + r2.z * hz + r2.w;
  // min(min(u, v), 1-(u+v)) >= 0 with NaN propagation: a NaN fails.
  ok = u >= 0.0f && v >= 0.0f && (1.0f - (u + v)) >= 0.0f && t > t_min && t < t_max &&
       rcp != 0.0f;
}

// Moller-Trumbore's quantities before its division: det = e1.p with
// p = d x e2, u's numerator a = t.p with the t-vector t = o - v0, v's
// numerator b = d.q with q = t x e1, and q itself (t's numerator e2.q
// needs it).
struct MtFront {
  float det, a, b, qx, qy, qz;
};

// The front of the test for Moller-Trumbore rows r0 (v0.xyz, e1.x), r1
// (e1.yz, e2.xy) and r2 (e2.z).
__device__ __forceinline__ MtFront mt_front(const float4 r0, const float4 r1, const float4 r2, const Ray& r) {
  const float v0x = r0.x, v0y = r0.y, v0z = r0.z;
  const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
  const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  MtFront f;
  f.det = e1x * px + e1y * py + e1z * pz;
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  f.a = tx * px + ty * py + tz * pz;
  f.qx = ty * e1z - tz * e1y;
  f.qy = tz * e1x - tx * e1z;
  f.qz = tx * e1y - ty * e1x;
  f.b = r.dx * f.qx + r.dy * f.qy + r.dz * f.qz;
  return f;
}

// The rest of the test on the front f and the triangle's e2: the
// division, u, v, t and the compares; `ok` is false where the test fails.
__device__ __forceinline__ void mt_tail(const MtFront& f, float e2x, float e2y, float e2z, float t_min,
                                        float t_max, float& t, float& u, float& v, bool& ok) {
  const float inv_det = fabsf(f.det) > 1e-12f ? 1.0f / f.det : 0.0f;
  u = f.a * inv_det;
  v = f.b * inv_det;
  t = (e2x * f.qx + e2y * f.qy + e2z * f.qz) * inv_det;
  ok = fabsf(f.det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min && t < t_max;
}

// The whole test, _mt_block's operations in its order.
__device__ __forceinline__ void mt_test(const float4 r0, const float4 r1, const float4 r2,
                                        const Ray& r, float t_min, float t_max, float& t, float& u,
                                        float& v, bool& ok) {
  mt_tail(mt_front(r0, r1, r2, r), r1.z, r1.w, r2.x, t_min, t_max, t, u, v, ok);
}

struct Best {
  float t;
  int prim;
  float u, v;
};

// The raw outputs of ray i: t, prim (kMissPrim on a miss) and uv, at
// offsets of type Off.
template <typename Off>
__device__ __forceinline__ void store_best(const Best& best, int i, float* t_out, int* prim_out, float* uv_out) {
  t_out[i] = best.t;
  prim_out[i] = best.prim;
  uv_out[Off{2} * i] = best.u;
  uv_out[Off{2} * i + 1] = best.v;
}

// The Hit of the ray in caller row `row` (restore_hits_plain): t, prim
// with -1 on a miss, bary with 0 on a miss (one 8-byte store), the hit
// byte.
__device__ __forceinline__ void store_hit(const Best& best, long long row, float* t_out, int* prim_out,
                                          float* bary_out, unsigned char* hit_out) {
  const bool hit = best.prim != kMissPrim;
  t_out[row] = best.t;
  prim_out[row] = hit ? best.prim : -1;
  reinterpret_cast<float2*>(bary_out)[row] = hit ? make_float2(best.u, best.v) : make_float2(0.0f, 0.0f);
  hit_out[row] = hit ? 1 : 0;
}

}  // namespace cluster_traversal
