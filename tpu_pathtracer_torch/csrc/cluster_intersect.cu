// Closest-hit packet traversal over Morton triangle clusters, for Hopper.
//
// Replaces the TPU kernel `_cluster_kernel` in
// tpu_pathtracer/ops/intersect_pallas.py (entry intersect_clusters_pallas),
// with its helpers _packet_rays, _slab_hits, _bw_tests and _mt_best.  Its
// plain PyTorch version is intersect_clusters_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false
// and IEEE division, the two give the same bits.
//
// What it computes.  One thread per ray; one block is one packet of
// `blockDim.x` rays.  The packet's direction octant comes from its first
// ray, and the packet visits the clusters in that octant's front-to-back
// order.  Per cluster, every ray slab-tests the cluster's box against its
// own running best t.  If no ray of the packet overlaps, the block skips
// the cluster (a block vote, __syncthreads_or, the counterpart of the TPU
// kernel's pl.when(jnp.any(overlap))).  Otherwise the cluster's K rows are
// staged once into shared memory and every ray of the packet, including
// those whose own slab test failed, runs the Baldwin-Weber test against
// all K triangles.  Within a cluster the smallest t wins and equal t goes
// to the lowest triangle id; across clusters a strictly smaller t wins, in
// visit order.
//
// What bounds it.  The triangle tests: about 30 float operations per
// ray-triangle pair, issued from shared memory that every thread of the
// block reads at the same address (a broadcast, no bank conflicts).  With
// 1024-ray packets a 131,072-ray batch is 128 blocks, at most one per SM,
// so the SMs run 32 of their 64 warps, and a packet whose rays diverge
// still pays for every cluster any of its rays overlaps.  This design keeps
// the per-cluster skip of the TPU kernel and stages each visited cluster
// once per packet; the rows are read from device memory once per packet
// and visit, 8 KB each, which the 50 MB L2 serves.  Warp-sized packets,
// persistent blocks and wider staging are later work.
//
// Rows ([C,K,16] f32): n (0:3), d0 = n.v0 (3), p1 (4:7), c1 = -p1.v0 (7),
// p2 (8:11), c2 = -p2.v0 (11), 12..15 unused; padding rows are all zero
// and fail the den test.

#include <cuda_runtime.h>

namespace {

constexpr int kMissPrim = 0x7FFFFFFF;

// XLA's minimum/maximum propagate NaN; fminf/fmaxf would drop it.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__global__ void cluster_intersect_kernel(
    const float4* __restrict__ tris,     // [C,K,4] float4 = [C,K,16] f32
    const float* __restrict__ aabb,      // [C,8] f32
    const int* __restrict__ order,       // [8,C] i32
    const float* __restrict__ origins,   // [N,3] f32
    const float* __restrict__ dirs,      // [N,3] f32
    int n, int num_clusters, int cluster_k, float t_min, float t_max,
    float* __restrict__ t_out,           // [N]
    int* __restrict__ prim_out,          // [N]
    float* __restrict__ uv_out) {        // [N,2]
  extern __shared__ float4 rows[];       // [K,4] float4: one cluster
  __shared__ int octant;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < n;
  // Padding rays start far out on +x and point away: they overlap no box.
  float ox = 3.0e37f, oy = 0.0f, oz = 0.0f;
  float dx = 1.0f, dy = 0.0f, dz = 0.0f;
  if (real) {
    ox = origins[3 * i];
    oy = origins[3 * i + 1];
    oz = origins[3 * i + 2];
    dx = dirs[3 * i];
    dy = dirs[3 * i + 1];
    dz = dirs[3 * i + 2];
  }
  const float big = 3.4e38f;
  const float ix = fabsf(dx) > 1e-12f ? 1.0f / dx : big;
  const float iy = fabsf(dy) > 1e-12f ? 1.0f / dy : big;
  const float iz = fabsf(dz) > 1e-12f ? 1.0f / dz : big;

  if (threadIdx.x == 0) {
    octant = (dx > 0.0f ? 1 : 0) + (dy > 0.0f ? 2 : 0) + (dz > 0.0f ? 4 : 0);
  }
  __syncthreads();
  const int* visit = order + octant * num_clusters;

  float best_t = t_max;
  int best_prim = kMissPrim;
  float best_u = 0.0f, best_v = 0.0f;

  for (int pos = 0; pos < num_clusters; ++pos) {
    const int c = visit[pos];
    const float* b = aabb + 8 * c;
    const float tx0 = (b[0] - ox) * ix;
    const float tx1 = (b[3] - ox) * ix;
    const float ty0 = (b[1] - oy) * iy;
    const float ty1 = (b[4] - oy) * iy;
    const float tz0 = (b[2] - oz) * iz;
    const float tz1 = (b[5] - oz) * iz;
    const float tnear = max_nan(
        max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)), min_nan(tz0, tz1));
    const float tfar = min_nan(
        min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)), max_nan(tz0, tz1));
    const bool overlap = (tnear <= tfar) && (tfar >= t_min) && (tnear <= best_t);
    if (!__syncthreads_or(overlap)) continue;

    const float4* src = tris + static_cast<size_t>(c) * cluster_k * 4;
    for (int j = threadIdx.x; j < cluster_k * 4; j += blockDim.x) rows[j] = src[j];
    __syncthreads();

    float t_blk = __int_as_float(0x7f800000);  // +inf
    int k_blk = 0;
    float u_blk = 0.0f, v_blk = 0.0f;
    for (int k = 0; k < cluster_k; ++k) {
      const float4 r0 = rows[4 * k];      // n.xyz, d0
      const float4 r1 = rows[4 * k + 1];  // p1.xyz, c1
      const float4 r2 = rows[4 * k + 2];  // p2.xyz, c2
      const float den = r0.x * dx + r0.y * dy + r0.z * dz;
      const float num = r0.w - (r0.x * ox + r0.y * oy + r0.z * oz);
      const float rcp = fabsf(den) > 1e-12f ? 1.0f / den : 0.0f;
      const float t = num * rcp;
      const float hx = ox + t * dx;
      const float hy = oy + t * dy;
      const float hz = oz + t * dz;
      const float u = r1.x * hx + r1.y * hy + r1.z * hz + r1.w;
      const float v = r2.x * hx + r2.y * hy + r2.z * hz + r2.w;
      // min(min(u, v), 1-(u+v)) >= 0 with NaN propagation: a NaN fails.
      const bool ok = u >= 0.0f && v >= 0.0f && (1.0f - (u + v)) >= 0.0f &&
                      t > t_min && t < t_max && rcp != 0.0f;
      if (ok && t < t_blk) {  // strict: equal t keeps the lower id
        t_blk = t;
        k_blk = k;
        u_blk = u;
        v_blk = v;
      }
    }
    if (t_blk < best_t) {
      best_t = t_blk;
      best_prim = c * cluster_k + k_blk;
      best_u = u_blk;
      best_v = v_blk;
    }
    __syncthreads();  // the next visited cluster overwrites the rows
  }

  if (real) {
    t_out[i] = best_t;
    prim_out[i] = best_prim;
    uv_out[2 * i] = best_u;
    uv_out[2 * i + 1] = best_v;
  }
}

}  // namespace

// Launches one block of `rays_per_packet` threads per packet on `stream`.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int cluster_intersect_launch(
    const float* tris, const float* aabb, const int* order,
    const float* origins, const float* dirs, int n, int num_clusters,
    int cluster_k, float t_min, float t_max, int rays_per_packet,
    float* t_out, int* prim_out, float* uv_out, void* stream) {
  if (n <= 0) return 0;
  const int packets = (n + rays_per_packet - 1) / rays_per_packet;
  const size_t smem = static_cast<size_t>(cluster_k) * 16 * sizeof(float);
  cluster_intersect_kernel<<<packets, rays_per_packet, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tris), aabb, order, origins, dirs, n,
      num_clusters, cluster_k, t_min, t_max, t_out, prim_out, uv_out);
  return static_cast<int>(cudaGetLastError());
}
