// The two-level (hier) traversal bodies, closest hit (cluster_hier.cu) and
// any hit (cluster_occluded_hier.cu): one thread per ray, one block per
// packet, over the device code of cluster_common.cuh.

#pragma once

#include "cluster_common.cuh"

namespace cluster_traversal {

// Two-level traversal: supers of `branch` consecutive children.  A packet
// slab-tests each super, and for a super some ray overlaps, each of its
// children in index order; a child some ray overlaps is staged and tested.
// Supers come in the packet octant's front-to-back order `order_super`;
// padding children are far point boxes that no ray overlaps, and the row
// index is clamped to C-1 all the same.
template <int kTest>
__global__ void __launch_bounds__(1024) two_level_kernel(const float4* __restrict__ tris,        // [C,K,4] float4
                                 const float* __restrict__ aabb_child,   // [S*branch,8]
                                 const float* __restrict__ aabb_super,   // [S,8]
                                 const int* __restrict__ order_super,    // [8,S]
                                 const float* __restrict__ origins,      // [N,3]
                                 const float* __restrict__ dirs,         // [N,3]
                                 int n, int num_supers, int branch, int num_clusters, int cluster_k,
                                 float t_min, float t_max,
                                 float* __restrict__ t_out,              // [N]
                                 int* __restrict__ prim_out,             // [N]
                                 float* __restrict__ uv_out) {           // [N,2]
  extern __shared__ float4 rows[];  // [K,4] float4: one cluster
  __shared__ int octant;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = load_ray(origins, dirs, i, n);
  if (threadIdx.x == 0) octant = octant_of(r);  // the packet's first ray
  __syncthreads();
  Best best = {t_max, kMissPrim, 0.0f, 0.0f};

  for (int pos = 0; pos < num_supers; ++pos) {
    const int s = order_super[octant * num_supers + pos];
    if (!__syncthreads_or(slab_hits(aabb_super + 8 * s, r, t_min, best.t))) continue;
    for (int j = 0; j < branch; ++j) {
      const int c = s * branch + j;
      if (!__syncthreads_or(slab_hits(aabb_child + 8 * c, r, t_min, best.t))) continue;
      stage_rows(rows, tris, min(c, num_clusters - 1), cluster_k);
      __syncthreads();
      test_cluster<kTest>(rows, cluster_k, c, r, t_min, t_max, best);
      __syncthreads();  // the next child overwrites the rows
    }
  }
  store_best(best, i, n, t_out, prim_out, uv_out);
}

// Launches one block of `rays_per_packet` threads per packet on `stream`.
// Returns cudaGetLastError() after the launch (0 = launched).
inline int launch_two_level(const float* tris, const float* aabb_child, const float* aabb_super,
                     const int* order_super, const float* origins, const float* dirs, int n,
                     int num_supers, int branch, int num_clusters, int cluster_k, float t_min,
                     float t_max, int rays_per_packet, int tri_test, float* t_out, int* prim_out,
                     float* uv_out, void* stream) {
  if (n <= 0) return 0;
  const int packets = (n + rays_per_packet - 1) / rays_per_packet;
  const size_t smem = static_cast<size_t>(cluster_k) * 16 * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* rows = reinterpret_cast<const float4*>(tris);
  if (tri_test == kMollerTrumbore) {
    two_level_kernel<kMollerTrumbore><<<packets, rays_per_packet, smem, st>>>(
        rows, aabb_child, aabb_super, order_super, origins, dirs, n, num_supers, branch,
        num_clusters, cluster_k, t_min, t_max, t_out, prim_out, uv_out);
  } else {
    two_level_kernel<kBaldwinWeber><<<packets, rays_per_packet, smem, st>>>(
        rows, aabb_child, aabb_super, order_super, origins, dirs, n, num_supers, branch,
        num_clusters, cluster_k, t_min, t_max, t_out, prim_out, uv_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Two-level any hit: two_level_kernel's visit order and row clamp, with the
// any-hit votes and the exit after a super.
template <int kTest>
__global__ void __launch_bounds__(1024) two_level_occluded_kernel(
    const float4* __restrict__ tris,        // [C,K,4] float4
    const float* __restrict__ aabb_child,   // [S*branch,8]
    const float* __restrict__ aabb_super,   // [S,8]
    const int* __restrict__ order_super,    // [8,S]
    const float* __restrict__ origins,      // [N,3]
    const float* __restrict__ dirs,         // [N,3]
    int n, int num_supers, int branch, int num_clusters, int cluster_k,
    float t_min, float t_max,
    unsigned char* __restrict__ occ_out) {  // [N] bool
  extern __shared__ float4 rows[];  // [K,4] float4: one cluster
  __shared__ int octant;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = load_ray(origins, dirs, i, n);
  if (threadIdx.x == 0) octant = octant_of(r);  // the packet's first ray
  __syncthreads();
  bool occluded = false;

  for (int pos = 0; pos < num_supers; ++pos) {
    const int s = order_super[octant * num_supers + pos];
    if (!__syncthreads_or(!occluded && slab_hits(aabb_super + 8 * s, r, t_min, t_max))) continue;
    for (int j = 0; j < branch; ++j) {
      const int c = s * branch + j;
      if (!__syncthreads_or(!occluded && slab_hits(aabb_child + 8 * c, r, t_min, t_max))) continue;
      occlude_cluster<kTest>(rows, tris, min(c, num_clusters - 1), cluster_k, r,
                             t_min, t_max, occluded);
    }
    if (__syncthreads_and(occluded)) break;  // every ray of the packet is occluded
  }
  if (i < n) occ_out[i] = occluded ? 1 : 0;
}

// Launches one block of `rays_per_packet` threads per packet on `stream`.
// Returns cudaGetLastError() after the launch (0 = launched).
inline int launch_two_level_occluded(const float* tris, const float* aabb_child, const float* aabb_super,
                              const int* order_super, const float* origins, const float* dirs,
                              int n, int num_supers, int branch, int num_clusters, int cluster_k,
                              float t_min, float t_max, int rays_per_packet, int tri_test,
                              unsigned char* occ_out, void* stream) {
  if (n <= 0) return 0;
  const int packets = (n + rays_per_packet - 1) / rays_per_packet;
  const size_t smem = static_cast<size_t>(cluster_k) * 16 * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* rows = reinterpret_cast<const float4*>(tris);
  if (tri_test == kMollerTrumbore) {
    two_level_occluded_kernel<kMollerTrumbore><<<packets, rays_per_packet, smem, st>>>(
        rows, aabb_child, aabb_super, order_super, origins, dirs, n, num_supers, branch,
        num_clusters, cluster_k, t_min, t_max, occ_out);
  } else {
    two_level_occluded_kernel<kBaldwinWeber><<<packets, rays_per_packet, smem, st>>>(
        rows, aabb_child, aabb_super, order_super, origins, dirs, n, num_supers, branch,
        num_clusters, cluster_k, t_min, t_max, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cluster_traversal
