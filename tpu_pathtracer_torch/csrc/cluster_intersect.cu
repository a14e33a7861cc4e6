// Closest-hit packet traversal over Morton triangle clusters, for Hopper.
//
// Replaces the TPU kernel `_cluster_kernel` in
// tpu_pathtracer/ops/intersect_pallas.py (entry intersect_clusters_pallas),
// with its helpers _packet_rays, _slab_hits, _bw_tests, _mt_tests and
// _mt_best.  Its plain PyTorch version is intersect_clusters_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false
// and IEEE division, the two give the same bits.  The slab test, the two
// triangle tests and the winner update are in cluster_common.cuh.
//
// What it computes.  One thread per ray; one block is one packet of
// `blockDim.x` rays.  The packet's direction octant comes from its first
// ray, and the packet visits the clusters in that octant's front-to-back
// order.  Per cluster, the packet gate of cluster_common.cuh: a block vote
// skips a cluster no ray overlaps, and otherwise the cluster's K rows are
// staged once into shared memory and every ray tests all K triangles,
// Baldwin-Weber or Moller-Trumbore as the launch asks.
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

#include "cluster_common.cuh"

namespace {

using namespace cluster_traversal;

template <int kTest>
__global__ void __launch_bounds__(1024) cluster_intersect_kernel(
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
  const Ray r = load_ray(origins, dirs, i, n);
  if (threadIdx.x == 0) octant = octant_of(r);
  __syncthreads();
  const int* visit = order + octant * num_clusters;
  Best best = {t_max, kMissPrim, 0.0f, 0.0f};

  for (int pos = 0; pos < num_clusters; ++pos) {
    const int c = visit[pos];
    if (!__syncthreads_or(slab_hits(aabb + 8 * c, r, t_min, best.t))) continue;
    stage_rows(rows, tris, c, cluster_k);
    __syncthreads();
    test_cluster<kTest>(rows, cluster_k, c, r, t_min, t_max, best);
    __syncthreads();  // the next visited cluster overwrites the rows
  }
  store_best(best, i, n, t_out, prim_out, uv_out);
}

}  // namespace

// Launches one block of `rays_per_packet` threads per packet on `stream`;
// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int cluster_intersect_launch(
    const float* tris, const float* aabb, const int* order,
    const float* origins, const float* dirs, int n, int num_clusters,
    int cluster_k, float t_min, float t_max, int rays_per_packet, int tri_test,
    float* t_out, int* prim_out, float* uv_out, void* stream) {
  if (n <= 0) return 0;
  const int packets = (n + rays_per_packet - 1) / rays_per_packet;
  const size_t smem = static_cast<size_t>(cluster_k) * 16 * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* rows = reinterpret_cast<const float4*>(tris);
  if (tri_test == cluster_traversal::kMollerTrumbore) {
    cluster_intersect_kernel<cluster_traversal::kMollerTrumbore><<<packets, rays_per_packet, smem, st>>>(
        rows, aabb, order, origins, dirs, n, num_clusters, cluster_k, t_min, t_max,
        t_out, prim_out, uv_out);
  } else {
    cluster_intersect_kernel<cluster_traversal::kBaldwinWeber><<<packets, rays_per_packet, smem, st>>>(
        rows, aabb, order, origins, dirs, n, num_clusters, cluster_k, t_min, t_max,
        t_out, prim_out, uv_out);
  }
  return static_cast<int>(cudaGetLastError());
}
