// Any-hit packet traversal over Morton triangle clusters, for Hopper: the
// shadow rays of next-event estimation.
//
// Replaces the TPU kernel `_occlusion_kernel` in
// tpu_pathtracer/ops/intersect_pallas.py (entry occluded_clusters_pallas).
// Its plain PyTorch version is occluded_clusters_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false and
// IEEE division, the two give the same flags.  The slab test, the two
// triangle tests and the any-hit step are in cluster_common.cuh.
//
// What it computes.  One thread per ray, one block per packet of
// `blockDim.x` rays (1024 on the headline's 25 clusters).  The packet
// visits the clusters in its first ray's octant order; a block vote of the
// rays not yet occluded, each slab-testing the box against t_max, skips a
// cluster no such ray overlaps.  A visited cluster is staged once into
// shared memory and every ray not yet occluded tests its triangles until
// the first valid one.  After each visited cluster the block leaves the
// loop if every ray is occluded (__syncthreads_and).
//
// What bounds it.  The triangle tests (33 float operations each for
// Baldwin-Weber) of the clusters a packet visits; a shadow ray stops at
// its first hit, and a packet stops once all its rays are occluded, so it
// does less work than the closest-hit kernel on the same packets.  The
// bytes are small: 24 B in and 1 B out per ray, and 0.2 MB of rows that
// stay in L2.  Parked rays (inactive lanes, moved outside the scene and
// sorted into packets of their own) vote for nothing, so such a packet
// costs one vote per cluster.  Finer packets and persistent blocks are
// later work.

#include "cluster_common.cuh"

namespace {

using namespace cluster_traversal;

template <int kTest>
__global__ void __launch_bounds__(1024) cluster_occluded_kernel(
    const float4* __restrict__ tris,     // [C,K,4] float4 = [C,K,16] f32
    const float* __restrict__ aabb,      // [C,8] f32
    const int* __restrict__ order,       // [8,C] i32
    const float* __restrict__ origins,   // [N,3] f32
    const float* __restrict__ dirs,      // [N,3] f32
    int n, int num_clusters, int cluster_k, float t_min, float t_max,
    unsigned char* __restrict__ occ_out) {  // [N] bool
  extern __shared__ float4 rows[];       // [K,4] float4: one cluster
  __shared__ int octant;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = load_ray(origins, dirs, i, n);
  if (threadIdx.x == 0) octant = octant_of(r);
  __syncthreads();
  const int* visit = order + octant * num_clusters;
  bool occluded = false;

  for (int pos = 0; pos < num_clusters; ++pos) {
    const int c = visit[pos];
    if (!__syncthreads_or(!occluded && slab_hits(aabb + 8 * c, r, t_min, t_max))) continue;
    occlude_cluster<kTest>(rows, tris, c, cluster_k, r, t_min, t_max, occluded);
    if (__syncthreads_and(occluded)) break;  // every ray of the packet is occluded
  }
  if (i < n) occ_out[i] = occluded ? 1 : 0;
}

}  // namespace

// Launches one block of `rays_per_packet` threads per packet on `stream`;
// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int cluster_occluded_launch(
    const float* tris, const float* aabb, const int* order,
    const float* origins, const float* dirs, int n, int num_clusters,
    int cluster_k, float t_min, float t_max, int rays_per_packet, int tri_test,
    unsigned char* occ_out, void* stream) {
  if (n <= 0) return 0;
  const int packets = (n + rays_per_packet - 1) / rays_per_packet;
  const size_t smem = static_cast<size_t>(cluster_k) * 16 * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* rows = reinterpret_cast<const float4*>(tris);
  if (tri_test == cluster_traversal::kMollerTrumbore) {
    cluster_occluded_kernel<cluster_traversal::kMollerTrumbore><<<packets, rays_per_packet, smem, st>>>(
        rows, aabb, order, origins, dirs, n, num_clusters, cluster_k, t_min, t_max, occ_out);
  } else {
    cluster_occluded_kernel<cluster_traversal::kBaldwinWeber><<<packets, rays_per_packet, smem, st>>>(
        rows, aabb, order, origins, dirs, n, num_clusters, cluster_k, t_min, t_max, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}
