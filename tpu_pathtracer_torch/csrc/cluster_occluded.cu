// Flat any-hit packet traversal over Morton triangle clusters, for Hopper:
// the shadow rays of next-event estimation.
//
// Replaces the TPU kernel `_occlusion_kernel` in
// tpu_pathtracer/ops/intersect_pallas.py (entry occluded_clusters_pallas).
// Its plain PyTorch version is occluded_clusters_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false and
// IEEE division, the two give the same flags.  The body is
// streamed_kernel<true, kFlat, ...> of cluster_streamed.cuh.
//
// What it computes.  Packets of 1,024 rays (the headline's 25 clusters).
// The packet visits the clusters in its first ray's octant order; a cluster
// is voted on by the rays not yet occluded, each slab-testing its box
// against t_max, and a cluster that passes is staged into shared memory,
// where every ray not yet occluded tests its triangles until the first
// valid one.  A packet whose rays are all occluded leaves the walk: the TPU
// kernel and the plain version check after each cluster, this kernel at its
// next vote (the alive bit), which changes no flag since an occluded ray
// votes for nothing.
//
// What bounds it.  Operations and the shape of the work: on the headline's
// NEE shadow rays half the 128 packets test no cluster (their lanes are
// parked or see the sky at once) and the heaviest test 24 of 25, so with
// one block a packet the time was those few chains on a few SMs.  The
// design is the closest-hit kernel's (cluster_intersect.cu,
// cluster_streamed.cuh): a packet over a thread block cluster of up to 8
// SMs, several threads a ray whose flags are OR-ed, one vote for the next
// cluster, its rows prefetched, packets heaviest first.
// The tensor cores do not apply: a wgmma or TF32 product would round
// otherwise than the plain version's float32 operations; what the design
// takes from Hopper is thread block clusters, distributed shared memory and
// cp.async.

#include "cluster_streamed.cuh"

// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows.  `visit` is
// each octant's visit order ([8,C]); `order` null or the packet each
// thread block cluster takes.  `perm` null or each ray's caller
// row: the flags go to that row.  Returns the launch's error (0 = launched).
extern "C" int cluster_occluded_launch(
    const float* tris, const float* aabb, const int* visit, const float* origins,
    const float* dirs, const int* order, int n, int num_clusters, int cluster_k,
    float t_min, float t_max, int rays_per_packet, int tri_test,
    const long long* perm, unsigned char* occ_out, void* stream) {
  return cluster_traversal::launch_streamed<true, cluster_traversal::kFlat>(
      tris, aabb, aabb, visit, origins, dirs, order, n, num_clusters, 1,
      num_clusters, cluster_k, t_min, t_max, rays_per_packet, tri_test, perm, nullptr,
      nullptr, nullptr, nullptr, occ_out, stream);
}

// Each packet's work estimate into weights[packets] (packet_weight_kernel).
extern "C" int cluster_occluded_weights(
    const float* aabb, const float* origins, const float* dirs, int n,
    int num_clusters, float t_min, float t_max, int rays_per_packet,
    int* weights, void* stream) {
  return cluster_traversal::launch_packet_weights(
      aabb, origins, dirs, n, num_clusters, t_min, t_max, rays_per_packet,
      weights, stream);
}

// The launch shape n rays would take, into out[6] (describe_streamed).
extern "C" int cluster_occluded_shape(int n, int rays_per_packet, int cluster_k,
                                      int tri_test, int* out) {
  return cluster_traversal::describe_streamed<true, cluster_traversal::kFlat>(
      n, rays_per_packet, cluster_k, tri_test, out);
}
