// Two-level any-hit packet traversal, for Hopper: NEE shadow rays on scenes
// of the two-level route.
//
// Replaces the TPU kernel `_occlusion_kernel_hier` in
// tpu_pathtracer/ops/intersect_pallas.py (entry
// occluded_clusters_pallas_hier), the route of scenes with at least
// cfg.hier_min_clusters clusters and at most 6 MB of rows.  Its plain
// PyTorch version is occluded_clusters_hier_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false
// and IEEE division, the two give the same flags.  The body is
// streamed_kernel<true, kPerPacket, ...> of cluster_streamed.cuh.
//
// What it computes.  Packets of 512 rays on the main path.  The packet
// visits the supers (groups of `branch` = 8 clusters) in its first ray's
// octant order, front to back; a super and then each of its children in
// index order is voted on by the rays not yet occluded, against t_max; a
// child that passes is staged (row clamped to C-1 as on the TPU) and every
// ray not yet occluded tests its triangles until the first valid one.  A
// packet whose rays are all occluded leaves the walk: the TPU kernel and
// the plain version check after each super, this kernel at its next super
// vote, which changes no flag since an occluded ray votes for nothing.
//
// What bounds it.  Operations and the shape of the work, as the
// closest-hit kernel (cluster_hier.cu): the packets that set the time are
// those whose rays stay unoccluded (the sky is visible) and test every
// child they overlap.  The design is that kernel's (cluster_streamed.cuh):
// a packet over a thread block cluster of up to 8 SMs, several threads per
// ray whose flags are OR-ed, one vote for the next child, prefetched rows,
// packets heaviest first; the all-occluded exit is one more bit of the
// super votes.

#include "cluster_streamed.cuh"

// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows.  `order` is
// null or the packet each cluster takes.  `perm` null or each ray's caller
// row: the flags go to that row.  Returns the launch's error
// (0 = launched).
extern "C" int cluster_occluded_hier_launch(
    const float* tris, const float* aabb_child, const float* aabb_super,
    const int* order_super, const float* origins, const float* dirs,
    const int* order, int n, int num_supers, int branch, int num_clusters,
    int cluster_k, float t_min, float t_max, int rays_per_packet, int tri_test,
    const long long* perm, unsigned char* occ_out, void* stream) {
  return cluster_traversal::launch_streamed<true, cluster_traversal::kPerPacket>(
      tris, aabb_child, aabb_super, order_super, origins, dirs, order, n,
      num_supers, branch, num_clusters, cluster_k, t_min, t_max,
      rays_per_packet, tri_test, perm, nullptr, nullptr, nullptr, nullptr, occ_out, stream);
}

// Each packet's work estimate into weights[packets] (packet_weight_kernel).
extern "C" int cluster_occluded_hier_weights(
    const float* aabb_super, const float* origins, const float* dirs, int n,
    int num_supers, float t_min, float t_max, int rays_per_packet, int* weights,
    void* stream) {
  return cluster_traversal::launch_packet_weights(
      aabb_super, origins, dirs, n, num_supers, t_min, t_max, rays_per_packet,
      weights, stream);
}

// The launch shape n rays would take, into out[6] (describe_streamed).
extern "C" int cluster_occluded_hier_shape(int n, int rays_per_packet, int cluster_k,
                                           int tri_test, int* out) {
  return cluster_traversal::describe_streamed<true, cluster_traversal::kPerPacket>(
      n, rays_per_packet, cluster_k, tri_test, out);
}
