// Streamed any-hit packet traversal for scenes beyond 6 MB of cluster rows,
// for Hopper: NEE shadow rays on large scenes.
//
// Replaces the TPU kernel `_occlusion_kernel_streamed` in
// tpu_pathtracer/ops/intersect_pallas.py (entry
// occluded_clusters_pallas_streamed).  Its plain PyTorch version is
// occluded_clusters_streamed_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false
// and IEEE division, the two give the same flags.  The body is
// streamed_kernel<true, kAscending, ...> of cluster_streamed.cuh.
//
// What it computes.  The TPU kernel's contract without its grid: the
// supers that streamed_pads builds (groups of `branch` = 16 clusters over
// the padded range) in ascending id, children in index order, a child at
// or past num_clusters never tested; each vote is taken by the rays not
// yet occluded, against t_max, and a packet whose rays are all occluded
// leaves the walk (the TPU skips a tile's work once it is fully occluded).
// The TPU kernel's block-major grid and per-tile scratch rows exist so
// VMEM streams the scene from HBM once per call; on the H100 the 12.8 MB of
// rows of a 200k-triangle scene sit in the 50 MB L2, so each packet walks
// the whole ascending-id super list itself.
//
// What bounds it.  Operations, and the shape of the work, as the closest-hit
// kernel (cluster_streamed.cu): the packets that set the time are those
// whose rays stay unoccluded and test every child they overlap, a few
// hundred of them, in one dependent chain.  An any-hit ray's limit stays
// t_max whatever it visits, so ascending order costs this kernel only a
// later first hit, not lost culling.  The design (cluster_streamed.cuh) is
// the closest-hit kernel's: a packet over a thread block cluster, several
// threads per ray whose flags are OR-ed, one vote for the next child,
// prefetched rows; the all-occluded exit rides on the super votes as one
// more bit.

#include "cluster_streamed.cuh"

// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows.  `order` is
// null or the packet each cluster takes.  `perm` null or each ray's caller
// row: the flags go to that row.  Returns the launch's error
// (0 = launched).
extern "C" int cluster_occluded_streamed_launch(
    const float* tris, const float* aabb_child, const float* aabb_super,
    const float* origins, const float* dirs, const int* order, int n,
    int num_supers, int branch, int num_clusters, int cluster_k, float t_min,
    float t_max, int rays_per_packet, int tri_test, const long long* perm, unsigned char* occ_out, void* stream) {
  return cluster_traversal::launch_streamed<true, cluster_traversal::kAscending>(
      tris, aabb_child, aabb_super, nullptr, origins, dirs, order, n, num_supers, branch,
      num_clusters, cluster_k, t_min, t_max, rays_per_packet, tri_test,
      perm, nullptr, nullptr, nullptr, nullptr, occ_out, stream);
}

// Each packet's work estimate into weights[packets] (packet_weight_kernel).
extern "C" int cluster_occluded_streamed_weights(
    const float* aabb_super, const float* origins, const float* dirs, int n,
    int num_supers, float t_min, float t_max, int rays_per_packet, int* weights,
    void* stream) {
  return cluster_traversal::launch_packet_weights(
      aabb_super, origins, dirs, n, num_supers, t_min, t_max, rays_per_packet,
      weights, stream);
}

// The launch shape n rays would take, into out[6] (describe_streamed).
extern "C" int cluster_occluded_streamed_shape(int n, int rays_per_packet, int cluster_k,
                          int tri_test, int* out) {
  return cluster_traversal::describe_streamed<true, cluster_traversal::kAscending>(
      n, rays_per_packet, cluster_k, tri_test, out);
}
