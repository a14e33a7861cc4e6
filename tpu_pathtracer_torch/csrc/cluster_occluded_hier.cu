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
// two_level_occluded_kernel of cluster_two_level.cuh.
//
// What it computes.  One thread per ray, one block per packet (512 rays on
// the main path).  The packet visits the supers (groups of `branch` = 8
// clusters) in its first ray's octant order, front to back; a super and
// then each of its children in index order is voted on by the rays not
// yet occluded, against t_max; a child that passes is staged and every
// ray not yet occluded tests its triangles until the first valid one.  The
// child row is clamped to C-1 as on the TPU (padding children are far
// point boxes that no ray overlaps).  After each super that passed, the
// block leaves the loop if every ray is occluded.
//
// What bounds it.  The triangle tests of the children that pass, as in
// cluster_occluded.cu, plus two block votes per child of a passing super.
// A shadow ray needs one hit, not the closest, so front-to-back order and
// the block exit cut the work below cluster_hier.cu's on the same packets;
// unoccluded rays (the sky is visible) still walk every super they
// overlap.  The 6 MB of rows stay in the 50 MB L2.

#include "cluster_two_level.cuh"

// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int cluster_occluded_hier_launch(
    const float* tris, const float* aabb_child, const float* aabb_super,
    const int* order_super, const float* origins, const float* dirs, int n,
    int num_supers, int branch, int num_clusters, int cluster_k, float t_min,
    float t_max, int rays_per_packet, int tri_test, unsigned char* occ_out,
    void* stream) {
  return cluster_traversal::launch_two_level_occluded(
      tris, aabb_child, aabb_super, order_super, origins, dirs, n, num_supers,
      branch, num_clusters, cluster_k, t_min, t_max, rays_per_packet, tri_test,
      occ_out, stream);
}
