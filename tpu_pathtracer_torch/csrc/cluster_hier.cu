// Two-level closest-hit packet traversal, for Hopper.
//
// Replaces the TPU kernel `_cluster_kernel_hier` in
// tpu_pathtracer/ops/intersect_pallas.py (entry
// intersect_clusters_pallas_hier), the route of scenes with at least
// cfg.hier_min_clusters clusters and at most 6 MB of rows.  Its plain
// PyTorch version is intersect_clusters_hier_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false
// and IEEE division, the two give the same bits.  The body is
// two_level_kernel of cluster_two_level.cuh.
//
// What it computes.  One thread per ray, one block per packet (512 rays on
// the main path: a 131,072-ray batch is 256 blocks).  Supers are groups of
// `branch` (8) Morton-consecutive clusters with their own boxes.  The
// packet takes its octant from its first ray and visits the supers in that
// octant's front-to-back order.  Per super, a block vote on each ray's slab
// test against its running best t; for a super some ray overlaps, the same
// vote on each of its children in index order; a child some ray overlaps
// has its 8 KB of rows staged once into shared memory, and every ray of
// the packet tests all K triangles.  The super vote never changes a
// result: a super's box contains its children's and the slab arithmetic
// is monotone, so it only skips children that every ray would skip.
//
// What bounds it.  The triangle tests of the children that pass, as in
// cluster_intersect.cu, plus two block-wide votes per child of every super
// that passes (one __syncthreads_or each, 16 warps at 512 rays).  The
// design keeps the TPU kernel's two-level skip, which removes the per-
// cluster vote of the flat kernel for every super no ray reaches, and
// reads each staged cluster from the 50 MB L2 (a 6 MB scene stays
// resident).  Finer packets and persistent blocks are later work.

#include "cluster_two_level.cuh"

// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int cluster_hier_launch(
    const float* tris, const float* aabb_child, const float* aabb_super,
    const int* order_super, const float* origins, const float* dirs, int n,
    int num_supers, int branch, int num_clusters, int cluster_k, float t_min,
    float t_max, int rays_per_packet, int tri_test, float* t_out, int* prim_out,
    float* uv_out, void* stream) {
  return cluster_traversal::launch_two_level(
      tris, aabb_child, aabb_super, order_super, origins, dirs, n, num_supers,
      branch, num_clusters, cluster_k, t_min, t_max, rays_per_packet, tri_test,
      t_out, prim_out, uv_out, stream);
}
