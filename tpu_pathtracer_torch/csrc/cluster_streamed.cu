// Streamed closest-hit packet traversal for scenes beyond 6 MB of cluster
// rows, for Hopper.
//
// Replaces the TPU kernel `_cluster_kernel_streamed` in
// tpu_pathtracer/ops/intersect_pallas.py (entry
// intersect_clusters_pallas_streamed).  Its plain PyTorch version is
// intersect_clusters_streamed_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false
// and IEEE division, the two give the same bits.  The body is
// two_level_kernel<true> of cluster_common.cuh.
//
// What it computes.  The TPU kernel's contract without its grid: supers are
// the groups of `branch` (16) clusters that streamed_pads builds over the
// padded cluster range, visited in ascending id, children in index order,
// and a child at or past num_clusters is never tested.  One thread per ray,
// one block per packet of 512 rays, the same block votes, staging and
// triangle tests as cluster_hier.cu.  The results do not depend on the
// TPU's block_clusters: it only sets how far the range is padded, and
// padding children are skipped.
//
// What bounds it, and why the TPU grid is not carried over.  The TPU
// kernel runs a block-major grid with (tiles, R) scratch rows so that VMEM
// streams the scene from HBM once per call.  On the H100 the rows of a
// 200k-triangle scene (12.8 MB) sit in the 50 MB L2, so every block walks
// the whole super list itself and reads its staged children from L2; the
// bound is the triangle tests of the children that pass plus two block
// votes per child of a passing super.  The ascending visit order culls
// less than a front-to-back one (a packet finds its closest hit later), so
// this kernel tests more children per ray than cluster_hier.cu does on a
// scene of the same size.

#include "cluster_common.cuh"

// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int cluster_streamed_launch(
    const float* tris, const float* aabb_child, const float* aabb_super,
    const float* origins, const float* dirs, int n, int num_supers, int branch,
    int num_clusters, int cluster_k, float t_min, float t_max,
    int rays_per_packet, int tri_test, float* t_out, int* prim_out,
    float* uv_out, void* stream) {
  return cluster_traversal::launch_two_level<true>(
      tris, aabb_child, aabb_super, nullptr, origins, dirs, n, num_supers,
      branch, num_clusters, cluster_k, t_min, t_max, rays_per_packet, tri_test,
      t_out, prim_out, uv_out, stream);
}
