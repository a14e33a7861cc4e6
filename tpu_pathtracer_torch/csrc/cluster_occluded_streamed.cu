// Streamed any-hit packet traversal for scenes beyond 6 MB of cluster rows,
// for Hopper: NEE shadow rays on large scenes.
//
// Replaces the TPU kernel `_occlusion_kernel_streamed` in
// tpu_pathtracer/ops/intersect_pallas.py (entry
// occluded_clusters_pallas_streamed).  Its plain PyTorch version is
// occluded_clusters_streamed_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false
// and IEEE division, the two give the same flags.  The body is
// two_level_occluded_kernel<true> of cluster_common.cuh.
//
// What it computes.  The TPU kernel's contract without its grid: the
// supers that streamed_pads builds (groups of `branch` = 16 clusters over
// the padded range) in ascending id, children in index order, a child at
// or past num_clusters never tested; each vote is taken by the rays not
// yet occluded, against t_max, and after each super that passed the block
// leaves the loop if every ray is occluded (the TPU skips a tile's work
// once it is fully occluded).
//
// What bounds it, and why the TPU grid is not carried over.  The TPU
// kernel's block-major grid and per-tile scratch rows exist so VMEM streams
// the scene from HBM once per call.  On the H100 the 12.8 MB of rows of a
// 200k-triangle scene sit in the 50 MB L2, so each block walks the whole
// ascending-id super list itself; block_clusters then only sets the
// padding, and padding children are skipped.  The bound is the triangle
// tests of the children that pass plus two block votes per child of a
// passing super.  An any-hit ray's limit stays t_max whatever it visits,
// so ascending order costs this kernel only a later first hit, not the
// lost culling it costs the closest-hit kernel.

#include "cluster_common.cuh"

// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int cluster_occluded_streamed_launch(
    const float* tris, const float* aabb_child, const float* aabb_super,
    const float* origins, const float* dirs, int n, int num_supers, int branch,
    int num_clusters, int cluster_k, float t_min, float t_max,
    int rays_per_packet, int tri_test, unsigned char* occ_out, void* stream) {
  return cluster_traversal::launch_two_level_occluded<true>(
      tris, aabb_child, aabb_super, nullptr, origins, dirs, n, num_supers,
      branch, num_clusters, cluster_k, t_min, t_max, rays_per_packet, tri_test,
      occ_out, stream);
}
