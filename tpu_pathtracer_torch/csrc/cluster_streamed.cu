// Streamed closest-hit packet traversal for scenes beyond 6 MB of cluster
// rows, for Hopper.
//
// Replaces the TPU kernel `_cluster_kernel_streamed` in
// tpu_pathtracer/ops/intersect_pallas.py (entry
// intersect_clusters_pallas_streamed).  Its plain PyTorch version is
// intersect_clusters_streamed_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false
// and IEEE division, the two give the same bits.  The body is
// streamed_kernel<false, kAscending, ...> of cluster_streamed.cuh.
//
// What it computes.  The TPU kernel's contract without its grid: supers are
// the groups of `branch` (16) clusters that streamed_pads builds over the
// padded cluster range, visited in ascending id, children in index order,
// and a child at or past num_clusters is never tested.  The results do not
// depend on the TPU's block_clusters: it only sets how far the range is
// padded, and padding children are skipped.  The TPU kernel runs a
// block-major grid with (tiles, R) scratch rows so that VMEM streams the
// scene from HBM once per call; on the H100 the rows of a 200k-triangle
// scene (12.8 MB) sit in the 50 MB L2, so every packet walks the whole
// super list itself and stages the children it tests from L2.
//
// What bounds it.  Operations, not bytes: the triangle tests of the
// children that pass (77 instructions each as the arithmetic must be
// written), and before that the shape of the work: a packet's walk
// is one dependent chain of votes and tests, and the ascending visit order
// culls late, so a few packets test a third of the scene while half of
// them test next to nothing.  The design (cluster_streamed.cuh) spreads a
// packet over a thread block cluster of up to 8 SMs with up to 8 threads
// per ray, finds the next child with one vote over a mask of candidates,
// and prefetches the next candidate's rows while the current child is
// tested.

#include "cluster_streamed.cuh"

// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows. `order` is null
// or the packet each cluster takes. `perm` null (raw outputs in the rays'
// order, or with hit_out the Hit) or each ray's caller row (with hit_out: the
// Hit in caller order); see streamed_kernel. Returns the launch's error (0 =
// launched).
extern "C" int cluster_streamed_launch(
    const float* tris, const float* aabb_child, const float* aabb_super,
    const float* origins, const float* dirs, const int* order, int n,
    int num_supers, int branch, int num_clusters, int cluster_k, float t_min,
    float t_max, int rays_per_packet, int tri_test, const long long* perm, float* t_out, int* prim_out, float* uv_out,
    unsigned char* hit_out, void* stream) {
  return cluster_traversal::launch_streamed<false, cluster_traversal::kAscending>(
      tris, aabb_child, aabb_super, nullptr, origins, dirs, order, n, num_supers, branch,
      num_clusters, cluster_k, t_min, t_max, rays_per_packet, tri_test,
      perm, t_out, prim_out, uv_out, hit_out, nullptr, stream);
}

// Each packet's work estimate into weights[packets] (packet_weight_kernel).
extern "C" int cluster_streamed_weights(
    const float* aabb_super, const float* origins, const float* dirs, int n,
    int num_supers, float t_min, float t_max, int rays_per_packet, int* weights,
    void* stream) {
  return cluster_traversal::launch_packet_weights(
      aabb_super, origins, dirs, n, num_supers, t_min, t_max, rays_per_packet,
      weights, stream);
}

// The launch shape n rays would take, into out[6] (describe_streamed).
extern "C" int cluster_streamed_shape(int n, int rays_per_packet, int cluster_k,
                          int tri_test, int* out) {
  return cluster_traversal::describe_streamed<false, cluster_traversal::kAscending>(
      n, rays_per_packet, cluster_k, tri_test, out);
}
