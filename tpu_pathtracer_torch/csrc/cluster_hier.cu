// Two-level closest-hit packet traversal, for Hopper.
//
// Replaces the TPU kernel `_cluster_kernel_hier` in
// tpu_pathtracer/ops/intersect_pallas.py (entry
// intersect_clusters_pallas_hier), the route of scenes with at least
// cfg.hier_min_clusters clusters and at most 6 MB of rows.  Its plain
// PyTorch version is intersect_clusters_hier_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false
// and IEEE division, the two give the same bits.  The body is
// streamed_kernel<false, kPerPacket, ...> of cluster_streamed.cuh, the
// streamed route's body in the packet's own visit order.
//
// What it computes.  Packets of 512 rays on the main path (a 131,072-ray
// batch is 256 packets).  Supers are groups of `branch` (8) Morton-
// consecutive clusters with their own boxes.  A packet takes its octant
// from its first ray and visits the supers in that octant's front-to-back
// order_super; a super some ray overlaps within its best t has each of its
// children voted on in index order, and a child some ray overlaps has its
// 8 KB of rows (row index clamped to C-1: padding children are far point
// boxes) staged into shared memory, where every ray of the packet tests
// all K triangles.  The super vote never changes a result: a super's box
// contains its children's and the slab arithmetic is monotone.
//
// What bounds it.  Operations: the triangle tests of the children that
// pass (on BASELINE config 4 a packet tests 52.5 of 766 children on
// average, 77 instructions a test as the arithmetic must be written), and
// before that the shape of the work, a packet's walk being one dependent
// chain of votes and tests.  The 6 MB of rows stay in the 50 MB L2.  The
// design (cluster_streamed.cuh) spreads a packet over a thread block
// cluster of up to 8 SMs with up to 8 threads per ray, finds the next
// super or child with one vote over a mask of candidates, prefetches the
// next candidate's rows by cp.async while the current child is tested, and
// takes the packets heaviest first.  Front-to-back order lets a packet's
// best t cull early, so its chain is shorter than on the streamed route.

#include "cluster_streamed.cuh"

// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows. `order` is null
// or the packet each cluster takes. `perm` null (raw outputs in the rays'
// order, or with hit_out the Hit) or each ray's caller row (with hit_out: the
// Hit in caller order); see streamed_kernel. Returns the launch's error (0 =
// launched).
extern "C" int cluster_hier_launch(
    const float* tris, const float* aabb_child, const float* aabb_super,
    const int* order_super, const float* origins, const float* dirs,
    const int* order, int n, int num_supers, int branch, int num_clusters,
    int cluster_k, float t_min, float t_max, int rays_per_packet, int tri_test,
    const long long* perm, float* t_out, int* prim_out, float* uv_out, unsigned char* hit_out, void* stream) {
  return cluster_traversal::launch_streamed<false, cluster_traversal::kPerPacket>(
      tris, aabb_child, aabb_super, order_super, origins, dirs, order, n,
      num_supers, branch, num_clusters, cluster_k, t_min, t_max,
      rays_per_packet, tri_test, perm, t_out, prim_out, uv_out, hit_out, nullptr, stream);
}

// Each packet's work estimate into weights[packets] (packet_weight_kernel).
extern "C" int cluster_hier_weights(
    const float* aabb_super, const float* origins, const float* dirs, int n,
    int num_supers, float t_min, float t_max, int rays_per_packet, int* weights,
    void* stream) {
  return cluster_traversal::launch_packet_weights(
      aabb_super, origins, dirs, n, num_supers, t_min, t_max, rays_per_packet,
      weights, stream);
}

// The launch shape n rays would take, into out[6] (describe_streamed).
extern "C" int cluster_hier_shape(int n, int rays_per_packet, int cluster_k,
                                  int tri_test, int* out) {
  return cluster_traversal::describe_streamed<false, cluster_traversal::kPerPacket>(
      n, rays_per_packet, cluster_k, tri_test, out);
}
