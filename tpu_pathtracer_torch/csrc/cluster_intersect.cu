// Flat closest-hit packet traversal over Morton triangle clusters, for
// Hopper.
//
// Replaces the TPU kernel `_cluster_kernel` in
// tpu_pathtracer/ops/intersect_pallas.py (entry intersect_clusters_pallas),
// the route of scenes with fewer than cfg.hier_min_clusters clusters.  Its
// plain PyTorch version is intersect_clusters_plain in
// tpu_pathtracer_torch/ops/intersect_cluster.py; built with -fmad=false and
// IEEE division, the two give the same bits.  The body is
// streamed_kernel<false, kFlat, ...> of cluster_streamed.cuh, the body of
// every traversal kernel, in the flat visit order.
//
// What it computes.  Packets of 1,024 rays (a 131,072-ray batch is 128
// packets, BASELINE config 1's pool of 16,384 lanes 16).  A packet takes
// its octant from its first ray and visits the clusters in that octant's
// front-to-back order; a cluster some ray of the packet overlaps within its
// best t has its K rows staged into shared memory, where every ray of the
// packet tests all K triangles.  Within a cluster the smallest t wins and
// equal t the lowest triangle id; across clusters a strictly smaller t, in
// visit order.
//
// What bounds it.  Operations and the shape of the work.  On the headline's
// 25 clusters a packet tests 11.26 clusters on average and the heaviest
// 24, each test 77 instructions as the arithmetic must be written; one
// block a packet put the heaviest packet's chain of votes and tests on one
// SM, and at config 1's 16 packets left 116 of 132 SMs idle.  The rows
// (25 x 8 KB) stay in the L2.  The design (cluster_streamed.cuh) spreads a
// packet over a thread block cluster of up to 8 SMs with several threads a
// ray, finds the next cluster to test with one vote over a batch of 31
// visit positions, prefetches the batch's next candidate by cp.async while
// the current cluster is tested, and takes the packets heaviest first.
// The tensor cores do not apply: a wgmma or TF32 product would round
// otherwise than the plain version's float32 operations; what the design
// takes from Hopper is thread block clusters, distributed shared memory and
// cp.async.

#include "cluster_streamed.cuh"

// tri_test 0 = Baldwin-Weber rows, 1 = Moller-Trumbore rows. `visit` is each
// octant's visit order ([8,C]); `order` null or the packet each thread block
// cluster takes. `perm` null (raw outputs in the rays' order, or with hit_out
// the Hit) or each ray's caller row (with hit_out: the Hit in caller order);
// see streamed_kernel. Returns the launch's error (0 = launched).
extern "C" int cluster_intersect_launch(
    const float* tris, const float* aabb, const int* visit, const float* origins,
    const float* dirs, const int* order, int n, int num_clusters, int cluster_k,
    float t_min, float t_max, int rays_per_packet, int tri_test, const long long* perm, float* t_out,
    int* prim_out, float* uv_out, unsigned char* hit_out, void* stream) {
  return cluster_traversal::launch_streamed<false, cluster_traversal::kFlat>(
      tris, aabb, aabb, visit, origins, dirs, order, n, num_clusters, 1,
      num_clusters, cluster_k, t_min, t_max, rays_per_packet, tri_test, perm, t_out,
      prim_out, uv_out, hit_out, nullptr, stream);
}

// Each packet's work estimate into weights[packets] (packet_weight_kernel).
extern "C" int cluster_intersect_weights(
    const float* aabb, const float* origins, const float* dirs, int n,
    int num_clusters, float t_min, float t_max, int rays_per_packet,
    int* weights, void* stream) {
  return cluster_traversal::launch_packet_weights(
      aabb, origins, dirs, n, num_clusters, t_min, t_max, rays_per_packet,
      weights, stream);
}

// The launch shape n rays would take, into out[6] (describe_streamed).
extern "C" int cluster_intersect_shape(int n, int rays_per_packet, int cluster_k,
                                       int tri_test, int* out) {
  return cluster_traversal::describe_streamed<false, cluster_traversal::kFlat>(
      n, rays_per_packet, cluster_k, tri_test, out);
}
