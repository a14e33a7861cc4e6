// The packet traversal of every route for Hopper, closest hit
// (cluster_intersect.cu, cluster_hier.cu, cluster_streamed.cu) and any hit
// (cluster_occluded.cu, cluster_occluded_hier.cu,
// cluster_occluded_streamed.cu): one body,
// streamed_kernel<kAnyHit, kVisit, kTest, T>.
//
// What the kernel must compute is fixed by its plain PyTorch versions
// (intersect_clusters_plain, intersect_clusters_hier_plain,
// intersect_clusters_streamed_plain and their occluded_clusters_*
// counterparts in tpu_pathtracer_torch/ops/intersect_cluster.py), bit for
// bit: a packet of rays_per_packet rays walks the supers in a visit order
// and each passing super's children in index order; a box passes when some
// ray of the packet overlaps it within its limit of that moment (closest
// hit: its best t; any hit: t_max, rays not yet occluded only); every ray
// of the packet tests every triangle of a child that passes.  Three visit
// orders:
//   * kAscending (the streamed route, kernels 3 and 6): supers in ascending
//     id, children at or past num_clusters never;
//   * kPerPacket (the two-level route, kernels 2 and 5): the packet takes
//     the octant of its first ray and walks the supers in that octant's
//     front-to-back order_super; every child of a passing super is voted
//     on, its rows staged from min(c, num_clusters - 1) as on the TPU;
//   * kFlat (the flat route, kernels 1 and 4): the walk of kPerPacket one
//     level down.  The "supers" are the clusters themselves, in the
//     octant's front-to-back order ([8,C], every id below C), and a
//     passing one is tested at once: there are no children.
//
// What bounds it on this card.  The work is very uneven: on a 200k-triangle
// scene at 131,072 rays half of the 256 packets test 2 clusters or fewer
// and the heaviest tests 559 of 1,563, and a packet's walk is one dependent
// chain, since every vote needs the limits the previous child left.  With
// one block per packet the kernel's time was that one chain on one SM while
// 131 SMs idled.  The arithmetic is fixed as well (one IEEE operation per
// float operation of the plain version, no contraction), so the design can
// only spread a packet's chain and shorten what lies between two votes.
//
// What the design does about it.
//   * A packet is a thread block cluster of G blocks on neighbouring SMs (G
//     up to 8), each holding rays_per_packet / G of its rays.  A vote is one
//     32-bit OR over the packet: a warp reduction, one atomic OR into a slot
//     of every block's shared memory (distributed shared memory), one
//     cluster barrier.  The heaviest packet's chain is spread over G SMs,
//     and the 132 SMs share the heavy packets.
//   * Each ray has T threads (lanes of one warp), each testing every T-th
//     triangle of the staged child.  Closest hit merges the T partial
//     winners by smaller t, then lower triangle id, which is the sequential
//     scan's winner whatever the scan order; any hit ORs the T flags.
//   * One vote finds the next box to enter instead of one vote per box.  All
//     candidates are slab-tested against the limits of now and OR-ed into a
//     mask: its lowest bit is the next box that passes, and every box before
//     it fails exactly, since no limit changes between two tests.  After a
//     child has been tested only the boxes still in the mask are voted on
//     again: limits only tighten, so the mask is a superset of what can
//     still pass.  The same holds one level up for batches of 31 supers,
//     bit b of a batch being the super at visit position s0 + b.
//     A packet crosses one barrier per child tested plus about two per
//     passing super, where the one-block bodies before crossed one per
//     super, one per child of a passing super and two per child tested.
//     In kFlat order the batch vote is the only one: a packet crosses one
//     barrier per cluster tested plus one per batch, where the one-block
//     flat bodies crossed one per cluster and two more per cluster tested.
//   * The child rows (cluster_k x 64 B, one contiguous run) go to shared
//     memory by cp.async into one of two buffers.  Before a child is tested
//     the mask's next candidate is prefetched into the other buffer; when
//     the next vote confirms it, its rows are there, and otherwise the right
//     child is staged then.  In kFlat order the candidate is the batch
//     mask's next cluster.
//   * Boxes are read through the read-only cache as two float4; every
//     thread of a warp reads the same box.
// The arithmetic leaves the tensor cores out: a wgmma or TF32 product would
// round otherwise than the plain version's float32 operations.  What the
// design takes from Hopper is thread block clusters, distributed shared
// memory and cp.async.
// Any hit does not repack unoccluded rays: on the shadow rays of the main
// path nine tenths of the ray-cluster pairs of the packets that set the
// time are unoccluded, so there is little to pack.  Its all-occluded exit is
// one more bit of the super votes (the one-block two-level body took a
// block-wide AND after every super); the flags do not depend on where the
// walk ends, since an occluded ray votes for nothing.

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "cluster_common.cuh"
#include "launch_order.cuh"

namespace cluster_traversal {

namespace cg = cooperative_groups;

// Supers voted on at once; bit 31 of that vote says whether some ray of the
// packet is not yet occluded (any hit).
constexpr int kSuperBatch = 31;
constexpr unsigned int kAliveBit = 0x80000000u;
// The order in which a packet walks the supers (see the top of this file).
enum VisitOrder { kAscending, kPerPacket, kFlat };
// The shape of a packet by visit order and by how many packets a launch has
// for each SM: most blocks a packet is spread over and most threads a ray
// gets.  Few packets: as wide as can be, to spread and shorten the heavy
// packets' chains.  Many packets: the card is full anyway, and a narrow
// packet spends less on votes and merges per triangle test.  Measured on an
// H100 80GB HBM3 at 700 W by sweep_streamed.py (PERF.md): ms of the
// closest-hit and the any-hit kernel at the row's shape, and in brackets at
// the next best; ascending on the 200k-triangle scene (kernels 3 and 6) and
// per packet on BASELINE config 4 (kernels 2 and 5), packets of 512; flat
// on the headline scene and config 1 (kernels 1 and 4), packets of 1,024.
// The per-packet walk ends sooner (front to back, a closest-hit ray's limit
// falls early), so at 31 packets an SM one thread a ray wins there.  At one
// flat packet an SM the two kinds part: closest hit gains from 1,024-thread
// blocks on 2 SMs, any hit, whose packets leave early, from 8 SMs.
enum RuleKind { kBothKinds, kClosestOnly, kAnyOnly };  // which kernels a rule holds for
struct ShapeRule {
  VisitOrder visit;
  RuleKind kind;
  float packets_per_sm;  // applies below this many
  int blocks;
  int threads_per_ray;
};
constexpr ShapeRule kShapeRules[] = {
    {kAscending, kBothKinds, 3, 8, 8},        // 256 packets: 4.43, 2.73 (8 x 4: 4.40, 4.03)
    {kAscending, kBothKinds, 6, 8, 4},        // 512
    {kAscending, kBothKinds, 1 << 30, 2, 2},  // 4,096: 50.95, 28.63 (1 x 1: 48.83, 28.35; 8 x 4: 57.83, 32.46)
    {kPerPacket, kBothKinds, 3, 8, 8},        // 256 packets: 3.25, 1.96 (8 x 4: 3.27, 2.73)
    {kPerPacket, kBothKinds, 6, 8, 4},        // 512: 5.45, 3.38 (4 x 8: 5.51, 3.41)
    {kPerPacket, kBothKinds, 24, 2, 2},       // 2,048: 18.85, 10.70 (2 x 1: 17.88, 12.03)
    {kPerPacket, kBothKinds, 1 << 30, 2, 1},  // 4,096: 34.83, 20.40 (2 x 2: 37.44, 20.74; 1 x 1: 34.58, 20.66)
    {kFlat, kBothKinds, 0.5f, 8, 8},          // 16 packets: 0.2372, 0.1603 (8 x 4: 0.2762, 0.1881)
    {kFlat, kClosestOnly, 2, 2, 2},           // 128: 0.5797 (4 x 2: 0.6044; 8 x 4: 0.6332)
    {kFlat, kAnyOnly, 2, 8, 4},               // 128: 0.4582 (8 x 2: 0.4992; 2 x 2: 0.5640)
    {kFlat, kBothKinds, 6, 2, 2},             // 338: 1.4700, 1.0643 (8 x 1: 1.5342; 1 x 1: 1.0507)
    {kFlat, kBothKinds, 1 << 30, 2, 1},       // 2,048: 7.5627, 5.0642 (1 x 1: 7.5069, 5.2808)
};
// A block's most threads (__launch_bounds__ of streamed_kernel): a ray's
// threads halve until the block fits.
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ unsigned int low_bits(int count) {
  return count >= 32 ? 0xFFFFFFFFu : ((1u << count) - 1u);
}

// Box `index` of `boxes` ([*,8] f32: min xyz, max xyz, two unused) against
// the ray: slab_hits on the same values.
__device__ __forceinline__ bool box_hits(const float* boxes, int index, const Ray& r, float t_min,
                                         float t_limit) {
  const float4* p = reinterpret_cast<const float4*>(boxes) + 2 * static_cast<size_t>(index);
  const float4 lo = __ldg(p);
  const float4 hi = __ldg(p + 1);
  const float b[6] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
  return slab_hits(b, r, t_min, t_limit);
}

// The box at position `pos` of a visit order: `pos` itself in ascending
// order, else ids[pos].
template <VisitOrder kVisit>
__device__ __forceinline__ int box_at(const int* ids, int pos) {
  return kVisit == kAscending ? pos : __ldg(ids + pos);
}

// The bits b of `boxes` whose box at position first + b the ray overlaps
// within [t_min, t_limit].
template <VisitOrder kVisit = kAscending>
__device__ __forceinline__ unsigned int overlapped(const float* aabbs, const int* ids, int first,
                                                   unsigned int boxes, const Ray& r, float t_min,
                                                   float t_limit) {
  unsigned int hits = 0u;
  for (unsigned int m = boxes; m; m &= m - 1u) {
    const int b = __ffs(m) - 1;
    if (box_hits(aabbs, box_at<kVisit>(ids, first + b), r, t_min, t_limit)) hits |= 1u << b;
  }
  return hits;
}

// The packet's votes.  `slots` are three words of this block's shared
// memory, used in turn: while vote n is taken in slot n % 3, the slot of
// vote n + 1 (last read before the barrier of vote n - 1) is set to 0.
struct PacketVote {
  unsigned int* slots;
  int turn;
  int blocks;  // blocks of the packet's cluster

  // OR of `mine` over every thread of the packet.  Every thread of every
  // block of the packet must call it, the same number of times.
  __device__ __forceinline__ unsigned int any(unsigned int mine) {
    const unsigned int warp_or = __reduce_or_sync(0xFFFFFFFFu, mine);
    unsigned int* slot = slots + turn;
    const int lane = threadIdx.x & 31;
    if (threadIdx.x == 0) slots[turn == 2 ? 0 : turn + 1] = 0u;
    __pipeline_wait_prior(0);  // this thread's share of a prefetched child has landed
    if (blocks == 1) {
      if (lane == 0 && warp_or) atomicOr(slot, warp_or);
      __syncthreads();
    } else {
      if (lane < blocks && warp_or) atomicOr(cg::this_cluster().map_shared_rank(slot, lane), warp_or);
      cg::this_cluster().sync();
    }
    turn = turn == 2 ? 0 : turn + 1;
    return *reinterpret_cast<volatile unsigned int*>(slot);
  }
};

// Start the copy of cluster c's K rows into `rows` ([3][K] float4): the
// first three float4 of each row (the fourth is unused), each kind together,
// so that the T threads of a ray, which read T neighbouring triangles, read
// neighbouring words: no bank conflict for any T.
__device__ __forceinline__ void stage_rows_async(float4* rows, const float4* tris, int c, int cluster_k) {
  const float4* src = tris + static_cast<size_t>(c) * cluster_k * 4;
  for (int j = threadIdx.x; j < cluster_k * 4; j += blockDim.x) {
    const int part = j & 3;
    if (part < 3) __pipeline_memcpy_async(rows + part * cluster_k + (j >> 2), src + j, sizeof(float4));
  }
  __pipeline_commit();
}

// Lanes of a warp: 32 / T rays, and sub-thread `sub` of ray `q` is lane
// sub * (32 / T) + q.
template <int T>
struct Lanes {
  static_assert(T == 1 || T == 2 || T == 4 || T == 8, "threads per ray");
  static constexpr int kRays = 32 / T;
  // The lanes of ray 0: one bit every kRays lanes.
  static constexpr unsigned int kRayLanes =
      T == 1 ? 0x1u : T == 2 ? 0x00010001u : T == 4 ? 0x01010101u : 0x11111111u;
  // The bits b of a vote mask with b % T == 0.
  static constexpr unsigned int kEveryT =
      T == 1 ? 0xFFFFFFFFu : T == 2 ? 0x55555555u : T == 4 ? 0x11111111u : 0x01010101u;
};

// Does the ray meet triangle k of the staged `rows` at a t in
// (t_min, t_limit)?  The plain version's test with t_limit, at most t_max,
// in the place of t_max: only such a t can still replace a winner (closest
// hit) or occlude (any hit, t_limit = t_max).
template <int kTest>
__device__ __forceinline__ bool meets(const float4* rows, int cluster_k, int k, const Ray& r,
                                      float t_min, float t_limit, float& t, float& u, float& v) {
  const float4 r0 = rows[k];
  const float4 r1 = rows[cluster_k + k];
  const float4 r2 = rows[2 * cluster_k + k];
  bool ok;
  if (kTest == kMollerTrumbore) {
    mt_test(r0, r1, r2, r, t_min, t_limit, t, u, v, ok);
  } else {
    bw_test(r0, r1, r2, r, t_min, t_limit, t, u, v, ok);
  }
  return ok;
}

// Cluster c's triangles sub, sub + T, ... staged in `rows` against the
// ray, the T partial winners merged: the closest valid hit of the cluster
// (lowest index on equal t) replaces `best` if strictly closer.  Only a t
// below best.t can do that, so each thread's scan starts from best.t, and
// a warp in which no thread found one skips the merge.
template <int kTest, int T>
__device__ __forceinline__ void test_cluster_split(const float4* rows, int cluster_k, int c, int sub,
                                                   const Ray& r, float t_min, Best& best) {
  float t_blk = best.t;
  int k_blk = 0;
  float u_blk = 0.0f, v_blk = 0.0f;
  for (int k = sub; k < cluster_k; k += T) {
    float t, u, v;
    if (meets<kTest>(rows, cluster_k, k, r, t_min, t_blk, t, u, v)) {  // strict: equal t keeps the lower id
      t_blk = t;
      k_blk = k;
      u_blk = u;
      v_blk = v;
    }
  }
  if (!__any_sync(0xFFFFFFFFu, t_blk < best.t)) return;
#pragma unroll
  for (int off = Lanes<T>::kRays; off < 32; off <<= 1) {
    const float t2 = __shfl_xor_sync(0xFFFFFFFFu, t_blk, off);
    const int k2 = __shfl_xor_sync(0xFFFFFFFFu, k_blk, off);
    const float u2 = __shfl_xor_sync(0xFFFFFFFFu, u_blk, off);
    const float v2 = __shfl_xor_sync(0xFFFFFFFFu, v_blk, off);
    if (t2 < t_blk || (t2 == t_blk && k2 < k_blk)) {
      t_blk = t2;
      k_blk = k2;
      u_blk = u2;
      v_blk = v2;
    }
  }
  if (t_blk < best.t) {
    best.t = t_blk;
    best.prim = c * cluster_k + k_blk;
    best.u = u_blk;
    best.v = v_blk;
  }
}

// Any hit: a ray not yet occluded is occluded if one of its T threads
// meets one of its triangles.
template <int kTest, int T>
__device__ __forceinline__ void occlude_cluster_split(const float4* rows, int cluster_k, int sub,
                                                      const Ray& r, float t_min, float t_max,
                                                      bool& occluded) {
  bool hit = false;
  if (!occluded) {
    for (int k = sub; k < cluster_k && !hit; k += T) {
      float t, u, v;
      hit = meets<kTest>(rows, cluster_k, k, r, t_min, t_max, t, u, v);
    }
  }
  const unsigned int hits = __ballot_sync(0xFFFFFFFFu, hit);
  const int q = (threadIdx.x & 31) % Lanes<T>::kRays;
  occluded = occluded || (hits & (Lanes<T>::kRayLanes << q)) != 0u;
}

// Grid: packets x G blocks in clusters of G; block: rays_per_packet / G
// rays x T threads (a multiple of 32).  Dynamic shared memory: two row
// buffers of cluster_k x 48 B.  order_super is read in kPerPacket and
// kFlat order only, aabb_child and branch not in kFlat order (there the
// supers are the clusters: num_supers = C).
// The outputs.  Any hit writes occ_out; closest hit writes t_out and
// prim_out, and either uv_out (hit_out null: the raw outputs, prim
// kMissPrim on a miss) or, with hit_out, the Hit (store_hit: prim -1 and
// bary 0 on a miss, the hit byte) into uv_out as bary.  A row's outputs go
// to row perm[i] where perm is given (the rays were sorted: row i is the
// caller's ray perm[i]; closest hit only with hit_out), else to row i.  So
// the traversal's store is the restore of the sorted outputs into caller
// order, and needs no launch of its own.  The one thread of ray i with
// sub == 0 stores it (the packet's other blocks hold other rays), and
// padding rays (i >= n) store nothing.  kWide: 64-bit row offsets, for
// launches of more than kIntRowsMax rays.
template <bool kAnyHit, VisitOrder kVisit, int kTest, int T, bool kWide>
__global__ void __launch_bounds__(kMaxThreads) streamed_kernel(
    const float4* __restrict__ tris,        // [C,K,4] float4
    const float* __restrict__ aabb_child,   // [S*branch,8]
    const float* __restrict__ aabb_super,   // [S,8]
    const int* __restrict__ order_super,    // [8,S]: each octant's visit order, or null
    const float* __restrict__ origins,      // [N,3]
    const float* __restrict__ dirs,         // [N,3]
    const int* __restrict__ order,          // [packets]: the packet each cluster takes, or null
    int n, int num_supers, int branch, int num_clusters, int cluster_k, int rays_per_packet,
    float t_min, float t_max,
    const long long* __restrict__ perm,     // [N]: the caller's row of each ray, or null
    float* __restrict__ t_out,              // [N]
    int* __restrict__ prim_out,             // [N]
    float* __restrict__ uv_out,             // [N,2]: uv, or the Hit's bary
    unsigned char* __restrict__ hit_out,    // [N] bool, or null
    unsigned char* __restrict__ occ_out) {  // [N] bool
  extern __shared__ float4 rows[];  // [2][3][K] float4
  __shared__ unsigned int slots[3];
  // Any hit: the NEE kernel, launched next as a programmatic dependent of
  // this launch, may start its blocks once every block of this one has
  // (launch_order.cuh); it reads the flags only after this launch is done.
  if constexpr (kAnyHit) launch_order::let_dependents_start();

  PacketVote vote = {slots, 0, static_cast<int>(cg::this_cluster().num_blocks())};
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int packet = order ? order[blockIdx.x / vote.blocks] : blockIdx.x / vote.blocks;
  const int lane = threadIdx.x & 31;
  const int sub = lane / Lanes<T>::kRays;
  const int ray = rank * (blockDim.x / T) + (threadIdx.x >> 5) * Lanes<T>::kRays + lane % Lanes<T>::kRays;
  const int i = packet * rays_per_packet + ray;
  const Ray r = load_ray<RowOffset<kWide>>(origins, dirs, i, n);
  // The row the store at the end writes (perm[i], else i), read now by the
  // thread that stores it, so that the packet's tail waits for no load
  // (PERF.md §6: it adds less to the traversal than a prefetch to L2 at
  // entry and a read at the end).
  const long long row = perm != nullptr && sub == 0 && i < n ? __ldg(perm + i) : i;
  const unsigned int my_bits = Lanes<T>::kEveryT << sub;  // the boxes of a vote this thread tests
  // The supers by visit position: the octant of the packet's first ray
  // picks the row of order_super (every block of the packet reads that ray).
  const int* visit = kVisit == kAscending
                         ? nullptr
                         : order_super + octant_of(load_ray<RowOffset<kWide>>(origins, dirs, packet * rays_per_packet,
                                                                                   n)) * num_supers;
  // The rows of child c: clamped to the last cluster in per-packet order,
  // where every child is voted on; the other orders never reach c >= C.
  auto row_of = [&](int c) { return kVisit == kPerPacket ? min(c, num_clusters - 1) : c; };

  if (threadIdx.x < 3) slots[threadIdx.x] = 0u;
  if (vote.blocks == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();  // no block votes into a slot not yet set to 0
  }

  Best best = {t_max, kMissPrim, 0.0f, 0.0f};
  bool occluded = false;
  int cur = 0;      // the row buffer tested last
  int guess = -1;   // the child whose rows are on their way into rows[cur ^ 1]
  bool alive = true;

  // Child c against the packet's rays, its rows staged unless they are the
  // guess already on their way; meanwhile the rows of `next` (none if -1)
  // go into the other buffer.  Every thread has left rows[cur ^ 1]: the
  // vote before was a barrier.
  auto test = [&](int c, int next) {
    float4* buf = rows + (cur ^ 1) * cluster_k * 3;
    if (c != guess) {
      stage_rows_async(buf, tris, row_of(c), cluster_k);
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    cur ^= 1;
    guess = next;
    if (next >= 0) stage_rows_async(rows + (cur ^ 1) * cluster_k * 3, tris, row_of(next), cluster_k);
    if (kAnyHit) {
      occlude_cluster_split<kTest, T>(buf, cluster_k, sub, r, t_min, t_max, occluded);
    } else {
      test_cluster_split<kTest, T>(buf, cluster_k, c, sub, r, t_min, best);
    }
  };

  // A thread's word of a vote stays right while its ray's limit stays: a
  // closest-hit ray tests its boxes again only after its best t fell, an
  // any-hit ray never (once occluded it votes for nothing).
  for (int s0 = 0; s0 < num_supers && alive; s0 += kSuperBatch) {
    unsigned int supers = low_bits(min(kSuperBatch, num_supers - s0));  // bit b: visit position s0 + b
    bool exact = false;  // was `supers` voted with the limits of now?
    unsigned int mine_supers = 0u;
    float voted_t = 0.0f;  // the limit mine_supers was taken with
    bool first = true;
    while (supers) {
      if (!exact) {
        if (first || (!kAnyHit && best.t != voted_t)) {
          mine_supers = overlapped<kVisit>(aabb_super, visit, s0, first ? supers & my_bits : mine_supers & supers,
                                           r, t_min, kAnyHit ? t_max : best.t);
          voted_t = best.t;
          first = false;
        }
        mine_supers &= supers;
        supers = vote.any(kAnyHit ? (occluded ? 0u : mine_supers | kAliveBit) : mine_supers);
        if (kAnyHit) {
          alive = (supers & kAliveBit) != 0u;  // else every ray of the packet is occluded
          supers &= ~kAliveBit;
        }
        if (!supers) break;
      }
      const int s = box_at<kVisit>(visit, s0 + __ffs(supers) - 1);  // the next super that passes
      supers &= supers - 1u;
      if (kVisit == kFlat) {  // s is the cluster to test; the batch's next candidate is prefetched
        test(s, supers ? box_at<kVisit>(visit, s0 + __ffs(supers) - 1) : -1);
        exact = false;
        continue;
      }
      exact = true;  // until a child is tested

      for (int j0 = 0; j0 < branch; j0 += 32) {
        const int c0 = s * branch + j0;
        const int count = kVisit == kPerPacket ? min(32, branch - j0)
                                               : min(min(32, branch - j0), num_clusters - c0);  // the c < C gate
        if (count <= 0) break;
        unsigned int kids = low_bits(count);
        unsigned int mine = overlapped(aabb_child, nullptr, c0, kids & my_bits, r, t_min, kAnyHit ? t_max : best.t);
        while (kids) {
          kids = vote.any(kAnyHit && occluded ? 0u : mine);
          if (!kids) break;
          const int c = c0 + __ffs(kids) - 1;  // the next child that passes
          kids &= kids - 1u;
          mine &= kids;
          const float before = best.t;
          test(c, kids ? c0 + __ffs(kids) - 1 : -1);
          if (!kAnyHit && best.t != before) mine = overlapped(aabb_child, nullptr, c0, mine, r, t_min, best.t);
          exact = false;
        }
      }
    }
  }
  __pipeline_wait_prior(0);
  if (sub == 0 && i < n) {
    if (kAnyHit) {
      occ_out[row] = occluded ? 1 : 0;
    } else if (hit_out != nullptr) {
      store_hit(best, row, t_out, prim_out, uv_out, hit_out);
    } else {
      store_best<RowOffset<kWide>>(best, i, t_out, prim_out, uv_out);
    }
  }
}

// A packet's work estimate: the number of supers (in kFlat order the
// clusters) that some ray of the packet overlaps within [t_min, t_max].  One
// block per packet, one thread per ray.  The traversal takes the packets
// heaviest first (the wrapper sorts these weights), so that the few packets
// that test hundreds of children start at once and not behind a queue of
// light ones.  kWide as streamed_kernel's.
template <bool kWide>
__global__ void __launch_bounds__(1024) packet_weight_kernel(
    const float* __restrict__ aabb_super,  // [S,8]
    const float* __restrict__ origins,     // [N,3]
    const float* __restrict__ dirs,        // [N,3]
    int n, int num_supers, float t_min, float t_max,
    int* __restrict__ weights) {           // [packets]
  __shared__ unsigned int slots[3];
  if (threadIdx.x < 3) slots[threadIdx.x] = 0u;
  __syncthreads();
  PacketVote vote = {slots, 0, 1};
  const Ray r = load_ray<RowOffset<kWide>>(origins, dirs, blockIdx.x * blockDim.x + threadIdx.x, n);
  int count = 0;
  for (int s0 = 0; s0 < num_supers; s0 += 32) {
    const unsigned int supers = low_bits(min(32, num_supers - s0));
    count += __popc(vote.any(overlapped(aabb_super, nullptr, s0, supers, r, t_min, t_max)));
  }
  if (threadIdx.x == 0) weights[blockIdx.x] = count;
}

inline int launch_packet_weights(const float* aabb_super, const float* origins, const float* dirs,
                                 int n, int num_supers, float t_min, float t_max,
                                 int rays_per_packet, int* weights, void* stream) {
  if (n <= 0) return 0;
  const int packets = (n - 1) / rays_per_packet + 1;
  const auto kernel = n > kIntRowsMax ? packet_weight_kernel<true> : packet_weight_kernel<false>;
  kernel<<<packets, rays_per_packet, 0, static_cast<cudaStream_t>(stream)>>>(aabb_super, origins, dirs, n, num_supers,
                                                                              t_min, t_max, weights);
  return static_cast<int>(cudaGetLastError());
}

using StreamedKernel = void (*)(const float4*, const float*, const float*, const int*, const float*,
                                const float*, const int*, int, int, int, int, int, int, float, float,
                                const long long*, float*, int*, float*, unsigned char*, unsigned char*);

template <bool kAnyHit, VisitOrder kVisit, int kTest, bool kWide>
StreamedKernel streamed_kernel_for(int threads_per_ray) {
  switch (threads_per_ray) {
    case 8: return streamed_kernel<kAnyHit, kVisit, kTest, 8, kWide>;
    case 4: return streamed_kernel<kAnyHit, kVisit, kTest, 4, kWide>;
    case 2: return streamed_kernel<kAnyHit, kVisit, kTest, 2, kWide>;
    default: return streamed_kernel<kAnyHit, kVisit, kTest, 1, kWide>;
  }
}

// The kernel of a plan: the triangle test's, 64-bit row offsets above
// kIntRowsMax rays.
template <bool kAnyHit, VisitOrder kVisit, int kTest>
StreamedKernel streamed_kernel_for(int threads_per_ray, int n) {
  return n > kIntRowsMax ? streamed_kernel_for<kAnyHit, kVisit, kTest, true>(threads_per_ray)
                         : streamed_kernel_for<kAnyHit, kVisit, kTest, false>(threads_per_ray);
}

// How a launch of n rays in packets of rays_per_packet (a multiple of 32, at
// most 1024) is laid out: G blocks a packet, each of whole warps, T threads
// per ray, by kShapeRules and what the packet size allows.
struct StreamedPlan {
  StreamedKernel kernel;
  int packets;
  int blocks;           // G
  int threads_per_ray;  // T
  int threads;          // of a block
  size_t shared_bytes;  // two row buffers
};

template <bool kAnyHit, VisitOrder kVisit>
int plan_streamed(int n, int rays_per_packet, int cluster_k, int tri_test, StreamedPlan& plan) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan.packets = (n - 1) / rays_per_packet + 1;
  const ShapeRule* rule = kShapeRules;
  while (rule->visit != kVisit || rule->kind == (kAnyHit ? kClosestOnly : kAnyOnly) ||
         plan.packets >= rule->packets_per_sm * sms) {
    ++rule;
  }
  const int warps = rays_per_packet / 32;
  plan.blocks = rule->blocks;
  while (warps % plan.blocks) plan.blocks /= 2;
  plan.threads_per_ray = rule->threads_per_ray;
  while (plan.threads_per_ray > 1 && rays_per_packet / plan.blocks * plan.threads_per_ray > kMaxThreads) {
    plan.threads_per_ray /= 2;
  }
  plan.threads = rays_per_packet / plan.blocks * plan.threads_per_ray;
  plan.shared_bytes = 2 * static_cast<size_t>(cluster_k) * 3 * sizeof(float4);
  plan.kernel = tri_test == kMollerTrumbore
                    ? streamed_kernel_for<kAnyHit, kVisit, kMollerTrumbore>(plan.threads_per_ray, n)
                    : streamed_kernel_for<kAnyHit, kVisit, kBaldwinWeber>(plan.threads_per_ray, n);
  if (plan.shared_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(plan.shared_bytes));
  }
  return static_cast<int>(err);
}

struct StreamedLaunch {
  cudaLaunchAttribute attribute;
  cudaLaunchConfig_t config;

  StreamedLaunch(const StreamedPlan& plan, void* stream) : attribute(), config() {
    attribute.id = cudaLaunchAttributeClusterDimension;
    attribute.val.clusterDim.x = plan.blocks;
    attribute.val.clusterDim.y = 1;
    attribute.val.clusterDim.z = 1;
    config.gridDim = dim3(plan.packets * plan.blocks);
    config.blockDim = dim3(plan.threads);
    config.dynamicSmemBytes = plan.shared_bytes;
    config.stream = static_cast<cudaStream_t>(stream);
    config.attrs = &attribute;
    config.numAttrs = 1;
  }
};

// Launches packets x G blocks in clusters of G on `stream`; cluster b takes
// packet order[b], or packet b where `order` is null.  order_super is the
// per-octant visit order of kPerPacket (null for kAscending).  perm and
// hit_out as streamed_kernel takes them: closest hit with perm needs
// hit_out.  Returns the launch's error, or cudaGetLastError() after it (0 =
// launched).
template <bool kAnyHit, VisitOrder kVisit>
int launch_streamed(const float* tris, const float* aabb_child, const float* aabb_super,
                    const int* order_super, const float* origins, const float* dirs, const int* order, int n,
                    int num_supers, int branch, int num_clusters, int cluster_k, float t_min,
                    float t_max, int rays_per_packet, int tri_test, const long long* perm, float* t_out,
                    int* prim_out, float* uv_out, unsigned char* hit_out, unsigned char* occ_out, void* stream) {
  if (n <= 0) return 0;
  if (!kAnyHit && perm != nullptr && hit_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  StreamedPlan plan;
  const int planned = plan_streamed<kAnyHit, kVisit>(n, rays_per_packet, cluster_k, tri_test, plan);
  if (planned) return planned;
  const StreamedLaunch launch(plan, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &launch.config, plan.kernel, reinterpret_cast<const float4*>(tris), aabb_child, aabb_super,
      order_super, origins, dirs, order, n, num_supers, branch, num_clusters, cluster_k, rays_per_packet, t_min,
      t_max, perm, t_out, prim_out, uv_out, hit_out, occ_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of n rays: out = {G, threads of a block, T, registers of
// a thread, blocks an SM holds at once, packets the card holds at once}.
template <bool kAnyHit, VisitOrder kVisit>
int describe_streamed(int n, int rays_per_packet, int cluster_k, int tri_test, int* out) {
  StreamedPlan plan;
  const int planned = plan_streamed<kAnyHit, kVisit>(n > 0 ? n : 1, rays_per_packet, cluster_k, tri_test, plan);
  if (planned) return planned;
  const StreamedLaunch launch(plan, nullptr);
  cudaFuncAttributes attributes;
  int resident_blocks = 0, resident_clusters = 0;
  cudaError_t err = cudaFuncGetAttributes(&attributes, plan.kernel);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident_blocks, plan.kernel, plan.threads,
                                                        plan.shared_bytes);
  }
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&resident_clusters, plan.kernel, &launch.config);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = plan.blocks;
  out[1] = plan.threads;
  out[2] = plan.threads_per_ray;
  out[3] = attributes.numRegs;
  out[4] = resident_blocks;
  out[5] = resident_clusters;
  return 0;
}

}  // namespace cluster_traversal
