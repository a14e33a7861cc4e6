// The traversal's ray ordering for Hopper: the coherence sort of the rays
// (the key, with the shadow rays' parking, and a stable radix sort that
// gathers the rays into key order as it writes its last pass) and the
// order in which a traversal kernel takes its packets (heaviest first).
// The restore of the traversal's outputs into caller order is the
// traversal's own store (csrc/cluster_streamed.cuh, through perm).
//
// Replaces no TPU kernel: in the JAX package this is work that XLA fuses
// inside the jitted loop around the Pallas traversal kernels
// (tpu_pathtracer/ops/intersect_pallas.py: ray_sort_key :1141, sort_by_key
// :1392, whose lax.sort_key_val is a library sort; tpu_pathtracer/accel/
// cluster.py: the parking :354-365).  The
// plain versions are the port's eager code in ops/ray_sort.py (the sort's:
// the key, torch.sort(key, stable=True), the gather); each kernel is
// bit-equal to its plain version (built with -fmad=false; the one float
// chain, the key's cell, is a subtraction, an IEEE division, a clamp and a
// product, as the plain version rounds them).
//
// What each computes:
// * sort_rays: each ray's key, that of ray_sort_key: the direction octant,
//   the origin's Morton cell of `spatial_bits` bits a axis above it,
//   `dir_bits` direction-magnitude bits a axis below it, an int32 of
//   W = 3 + 3 spatial_bits + 3 dir_bits <= 30 bits (the host clamps
//   dir_bits), of the ray parked at (hi + (hi - lo)) + 1 pointing +x where
//   `active` is given and false; then perm, the stable ascending order of
//   the keys (equal keys in index order: torch.sort(stable=True)'s and
//   lax.sort_key_val's permutation), and row i of the sorted rays = ray
//   perm[i], parked the same way (the caller's rays are left as they are);
// * packet_order: rank_i = #{j : w_j > w_i} + #{j < i : w_j == w_i}, and
//   order[rank_i] = i, which is a stable descending argsort of the weights.
//   Each block stages the weights in shared memory in chunks of 4,096 (the
//   main path has at most 4,096 packets: 2,097,152 rays in packets of 512);
//   a warp ranks four packets, its lanes counting over every 32nd weight
//   and summing their counts with one warp reduction, so that 4,096 packets
//   take 128 blocks (one wave) of 128 steps a lane.
//
// The sort is an LSD radix sort over digits of 8 bits, ceil(W / 8) passes
// (1 to 4; the host derives W from the bit counts), each pass stable, so
// the whole is.  The keys go in tiles, a block of 256 threads each, 8 keys
// a thread in the one-launch sort, 4, 8 or 16 over more tiles (the host
// picks by n).  Within a tile a key's rank among the keys of its digit
// counts, in index order, the keys of earlier warps, then of its own warp:
// a warp holds 32 consecutive keys an item, its items in order, and ranks
// one item at a time by a match of the lanes that share a digit (one
// ballot a bit; the lower lanes come first) on a per-warp count a digit
// in shared memory.  Two ways through:
// * n <= 16,384 (kSmallMax: config 1's pool), one launch: a thread block
//   cluster of one block a tile of 2,048 keys (up to 8) keeps every key
//   and index in shared memory.  Each block computes its tile's keys; each pass, each
//   block ranks its tile, publishes its counts a digit, and after a
//   cluster barrier reads the other blocks' counts over distributed
//   shared memory (the digit starts and the earlier tiles' keys of each
//   digit), and stores each key and index into the shared memory of the
//   block that holds its new place; after the last pass each block writes
//   its share of the sorted rows and perm, in order;
// * larger n, 1 + ceil(W / 8) launches: the first computes the keys into
//   int32 scratch and every pass's digit counts (shared-memory counts a
//   block, added into the scratch's sums; the block that arrives last of
//   the launch turns the sums into each pass's digit starts and sets them
//   back to 0); each pass then ranks its tile's keys and finds, for each
//   digit, the keys of that digit in earlier tiles by a decoupled
//   look-back in tile order (tiles taken by ticket, so a tile only waits
//   on tiles that already run; a thread a digit, reading 16 earlier
//   tiles' words at once), stages the tile in shared memory in its sorted
//   order, and writes each digit's keys and indices as one run at start +
//   earlier tiles' keys; the last pass writes the sorted rows and perm
//   (the rays read at their old places) instead.
// The scratch is never cleared, as kernel 7's (csrc/fused_schedule.cu):
// tickets and arrivals only grow, so launch e of a scratch holds tickets
// e*T .. e*T+T-1, and a status word carries the launch's tag (e mod 127,
// plus 1) beside its flag and count; every launch writes every word, so a
// word left by the previous launch reads as not yet published.  A replayed
// CUDA graph needs no memset, and the host reads nothing.  A status word
// is 32 bits up to kNarrowMax = 2^23 - 1 keys (the main path's pools: a
// look-back step reads 16 words in 64 bytes), 64 bits above (its count
// field holds every key an int32 index reaches; the step reads 128
// bytes); the launch picks the word from n, and a scratch serves launches
// of one word width only (the wrapper keys it by width).  Ray and row
// indices are int32 (n <= 2^31 - 1: a tile's last index, n rounded up to
// whole tiles, stays below 2^31); with the 64-bit words every product of
// an index and a row's width is 64-bit too (Offset), where 3 n passes
// 2^31 from 715,827,883 rays, and with the 32-bit words int32, as the
// main path's pools measured fastest.
//
// What bounds them.  Bytes, and at the main path's pools the launch:
// the sort must read each ray (24 B, 1 for a parked lane's mask byte and
// its ray not at all) and write each sorted ray and perm (32 B); 1.3-7.3
// MB at 131,072 rays, 0.4-2.2 us at 3.35 TB/s.  The sort's key and index scratch (16 B a key a
// pass) stays in the 50 MB L2 at these sizes.  At 131,072 rays (128 tiles
// of 1,024 keys, a block on each of 128 SMs) each launch of the sort is a
// chain of dependent steps (ticket, loads, ranks, look-back, scan,
// stores), and the chain, not the bytes, sets its time (PERF.md §6).
// The sort's final rays are scattered by the permutation, in rows of 12
// bytes.  packet_order moves 8 B a packet; the function, a sort,
// needs P log2 P compares, and this kernel makes P^2 (16.8 M at 4,096
// packets, spread over every SM).

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kOrderChunk = 4096;  // weights staged in shared memory at a time
constexpr int kOrderPerWarp = 4;    // packets a warp ranks
constexpr int kOrderPerBlock = kThreads / 32 * kOrderPerWarp;

// The radix sort.
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;    // digits a pass
constexpr int kMaxPasses = 4;              // W <= 30 bits
constexpr int kWarps = kThreads / 32;
// The one-launch sort: a thread block cluster of up to 8 blocks (the
// portable size), a tile of 2,048 keys each (8 a thread).
constexpr int kItems = 8;
constexpr int kTileKeys = kThreads * kItems;
constexpr int kClusterMax = 8;
constexpr int kSmallMax = kClusterMax * kTileKeys;
// The launches over tiles take Items keys a thread, 4, 8 or 16 (tiles of
// 1,024 to 4,096 keys), as the host picks by n.
constexpr int kWindow = 16;                // earlier tiles' words a look-back step reads
constexpr uint32_t kPad = 0xFFFFFFFFu;     // past the last key: the largest digit in every pass
// The scratch (64-bit words): the pass launches' ticket counter, the key
// launch's arrival counter, the digit counts of every pass, the digit
// starts of every pass, then a status word (of Status<Word>) a tile a
// digit.
constexpr int kTicket = 0;
constexpr int kArrival = 1;
constexpr int kCounts = 2;
constexpr int kStarts = kCounts + kMaxPasses * kRadix;
constexpr int kStatus = kStarts + kMaxPasses * kRadix;
// A status word: tag << kTagShift | flag | keys of the digit, in the top
// kTagBits bits, the two below and the rest.  Every launch writes every
// word of its scratch, so a word holds this launch's tag or the previous
// launch's, which differ.
constexpr int kTagBits = 7;
constexpr unsigned kTags = 127;  // tags 1..127; 0 is a fresh word
template <typename Word>
struct Status {
  static constexpr int kTagShift = 8 * static_cast<int>(sizeof(Word)) - kTagBits;
  static constexpr Word kAggregate = Word{1} << (kTagShift - 2);        // this tile's keys of the digit
  static constexpr Word kInclusive = Word{2} << (kTagShift - 2);        // every tile's up to this one's
  static constexpr Word kCountMask = (Word{1} << (kTagShift - 2)) - 1;  // keys a word counts
};
using NarrowWord = unsigned;            // tag 7 | flag 2 | count 23
using WideWord = unsigned long long;    // tag 7 | flag 2 | count 55
constexpr int kNarrowMax = static_cast<int>(Status<NarrowWord>::kCountMask);  // 2^23 - 1
// A ray's or row's first float: int32 with the 32-bit words (n < 2^23),
// 64-bit with the 64-bit ones.
template <typename Word>
using Offset = typename std::conditional<sizeof(Word) == 8, long long, int>::type;
static_assert(kTags < (1u << kTagBits), "a tag fits its field");
static_assert(kThreads == kRadix, "a thread a digit in the scans and the look-back");

// Spread 10 bits of v so bit i lands at bit 3i (3-D Morton).
__device__ __forceinline__ uint32_t part1by2(uint32_t v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// torch.clamp(x, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp01(float x) { return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x); }

// The park point of one axis: (hi + (hi - lo)) + 1, as the plain version
// rounds it.
__device__ __forceinline__ float park(const float* lo, const float* hi, int a) {
  return (hi[a] + (hi[a] - lo[a])) + 1.0f;
}

__device__ __forceinline__ bool parked(const unsigned char* active, long long j) {
  return active != nullptr && !active[j];
}

// The sort's arguments.
struct SortArgs {
  const float* origins;       // [n,3]
  const float* directions;    // [n,3]
  const float* lo;            // [3] scene box; read with spatial bits or a mask
  const float* hi;            // [3]
  const unsigned char* active;  // [n] bool, or null
  int n, spatial_bits, dir_bits, passes, tiles;
  int* keys[2];               // [n] int32 scratch each (more than kSmallMax keys)
  int* idx[2];                // [n]
  unsigned long long* scratch;  // kStatus + tiles * kRadix words (status words of 32 or 64 bits)
  float* origins_out;         // [n,3]
  float* directions_out;      // [n,3]
  long long* perm;            // [n]
};

// Ray i's key (ray_sort_key), parked first where `active` says; `Off`
// the type of its row's offsets.
template <typename Off>
__device__ __forceinline__ uint32_t ray_key(const SortArgs& a, int i) {
  float o[3], d[3];
  if (parked(a.active, i)) {
    for (int k = 0; k < 3; ++k) o[k] = park(a.lo, a.hi, k);
    d[0] = 1.0f;
    d[1] = 0.0f;
    d[2] = 0.0f;
  } else {
    for (int k = 0; k < 3; ++k) {
      o[k] = a.origins[Off{3} * i + k];
      d[k] = a.directions[Off{3} * i + k];
    }
  }
  uint32_t key = (d[0] > 0.0f ? 1u : 0u) + (d[1] > 0.0f ? 2u : 0u) + (d[2] > 0.0f ? 4u : 0u);
  if (a.spatial_bits) {
    const float cells = static_cast<float>((1 << a.spatial_bits) - 1);
    const float span_min = static_cast<float>(1e-6);  // the plain clamp_min's float32 bound
    uint32_t morton = 0;
    for (int k = 0; k < 3; ++k) {
      float span = a.hi[k] - a.lo[k];
      span = span < span_min ? span_min : span;
      const float q = clamp01((o[k] - a.lo[k]) / span) * cells;
      morton |= part1by2(static_cast<uint32_t>(q)) << k;
    }
    key |= morton << 3;
  }
  if (a.dir_bits) {
    const float cells = static_cast<float>((1 << a.dir_bits) - 1);
    uint32_t fine = 0;
    for (int k = 0; k < 3; ++k) {
      fine |= static_cast<uint32_t>(clamp01(fabsf(d[k])) * cells) << ((2 - k) * a.dir_bits);
    }
    key = (key << (3 * a.dir_bits)) | fine;
  }
  return key;
}

// Sorted rows row[k] from rays j[k] (parked where `active` says), and
// perm[row[k]] = j[k], for k < Items with row[k] >= 0: every load before
// any store, so that a thread's loads are in flight together; `Off` the
// type of a row's offsets.
template <int Items, typename Off>
__device__ __forceinline__ void write_rows(const SortArgs& a, const int (&row)[Items], const int (&j)[Items]) {
  float o[Items][3], d[Items][3];
#pragma unroll
  for (int k = 0; k < Items; ++k) {
    if (row[k] < 0) continue;
    if (parked(a.active, j[k])) {
      for (int c = 0; c < 3; ++c) o[k][c] = park(a.lo, a.hi, c);
      d[k][0] = 1.0f;
      d[k][1] = 0.0f;
      d[k][2] = 0.0f;
    } else {
      for (int c = 0; c < 3; ++c) {
        o[k][c] = a.origins[Off{3} * j[k] + c];
        d[k][c] = a.directions[Off{3} * j[k] + c];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < Items; ++k) {
    if (row[k] < 0) continue;
    a.perm[row[k]] = j[k];
    for (int c = 0; c < 3; ++c) {
      a.origins_out[Off{3} * row[k] + c] = o[k][c];
      a.directions_out[Off{3} * row[k] + c] = d[k][c];
    }
  }
}

// The keys of a tile's rays i0 + k * stride (k < Items; kPad past n),
// every ray's loads before any key is used.
template <int Items, typename Off>
__device__ __forceinline__ void tile_keys(const SortArgs& a, int i0, int stride, uint32_t (&key)[Items]) {
#pragma unroll
  for (int k = 0; k < Items; ++k) {
    const int i = i0 + k * stride;
    key[k] = i < a.n ? ray_key<Off>(a, i) : kPad;
  }
}

__device__ __forceinline__ uint32_t digit_of(uint32_t key, int pass) {
  return (key >> (kRadixBits * pass)) & (kRadix - 1);
}

// The lanes of the warp whose digit equals this lane's: one ballot a bit
// (what __match_any_sync answers).  Every lane calls it.
__device__ __forceinline__ unsigned match_digit(uint32_t digit) {
  unsigned peers = 0xFFFFFFFFu;
#pragma unroll
  for (int b = 0; b < kRadixBits; ++b) {
    const bool bit = (digit >> b) & 1u;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, bit);
    peers &= bit ? ballot : ~ballot;
  }
  return peers;
}

// This lane's key's rank among the keys of its digit that its warp ranked
// before it (earlier items, then lower lanes of this item), on `counts`,
// the warp's count a digit in shared memory, which it advances.  Every
// lane of the warp calls it.
__device__ __forceinline__ int warp_rank(int* counts, uint32_t digit, int lane) {
  const unsigned peers = match_digit(digit);
  const unsigned lower = peers & ((1u << lane) - 1u);
  const int before = counts[digit];
  __syncwarp();  // every peer has read the count before the lowest peer writes it
  if (lower == 0) counts[digit] = before + __popc(peers);
  __syncwarp();
  return before + __popc(lower);
}

// Exclusive prefix sum over digits: thread d < kRadix passes digit d's
// value and gets the sum of the values before it.  Every thread of the
// block calls it (threads from kRadix up pass 0 and get nothing useful).
// `sums`: kRadix / 32 ints of shared memory.
__device__ __forceinline__ int scan_digits(int v, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int up = __shfl_up_sync(0xFFFFFFFFu, incl, k);
    if (lane >= k) incl += up;
  }
  if (lane == 31 && warp < kRadix / 32) sums[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp && w < kRadix / 32; ++w) before += sums[w];
  __syncthreads();  // the sums are read before the next call writes them
  return before + incl - v;
}

// After every warp has ranked its keys: thread d < kRadix turns the warps'
// counts of digit d into each warp's keys of d before it, and returns the
// tile's keys of d.
__device__ __forceinline__ int warp_offsets(int* counts, int warps) {
  int total = 0;
  if (threadIdx.x < kRadix) {
    for (int w = 0; w < warps; ++w) {
      const int c = counts[w * kRadix + threadIdx.x];
      counts[w * kRadix + threadIdx.x] = total;
      total += c;
    }
  }
  return total;
}

template <typename Word>
__device__ __forceinline__ Word status_word(unsigned tag, Word flag, int count) {
  return (static_cast<Word>(tag) << Status<Word>::kTagShift) | flag | static_cast<Word>(count);
}

// Thread d of tile `tile`: publishes the tile's `count` keys of digit d,
// looks back over the earlier tiles' words of d, kWindow at a time
// (nearest first; reading again from a word not yet this launch's),
// until it meets an inclusive one, publishes its inclusive count, and
// returns the keys of d in the earlier tiles.  A count is at most n.
template <typename Word>
__device__ __forceinline__ int look_back(Word* status, int tile, int count, unsigned tag) {
  using S = Status<Word>;
  const int d = threadIdx.x;
  Word* mine = status + static_cast<size_t>(tile) * kRadix + d;
  if (tile == 0) {
    atomicExch(mine, status_word<Word>(tag, S::kInclusive, count));
    return 0;
  }
  atomicExch(mine, status_word<Word>(tag, S::kAggregate, count));
  const volatile Word* words = status;
  int before = 0;
  for (int q = tile - 1;;) {
    Word w[kWindow];
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      // before tile 0: an inclusive count of nothing (never reached: tile 0's word is inclusive)
      w[k] = q - k >= 0 ? words[static_cast<size_t>(q - k) * kRadix + d] : status_word<Word>(tag, S::kInclusive, 0);
    }
    bool open = true, inclusive = false;
    int taken = 0;
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      open = open && !inclusive && (w[k] >> S::kTagShift) == tag;
      if (open) {
        before += static_cast<int>(w[k] & S::kCountMask);
        inclusive = (w[k] & S::kInclusive) != 0;
        ++taken;
      }
    }
    if (inclusive) break;
    q -= taken;  // a word not yet published: read again from it
  }
  atomicExch(mine, status_word<Word>(tag, S::kInclusive, before + count));
  return before;
}

// Ranks a tile's keys (key[k]: item k of this lane; Items items a
// thread) by digit `pass` on `counts` (the warps' counts a digit, zeroed),
// then, after a block barrier, turns the counts into each warp's keys of
// a digit before it and returns thread d's tile count of digit d.
template <int Items>
__device__ __forceinline__ int rank_tile(int* counts, const uint32_t (&key)[Items], int (&rank)[Items], int pass) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < Items; ++k) rank[k] = warp_rank(counts + warp * kRadix, digit_of(key[k], pass), lane);
  __syncthreads();
  return warp_offsets(counts, kWarps);
}

// n <= kSmallMax: the whole sort in one launch, a cluster of one block a
// tile, every key and index in the blocks' shared memory.
__global__ void __launch_bounds__(kThreads) sort_cluster_kernel(SortArgs a) {
  __shared__ uint32_t keys[kTileKeys];
  __shared__ unsigned short idx[kTileKeys];
  __shared__ int counts[kWarps * kRadix];
  __shared__ int totals[kRadix];
  __shared__ int start[kRadix];
  __shared__ int sums[kRadix / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank()), blocks = static_cast<int>(cluster.num_blocks());
  const int n = a.n, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d = threadIdx.x;
  const int base = b * kTileKeys;
  // The warp's keys: item k of lane l is tile key first + 32 k.
  const int first = warp * 32 * kItems + lane;
  uint32_t key[kItems];
  tile_keys<kItems, int>(a, base + first, 32, key);
  for (int pass = 0; pass < a.passes; ++pass) {
    int from[kItems], rank[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int t = first + 32 * k;
      if (pass > 0) key[k] = base + t < n ? keys[t] : kPad;
      from[k] = pass == 0 ? base + t : idx[t];
    }
    for (int k = threadIdx.x; k < kWarps * kRadix; k += kThreads) counts[k] = 0;
    __syncthreads();
    totals[d] = rank_tile(counts, key, rank, pass);
    cluster.sync();  // every block's counts; every block's keys of this pass read
    int c[kClusterMax], before = 0, all = 0;
#pragma unroll
    for (int r = 0; r < kClusterMax; ++r) c[r] = r < blocks ? *cluster.map_shared_rank(&totals[d], r) : 0;
#pragma unroll
    for (int r = 0; r < kClusterMax; ++r) {
      before += r < b ? c[r] : 0;
      all += c[r];
    }
    start[d] = scan_digits(all, sums) + before;
    __syncthreads();
    const bool last = pass == a.passes - 1;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + first + 32 * k >= n) continue;
      const uint32_t digit = digit_of(key[k], pass);
      const int pos = start[digit] + counts[warp * kRadix + digit] + rank[k];
      const int to = pos / kTileKeys, t = pos % kTileKeys;
      if (!last) *cluster.map_shared_rank(&keys[t], to) = key[k];
      *cluster.map_shared_rank(&idx[t], to) = static_cast<unsigned short>(from[k]);
    }
    cluster.sync();  // every key in its new place; every block's counts read
  }
  // This block's share of the sorted rows, in order.
  int row[kItems], j[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int t = threadIdx.x + k * kThreads;
    row[k] = base + t < n ? base + t : -1;
    j[k] = row[k] >= 0 ? idx[t] : 0;
  }
  write_rows<kItems, int>(a, row, j);
}

// The first of 1 + passes launches: each tile's keys into a.keys[0] and
// every pass's digit counts into the scratch; the block that arrives last
// writes each pass's digit starts and sets the counts back to 0.  Word:
// the pass launches' status words, whose width sets the offsets'.
template <int Items, typename Word>
__global__ void __launch_bounds__(kThreads) sort_keys_kernel(SortArgs a) {
  __shared__ int counts[kMaxPasses * kRadix];
  __shared__ int sums[kRadix / 32];
  __shared__ bool last;
  for (int k = threadIdx.x; k < kMaxPasses * kRadix; k += kThreads) counts[k] = 0;
  uint32_t key[Items];
  const int i0 = blockIdx.x * kThreads * Items + threadIdx.x;
  tile_keys<Items, Offset<Word>>(a, i0, kThreads, key);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < Items; ++k) {
    const int i = i0 + k * kThreads;
    if (i >= a.n) continue;
    a.keys[0][i] = static_cast<int>(key[k]);
    for (int pass = 0; pass < a.passes; ++pass) atomicAdd(&counts[pass * kRadix + digit_of(key[k], pass)], 1);
  }
  __syncthreads();
  unsigned long long* sum = a.scratch + kCounts;
  for (int k = threadIdx.x; k < a.passes * kRadix; k += kThreads) {
    if (counts[k]) atomicAdd(&sum[k], static_cast<unsigned long long>(counts[k]));
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long arrival = atomicAdd(&a.scratch[kArrival], 1ull);
    last = arrival % static_cast<unsigned long long>(a.tiles) == static_cast<unsigned long long>(a.tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int count[kMaxPasses];
#pragma unroll
  for (int pass = 0; pass < kMaxPasses; ++pass) {  // every pass's sums in flight at once
    count[pass] = pass < a.passes ? static_cast<int>(atomicExch(&sum[pass * kRadix + threadIdx.x], 0ull)) : 0;
  }
#pragma unroll
  for (int pass = 0; pass < kMaxPasses; ++pass) {
    const int start = scan_digits(count[pass], sums);
    if (pass < a.passes) a.scratch[kStarts + pass * kRadix + threadIdx.x] = static_cast<unsigned long long>(start);
  }
}

// Pass `pass` of the sort: a tile's keys ranked, the earlier tiles' keys
// of each digit by look-back on status words of type Word, the tile
// staged in shared memory in its sorted order, and each digit's keys and
// indices written as one run in the other buffer; the last pass writes
// the sorted rays and perm.
template <int Items, typename Word>
__global__ void __launch_bounds__(kThreads) sort_pass_kernel(SortArgs a, int pass) {
  constexpr int kTile = kThreads * Items;
  __shared__ int counts[kWarps * kRadix];
  __shared__ int start[kRadix];   // this tile's first key of each digit, in the whole order
  __shared__ int local[kRadix];   // and in the tile's
  __shared__ int sums[kRadix / 32];
  __shared__ uint32_t stage_key[kTile];
  __shared__ int stage_idx[kTile];
  __shared__ unsigned long long ticket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n = a.n;
  if (threadIdx.x == 0) ticket = atomicAdd(&a.scratch[kTicket], 1ull);
  for (int k = threadIdx.x; k < kWarps * kRadix; k += kThreads) counts[k] = 0;
  __syncthreads();
  const int tile = static_cast<int>(ticket % static_cast<unsigned long long>(a.tiles));
  const unsigned tag = static_cast<unsigned>((ticket / a.tiles) % kTags) + 1u;  // never 0: a fresh word
  const bool odd = pass & 1;
  const int* keys_in = odd ? a.keys[1] : a.keys[0];
  const int* idx_in = pass == 0 ? nullptr : (odd ? a.idx[1] : a.idx[0]);
  // The warp's keys: item k of lane l is key first + 32 k.
  const int first = tile * kTile + warp * 32 * Items + lane;
  uint32_t key[Items];
  int from[Items], rank[Items];
#pragma unroll
  for (int k = 0; k < Items; ++k) {
    const int i = first + 32 * k;
    key[k] = i < n ? static_cast<uint32_t>(keys_in[i]) : kPad;
    from[k] = idx_in == nullptr ? i : (i < n ? idx_in[i] : 0);
  }
  const int total = rank_tile(counts, key, rank, pass);
  const int before = look_back(reinterpret_cast<Word*>(a.scratch + kStatus), tile, total, tag);
  const int s = scan_digits(total, sums);
  start[threadIdx.x] = static_cast<int>(a.scratch[kStarts + pass * kRadix + threadIdx.x]) + before;
  local[threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < Items; ++k) {
    if (first + 32 * k >= n) continue;  // a pad: last of the last digit, past the tile's keys
    const uint32_t digit = digit_of(key[k], pass);
    const int t = local[digit] + counts[warp * kRadix + digit] + rank[k];
    stage_key[t] = key[k];
    stage_idx[t] = from[k];
  }
  __syncthreads();
  const int keys_here = min(kTile, n - tile * kTile);
  int row[Items], j[Items];
#pragma unroll
  for (int k = 0; k < Items; ++k) {
    const int t = threadIdx.x + k * kThreads;
    row[k] = -1;
    j[k] = 0;
    if (t >= keys_here) continue;
    const uint32_t digit = digit_of(stage_key[t], pass);
    row[k] = start[digit] + t - local[digit];
    j[k] = stage_idx[t];
  }
  if (pass == a.passes - 1) {
    write_rows<Items, Offset<Word>>(a, row, j);
    return;
  }
  int* keys_out = odd ? a.keys[0] : a.keys[1];
  int* idx_out = odd ? a.idx[0] : a.idx[1];
#pragma unroll
  for (int k = 0; k < Items; ++k) {
    if (row[k] < 0) continue;
    keys_out[row[k]] = static_cast<int>(stage_key[threadIdx.x + k * kThreads]);
    idx_out[row[k]] = j[k];
  }
}

__global__ void __launch_bounds__(kThreads) packet_order_kernel(
    const int* __restrict__ weights,         // [p]
    int p,
    int* __restrict__ order) {               // [p]
  __shared__ int w[kOrderChunk];
  const int lane = threadIdx.x % 32;
  const int first = blockIdx.x * kOrderPerBlock + threadIdx.x / 32 * kOrderPerWarp;  // the warp's packets
  int wi[kOrderPerWarp], rank[kOrderPerWarp];
  for (int r = 0; r < kOrderPerWarp; ++r) {
    wi[r] = first + r < p ? weights[first + r] : 0;
    rank[r] = 0;
  }
  for (int base = 0; base < p; base += kOrderChunk) {
    const int len = min(kOrderChunk, p - base);
    __syncthreads();  // the chunk before is read
    for (int k = threadIdx.x; k < len; k += kThreads) w[k] = weights[base + k];
    __syncthreads();
    for (int k = lane; k < len; k += 32) {
      const int wj = w[k], j = base + k;
      for (int r = 0; r < kOrderPerWarp; ++r) rank[r] += (wj > wi[r]) | ((wj == wi[r]) & (j < first + r));
    }
  }
  for (int r = 0; r < kOrderPerWarp; ++r) {
    const int total = __reduce_add_sync(0xFFFFFFFFu, rank[r]);
    if (lane == 0 && first + r < p) order[total] = first + r;
  }
}

template <int Items, typename Word>
cudaError_t launch_passes(const SortArgs& a, cudaStream_t s) {
  sort_keys_kernel<Items, Word><<<a.tiles, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  for (int pass = 0; pass < a.passes && err == cudaSuccess; ++pass) {
    sort_pass_kernel<Items, Word><<<a.tiles, kThreads, 0, s>>>(a, pass);
    err = cudaGetLastError();
  }
  return err;
}

// The status words by n: 32 bits up to kNarrowMax keys, 64 above.
template <int Items>
cudaError_t launch_tiles(const SortArgs& a, cudaStream_t s) {
  return a.n > kNarrowMax ? launch_passes<Items, WideWord>(a, s) : launch_passes<Items, NarrowWord>(a, s);
}

}  // namespace

// Each launch runs on `stream` and returns cudaGetLastError() after it
// (0 = launched); n (or p) <= 0 launches nothing.

// n <= kSmallMax: one launch (keys, idx, scratch null, tiles and items 0);
// else tiles of 256 * items keys (items 4, 8 or 16), 1 + passes launches,
// on a scratch of kStatus + tiles * kRadix words of 64 bits (the status
// words 32-bit up to kNarrowMax keys: half of them used) that launches of
// one status word width only share.  n <= 2^31 - 1.
extern "C" int ray_sort_rays_launch(const float* origins, const float* directions, const float* lo, const float* hi,
                                    const unsigned char* active, int n, int spatial_bits, int dir_bits, int passes,
                                    int* keys, int* idx, unsigned long long* scratch, int tiles, int items,
                                    float* origins_out, float* directions_out, long long* perm, void* stream) {
  if (n <= 0) return 0;
  const bool small = n <= kSmallMax;
  const bool tiled =
      (items == 4 || items == 8 || items == 16) && tiles == (n - 1) / (kThreads * items) + 1;
  if (passes < 1 || passes > kMaxPasses || (!small && !tiled)) return static_cast<int>(cudaErrorInvalidValue);
  SortArgs a{origins, directions, lo, hi, active, n, spatial_bits, dir_bits, passes, tiles,
             {keys, keys == nullptr ? nullptr : keys + n}, {idx, idx == nullptr ? nullptr : idx + n}, scratch,
             origins_out, directions_out, perm};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (small) {
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = (n + kTileKeys - 1) / kTileKeys;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(cluster.val.clusterDim.x);
    config.blockDim = dim3(kThreads);
    config.stream = s;
    config.attrs = &cluster;
    config.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&config, sort_cluster_kernel, a);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  return static_cast<int>(items == 4 ? launch_tiles<4>(a, s) : items == 8 ? launch_tiles<8>(a, s)
                                                                          : launch_tiles<16>(a, s));
}

extern "C" int ray_sort_order_launch(const int* weights, int p, int* order, void* stream) {
  if (p <= 0) return 0;
  const int blocks = (p + kOrderPerBlock - 1) / kOrderPerBlock;
  packet_order_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(weights, p, order);
  return static_cast<int>(cudaGetLastError());
}
