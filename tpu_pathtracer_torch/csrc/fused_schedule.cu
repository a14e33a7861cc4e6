// The fused schedule step, for Hopper: the streaming schedule's post-trace
// tail in one launch.
//
// Replaces the TPU kernel `_fused_step_kernel` in
// tpu_pathtracer/ops/fused_schedule.py (entry fused_stream_step).  Its
// plain PyTorch version is fused_stream_step_plain in
// tpu_pathtracer_torch/ops/fused_schedule.py.  Every float operation is a
// single IEEE-rounded op (a division, a product, a sum, a compare), built
// with -fmad=false and IEEE division, so the two agree bit for bit.
//
// What it computes.  For every lane of the pool: the Russian-roulette
// draw (one PCG step; u32 -> f32 by __uint2float_rn, round to nearest even
// as the plain version's int64 -> float32), the estimator of rr_mode, the
// sample added into the lane's pixel sum, the retire of a finished pixel
// straight into its image row (rows are distinct across lanes: no race,
// and each row takes one non-zero add per frame, as the unfused
// index_add_), then the work queue: a lane that retired takes slot
// head + (retired lanes before it, in lane order), and last the masked
// state merges and the regen mask.  The state is updated in place.
//
// What bounds it.  Bytes.  The step must move what each lane's fate
// needs: every lane reads its slot and writes its regen byte (5 B); a live
// lane reads the payload's seed, done flag, attenuation and radiance and
// writes its seed (41 B); a lane that goes on also reads the payload's
// origin and direction and its depth and writes origin, direction,
// attenuation, radiance and depth (80 B); a lane whose path ends reads and
// writes its pixel sum and sample count (32 B), and writes attenuation,
// radiance and depth if it respawns (28 B); a pixel done reads and writes
// its image row and writes slot and pix (32 B).  On the headline's lane
// state after 16 iterations (131,072 lanes, 31,526 pixels done) that is
// 15,978,244 B, 4.8 us at 3.35 TB/s (chip_smoke.py phase 18).  The
// arithmetic is a few dozen operations a lane.
//
// The design, against that bound (each choice measured on an H100 80GB
// HBM3; PERF.md, the kernel 7 findings).
// - Fate-predicated payload loads: a lane reads the trace payload only as
//   its fate needs it (seed, done flag, attenuation and radiance if live,
//   origin and direction if it goes on).  Stores are not predicated: every
//   lane rewrites each state field that some fate changes (origin,
//   direction, attenuation, radiance, depth, seed, pixel sum, sample
//   count, slot, pix), with its old value where its own fate leaves it, so
//   every sector is written whole.  Stores predicated on each lane's fate
//   write most sectors in part, and the card's L2 then has to fill them
//   from memory: that measured slower, though it moves fewer bytes.
// - One lane a thread, coalesced scalar accesses, in tiles of 256 lanes
//   (one block of 256 threads).  Measured against it and dropped: V lanes
//   a thread (4 or 8) with 16-byte accesses, slower at every pool size,
//   having a quarter of the warps to hide the memory's latency with; and
//   tiles of 128, 512 or 1024 lanes (PERF.md, the kernel 7 findings).
// - The queue's prefix sum is exact integer arithmetic in lane order, in
//   one launch, over tiles of kThreads lanes: a block
//   takes a ticket (an atomic counter, so a block only ever waits on
//   blocks that already run) and the ticket's tile, counts its retired and
//   live lanes (shuffles, then one shared-memory pass over the warps),
//   publishes them, and its first warp looks back over the earlier tiles'
//   published words 32 at a time until it meets an inclusive prefix
//   (decoupled look-back), then publishes its own.  Every store that does
//   not depend on the queue is issued before the tile counts, and the
//   other warps add their done pixels into the image during the look-back;
//   the first warp spins as one, so its vote sees a whole window.
// - No zeroing per call: the scratch (ticket counter, then one 64-bit
//   status word a tile) is allocated once per device and tile count and
//   never cleared.  Tickets only grow, so launch e of a scratch holds
//   tickets e*T .. e*T+T-1: tile = ticket % T, and a status word carries
//   the launch's tag (e mod 4095, plus 1) beside its flag and counts, so a
//   word left by the previous launch (every launch writes every word)
//   reads as not yet published.  A word is tag (12 bits), flag (2),
//   retired lanes (25) and live lanes (25), published by one atomicExch
//   and read by volatile loads, so lanes < 2^25.
// - head', segments' and the live count are written exactly, once, by the
//   last tile, which holds the inclusive totals: head + retired, segments
//   + live, and live - retired + min(max(n_pix - head, 0), retired) (the
//   retired lanes take slots head, head+1, ..., so that many stay live).
// The TPU kernel's lane-major planes, u32 -> f32 split, matmul prefix sum,
// float32 running head and retire FIFO are not carried over.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// A tile's status word: tag << 52 | flag | retired lanes << 25 | live lanes.
constexpr int kTagShift = 52;
constexpr unsigned long long kTags = 4095;             // tags 1..4095; 0 is a fresh word
constexpr unsigned long long kAggregate = 1ull << 50;  // counts of this tile only
constexpr unsigned long long kInclusive = 2ull << 50;  // counts of every lane up to this tile's last
constexpr int kDoneShift = 25;
constexpr unsigned long long kCountMask = (1ull << 25) - 1;
constexpr float kInvU32 = 2.3283064365386963e-10f;     // 2^-32
constexpr int kThreads = 256;                          // lanes (threads) a tile (block)
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

// max that propagates NaN, as torch.amax does.
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }

__device__ __forceinline__ unsigned long long status_word(unsigned long long tag, unsigned long long flag,
                                                          long long done, long long live) {
  return (tag << kTagShift) | flag | (static_cast<unsigned long long>(done) << kDoneShift) |
         static_cast<unsigned long long>(live);
}

// One lane's Russian roulette and estimator, as the plain version computes
// them.  In: the payload's seed, done flag, attenuation `a` and radiance
// `r`, and the lane's pixel sum `acc`, sample count `si` and depth `dp`.
// Out: the advanced seed; for a lane that goes on (returns 1) the
// attenuation it carries on in `a` and dp - 1; for a lane whose path ends
// (returns 2, or 3 when that was its pixel's last sample) the sum with
// this sample in `acc` and si + 1.
__device__ __forceinline__ int roulette(uint32_t& seed, bool tb_done, float (&a)[3], const float (&r)[3],
                                        float (&acc)[3], int& si, int& dp, int spp, int rr_reference) {
  seed = pcg_hash(seed);
  const float u_rr = __uint2float_rn(seed) * kInvU32;
  const float p = max_nan(max_nan(a[0], a[1]), a[2]);
  const float p_safe = p > 0.f ? p : 1.f;
  if (!(tb_done || u_rr > p)) {
    if (!rr_reference) {
      const float p_div = fminf(p_safe, 1.f);  // survival probability is min(p, 1)
      for (int c = 0; c < 3; ++c) a[c] = a[c] / p_div;
    }
    dp -= 1;
    return 1;
  }
  for (int c = 0; c < 3; ++c) acc[c] = acc[c] + (rr_reference ? r[c] / p_safe : r[c]);
  si += 1;
  return si >= spp ? 3 : 2;
}

// The block's share of one launch: its ticket, tile and tag, the warps'
// counts, and the retired lanes of earlier tiles.
struct Tile {
  unsigned long long ticket;
  int warp_done[kWarps], warp_live[kWarps];
  long long before;  // retired lanes in earlier tiles
};

// Takes the block's ticket: sets its tile and the launch's tag.
__device__ __forceinline__ void take_ticket(Tile& sh, unsigned long long* scratch, int tiles, int& tile,
                                            unsigned long long& tag) {
  if (threadIdx.x == 0) sh.ticket = atomicAdd(&scratch[0], 1ull);
  __syncthreads();
  tile = static_cast<int>(sh.ticket % static_cast<unsigned long long>(tiles));
  tag = (sh.ticket / tiles) % kTags + 1ull;  // never 0: a fresh word
}

// The tile's counts and the queue's prefix: every thread passes its
// retired and live lanes and gets the retired lanes of this tile before
// its own; the first warp publishes the tile, looks back, and leaves the
// retired lanes of earlier tiles in sh.before (read after the next
// __syncthreads); the last tile writes head', segments' and the live count.
__device__ __forceinline__ int tile_prefix(Tile& sh, int done_count, int live_count, int tile, int tiles,
                                           unsigned long long tag, unsigned long long* status,
                                           const long long* head_in, const long long* seg_in, int n_pix,
                                           long long* result) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // ---- the tile's counts: a scan of retired lanes over the warp ----------
  int incl = done_count, live_sum = live_count;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, k);
    if (lane >= k) incl += up;
    live_sum += __shfl_xor_sync(0xffffffffu, live_sum, k);
  }
  if (lane == 31) {
    sh.warp_done[warp] = incl;
    sh.warp_live[warp] = live_sum;
  }
  __syncthreads();
  int warp_offset = 0;
  for (int w = 0; w < warp; ++w) warp_offset += sh.warp_done[w];
  const int before_me = warp_offset + incl - done_count;  // retired lanes of this tile before this thread

  // ---- the first warp publishes the tile and looks back ------------------
  if (warp == 0) {
    long long agg_done = 0, agg_live = 0;
    for (int w = 0; w < kWarps; ++w) {
      agg_done += sh.warp_done[w];
      agg_live += sh.warp_live[w];
    }
    long long excl_done = 0, excl_live = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(&status[0], status_word(tag, kInclusive, agg_done, agg_live));
    } else {
      if (lane == 0) atomicExch(&status[tile], status_word(tag, kAggregate, agg_done, agg_live));
      const volatile unsigned long long* words = status;
      for (int base = tile - 1;; base -= 32) {
        const int q = base - lane;  // lane 0 reads the nearest predecessor
        // Before tile 0: an inclusive prefix of nothing.  The warp spins as
        // one until every word of the window is this launch's (a word of
        // this launch always holds a flag), so the vote below sees them all.
        unsigned long long s;
        do {
          s = q >= 0 ? words[q] : kInclusive | (tag << kTagShift);
        } while (!__all_sync(0xffffffffu, (s >> kTagShift) == tag));
        const unsigned inclusive = __ballot_sync(0xffffffffu, (s & kInclusive) != 0);
        const int stop = inclusive ? __ffs(inclusive) - 1 : 31;  // nearest inclusive word
        long long dn = lane <= stop ? static_cast<long long>((s >> kDoneShift) & kCountMask) : 0;
        long long lv = lane <= stop ? static_cast<long long>(s & kCountMask) : 0;
        for (int k = 16; k > 0; k >>= 1) {
          dn += __shfl_xor_sync(0xffffffffu, dn, k);
          lv += __shfl_xor_sync(0xffffffffu, lv, k);
        }
        excl_done += dn;
        excl_live += lv;
        if (inclusive) break;
      }
      if (lane == 0)
        atomicExch(&status[tile], status_word(tag, kInclusive, excl_done + agg_done, excl_live + agg_live));
    }
    if (lane == 0) {
      sh.before = excl_done;
      if (tile == tiles - 1) {
        const long long head = *head_in, retired = excl_done + agg_done, live = excl_live + agg_live;
        const long long room = n_pix - head;
        result[0] = head + retired;
        result[1] = *seg_in + live;
        result[2] = live - retired + (room < 0 ? 0 : (room < retired ? room : retired));
      }
    }
  }

  return before_me;
}

// One lane a thread: coalesced scalar accesses.
__global__ void __launch_bounds__(kThreads) fused_step_kernel(
    const float* __restrict__ tb_o, const float* __restrict__ tb_d,      // [L,3]
    const float* __restrict__ tb_att, const float* __restrict__ tb_rad,  // [L,3]
    const long long* __restrict__ tb_seeds,                              // [L] u32 in int64
    const bool* __restrict__ tb_done,                                    // [L]
    float* __restrict__ o, float* __restrict__ d,                        // [L,3] state, in place
    float* __restrict__ att, float* __restrict__ rad,                    // [L,3]
    long long* __restrict__ seeds,                                       // [L]
    int* __restrict__ slot, int* __restrict__ pix,                       // [L]
    int* __restrict__ sample_i, int* __restrict__ depth,                 // [L]
    float* __restrict__ accum,                                           // [L,3]
    float* __restrict__ out,                                             // [n_pix+1,3]
    const long long* __restrict__ head_in, const long long* __restrict__ seg_in,
    unsigned long long* __restrict__ scratch,  // ticket, then status[tiles]
    bool* __restrict__ regen_out,              // [L]
    long long* __restrict__ result,            // head', segments', live'
    int n, int tiles, int spp, int n_pix, int max_depth, int rr_reference, float inv_spp) {
  __shared__ Tile sh;
  int tile;
  unsigned long long tag;
  take_ticket(sh, scratch, tiles, tile, tag);
  const int i = tile * kThreads + threadIdx.x;
  const bool in = i < n;
  const int slot_old = in ? slot[i] : n_pix;
  const bool live = slot_old < n_pix;
  int fate = 0;
  float acc[3], a[3], r[3];
  int dp = 0;
  if (in) {
    uint32_t seed = static_cast<uint32_t>(seeds[i]);
    int si = sample_i[i];
    dp = depth[i];
    for (int c = 0; c < 3; ++c) acc[c] = accum[3 * i + c];
    if (live) {
      seed = static_cast<uint32_t>(__ldg(tb_seeds + i));
      for (int c = 0; c < 3; ++c) {
        a[c] = __ldg(tb_att + 3 * i + c);
        r[c] = __ldg(tb_rad + 3 * i + c);
      }
      fate = roulette(seed, __ldg(reinterpret_cast<const unsigned char*>(tb_done) + i) != 0, a, r, acc, si, dp,
                      spp, rr_reference);
    }
    float po[3], pd[3];
    if (fate == 1) {  // goes on: the payload's origin and direction
      for (int c = 0; c < 3; ++c) {
        po[c] = __ldg(tb_o + 3 * i + c);
        pd[c] = __ldg(tb_d + 3 * i + c);
      }
    } else {  // keeps its origin, direction, attenuation and radiance
      for (int c = 0; c < 3; ++c) {
        po[c] = o[3 * i + c];
        pd[c] = d[3 * i + c];
        a[c] = att[3 * i + c];
        r[c] = rad[3 * i + c];
      }
    }
    for (int c = 0; c < 3; ++c) {  // every lane rewrites what any fate may change: whole sectors
      o[3 * i + c] = po[c];
      d[3 * i + c] = pd[c];
    }
    seeds[i] = static_cast<long long>(seed);
    sample_i[i] = fate == 3 ? 0 : si;
    for (int c = 0; c < 3; ++c) accum[3 * i + c] = fate == 3 ? 0.f : acc[c];
  }
  const int before_me = tile_prefix(sh, fate == 3, live, tile, tiles, tag, scratch + 1, head_in, seg_in, n_pix,
                                    result);
  if (fate == 3) {  // the pixel's mean into its image row
    float* row = out + 3 * static_cast<size_t>(slot_old);
    for (int c = 0; c < 3; ++c) row[c] = row[c] + acc[c] * inv_spp;
  }
  const int pix_old = in ? pix[i] : 0;
  __syncthreads();
  if (!in) return;
  int new_slot = slot_old, new_pix = pix_old;
  bool regen = fate >= 2;  // a lane whose path ends keeps a live slot unless its pixel is done
  if (fate == 3) {         // identity pixel mapping: pix = slot
    new_slot = new_pix = static_cast<int>(*head_in + sh.before + before_me);
    regen = new_slot < n_pix;
  }
  slot[i] = new_slot;
  pix[i] = new_pix;
  for (int c = 0; c < 3; ++c) {
    att[3 * i + c] = regen ? 1.f : a[c];
    rad[3 * i + c] = regen ? 0.f : r[c];
  }
  depth[i] = regen ? max_depth : dp;
  regen_out[i] = regen;
}

}  // namespace

// Launches tiles of 256 lanes on `stream`, one block a tile.  `scratch`
// ([1 + tiles] int64) is zero before its first launch and is used only by
// launches of the same tile count, one at a time; `result` ([3] int64)
// takes head', segments' and the live count.  n < 2^25.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_step_launch(
    const float* tb_o, const float* tb_d, const float* tb_att, const float* tb_rad,
    const long long* tb_seeds, const bool* tb_done,
    float* o, float* d, float* att, float* rad, long long* seeds,
    int* slot, int* pix, int* sample_i, int* depth, float* accum,
    float* out, const long long* head_in, const long long* seg_in,
    unsigned long long* scratch, bool* regen_out, long long* result,
    int n, int spp, int n_pix, int max_depth, int rr_reference, float inv_spp, void* stream) {
  if (n <= 0) return 0;
  const int tiles = (n + kThreads - 1) / kThreads;
  fused_step_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tb_o, tb_d, tb_att, tb_rad, tb_seeds, tb_done, o, d, att, rad, seeds, slot, pix, sample_i, depth, accum, out,
      head_in, seg_in, scratch, regen_out, result, n, tiles, spp, n_pix, max_depth, rr_reference, inv_spp);
  return static_cast<int>(cudaGetLastError());
}
