// The schedules' steps after a trace, for Hopper: the streaming
// schedule's post-trace tail in one launch (entry 0, the stream step), and
// the Russian roulette and state merges of render_rays and
// render_pixels_regen in one launch (entry 1, the path step).
//
// The stream step replaces the TPU kernel `_fused_step_kernel` in
// tpu_pathtracer/ops/fused_schedule.py (entry fused_stream_step), widened
// to what the unfused stream also needs: any of the three slot -> pixel
// maps and next-event estimation's bookkeeping.  The path step replaces no
// TPU kernel: it is the counterpart of the fusion XLA makes of the
// while_loop bodies of render_rays and render_pixels_regen
// (tpu_pathtracer/render/integrator.py :870 and :1031).  Their plain
// PyTorch versions are fused_stream_step_plain and path_step_plain in
// tpu_pathtracer_torch/ops/fused_schedule.py.  Every float operation is a
// single IEEE-rounded op (a division, a product, a sum, a compare), built
// with -fmad=false and IEEE division, so the two agree bit for bit; a sum
// with the plain version's `+ where(newly, result, 0.0)` adds +0.0 where
// no sample ends (which turns -0.0 into +0.0, as the plain version does).
//
// What the stream step computes.  For every lane of the pool: the
// Russian-roulette draw (one PCG step; u32 -> f32 by __uint2float_rn,
// round to nearest even as the plain version's int64 -> float32), the
// estimator of rr_mode, the sample added into the lane's pixel sum, the
// retire of a finished pixel straight into its image row (rows are
// queue slots, distinct across lanes: no race, and each row takes one
// non-zero add per frame, as the plain version's index_add_), then the
// work queue: a lane that retired takes slot head + (retired lanes before
// it, in lane order) and the pixel the map gives that slot (the identity,
// base + slot for an affine range, ids[min(slot, n_pix - 1)] for an id
// table), and last the masked state merges and the regen mask.  Under NEE
// it also counts the live lanes that hit (shadow segments) and sets each
// lane's env credit: 1 where it respawns, the payload's elsewhere.  The
// state is updated in place.
//
// What the path step computes.  For every lane: the same draw and
// estimator; for render_rays the ending path's result, the terminated
// flag and the merges of a lane that goes on; for render_pixels_regen the
// sample added into the pixel's sum, the sample count, the exhausted flag,
// the regen mask and the merges (a respawning lane's attenuation,
// radiance, depth and env credit reset); the live lanes, under NEE the
// live lanes that hit, and whether every lane has ended.  The camera
// respawn on the regen mask stays with the caller's camera kernel.
//
// What bounds them.  Bytes.  The stream step must move what each lane's
// fate needs: every lane reads its slot and writes its regen byte (5 B); a
// live lane reads the payload's seed, done flag, attenuation and radiance
// and writes its seed (41 B); a lane that goes on also reads the payload's
// origin and direction and its depth and writes origin, direction,
// attenuation, radiance and depth (80 B); a lane whose path ends reads and
// writes its pixel sum and sample count (32 B), and writes attenuation,
// radiance and depth if it respawns (28 B); a pixel done reads and writes
// its image row and writes slot and pix (32 B; an id table's entry, 4 B).
// On the headline's lane state after 16 iterations (131,072 lanes, 31,526
// pixels done) that is 15,978,244 B, 4.8 us at 3.35 TB/s (chip_smoke.py
// phase 18).  The path step's bytes are chip_smoke.py's path_bytes.  The
// arithmetic is a few dozen operations a lane.
//
// The design, against that bound (each choice measured on an H100 80GB
// HBM3; PERF.md, the kernel 7 findings).
// - Fate-predicated payload loads: a lane reads the trace payload only as
//   its fate needs it (seed, done flag, attenuation and radiance if live,
//   origin and direction if it goes on).  The stream step's stores are not
//   predicated: every lane rewrites each state field that some fate
//   changes (origin, direction, attenuation, radiance, depth, seed, pixel
//   sum, sample count, slot, pix), with its old value where its own fate
//   leaves it, so every sector is written whole.  Stores predicated on
//   each lane's fate write most sectors in part, and the card's L2 then
//   has to fill them from memory: that measured slower, though it moves
//   fewer bytes.  The path step is the other way round (PERF.md, the
//   path step's findings): it runs most of its launches on pools where
//   nearly every lane has ended, so an ended lane reads its flag and
//   nothing else and stores nothing, and a live lane stores only what its
//   fate changes (whole warps of ended lanes skipped, and live lanes
//   rewriting every field, measured slower on the 1-spp tiles and on the
//   dense regen pools).  It loads before its wait what it can and the
//   payload after it, as a programmatic dependent of the bounce or NEE
//   kernel (launch_order.cuh).
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
// - No zeroing per call: the scratch is allocated once per device, entry
//   and tile count and never cleared.  The stream step's holds a ticket
//   counter, the grid sum's arrival counter and sum, then one 64-bit
//   status word a tile.  Tickets only grow, so launch e of a scratch holds
//   tickets e*T .. e*T+T-1: tile = ticket % T, and a status word carries
//   the launch's tag (e mod 4095, plus 1) beside its flag and counts, so a
//   word left by the previous launch (every launch writes every word)
//   reads as not yet published.  Below kNarrowLanes = 2^25 lanes (every
//   pool of the main path) a word is tag (12 bits), flag (2), retired
//   lanes (25) and live lanes (25), published by one atomicExch and read
//   by volatile loads.  From 2^25 lanes up to 2^31 - 1 the two counts
//   need 31 bits each, 76 bits with the tag and flag: the wide layout
//   (fused_step_kernel<true>) gives a tile two words, each tag (12) | flag
//   (2) | one count (50), retired lanes then live lanes, published and
//   read as the narrow word.  Each word carries its own flag, so the two
//   look-backs are independent and each is exact by itself: the first
//   warp reads both words of its window, spins until both are this
//   launch's, and stops each sum at that word's own nearest inclusive
//   prefix; the retired lanes' prefix places the lanes in the queue, and
//   the last tile takes the live lanes' inclusive total.  A 16-byte word
//   would need its load to be single-copy atomic, which CUDA does not
//   promise for a volatile 128-bit load; two 8-byte words need nothing
//   but what the narrow layout already relies on.  A scratch is used by
//   one layout only (its size is the layout's: fused_step_scratch_words),
//   since a narrow launch would leave the wide words it does not write
//   holding tags that go live again 4,095 launches later.
// - A total with no prefix (the stream step's shadow segments) is a
//   self-clearing grid sum: each block adds its counts
//   (__syncthreads_count) into the scratch's sums, fences, and takes an
//   arrival number off a counter that only grows; the block that arrives
//   T-th of its launch (arrival % T == T - 1) reads every sum and sets it
//   back to 0 with one atomicExch each, so a graph replay needs no memset
//   and the host reads nothing.  The path step's three totals (live
//   lanes, hit lanes, lanes not ended) travel in one packed arrival
//   instead: one same-address atomic a block (path_step_kernel) below 2^25
//   lanes; above, the tiles not ended take a word of their own.
// - head', segments' and the live count are written exactly, once, by the
//   last tile, which holds the inclusive totals: head + retired, segments
//   + live, and live - retired + min(max(n_pix - head, 0), retired) (the
//   retired lanes take slots head, head+1, ..., so that many stay live).
// The TPU kernel's lane-major planes, u32 -> f32 split, matmul prefix sum,
// float32 running head and retire FIFO are not carried over.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "launch_order.cuh"

// The launch's arguments (mirrored by ops/fused_schedule.py: StepParams).
// A field an entry does not use is null.
struct StepParams {
  // the trace payload: [L,3] f32; seeds [L] u32 in int64; done, hit [L]
  // bool; spec [L] bool, or f32 under nee_mis_spec (hit, spec: NEE only)
  const float* tb_origin;
  const float* tb_direction;
  const float* tb_attenuation;
  const float* tb_radiance;
  const long long* tb_seeds;
  const unsigned char* tb_done;
  const unsigned char* tb_hit;
  const void* tb_spec;
  // the lane state, updated in place
  float* origin;           // [L,3]
  float* direction;        // [L,3]
  float* attenuation;      // [L,3]
  float* radiance;         // [L,3]
  long long* seeds;        // [L]
  int* slot;               // [L] stream
  int* pix;                // [L] stream
  int* sample_i;           // [L] stream, regen
  int* depth;              // [L]
  float* accum;            // [L,3] stream (lane_accum), regen (accum)
  void* spec;              // [L] the env credit, as tb_spec (NEE only)
  unsigned char* flag;     // [L] path step: terminated (rays), exhausted (regen)
  float* result;           // [L,3] rays
  float* out;              // [n_pix+1,3] stream: the image, its rows slots
  const long long* head;   // stream: 0-d
  const long long* base;   // stream, affine map: 0-d
  const int* ids;          // stream, id-table map: [n_pix]
  long long* segments;     // 0-d: stream reads it, the path step updates it
  long long* shadow;       // 0-d, NEE: as segments
  unsigned long long* scratch;
  unsigned char* regen;    // [L] out: stream, regen
  long long* totals;       // stream: head', segments', live', shadow'
  unsigned char* done;     // 0-d out, path step: every lane ended
  int n;
  int spp;
  int n_pix;
  int max_depth;
  int rr_reference;
  int pixel_map;           // stream: 0 identity, 1 affine, 2 id table
  int nee;                 // 0 off, 1 bool env credit, 2 f32 (nee_mis_spec)
  int schedule;            // path step: 0 render_rays, 1 render_pixels_regen
  float inv_spp;
};

namespace {

// A tile's status word: tag << 52 | flag | retired lanes << 25 | live lanes.
constexpr int kTagShift = 52;
constexpr unsigned long long kTags = 4095;             // tags 1..4095; 0 is a fresh word
constexpr unsigned long long kAggregate = 1ull << 50;  // counts of this tile only
constexpr unsigned long long kInclusive = 2ull << 50;  // counts of every lane up to this tile's last
constexpr int kDoneShift = 25;
constexpr unsigned long long kCountMask = (1ull << 25) - 1;
// The wide layout's two words a tile: tag << 52 | flag | one count.
constexpr unsigned long long kWideCountMask = kAggregate - 1;
// From here on the stream step takes the wide layout and the path step its
// two-word count.
constexpr int kNarrowLanes = 1 << 25;
constexpr float kInvU32 = 2.3283064365386963e-10f;     // 2^-32
constexpr int kThreads = 256;                          // lanes (threads) a tile (block)
constexpr int kWarps = kThreads / 32;
// The stream step's scratch: ticket, arrivals, the shadow sum, then status[tiles].
constexpr int kStatus = 3;

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

__device__ __forceinline__ unsigned long long wide_word(unsigned long long tag, unsigned long long flag,
                                                        long long count) {
  return (tag << kTagShift) | flag | static_cast<unsigned long long>(count);
}

// Float c of lane i's row of an [L,3] field: int32 in the narrow layouts'
// grids (the parent's arithmetic, measured fastest there), 64-bit in the
// wide ones' (3 x 2^31 overflows an int).
template <bool Wide>
__device__ __forceinline__ typename std::conditional<Wide, long long, int>::type at3(int i, int c) {
  return typename std::conditional<Wide, long long, int>::type{3} * i + c;
}

// One live lane's Russian roulette, as the plain version's roulette
// computes it.  In: the payload's seed, done flag, attenuation `a` and
// radiance `r`.  Out: the advanced seed; returns whether the lane goes on,
// and then `a` is the attenuation it carries on; otherwise `res` is the
// ending path's result.
__device__ __forceinline__ bool roulette(uint32_t& seed, bool tb_done, float (&a)[3], const float (&r)[3],
                                         float (&res)[3], int rr_reference) {
  seed = pcg_hash(seed);
  const float u_rr = __uint2float_rn(seed) * kInvU32;
  const float p = max_nan(max_nan(a[0], a[1]), a[2]);
  const float p_safe = p > 0.f ? p : 1.f;
  if (!(tb_done || u_rr > p)) {
    if (!rr_reference) {
      const float p_div = fminf(p_safe, 1.f);  // survival probability is min(p, 1)
      for (int c = 0; c < 3; ++c) a[c] = a[c] / p_div;
    }
    return true;
  }
  for (int c = 0; c < 3; ++c) res[c] = rr_reference ? r[c] / p_safe : r[c];
  return false;
}

// Adds this block's counts into the launch's sums (scratch[1 .. K]) and
// takes an arrival number (scratch[0]); the block that arrives last of
// the launch's `tiles` returns true with the launch's totals in `total`,
// the sums set back to 0.  Thread 0 only.  Every launch on one scratch
// has `tiles` blocks, so launch e's arrivals are e*tiles .. e*tiles+tiles-1.
template <int K>
__device__ __forceinline__ bool grid_sum(unsigned long long* scratch, int tiles, const int (&count)[K],
                                         unsigned long long (&total)[K]) {
  for (int k = 0; k < K; ++k)
    if (count[k]) atomicAdd(&scratch[1 + k], static_cast<unsigned long long>(count[k]));
  __threadfence();
  const unsigned long long arrival = atomicAdd(&scratch[0], 1ull);
  if (arrival % static_cast<unsigned long long>(tiles) != static_cast<unsigned long long>(tiles - 1)) return false;
  __threadfence();
  for (int k = 0; k < K; ++k) total[k] = atomicExch(&scratch[1 + k], 0ull);
  return true;
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

// One window of the wide layout's look-back over one count: the first
// warp's words `s` (lane 0 the nearest predecessor), each this launch's.
// Returns the window's sum up to and including the nearest inclusive
// word; `open` turns false once a window held one.
__device__ __forceinline__ long long wide_window(unsigned long long s, int lane, bool& open) {
  const unsigned inclusive = __ballot_sync(0xffffffffu, (s & kInclusive) != 0);
  const int stop = inclusive ? __ffs(inclusive) - 1 : 31;  // nearest inclusive word
  long long c = lane <= stop ? static_cast<long long>(s & kWideCountMask) : 0;
  for (int k = 16; k > 0; k >>= 1) c += __shfl_xor_sync(0xffffffffu, c, k);
  if (inclusive) open = false;
  return c;
}

// The wide layout's publish and look-back (the first warp): the tile's
// two words (status[2 tile]: retired lanes, status[2 tile + 1]: live
// lanes), each look-back stopped at its own nearest inclusive word.
// Returns the retired and live lanes of earlier tiles.
__device__ __forceinline__ void wide_look_back(int lane, int tile, unsigned long long tag,
                                               unsigned long long* status, long long agg_done, long long agg_live,
                                               long long& excl_done, long long& excl_live) {
  unsigned long long* mine = status + 2 * tile;
  if (tile == 0) {
    if (lane == 0) {
      atomicExch(&mine[0], wide_word(tag, kInclusive, agg_done));
      atomicExch(&mine[1], wide_word(tag, kInclusive, agg_live));
    }
    return;
  }
  if (lane == 0) {
    atomicExch(&mine[0], wide_word(tag, kAggregate, agg_done));
    atomicExch(&mine[1], wide_word(tag, kAggregate, agg_live));
  }
  const volatile unsigned long long* words = status;
  // Before tile 0, and for a count whose look-back has ended: an inclusive
  // prefix of nothing.
  const unsigned long long nothing = kInclusive | (tag << kTagShift);
  bool open_done = true, open_live = true;
  for (int base = tile - 1; open_done || open_live; base -= 32) {
    const int q = base - lane;  // lane 0 reads the nearest predecessor
    unsigned long long sd, sl;
    do {  // the warp spins as one until both words of every lane are this launch's
      sd = q >= 0 && open_done ? words[2 * q] : nothing;
      sl = q >= 0 && open_live ? words[2 * q + 1] : nothing;
    } while (!__all_sync(0xffffffffu, (sd >> kTagShift) == tag && (sl >> kTagShift) == tag));
    excl_done += wide_window(sd, lane, open_done);
    excl_live += wide_window(sl, lane, open_live);
  }
  if (lane == 0) {
    atomicExch(&mine[0], wide_word(tag, kInclusive, excl_done + agg_done));
    atomicExch(&mine[1], wide_word(tag, kInclusive, excl_live + agg_live));
  }
}

// The tile's counts and the queue's prefix: every thread passes its
// retired and live lanes and gets the retired lanes of this tile before
// its own; the first warp publishes the tile, looks back, and leaves the
// retired lanes of earlier tiles in sh.before (read after the next
// __syncthreads); the last tile writes head', segments' and the live count.
template <bool Wide>
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
    if (Wide) {
      wide_look_back(lane, tile, tag, status, agg_done, agg_live, excl_done, excl_live);
    } else if (tile == 0) {
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

// The env credit a lane carries into its next segment: 1 where it
// respawns, else `from`'s (the payload's, or the lane's own).
__device__ __forceinline__ void set_spec(const StepParams& p, int i, bool reset, const void* from) {
  if (p.nee == 2) {
    static_cast<float*>(p.spec)[i] = reset ? 1.f : static_cast<const float*>(from)[i];
  } else {
    static_cast<unsigned char*>(p.spec)[i] = reset ? 1 : static_cast<const unsigned char*>(from)[i];
  }
}

// The stream step: one lane a thread, coalesced scalar accesses; the
// narrow layout below kNarrowLanes lanes, the wide one from there.
template <bool Wide>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(const __grid_constant__ StepParams p, int tiles) {
  // The camera kernel, launched next as a programmatic dependent of this
  // launch, may start its blocks once every block of this one has
  // (launch_order.cuh); it reads the lanes' pixels, samples and regen mask
  // only after this launch is done.
  launch_order::let_dependents_start();
  __shared__ Tile sh;
  int tile;
  unsigned long long tag;
  take_ticket(sh, p.scratch, tiles, tile, tag);
  const int i = tile * kThreads + threadIdx.x;
  const bool in = i < p.n;
  const int n_pix = p.n_pix;
  const int slot_old = in ? p.slot[i] : n_pix;
  const bool live = slot_old < n_pix;
  int fate = 0;  // 1 goes on, 2 its path ends, 3 and that was its pixel's last sample
  bool hit = false;
  float acc[3], a[3], r[3];
  int dp = 0;
  if (in) {
    uint32_t seed = static_cast<uint32_t>(p.seeds[i]);
    int si = p.sample_i[i];
    dp = p.depth[i];
    for (int c = 0; c < 3; ++c) acc[c] = p.accum[at3<Wide>(i, c)];
    if (live) {
      seed = static_cast<uint32_t>(__ldg(p.tb_seeds + i));
      for (int c = 0; c < 3; ++c) {
        a[c] = __ldg(p.tb_attenuation + at3<Wide>(i, c));
        r[c] = __ldg(p.tb_radiance + at3<Wide>(i, c));
      }
      float res[3];
      if (roulette(seed, __ldg(p.tb_done + i) != 0, a, r, res, p.rr_reference)) {
        dp -= 1;
        fate = 1;
      } else {
        for (int c = 0; c < 3; ++c) acc[c] = acc[c] + res[c];
        si += 1;
        fate = si >= p.spp ? 3 : 2;
      }
      hit = p.nee && __ldg(p.tb_hit + i) != 0;
    }
    if (fate < 2) {
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + 0.f;  // the plain version's + where(newly, result, 0.0)
    }
    float po[3], pd[3];
    if (fate == 1) {  // goes on: the payload's origin and direction
      for (int c = 0; c < 3; ++c) {
        po[c] = __ldg(p.tb_origin + at3<Wide>(i, c));
        pd[c] = __ldg(p.tb_direction + at3<Wide>(i, c));
      }
    } else {  // keeps its origin, direction, attenuation and radiance
      for (int c = 0; c < 3; ++c) {
        po[c] = p.origin[at3<Wide>(i, c)];
        pd[c] = p.direction[at3<Wide>(i, c)];
        a[c] = p.attenuation[at3<Wide>(i, c)];
        r[c] = p.radiance[at3<Wide>(i, c)];
      }
    }
    for (int c = 0; c < 3; ++c) {  // every lane rewrites what any fate may change: whole sectors
      p.origin[at3<Wide>(i, c)] = po[c];
      p.direction[at3<Wide>(i, c)] = pd[c];
    }
    p.seeds[i] = static_cast<long long>(seed);
    p.sample_i[i] = fate == 3 ? 0 : si;
    for (int c = 0; c < 3; ++c) p.accum[at3<Wide>(i, c)] = fate == 3 ? 0.f : acc[c];
  }
  if (p.nee) {  // shadow segments: the live lanes that hit
    const int hits[1] = {__syncthreads_count(hit)};
    unsigned long long total[1];
    if (threadIdx.x == 0 && grid_sum<1>(p.scratch + 1, tiles, hits, total))
      p.totals[3] = *p.shadow + static_cast<long long>(total[0]);
  }
  const int before_me = tile_prefix<Wide>(sh, fate == 3, live, tile, tiles, tag, p.scratch + kStatus, p.head,
                                    p.segments, n_pix, p.totals);
  if (fate == 3) {  // the pixel's mean into its image row
    float* row = p.out + 3 * static_cast<size_t>(slot_old);
    for (int c = 0; c < 3; ++c) row[c] = row[c] + acc[c] * p.inv_spp;
  }
  const int pix_old = in ? p.pix[i] : 0;
  __syncthreads();
  if (!in) return;
  int new_slot = slot_old, new_pix = pix_old;
  bool regen = fate >= 2;  // a lane whose path ends keeps a live slot unless its pixel is done
  if (fate == 3) {         // the next slot off the queue, and its pixel
    new_slot = static_cast<int>(*p.head + sh.before + before_me);
    new_pix = p.pixel_map == 0   ? new_slot
              : p.pixel_map == 1 ? static_cast<int>(*p.base + new_slot)
                                 : __ldg(p.ids + min(new_slot, n_pix - 1));
    regen = new_slot < n_pix;
  }
  p.slot[i] = new_slot;
  p.pix[i] = new_pix;
  for (int c = 0; c < 3; ++c) {
    p.attenuation[at3<Wide>(i, c)] = regen ? 1.f : a[c];
    p.radiance[at3<Wide>(i, c)] = regen ? 0.f : r[c];
  }
  p.depth[i] = regen ? p.max_depth : dp;
  p.regen[i] = regen;
  if (p.nee) set_spec(p, i, regen, p.tb_spec);
}

// The path step's count word (its scratch[0]) below kNarrowLanes lanes:
// live lanes (25 bits: lanes < 2^25), tiles with a lane not ended (18
// bits: tiles <= 2^17) and the launch's arrivals so far (18 bits), one
// atomic a block.  From kNarrowLanes up to 2^31 - 1 lanes (2^23 tiles)
// the three fields need 31 + 24 + 24 bits, more than a word: the count
// word holds live lanes (32 bits) and arrivals (the high 32), and the
// tiles with a lane not ended go into scratch[2], added before the
// arrival by the blocks that have one (as the hit lanes into scratch[1]).
constexpr int kOpenShift = 25, kArrivalShift = 43;
constexpr unsigned long long kLiveMask = (1ull << kOpenShift) - 1, kTileMask = (1ull << 18) - 1;
constexpr int kWideArrivalShift = 32;
constexpr unsigned long long kWideLiveMask = (1ull << kWideArrivalShift) - 1;

// The path step of render_rays (schedule 0) and render_pixels_regen
// (schedule 1): one lane a thread, a programmatic dependent of the
// bounce kernel (of the NEE kernel under NEE) where the caller asks.
//
// An ended lane (its flag set at entry) reads its flag and nothing else,
// and stores nothing: path_step_plain leaves every field of such a lane
// as it was, bit for bit, on every state the loop reaches.  Field by field
// (live = !flag is false, so newly = adv = false):
// * origin, direction, attenuation, radiance, depth: where(adv, .., st)
//   and where(regen, .., ..) with regen = newly & .. false: the lane's own;
// * seeds: where(live, .., st): its own; result (rays): where(newly, ..,
//   st): its own; the flag: flag | newly: set;
// * sample_i (regen): sample_i + newly: its own; accum (regen): accum +
//   where(newly, result, 0.0) = accum + 0.0, its own unless it is -0.0
//   (made +0.0).  accum starts at +0.0 and is only ever x + y, and a sum
//   is -0.0 only where both terms are: so -0.0 never reaches it
//   (tests/test_torch_path_step_design.py);
// * the env credit (NEE): where(regen, 1, where(adv, .., st)): its own;
// * the regen mask (regen): newly & ..: 0, which the lane's byte of the
//   loop's mask already holds: the step that set the flag wrote it 0 (the
//   wrapper's mask is the loop's buffer, zeroed at the frame's start);
// * the counts: live, hit and not ended are all 0.
// A live lane likewise stores only what its fate changes: the seed, the
// flag, and in regen accum, sample_i and its regen byte; one that goes on
// the payload's origin, direction and radiance, the attenuation it
// carries, depth - 1 and (NEE) the payload's env credit; one that
// respawns attenuation 1, radiance 0, max_depth and credit 1; one whose
// path ends and does not respawn keeps origin, direction, attenuation,
// radiance, depth and credit, so it reads none of them either.
//
// The order, against the launch before (launch_order.cuh).  Before the
// wait the kernel reads only what the previous path step (or the frame's
// set-up) wrote, before the nearest launch made without the attribute
// began: the flag and a
// live lane's depth (in regen also sample_i and accum).  After it, one
// round: the payload the bounce kernel (and NEE's radiance and credit)
// wrote: seed, done flag, attenuation, radiance, origin and direction,
// under NEE the hit flag and the credit.  Every store, the counts'
// included, comes after the wait: the bounce and NEE kernels read the
// state it rewrites.
//
// The totals (segments, shadow, done) without a memset or a host read,
// one same-address atomic a block (two under NEE): the block's counts
// travel in its arrival, one atomicAdd of its live lanes, whether it has
// a lane not ended, and 1 into the count word; under NEE its hit lanes
// are added into scratch[1] first, fenced before the arrival.  The block
// whose add finds T - 1 arrivals is the launch's last: its add's result
// and its own are the totals, and it sets both words back to 0 for the
// next launch.  Only the block's first thread waits for the add.
template <bool Wide>
__global__ void __launch_bounds__(kThreads) path_step_kernel(const __grid_constant__ StepParams p, int tiles) {
  launch_order::let_dependents_start();  // the regen schedule's camera kernel, as kernel 7's
  __shared__ int warp_counts[kWarps][3];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool regen_schedule = p.schedule == 1;
  const bool live = i < p.n && p.flag[i] == 0;
  int dp = 0, si = 0;
  float acc[3];
  if (live) {
    dp = p.depth[i];
    if (regen_schedule) {
      si = p.sample_i[i];
      for (int c = 0; c < 3; ++c) acc[c] = p.accum[at3<Wide>(i, c)];
    }
  }

  // The launch before writes the payload.
  launch_order::wait_for_launch_before();
  bool hit = false, ended = true;
  if (live) {
    uint32_t seed = static_cast<uint32_t>(p.tb_seeds[i]);
    const bool tb_done = p.tb_done[i] != 0;
    float a[3], r[3], o[3], d[3], res[3], spec_f = 0.f;
    for (int c = 0; c < 3; ++c) {
      a[c] = p.tb_attenuation[at3<Wide>(i, c)];
      r[c] = p.tb_radiance[at3<Wide>(i, c)];
      o[c] = p.tb_origin[at3<Wide>(i, c)];
      d[c] = p.tb_direction[at3<Wide>(i, c)];
    }
    unsigned char spec_b = 0;
    if (p.nee) {
      hit = p.tb_hit[i] != 0;
      if (p.nee == 2) {
        spec_f = static_cast<const float*>(p.tb_spec)[i];
      } else {
        spec_b = static_cast<const unsigned char*>(p.tb_spec)[i];
      }
    }
    const bool adv = roulette(seed, tb_done, a, r, res, p.rr_reference);  // a: the attenuation carried on
    const bool newly = !adv;
    p.seeds[i] = static_cast<long long>(seed);
    bool regen = false;
    if (regen_schedule) {
      si += newly;
      ended = newly && si >= p.spp;
      regen = newly && !ended;
      for (int c = 0; c < 3; ++c) p.accum[at3<Wide>(i, c)] = acc[c] + (newly ? res[c] : 0.f);
      p.sample_i[i] = si;
      p.regen[i] = regen;
    } else {
      ended = newly;
      if (newly) {
        for (int c = 0; c < 3; ++c) p.result[at3<Wide>(i, c)] = res[c];
      }
    }
    p.flag[i] = ended;
    if (adv || regen) {
      if (adv) {  // goes on: the payload's origin, direction and radiance
        for (int c = 0; c < 3; ++c) {
          p.origin[at3<Wide>(i, c)] = o[c];
          p.direction[at3<Wide>(i, c)] = d[c];
        }
      }
      for (int c = 0; c < 3; ++c) {
        p.attenuation[at3<Wide>(i, c)] = regen ? 1.f : a[c];
        p.radiance[at3<Wide>(i, c)] = regen ? 0.f : r[c];
      }
      p.depth[i] = regen ? p.max_depth : dp - 1;
      if (p.nee == 2) {
        static_cast<float*>(p.spec)[i] = regen ? 1.f : spec_f;
      } else if (p.nee) {
        static_cast<unsigned char*>(p.spec)[i] = regen ? 1 : spec_b;
      }
    }
  }

  // The counts: each warp's by ballot, the block's in its arrival.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned live_bits = __ballot_sync(0xffffffffu, live), hit_bits = __ballot_sync(0xffffffffu, hit),
                 open_bits = __ballot_sync(0xffffffffu, !ended);
  if (lane == 0) {
    warp_counts[warp][0] = __popc(live_bits);
    warp_counts[warp][1] = __popc(hit_bits);
    warp_counts[warp][2] = __popc(open_bits);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long count[3] = {0, 0, 0};
  for (int w = 0; w < kWarps; ++w) {
    for (int k = 0; k < 3; ++k) count[k] += warp_counts[w][k];
  }
  if (p.nee && count[1]) atomicAdd(p.scratch + 1, count[1]);
  if (Wide && count[2]) atomicAdd(p.scratch + 2, 1ull);
  if (p.nee || Wide) __threadfence();
  constexpr int arrival_shift = Wide ? kWideArrivalShift : kArrivalShift;
  const unsigned long long mine =
      count[0] | (Wide ? 0ull : static_cast<unsigned long long>(count[2] != 0) << kOpenShift) | 1ull << arrival_shift;
  const unsigned long long before = atomicAdd(p.scratch, mine);
  if ((before >> arrival_shift) != static_cast<unsigned long long>(tiles - 1)) return;
  const unsigned long long total = before + mine;
  atomicExch(p.scratch, 0ull);
  *p.segments += static_cast<long long>(total & (Wide ? kWideLiveMask : kLiveMask));
  if (p.nee || Wide) __threadfence();
  if (p.nee) *p.shadow += static_cast<long long>(atomicExch(p.scratch + 1, 0ull));
  const unsigned long long open = Wide ? atomicExch(p.scratch + 2, 0ull) : (total >> kOpenShift) & kTileMask;
  *p.done = open == 0;
}

}  // namespace

// entry 0: the stream step over p->n <= 2^31 - 1 lanes (p->scratch:
// fused_step_scratch_words(0, n) int64, zero before its first launch; its
// status words' layout by n: one word a tile below kNarrowLanes, two from
// there; p->totals: [4] int64); entry 1: the path step over p->n <= 2^31
// - 1 lanes (p->scratch: [3] int64, zero before its first launch; its count
// word's layout by n: one atomic a block below kNarrowLanes), as a
// programmatic dependent of the launch before it on `stream` where
// `dependent` (the caller vouches that that launch is the bounce or the
// NEE kernel: launch_order.cuh).  Tiles of 256 lanes, one block a tile, on
// `stream`; a scratch is used only by launches of one entry, tile count
// and layout, one at a time (both count word layouts leave theirs at 0;
// the stream step's two status word layouts do not).  Returns the
// launch's error, or cudaGetLastError() after it (0 = launched); the
// stream step is never a dependent (cudaErrorInvalidValue).
extern "C" int fused_step_launch(const StepParams* p, int entry, int dependent, void* stream) {
  if (entry == 0 && dependent) return static_cast<int>(cudaErrorInvalidValue);
  if (p->n <= 0) return 0;
  const int tiles = (p->n - 1) / kThreads + 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (entry == 0) {
    if (p->n < kNarrowLanes) {
      fused_step_kernel<false><<<tiles, kThreads, 0, st>>>(*p, tiles);
    } else {
      fused_step_kernel<true><<<tiles, kThreads, 0, st>>>(*p, tiles);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = p->n < kNarrowLanes
                              ? launch_order::launch(path_step_kernel<false>, tiles, kThreads, st, dependent != 0, *p,
                                                     tiles)
                              : launch_order::launch(path_step_kernel<true>, tiles, kThreads, st, dependent != 0, *p,
                                                     tiles);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The int64 words of the scratch that launches of `entry` over `n` lanes
// take, which the wrapper allocates: the stream step's ticket, arrivals,
// shadow sum and a status word a tile (two in the wide layout); the path
// step's count word, hit sum and (wide layout) count of tiles with a lane
// not ended.
extern "C" int fused_step_scratch_words(int entry, int n) {
  const int tiles = n > 0 ? (n - 1) / kThreads + 1 : 0;
  return entry == 0 ? kStatus + (n < kNarrowLanes ? 1 : 2) * tiles : 3;
}

// sizeof(StepParams), which the wrapper checks against its mirror.
extern "C" int fused_schedule_params_size() { return static_cast<int>(sizeof(StepParams)); }
