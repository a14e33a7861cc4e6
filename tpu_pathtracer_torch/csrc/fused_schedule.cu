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
// What it computes.  One thread per lane of the pool: the Russian-roulette
// draw (one PCG step; u32 -> f32 by __uint2float_rn, round to nearest even
// as the plain version's int64 -> float32), the estimator of rr_mode, the
// sample added into the lane's pixel sum, the retire of a finished pixel
// straight into its image row (rows are distinct across lanes: no race,
// and each row takes one non-zero add per frame, as the unfused
// index_add_), then the work queue: a lane that retired takes slot
// head + (retired lanes up to and including it, in lane order) - 1, and
// last the masked state merges and the regen mask.  The state is updated
// in place.
//
// The queue's prefix sum is exact integer arithmetic in lane order, in one
// launch: each block takes a ticket (an atomic counter, so tickets follow
// the order in which blocks start, and a block only ever waits on blocks
// that already run) and the ticket's 256 lanes; it counts its retired
// lanes with warp ballots, publishes that count, and looks back over the
// earlier tickets' published counts until it meets an inclusive prefix
// (decoupled look-back), then publishes its own.  A status word holds a
// flag and a count together, so one 64-bit store publishes both.  head',
// segments' and the live count are integer sums, exact in any order.
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
// arithmetic is a few dozen operations a lane.  This kernel is simpler:
// it reads every lane's state and writes most of it back (about 226 B a
// lane, 29.6 MB), each of the port's [L,3] and [L] tensors once and as
// they are, and does the scan in the same pass; the look-back is the only
// serial part.  The TPU kernel's lane-major planes, u32 -> f32 split,
// matmul prefix sum, float32 running head and retire FIFO are not carried
// over.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kAggregate = 1ull << 32;  // count of this block only
constexpr unsigned long long kPrefix = 2ull << 32;     // count of every lane up to this block's last
constexpr float kInvU32 = 2.3283064365386963e-10f;     // 2^-32

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

// max that propagates NaN, as torch.amax does.
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }

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
    unsigned long long* __restrict__ scratch,  // head', segments', live', ticket, status[blocks]
    bool* __restrict__ regen_out,              // [L]
    int n, int spp, int n_pix, int max_depth, int rr_reference, float inv_spp) {
  __shared__ int ticket;
  __shared__ int warp_done[kWarps];
  __shared__ int warp_live[kWarps];
  __shared__ long long before;  // retired lanes in earlier tickets
  __shared__ int live_next_count;

  if (threadIdx.x == 0) {
    ticket = static_cast<int>(atomicAdd(&scratch[3], 1ull));
    live_next_count = 0;
  }
  __syncthreads();
  const int b = ticket;
  const int i = b * kThreads + threadIdx.x;
  const bool in = i < n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // ---- Russian roulette and the estimator --------------------------------
  const int slot_old = in ? slot[i] : n_pix;
  const bool live = slot_old < n_pix;
  bool newly = false, adv = false, pixel_done = false;
  uint32_t seed_new = 0;
  float r[3] = {0.f, 0.f, 0.f}, a[3] = {0.f, 0.f, 0.f}, acc[3] = {0.f, 0.f, 0.f};
  int si = 0;
  if (in) {
    seed_new = pcg_hash(static_cast<uint32_t>(tb_seeds[i]));
    const float u_rr = __uint2float_rn(seed_new) * kInvU32;
    for (int c = 0; c < 3; ++c) {
      a[c] = tb_att[3 * i + c];
      r[c] = tb_rad[3 * i + c];
    }
    const float p = max_nan(max_nan(a[0], a[1]), a[2]);
    const bool rr_done = tb_done[i] || (u_rr > p);
    newly = live && rr_done;
    adv = live && !rr_done;
    const float p_safe = p > 0.f ? p : 1.f;
    float res[3];
    if (rr_reference) {
      for (int c = 0; c < 3; ++c) res[c] = r[c] / p_safe;
    } else {
      const float p_div = fminf(p_safe, 1.f);  // survival probability is min(p, 1)
      for (int c = 0; c < 3; ++c) {
        res[c] = r[c];
        if (adv) a[c] = a[c] / p_div;
      }
    }
    for (int c = 0; c < 3; ++c) acc[c] = accum[3 * i + c] + (newly ? res[c] : 0.f);
    si = sample_i[i] + (newly ? 1 : 0);
    pixel_done = newly && si >= spp;
    if (pixel_done) {
      float* row = out + 3 * static_cast<size_t>(slot_old);
      for (int c = 0; c < 3; ++c) row[c] = row[c] + acc[c] * inv_spp;
    }
  }

  // ---- the work queue: exact prefix sum in lane order --------------------
  const unsigned done_bits = __ballot_sync(0xffffffffu, pixel_done);
  const unsigned live_bits = __ballot_sync(0xffffffffu, live);
  if (lane == 0) {
    warp_done[warp] = __popc(done_bits);
    warp_live[warp] = __popc(live_bits);
  }
  __syncthreads();
  int warp_offset = 0, block_done = 0, block_live = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) warp_offset += warp_done[w];
    block_done += warp_done[w];
    block_live += warp_live[w];
  }
  if (threadIdx.x == 0) {
    volatile unsigned long long* status = scratch + 4;
    long long earlier = 0;
    if (b == 0) {
      atomicExch(const_cast<unsigned long long*>(&status[0]), kPrefix | block_done);
    } else {
      atomicExch(const_cast<unsigned long long*>(&status[b]), kAggregate | block_done);
      for (int q = b - 1; q >= 0; --q) {
        unsigned long long s;
        do {
          s = status[q];
        } while ((s >> 32) == 0);
        earlier += static_cast<long long>(s & 0xffffffffull);
        if ((s & kPrefix) != 0) break;
      }
      atomicExch(const_cast<unsigned long long*>(&status[b]),
                 kPrefix | static_cast<unsigned long long>(earlier + block_done));
    }
    before = earlier;
    const long long base_head = b == 0 ? *head_in : 0;
    const long long base_seg = b == 0 ? *seg_in : 0;
    atomicAdd(&scratch[0], static_cast<unsigned long long>(base_head + block_done));
    atomicAdd(&scratch[1], static_cast<unsigned long long>(base_seg + block_live));
  }
  __syncthreads();
  const int inclusive = warp_offset + __popc(done_bits & (0xffffffffu >> (31 - lane)));
  const int new_slot = pixel_done ? static_cast<int>(*head_in + before + inclusive - 1) : slot_old;
  const bool live_next = new_slot < n_pix;
  const unsigned next_bits = __ballot_sync(0xffffffffu, in && live_next);
  if (lane == 0) atomicAdd(&live_next_count, __popc(next_bits));

  // ---- masked state merges and the regen mask ------------------------------
  if (in) {
    const bool regen = newly && live_next;
    for (int c = 0; c < 3; ++c) {
      const int k = 3 * i + c;
      if (adv) {
        o[k] = tb_o[k];
        d[k] = tb_d[k];
      }
      att[k] = regen ? 1.f : (adv ? a[c] : att[k]);
      rad[k] = regen ? 0.f : (adv ? r[c] : rad[k]);
      accum[k] = pixel_done ? 0.f : acc[c];
    }
    if (live) seeds[i] = static_cast<long long>(seed_new);
    depth[i] = regen ? max_depth : (adv ? depth[i] - 1 : depth[i]);
    slot[i] = new_slot;
    if (pixel_done) pix[i] = new_slot;  // identity pixel mapping
    sample_i[i] = pixel_done ? 0 : si;
    regen_out[i] = regen;
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(&scratch[2], static_cast<unsigned long long>(live_next_count));
}

}  // namespace

// Launches one block of 256 lanes per 256 lanes of the pool on `stream`.
// `scratch` ([4 + blocks] int64) must be zero.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int fused_step_launch(
    const float* tb_o, const float* tb_d, const float* tb_att, const float* tb_rad,
    const long long* tb_seeds, const bool* tb_done,
    float* o, float* d, float* att, float* rad, long long* seeds,
    int* slot, int* pix, int* sample_i, int* depth, float* accum,
    float* out, const long long* head_in, const long long* seg_in,
    unsigned long long* scratch, bool* regen_out,
    int n, int spp, int n_pix, int max_depth, int rr_reference, float inv_spp, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  fused_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tb_o, tb_d, tb_att, tb_rad, tb_seeds, tb_done, o, d, att, rad, seeds,
      slot, pix, sample_i, depth, accum, out, head_in, seg_in, scratch, regen_out,
      n, spp, n_pix, max_depth, rr_reference, inv_spp);
  return static_cast<int>(cudaGetLastError());
}
