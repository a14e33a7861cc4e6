// The traversal's ray ordering, four kernels for Hopper: the coherence-sort
// key (with the shadow rays' parking), the gather of the rays into key
// order, the restore of the traversal's outputs into caller order (the Hit,
// or the any-hit flags), and the order in which a traversal kernel takes its
// packets (heaviest first).
//
// Replaces no TPU kernel: in the JAX package this is work that XLA fuses
// inside the jitted loop around the Pallas traversal kernels
// (tpu_pathtracer/ops/intersect_pallas.py: ray_sort_key :1141, sort_by_key
// :1392; tpu_pathtracer/accel/cluster.py: the parking :354-365 and the
// packed restore :293-325).  The sort between the key and the gather stays
// a library sort (torch.sort on the int32 key, as the JAX package leaves it
// to lax.sort_key_val).  The plain versions are the port's eager code in
// ops/ray_sort.py; each kernel is bit-equal to its plain version (built
// with -fmad=false; the one float chain, the key's cell, is a subtraction,
// an IEEE division, a clamp and a product, as the plain version rounds
// them).
//
// What each computes, one thread a ray (a warp for four packets in
// packet_order):
// * sort_key: lanes outside `active` (when given) parked at
//   (hi + (hi - lo)) + 1 pointing +x; then the key of ray_sort_key:
//   the direction octant, the origin's Morton cell of `spatial_bits` bits a
//   axis above it, `dir_bits` direction-magnitude bits a axis below it,
//   an int32 (the host clamps dir_bits so the value fits 30 bits);
// * gather_rays: origins and directions at perm[i] into row i, parked as
//   sort_key parks them where `active` is given (the key's launch writes
//   no rays, so the caller's buffers stay as they are);
// * restore_hits: row i of the traversal's sorted outputs into row perm[i]
//   (row i without perm): t, prim (-1 on a miss), bary (0 on a miss) and
//   the hit flag; or the any-hit flags;
// * packet_order: rank_i = #{j : w_j > w_i} + #{j < i : w_j == w_i}, and
//   order[rank_i] = i, which is a stable descending argsort of the weights.
//   Each block stages the weights in shared memory in chunks of 4,096 (the
//   main path has at most 4,096 packets: 2,097,152 rays in packets of 512);
//   a warp ranks four packets, its lanes counting over every 32nd weight
//   and summing their counts with one warp reduction, so that 4,096 packets
//   take 128 blocks (one wave) of 128 steps a lane.
//
// What bounds them.  Bytes, and at the main path's 131,072 rays the launch:
// the key moves 28 B a ray (29 with the mask, 5 for a lane outside it), the
// gather 56 (57, 33 outside), the restore 41 a hit, 33 a miss or 10 any
// hit, 1.3-7.3 MB, 0.4-2 us at 3.35 TB/s, the width of one wave of blocks.  The gather's reads and the
// restore's writes are scattered by the permutation, in rows of 12 and 4-8
// bytes.  packet_order moves 8 B a packet; the function, a sort, needs
// P log2 P compares, and this kernel makes P^2 (16.8 M at 4,096 packets,
// spread over every SM).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOrderChunk = 4096;  // weights staged in shared memory at a time
constexpr int kOrderPerWarp = 4;    // packets a warp ranks
constexpr int kOrderPerBlock = kThreads / 32 * kOrderPerWarp;
constexpr int kMissPrim = 0x7FFFFFFF;

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

__global__ void __launch_bounds__(kThreads) sort_key_kernel(
    const float* __restrict__ origins,       // [n,3]
    const float* __restrict__ directions,    // [n,3]
    const float* __restrict__ lo,            // [3] scene box
    const float* __restrict__ hi,            // [3]
    const unsigned char* __restrict__ active,  // [n] bool, or null
    int n, int spatial_bits, int dir_bits,
    int* __restrict__ key) {                 // [n]
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3];
  if (parked(active, i)) {
    for (int a = 0; a < 3; ++a) o[a] = park(lo, hi, a);
    d[0] = 1.0f;
    d[1] = 0.0f;
    d[2] = 0.0f;
  } else {
    for (int a = 0; a < 3; ++a) {
      o[a] = origins[3 * i + a];
      d[a] = directions[3 * i + a];
    }
  }
  uint32_t k = (d[0] > 0.0f ? 1u : 0u) + (d[1] > 0.0f ? 2u : 0u) + (d[2] > 0.0f ? 4u : 0u);
  if (spatial_bits) {
    const float cells = static_cast<float>((1 << spatial_bits) - 1);
    const float span_min = static_cast<float>(1e-6);  // the plain clamp_min's float32 bound
    uint32_t morton = 0;
    for (int a = 0; a < 3; ++a) {
      float span = hi[a] - lo[a];
      span = span < span_min ? span_min : span;
      const float q = clamp01((o[a] - lo[a]) / span) * cells;
      morton |= part1by2(static_cast<uint32_t>(q)) << a;
    }
    k |= morton << 3;
  }
  if (dir_bits) {
    const float cells = static_cast<float>((1 << dir_bits) - 1);
    uint32_t fine = 0;
    for (int a = 0; a < 3; ++a) {
      fine |= static_cast<uint32_t>(clamp01(fabsf(d[a])) * cells) << ((2 - a) * dir_bits);
    }
    k = (k << (3 * dir_bits)) | fine;
  }
  key[i] = static_cast<int>(k);
}

__global__ void __launch_bounds__(kThreads) gather_rays_kernel(
    const float* __restrict__ origins,       // [n,3]
    const float* __restrict__ directions,    // [n,3]
    const long long* __restrict__ perm,      // [n]
    const unsigned char* __restrict__ active,  // [n] bool, or null
    const float* __restrict__ lo,            // [3], read only with active
    const float* __restrict__ hi,            // [3]
    int n,
    float* __restrict__ origins_out,         // [n,3]
    float* __restrict__ directions_out) {    // [n,3]
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long j = perm[i];
  if (parked(active, j)) {
    for (int a = 0; a < 3; ++a) origins_out[3 * i + a] = park(lo, hi, a);
    directions_out[3 * i] = 1.0f;
    directions_out[3 * i + 1] = 0.0f;
    directions_out[3 * i + 2] = 0.0f;
    return;
  }
  for (int a = 0; a < 3; ++a) {
    origins_out[3 * i + a] = origins[3 * j + a];
    directions_out[3 * i + a] = directions[3 * j + a];
  }
}

__global__ void __launch_bounds__(kThreads) restore_hits_kernel(
    const long long* __restrict__ perm,      // [n], or null (the identity)
    const float* __restrict__ t,             // [n] closest hit, sorted
    const int* __restrict__ prim,            // [n] kMissPrim on a miss
    const float* __restrict__ uv,            // [n,2]
    const unsigned char* __restrict__ occ,   // [n] any hit, sorted; null for closest hit
    int n,
    float* __restrict__ t_out,               // [n]
    int* __restrict__ prim_out,              // [n] -1 on a miss
    float* __restrict__ bary_out,            // [n,2] 0 on a miss
    unsigned char* __restrict__ hit_out,     // [n]
    unsigned char* __restrict__ occ_out) {   // [n]
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long dst = perm != nullptr ? perm[i] : i;
  if (occ != nullptr) {
    occ_out[dst] = occ[i];
    return;
  }
  const int p = prim[i];
  const bool hit = p != kMissPrim;
  t_out[dst] = t[i];
  prim_out[dst] = hit ? p : -1;
  bary_out[2 * dst] = hit ? uv[2 * i] : 0.0f;
  bary_out[2 * dst + 1] = hit ? uv[2 * i + 1] : 0.0f;
  hit_out[dst] = hit ? 1 : 0;
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

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Each launch runs on `stream` and returns cudaGetLastError() after it
// (0 = launched); n (or p) <= 0 launches nothing.

extern "C" int ray_sort_key_launch(const float* origins, const float* directions, const float* lo, const float* hi,
                                   const unsigned char* active, int n, int spatial_bits, int dir_bits, int* key,
                                   void* stream) {
  if (n <= 0) return 0;
  sort_key_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, lo, hi, active, n, spatial_bits, dir_bits, key);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_sort_gather_launch(const float* origins, const float* directions, const long long* perm,
                                      const unsigned char* active, const float* lo, const float* hi, int n,
                                      float* origins_out, float* directions_out, void* stream) {
  if (n <= 0) return 0;
  gather_rays_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, perm, active, lo, hi, n, origins_out, directions_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_sort_restore_launch(const long long* perm, const float* t, const int* prim, const float* uv,
                                       const unsigned char* occ, int n, float* t_out, int* prim_out,
                                       float* bary_out, unsigned char* hit_out, unsigned char* occ_out,
                                       void* stream) {
  if (n <= 0) return 0;
  restore_hits_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      perm, t, prim, uv, occ, n, t_out, prim_out, bary_out, hit_out, occ_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_sort_order_launch(const int* weights, int p, int* order, void* stream) {
  if (p <= 0) return 0;
  const int blocks = (p + kOrderPerBlock - 1) / kOrderPerBlock;
  packet_order_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(weights, p, order);
  return static_cast<int>(cudaGetLastError());
}
