// The bounce's shading, one lane a thread, for Hopper: everything
// _trace_bounce does after the closest-hit traversal, in one launch.
//
// Replaces no TPU kernel: in the JAX package this is a fusion that XLA
// makes of _trace_bounce's elementwise chains under jax.jit
// (tpu_pathtracer/render/integrator.py: _trace_bounce :548, _shade :109,
// eval_env in render/envmap.py :107, the NEE light draw :635-720).  Its
// plain version is the port's eager _trace_bounce (render/integrator.py:
// _shade, _light_sample, _shadow_candidates and the payload combine), some
// 700 device kernels a bounce when run op by op.
//
// What it computes, per lane, as the plain version does:
// * the miss program: eval_env in the three env modes (equirect through
//   the quad table, scrambled or not; sunsky; constant), and the miss
//   radiance with NEE's spec_last credit;
// * _shade in full: the tri_attrs and material gathers (a miss lane reads
//   row 0, as the plain version does), the flat and interpolated normals
//   with the degenerate test, the texture maps in both layouts (the quad
//   pool; bundles row-major, Morton or scrambled, pow2 or not), the normal
//   map, GGX sampling, the specular BRDF, the lobe choice and two-lobe
//   blend, glass with refraction, TIR and the unit-ball perturbation
//   (rng.cuh: ptrng::unit_sphere, inline), emission and
//   seed_advance_quirk;
// * the payload combine: radiance, attenuation, origin, direction, done
//   and seeds;
// * under NEE, _light_sample (two uniform pairs into the alias table,
//   under nee_defensive_mix a third pair and the cosine draw) and
//   _shadow_candidates: the shadow ray and its candidate mask, and the
//   record the NEE kernel (nee.cu) reads after the any-hit traversal.
// The plain version shades every lane and selects; so does the kernel,
// whose outputs equal its bits.  The miss program runs only on miss
// lanes, where its value is read.  A
// second entry point (shade_lanes_kernel) shades the lanes a slot table
// names and writes _shade_deferred's fields: deferred shading's chunks.
//
// Bit-equality with the plain version: see shade_math.cuh.  Built with
// -fmad=false; the float32 constants arrive from the host.
//
// What bounds it.  The bytes it must move are few: a lane reads its state
// (origin, direction, attenuation, radiance: 48 B; seed, depth, hit
// record: 29 B), a hit a 128 B tri_attrs row, a 160 B material row (few
// materials) and up to four texture rows, a miss one env quad row, and
// each writes about 60 B (190 B under NEE, with the shadow ray and the 96
// B record, which it stores field by field so that each field's stores
// coalesce across a warp): 0.0007 ms at config 1's 16,384 lanes and
// 0.005 ms at 131,072 at 3.35 TB/s, against 0.012 and 0.022 ms measured
// with the L2 flushed (PERF.md §6).  The arithmetic is a few hundred float
// operations a lane, about 1 us at the card's float32 rate.  What sets the
// time is a lane's chain: the first touch of each array after the flush,
// dependent loads (prim, its tri_attrs row, its material row, its texture
// rows) and then a few thousand dependent instructions (IEEE divisions and
// square roots, the trigonometry of the GGX and cosine draws, the
// unit-ball sampler's rejection loop), with one warp a scheduler at
// 16,384 lanes to hide nothing.  The design shortens the chain
// (bounce_kernel: the loads and the random draws first) and keeps every
// intermediate in registers.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch_order.cuh"
#include "rng.cuh"
#include "shade_math.cuh"

using shade::V3;

namespace {

// The launch shape: threads a block, and the least blocks an SM holds in
// the launch bounds (sweep_bounce.py, PERF.md).
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;
// tri_attrs rows (32 floats) and material rows (40): the float4s read of
// each, the fields _shade reads (tri_attrs 0..24, materials 0..31).
constexpr int kTriRow4 = 8;
constexpr int kTriRead4 = 7;
constexpr int kMatRow4 = 10;
constexpr int kMatRead4 = 8;

}  // namespace

// The launch's arguments (mirrored by ops/bounce.py: BounceParams).
struct BounceParams {
  // scene
  const float* tri_attrs;         // [T,32], 16-byte aligned
  const float* mat_attrs;         // [M,40], 16-byte aligned
  const long long* tex_quads;     // [P,4] u32 in int64
  const long long* bundles;       // [Pb,8] u32 in int64
  const float* env_quads;         // [h*w,12]
  const float* alias;             // [h*w,4], or null without NEE
  // the hit record and the lane state
  const float* hit_t;             // [n]
  const int* hit_prim;            // [n], -1 on a miss
  const float* hit_bary;          // [n,2], 8-byte aligned
  const unsigned char* hit;       // [n] bool
  const float* origin;            // [n,3]
  const float* direction;         // [n,3]
  const float* attenuation;       // [n,3]
  const float* radiance;          // [n,3]
  const long long* seeds;         // [n] u32 in int64
  const int* depth;               // [n]
  const void* spec_last;          // [n] bool, float32 under nee_mis_spec; null without NEE
  // the bounce's payload
  float* radiance_out;            // [n,3]; under NEE before the light's share (nee.cu adds it)
  float* attenuation_out;         // [n,3]
  float* origin_out;              // [n,3]
  float* direction_out;           // [n,3]
  unsigned char* done_out;        // [n]
  long long* seeds_out;           // [n]
  // NEE: the shadow ray, its candidate mask and the record for nee.cu
  float* shadow_origin;           // [n,3]
  float* shadow_dir;              // [n,3]
  unsigned char* cand;            // [n]
  float* record;                  // [nee_record::kRecord, n]: field f of lane i at f*n + i
  // the deferred entry: slots -> lanes, and _shade_deferred's fields
  const long long* lane_of_slot;  // [slots], a lane in [0, n]; n = the sink row
  float* d_origin;                // [n+1,3] new_origin
  float* d_direction;             // [n+1,3] new_direction
  float* d_att_factor;            // [n+1,3]
  float* d_emission;              // [n+1,3]
  unsigned char* d_att_ok;        // [n+1]
  unsigned char* d_emissive;      // [n+1]
  unsigned char* d_degenerate;    // [n+1]
  unsigned char* d_done;          // [n+1]
  long long* d_seeds;             // [n+1]
  int n;                          // lanes of the state
  int slots;                      // the deferred entry: slots of this launch
  int env_h, env_w, env_mode, env_scrambled;
  int flip_v, bundled, morton, scrambled, pow2, quirk;
  int nee, mis, defensive;
  shade::ShadeConsts c;
};

namespace {

// What _shade returns for one lane.
struct Shaded {
  V3 new_origin, new_direction, att_factor, emission;
  bool att_ok, emissive, degenerate, done;
  uint32_t seed;
  V3 normal, diffuse_albedo, brdf_combined, spec_dir, f_vec;
  bool glass, choose_spec;
  float spec_prob, idotn, spec_pdf, alpha;
};

// A lane's hit record and state: every load of the lane that does not
// depend on what it hit.
struct Lane {
  bool hit;
  int prim;            // max(hit_prim, 0): a miss lane's shade reads row 0
  float t, beta, gamma;
  V3 origin, dir;
  long long seed;      // u32 in int64
  int depth;
};

// The fields of a tri_attrs row and a material row that _shade reads.
struct TriRow {
  float f[4 * kTriRead4];
};
struct MatRow {
  float f[4 * kMatRead4];
};

// A lane's random draws, which depend on its seed alone, in the order
// _shade and _light_sample take them: drawn at entry, so that the PCG
// chain, the unit-ball loop and the trigonometry of the cosine draws run
// while the lane's rows are on their way.
struct Draws {
  float r1, r2, u_lobe, u_reflect;
  V3 diffuse_local;  // cosine_sample_hemisphere(r3, r4)
  V3 ball;           // the unit-ball point of the glass perturbation
  uint32_t s;        // the seed after them: _shade's seeds
};

struct NeeDraws {
  float u1, u2, u3, u4, u5;  // u5 under the defensive mixture only
  uint32_t s;                // the seed after them
};

__device__ __forceinline__ Draws draw_shade(uint32_t s, bool quirk, const shade::ShadeConsts& c) {
  Draws d;
  if (quirk) {
    float qx, qy, qz;
    ptrng::unit_sphere(s, qx, qy, qz);
  }
  d.r1 = ptrng::uniform(s);
  d.r2 = ptrng::uniform(s);
  const float r3 = ptrng::uniform(s);
  const float r4 = ptrng::uniform(s);
  d.diffuse_local = shade::cosine_sample_hemisphere(r3, r4, c);
  d.u_lobe = ptrng::uniform(s);
  d.u_reflect = ptrng::uniform(s);
  ptrng::unit_sphere(s, d.ball.x, d.ball.y, d.ball.z);
  d.s = s;
  return d;
}

// _light_sample's draws after the shade's: two pairs, and under the
// defensive mixture a third, its second value discarded.
__device__ __forceinline__ NeeDraws draw_nee(uint32_t s, bool defensive) {
  NeeDraws d;
  d.u1 = ptrng::uniform(s);
  d.u2 = ptrng::uniform(s);
  d.u3 = ptrng::uniform(s);
  d.u4 = ptrng::uniform(s);
  d.u5 = 0.f;
  if (defensive) {
    d.u5 = ptrng::uniform(s);
    ptrng::uniform(s);
  }
  d.s = s;
  return d;
}

__device__ __forceinline__ V3 div3(V3 a, float d) { return shade::v3(a.x / d, a.y / d, a.z / d); }

__device__ __forceinline__ Lane load_lane(const BounceParams& p, int i) {
  Lane l;
  l.hit = __ldg(p.hit + i) != 0;
  l.prim = max(__ldg(p.hit_prim + i), 0);
  l.t = __ldg(p.hit_t + i);
  const float2 bary = __ldg(reinterpret_cast<const float2*>(p.hit_bary) + i);
  l.beta = bary.x;
  l.gamma = bary.y;
  l.origin = shade::v3(__ldg(p.origin + 3ll * i), __ldg(p.origin + 3ll * i + 1), __ldg(p.origin + 3ll * i + 2));
  l.dir = shade::v3(__ldg(p.direction + 3ll * i), __ldg(p.direction + 3ll * i + 1),
                    __ldg(p.direction + 3ll * i + 2));
  l.seed = __ldg(p.seeds + i);
  l.depth = __ldg(p.depth + i);
  return l;
}

__device__ __forceinline__ TriRow load_tri(const BounceParams& p, int prim) {
  TriRow r;
  const float4* row = reinterpret_cast<const float4*>(p.tri_attrs) + static_cast<long long>(kTriRow4) * prim;
#pragma unroll
  for (int k = 0; k < kTriRead4; ++k) {
    const float4 q = __ldg(row + k);
    r.f[4 * k] = q.x;
    r.f[4 * k + 1] = q.y;
    r.f[4 * k + 2] = q.z;
    r.f[4 * k + 3] = q.w;
  }
  return r;
}

__device__ __forceinline__ MatRow load_mat(const BounceParams& p, int mat) {
  MatRow r;
  const float4* row = reinterpret_cast<const float4*>(p.mat_attrs) + static_cast<long long>(kMatRow4) * mat;
#pragma unroll
  for (int k = 0; k < kMatRead4; ++k) {
    const float4 q = __ldg(row + k);
    r.f[4 * k] = q.x;
    r.f[4 * k + 1] = q.y;
    r.f[4 * k + 2] = q.z;
    r.f[4 * k + 3] = q.w;
  }
  return r;
}

// _shade (render/integrator.py) for one lane: its state `l`, its
// tri_attrs row `tr` and its draws `dr` (draw_shade of its seed).
__device__ Shaded shade_lane(const BounceParams& p, const Lane& l, const TriRow& tr, const Draws& dr) {
  using namespace shade;
  const ShadeConsts& c = p.c;
  const float* ta = tr.f;
  const V3 v0 = v3(ta[0], ta[1], ta[2]);
  const V3 v1 = v3(ta[3], ta[4], ta[5]);
  const V3 v2 = v3(ta[6], ta[7], ta[8]);
  const V3 n0 = v3(ta[9], ta[10], ta[11]);
  const V3 n1 = v3(ta[12], ta[13], ta[14]);
  const V3 n2 = v3(ta[15], ta[16], ta[17]);
  const MatRow mrow = load_mat(p, to_i32(ta[24]));
  const float* ma = mrow.f;

  const V3 ray_dir = l.dir;
  const V3 neg_dir = neg(ray_dir);

  // Flat geometric normal, face-forwarded against the ray.
  V3 flat_n = normalize(cross(sub(v1, v0), sub(v2, v0)), c);
  flat_n = faceforward(flat_n, neg_dir, flat_n);

  const float beta = l.beta;
  const float gamma = l.gamma;
  const float w0 = 1.f - beta - gamma;
  const float uv_u = (w0 * ta[18] + beta * ta[20]) + gamma * ta[22];
  const float uv_v = (w0 * ta[19] + beta * ta[21]) + gamma * ta[23];
  const float tex_u = uv_u;
  const float tex_v = p.flip_v ? 1.f - uv_v : uv_v;

  const V3 normal_raw = add(add(scale(n0, w0), scale(n1, beta)), scale(n2, gamma));
  const bool degenerate = length(normal_raw) <= c.deg_len;
  V3 normal = normalize(normal_raw, c);
  // A backfacing smooth normal falls back to the flat normal.
  normal = dot(normal, ray_dir) > 0.f ? flat_n : normal;

  const V3 hit_pos = add(l.origin, scale(ray_dir, l.t));

  // ---- texture-driven material properties ------------------------------
  bool has_map[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) has_map[k] = ma[12 + k] > 0.5f;
  V3 diffuse_albedo = v3(ma[0], ma[1], ma[2]);
  V3 nmap = v3(0.f, 1.f, 0.f);
  float roughness = ma[9];
  float metallic = ma[10];
  if (p.bundled) {
    if (has_map[0] || has_map[1] || has_map[2] || has_map[3]) {
      V3 rgb[2];
      float scalar[2];
      sample_bundle(p.bundles, to_i32(ma[28]), to_i32(ma[29]), to_i32(ma[30]), tex_u, tex_v, p.morton, p.scrambled,
                    p.pow2, c, rgb, scalar);
      if (has_map[0]) diffuse_albedo = rgb[0];
      if (has_map[1]) roughness = scalar[0];
      if (has_map[2]) nmap = rgb[1];
      if (has_map[3]) metallic = scalar[1];
    }
  } else {
    V3 sampled[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (has_map[k]) {
        sampled[k] = sample_pool(p.tex_quads, to_i32(ma[16 + k]), to_i32(ma[20 + k]), to_i32(ma[24 + k]), tex_u,
                                 tex_v, c);
      }
    }
    if (has_map[0]) diffuse_albedo = sampled[0];
    if (has_map[1]) roughness = sampled[1].x;
    if (has_map[2]) nmap = sampled[2];
    if (has_map[3]) metallic = sampled[3].x;
  }
  if (has_map[2]) {
    // Decode 2n-1 and swap the Y/Z channels.
    const V3 d = normalize(sub(scale(nmap, 2.f), v3(1.f, 1.f, 1.f)), c);
    nmap = v3(d.x, d.z, d.y);
  }
  // Rotate into the shading frame and blend at a fixed strength.
  V3 tang, binorm;
  onb(normal, c, tang, binorm);
  const V3 nmap_world = onb_transform(nmap, tang, normal, binorm);
  normal = normalize(add(scale(nmap_world, c.nmap_s), scale(normal, c.nmap_1ms)), c);

  const V3 emission_color = v3(ma[6], ma[7], ma[8]);
  const float transparency = ma[11];
  const float mat_ior = ma[31];
  const float ior = mat_ior > 0.f ? mat_ior : c.ior;
  const bool emissive = length(emission_color) > c.emis_len;

  roughness = clamp(roughness, c.rough_min, c.rough_max);
  const bool depth_done = l.depth <= 0;
  // ---- GGX importance sampling -------------------------------------------
  const float alpha = roughness * roughness;
  const V3 half_local = ggx_importance_sample(dr.r1, dr.r2, alpha, c);
  V3 tang2, binorm2;
  onb(normal, c, tang2, binorm2);
  const V3 half_vec = onb_transform(half_local, tang2, normal, binorm2);
  const V3 light_dir = reflect(ray_dir, half_vec);
  const V3 light_dir_diffuse = onb_transform(dr.diffuse_local, tang2, normal, binorm2);

  // ---- specular BRDF -------------------------------------------------------
  float f0_scalar = (1.f - ior) / (1.f + ior);
  f0_scalar = f0_scalar * f0_scalar;  // ** 2: x * x on the card
  const V3 f0 = lerp(v3(f0_scalar, f0_scalar, f0_scalar), diffuse_albedo, metallic);
  const float ndotv_raw = dot(normal, neg_dir);
  const V3 f_vec = fresnel_schlick(clamp_min(ndotv_raw, 0.f), f0, c);
  const float d_term = d_ggx(normal, half_vec, alpha, c);
  const float g_term = g_smith(alpha, normal, neg_dir, light_dir, c);
  const float denom = 4.f * fabsf(ndotv_raw) * fabsf(dot(normal, light_dir));
  const V3 brdf_specular = scale(f_vec, d_term * g_term / clamp_min(denom, c.tiny));

  const float ndoth = clamp_min(dot(normal, half_vec), c.tiny);
  const float vdoth = clamp_min(dot(neg_dir, half_vec), c.tiny);
  const float ndotv = clamp_min(ndotv_raw, 0.f);
  // The throughput cosine is always taken against the specular direction.
  const float idotn = fabsf(dot(normal, normalize(light_dir, c)));
  const float f_blend = fresnel_schlick_scalar(ndotv, ior, c);

  // ---- lobe selection --------------------------------------------------------
  const float spec_prob = metallic + (1.f - metallic) * f_blend;
  const float spdf = ggx_pdf(d_term, ndoth, vdoth);
  const bool choose_spec = dr.u_lobe < spec_prob;
  const V3 spec_dir = normalize(light_dir, c);
  const V3 dir_surface = choose_spec ? spec_dir : normalize(light_dir_diffuse, c);
  // Deterministic two-lobe blend, the same whichever lobe was sampled.
  const V3 brdf_combined = add(scale(div3(brdf_specular, clamp_min(spdf, c.pdf_min)), spec_prob),
                               scale(scale(diffuse_albedo, c.inv_dpdf), 1.f - spec_prob));

  // ---- glass branch ----------------------------------------------------------
  const bool glass = transparency > 0.5f;
  const float cos_theta_i = dot(normal, neg_dir);
  const bool inside = cos_theta_i < 0.f;
  const float cos_i = fabsf(cos_theta_i);
  const V3 n_glass = inside ? neg(normal) : normal;
  const float eta_passed = inside ? 1.f / ior : ior;
  const float reflectance = fresnel_schlick_scalar(cos_i, ior, c);
  // Reflection reuses the GGX half-vector, i.e. exactly light_dir.
  const V3 refr_dir = refract(ray_dir, n_glass, eta_passed, c);
  // The reference leaves the perturbed refraction unnormalized.
  const V3 refr_perturbed = add(refr_dir, scale(dr.ball, c.glass_perturb * alpha));
  const V3 glass_dir = dr.u_reflect < reflectance ? light_dir : refr_perturbed;

  // ---- combine ----------------------------------------------------------------
  Shaded out;
  out.new_origin = hit_pos;
  out.new_direction = glass ? glass_dir : dir_surface;
  out.att_factor = scale(brdf_combined, idotn);
  out.emission = emission_color;
  const bool brdf_ok = length(brdf_combined) >= c.tiny;
  out.att_ok = brdf_ok && !glass && !emissive && !degenerate;
  out.emissive = emissive && !degenerate;
  out.degenerate = degenerate;
  out.done = degenerate || emissive || depth_done;
  out.seed = dr.s;
  out.normal = normal;
  out.diffuse_albedo = diffuse_albedo;
  out.glass = glass;
  out.choose_spec = choose_spec;
  out.spec_prob = spec_prob;
  out.idotn = idotn;
  out.brdf_combined = brdf_combined;
  out.spec_dir = spec_dir;
  out.spec_pdf = spdf;
  out.f_vec = f_vec;
  out.alpha = alpha;
  return out;
}

__device__ __forceinline__ shade::EnvParams env_of(const BounceParams& p) {
  return shade::EnvParams{p.env_quads, p.alias, p.env_h, p.env_w, p.env_mode, p.env_scrambled};
}

// A lane's state as the bounce kernel reads it at entry: its hit record,
// ray, seed and depth (load_lane), attenuation, radiance and NEE's env
// credit.
struct LaneState {
  Lane l;
  V3 att, rad;
  float spec_w;  // under nee_mis_spec
  bool credit;   // under NEE without it
};

__device__ __forceinline__ LaneState load_state(const BounceParams& p, int i) {
  LaneState st{};
  st.l = load_lane(p, i);
  st.att = shade::v3(__ldg(p.attenuation + 3ll * i), __ldg(p.attenuation + 3ll * i + 1),
                     __ldg(p.attenuation + 3ll * i + 2));
  st.rad = shade::v3(__ldg(p.radiance + 3ll * i), __ldg(p.radiance + 3ll * i + 1), __ldg(p.radiance + 3ll * i + 2));
  if (p.nee && p.mis) {
    st.spec_w = __ldg(static_cast<const float*>(p.spec_last) + i);
  } else if (p.nee) {
    st.credit = __ldg(static_cast<const unsigned char*>(p.spec_last) + i) != 0;
  }
  return st;
}

// The bounce of lane i.  The design, for a card on which a lane is one
// long chain of dependent loads and arithmetic:
// * every load the lane needs that does not depend on its hit record is
//   issued at entry (load_state), the tri_attrs row (seven 16-byte loads)
//   right after its prim and the material row as eight, so the chain is
//   prim -> tri_attrs row -> material row -> texture rows;
// * the lane's random draws, which depend on its seed alone, are taken
//   while its rows are on their way (draw_shade, draw_nee), and under NEE
//   the alias table's draw too;
// * every lane shades, a miss lane row 0 as the plain version does: under
//   NEE its shadow ray, candidate flag and record read that shade.
// Tried and left out (sweep_bounce.py, PERF.md §6): no shade on a miss
// lane without NEE, where no field it writes reads the shade (faster only
// where warps do not mix hits and misses, as on camera rays; level on the
// pools a render feeds the kernel), the material table staged in each
// block's shared memory by cp.async (level), and each block's hit lanes
// and miss lanes partitioned into separate warps (2-3% slower at 16,384
// lanes, 1-2% faster at 131,072).
__global__ void __launch_bounds__(kThreads, kMinBlocks) bounce_kernel(const __grid_constant__ BounceParams p) {
  using namespace shade;
  // Without NEE the path step follows as a programmatic dependent
  // (launch_order.cuh): its blocks may start once every block of this
  // launch has; it reads the payload only after this launch is done.
  launch_order::let_dependents_start();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const LaneState st = load_state(p, i);
  const Lane& l = st.l;
  const bool hit = l.hit;
  const TriRow tr = load_tri(p, l.prim);
  const ShadeConsts& c = p.c;
  const EnvParams env = env_of(p);

  V3 radiance_out;
  if (hit) {
    radiance_out = st.rad;  // the emission is added below, once shaded
  } else {
    // Miss program: radiance += attenuation * env.  Under NEE only
    // spec-sampled and primary segments take the env's light.
    const V3 env_light = mul(st.att, eval_env(env, l.dir, false, 0.f, 0.f, c));
    if (p.nee && p.mis) {
      radiance_out = add(st.rad, scale(env_light, st.spec_w));
    } else if (p.nee) {
      radiance_out = add(st.rad, st.credit ? env_light : v3(0.f, 0.f, 0.f));
    } else {
      radiance_out = add(st.rad, env_light);
    }
  }
  const Draws dr = draw_shade(static_cast<uint32_t>(l.seed), p.quirk, c);
  NeeDraws nd{};
  float pdf = 0.f, env_u = 0.f, env_v = 0.f;
  V3 env_dir{};
  if (p.nee) {
    // _light_sample's alias draw: the seed's alone
    nd = draw_nee(dr.s, p.defensive);
    env_dir = sample_env_alias(env, nd.u1, nd.u2, nd.u3, nd.u4, c, pdf, env_u, env_v);
  }
  const Shaded sh = shade_lane(p, l, tr, dr);
  if (hit && sh.emissive) radiance_out = add(st.rad, mul(st.att, sh.emission));

  uint32_t s = sh.seed;
  if (p.nee) {
    s = nd.s;
    // Under the defensive mixture the cosine draw around the normal, and
    // the mixture's pdf.
    if (p.defensive) {
      V3 tang_n, binorm_n;
      onb(sh.normal, c, tang_n, binorm_n);
      const V3 dir_cos =
          onb_transform(cosine_sample_hemisphere(nd.u3, nd.u4, c), tang_n, sh.normal, binorm_n);
      const bool take_alias = nd.u5 < 0.5f;
      env_dir = take_alias ? env_dir : dir_cos;
      if (!take_alias) {
        direction_to_uv(dir_cos, c, env_u, env_v);
      }
      const float p_alias = take_alias ? pdf : env_pdf_alias(env, dir_cos, c);
      const float cos_sel = clamp_min(dot(sh.normal, env_dir), 0.f);
      pdf = 0.5f * p_alias + 0.5f * cos_sel * c.inv_pi;
    }
    // _shadow_candidates
    const float cos_l = clamp_min(dot(sh.normal, env_dir), 0.f);
    const bool cand = hit && !sh.done && !sh.glass && !sh.emissive && !sh.degenerate && cos_l > 0.f;
    store3(p.shadow_origin + 3ll * i, sh.new_origin);
    store3(p.shadow_dir + 3ll * i, env_dir);
    p.cand[i] = cand;
    namespace R = nee_record;
    const R::Ref rec{p.record + i, p.n};
    rec.store3(R::kNormal, sh.normal);
    rec.at(R::kAlpha) = sh.alpha;
    rec.at(R::kSpecProb) = sh.spec_prob;
    rec.at(R::kIdotN) = sh.idotn;
    rec.store3(R::kBrdf, sh.brdf_combined);
    rec.store3(R::kFvec, sh.f_vec);
    rec.store3(R::kDiffuse, sh.diffuse_albedo);
    rec.store3(R::kSpecDir, sh.spec_dir);
    rec.at(R::kSpecPdf) = sh.spec_pdf;
    rec.at(R::kPdf) = pdf;
    rec.at(R::kU) = env_u;
    rec.at(R::kV) = env_v;
    rec.at(R::kCosL) = cos_l;
    const int flags = (hit ? R::kHit : 0) | (cand ? R::kCand : 0) | (sh.glass ? R::kGlass : 0) |
                      (sh.choose_spec ? R::kChooseSpec : 0);
    rec.at(R::kFlags) = __int_as_float(flags);
  }

  store3(p.radiance_out + 3ll * i, radiance_out);
  store3(p.attenuation_out + 3ll * i, hit && sh.att_ok ? mul(st.att, sh.att_factor) : st.att);
  store3(p.origin_out + 3ll * i, hit ? sh.new_origin : l.origin);
  store3(p.direction_out + 3ll * i, hit ? sh.new_direction : l.dir);
  p.done_out[i] = hit ? sh.done : true;
  p.seeds_out[i] = hit ? static_cast<long long>(s) : l.seed;
}

// _shade_deferred's chunk: slot j shades lane min(lane_of_slot[j], n - 1)
// and writes its fields to row lane_of_slot[j] (row n: the sink).
__global__ void __launch_bounds__(kThreads) shade_lanes_kernel(const __grid_constant__ BounceParams p) {
  using namespace shade;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= p.slots) return;
  const long long lane = p.lane_of_slot[j];
  const int src = static_cast<int>(min(lane, static_cast<long long>(p.n - 1)));
  const Lane l = load_lane(p, src);
  const Shaded sh = shade_lane(p, l, load_tri(p, l.prim), draw_shade(static_cast<uint32_t>(l.seed), p.quirk, p.c));
  store3(p.d_origin + 3 * lane, sh.new_origin);
  store3(p.d_direction + 3 * lane, sh.new_direction);
  store3(p.d_att_factor + 3 * lane, sh.att_factor);
  store3(p.d_emission + 3 * lane, sh.emission);
  p.d_att_ok[lane] = sh.att_ok;
  p.d_emissive[lane] = sh.emissive;
  p.d_degenerate[lane] = sh.degenerate;
  p.d_done[lane] = sh.done;
  p.d_seeds[lane] = static_cast<long long>(sh.seed);
}

// The math functions the shading calls, one over n inputs, built with the
// kernel's flags: the check that each gives ATen's bits on this card.
// fn: 0 sinf(a), 1 cosf(a), 2 atan2f(a, b), 3 asinf(a), 4 powf(a, e),
// 5 rsqrtf(a), 6 sqrtf(a), 7 a / b.
__global__ void math_probe_kernel(const float* a, const float* b, float* out, int n, int fn, float e) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const float x = a[i], y = b[i];
  float r;
  switch (fn) {
    case 0: r = sinf(x); break;
    case 1: r = cosf(x); break;
    case 2: r = atan2f(x, y); break;
    case 3: r = asinf(x); break;
    case 4: r = powf(x, e); break;
    case 5: r = rsqrtf(x); break;
    case 6: r = sqrtf(x); break;
    default: r = x / y; break;
  }
  out[i] = r;
}

}  // namespace

extern "C" int shade_math_probe(const float* a, const float* b, float* out, int n, int fn, float e, void* stream) {
  if (n <= 0) return 0;
  math_probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out, n, fn, e);
  return static_cast<int>(cudaGetLastError());
}

// entry 0: the bounce over p->n lanes; entry 1: the deferred shade over
// p->slots slots.  Launches on `stream`; returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int bounce_launch(const BounceParams* p, int entry, void* stream) {
  const int count = entry == 0 ? p->n : p->slots;
  if (count <= 0) return 0;
  const int blocks = (count + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (entry == 0) {
    bounce_kernel<<<blocks, kThreads, 0, st>>>(*p);
  } else {
    shade_lanes_kernel<<<blocks, kThreads, 0, st>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

// What the card made of the kernel of `entry` (0: the bounce, 1: the
// deferred shade), into out[5]: registers a thread, local memory a thread
// (stack and spills, bytes), static shared memory a block (bytes), threads
// a block, blocks an SM holds at once.  Returns the first CUDA error.
extern "C" int bounce_attributes(int entry, int* out) {
  const void* kernel = entry == 0 ? reinterpret_cast<const void*>(bounce_kernel)
                                  : reinterpret_cast<const void*>(shade_lanes_kernel);
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = kThreads;
  out[4] = blocks;
  return 0;
}

// sizeof(BounceParams), which the wrapper checks against its mirror.
extern "C" int bounce_params_size() { return static_cast<int>(sizeof(BounceParams)); }
