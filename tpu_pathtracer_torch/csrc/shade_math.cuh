// Device counterparts of the port's shading math, one function for each
// plain function: utils/math.py (dot, normalize, cross, reflect,
// faceforward, refract, onb), render/bsdf.py, render/texsample.py,
// render/envmap.py (direction_to_uv, uv_to_direction, sample_equirect,
// sunsky, eval_env, sample_env_alias, env_pdf_alias) and
// utils/rng.py: cosine_sample_hemisphere.
//
// Each function does its plain version's float32 operations in the same
// order, and every source that includes this header is built with
// -fmad=false (no product contracted into a sum), so on the card it gives
// the plain version's bits.  What that takes, op by op:
// * Every eager PyTorch op rounds once; a dot product is
//   (x*x' + y*y') + z*z'.  A negated vector is negated before the dot, as
//   the plain code writes it (-a.b and -(a.b) differ in the sign of 0).
// * clamp_min and clamp propagate NaN and otherwise are ATen's
//   fmaxf / fminf; rsqrt is rsqrtf; sqrt, division, sin, cos, atan2, asin
//   and pow are the accurate CUDA functions, as ATen calls them.
// * A tensor divided by a Python scalar is, on the card, a product with
//   the float32 reciprocal of the float32 scalar; a Python constant
//   expression is folded in double and rounded once to float32.  Those
//   constants are computed on the host (ops/bounce.py: shade_consts) and
//   arrive in ShadeConsts, never folded here: the kernels also take pow's
//   exponent from it, so that powf is called as ATen calls it.
// * torch.remainder on integers is a floor-mod; .to(int32) truncates
//   (saturating, as the cast compiles on the card).
// * Seeds are u32 (int64 tensors holding u32 in the plain version).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "rng.cuh"

namespace shade {

// The float32 constants of the plain code, packed on the host
// (ops/bounce.py: shade_consts, in this order).
struct ShadeConsts {
  float eps2;           // normalize's floor: float32(1e-10 * 1e-10)
  float deg_len;        // 0.01: a shading normal this short is degenerate
  float emis_len;       // 0.0001: an emission this long is emissive
  float onb_y;          // 0.9999: onb_from_normal's switch of the up axis
  float tiny;           // 1e-10: the BSDF's floors
  float d_min;          // 1e-12: d_ggx's floor, the NEE pdf's floor
  float pdf_min;        // 1e-20: the two-lobe pdf's and MIS weights' floor
  float elev_min;       // 1e-6: the alias pdf's floor on cos(elevation)
  float sun_cos;        // 0.99: the sun disk's cosine
  float pi;             // float32(pi)
  float two_pi;         // float32(2 pi)
  float inv_two_pi;     // / (2 pi) on the card: 1 / float32(2 pi) in float32
  float inv_pi;         // / pi on the card: 1 / float32(pi) in float32
  float two_pi2;        // float32(2 pi^2), folded in double
  float inv255;         // float32(1 / 255)
  float pow_exp;        // 5: Schlick's exponent, as torch.pow takes it
  float inv_dpdf;       // / (1 / pi) on the card: 1 / float32(1 / pi) in float32
  float nmap_s;         // float32(normal_map_strength)
  float nmap_1ms;       // float32(1 - normal_map_strength), folded in double
  float ior;            // float32(cfg.ior)
  float rough_min;      // float32(cfg.roughness_min)
  float rough_max;      // float32(cfg.roughness_max)
  float glass_perturb;  // float32(cfg.glass_roughness_perturb)
  float env_const[3];   // float32(cfg.env_constant)
  float sun_axis[3];    // (0, 2, 3), normalised at run time as sunsky does
  float sun_rgb[3];     // (200, 175, 125)
  float sky_rgb[3];     // (0.4, 0.4, 0.6)
};

// The environment: its mode (0 equirect, 1 sunsky, 2 constant), the quad
// table and, for NEE, the alias table.
struct EnvParams {
  const float* quads;  // [h*w,12]
  const float* alias;  // [h*w,4] or null
  int h, w;
  int mode;
  int scrambled;       // quads_scrambled
};

constexpr uint32_t kScrambleMult = 2654435761u;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 load3(const float* p) { return V3{p[0], p[1], p[2]}; }
__device__ __forceinline__ void store3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return V3{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

// torch.clamp_min / clamp with scalar bounds (NaN propagates).
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.remainder on integers (floor-mod) and .to(torch.int32).
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
__device__ __forceinline__ int to_i32(float x) { return static_cast<int>(x); }

__device__ __forceinline__ float length(V3 v) { return sqrtf(dot(v, v)); }

// v * rsqrt(max(|v|^2, eps^2)).
__device__ __forceinline__ V3 normalize(V3 v, const ShadeConsts& c) {
  const float r = rsqrtf(clamp_min(dot(v, v), c.eps2));
  return scale(v, r);
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// i - (2 (i.n)) n
__device__ __forceinline__ V3 reflect(V3 i, V3 n) { return sub(i, scale(n, 2.f * dot(i, n))); }

// n * sign(i.nref), sign(0) (and NaN) taken as +1.
__device__ __forceinline__ V3 faceforward(V3 n, V3 i, V3 nref) {
  const float d = dot(i, nref);
  const float s = static_cast<float>((0.f < d) - (d < 0.f));
  return scale(n, s == 0.f ? 1.f : s);
}

// sutil refract with the index ratio 1/eta_passed; zero on TIR.
__device__ __forceinline__ V3 refract(V3 i, V3 n, float eta_passed, const ShadeConsts& c) {
  const float eta = 1.f / eta_passed;
  const float cos_i = -dot(i, n);
  const float k = 1.f - eta * eta * (1.f - cos_i * cos_i);
  const bool tir = k < 0.f;
  const float k_safe = clamp_min(k, 0.f);
  V3 r = add(scale(i, eta), scale(n, eta * cos_i - sqrtf(k_safe)));
  r = normalize(r, c);
  return tir ? v3(0.f, 0.f, 0.f) : r;
}

// onb_from_normal: (tangent, binormal).
__device__ __forceinline__ void onb(V3 normal, const ShadeConsts& c, V3& tangent, V3& binormal) {
  const V3 n = normalize(normal, c);
  const bool ny = fabsf(n.y) < c.onb_y;
  const V3 up = ny ? v3(0.f, 1.f, 0.f) : v3(1.f, 0.f, 0.f);
  tangent = normalize(cross(up, n), c);
  binormal = normalize(cross(n, tangent), c);
}

// p.x T + p.y N + p.z B
__device__ __forceinline__ V3 onb_transform(V3 p, V3 t, V3 n, V3 b) {
  return add(add(scale(t, p.x), scale(n, p.y)), scale(b, p.z));
}

__device__ __forceinline__ V3 lerp(V3 a, V3 b, float t) { return add(a, scale(sub(b, a), t)); }

// ---- render/bsdf.py --------------------------------------------------------

__device__ __forceinline__ float d_ggx(V3 n, V3 h, float alpha, const ShadeConsts& c) {
  const float a2 = alpha * alpha;
  const float ndoth = clamp_min(dot(n, h), c.tiny);
  const float ndoth2 = ndoth * ndoth;
  float denom = ndoth2 * (a2 - 1.f) + 1.f;
  denom = c.pi * denom * denom;
  return a2 / clamp_min(denom, c.d_min);
}

__device__ __forceinline__ float g_schlick_ggx(float alpha, V3 n, V3 x, const ShadeConsts& c) {
  const float ndotx = fabsf(dot(n, x));
  const float k = alpha * 0.5f;  // alpha / 2.0: a product with 1/2 on the card, exact
  return ndotx / clamp_min(ndotx * (1.f - k) + k, c.tiny);
}

__device__ __forceinline__ float g_smith(float alpha, V3 n, V3 v, V3 l, const ShadeConsts& c) {
  return g_schlick_ggx(alpha, n, v, c) * g_schlick_ggx(alpha, n, l, c);
}

__device__ __forceinline__ V3 fresnel_schlick(float cos_theta, V3 f0, const ShadeConsts& c) {
  const float cc = clamp(cos_theta, 0.f, 1.f);
  const float p = powf(1.f - cc, c.pow_exp);
  return add(f0, scale(sub(v3(1.f, 1.f, 1.f), f0), p));
}

__device__ __forceinline__ float fresnel_schlick_scalar(float cosine, float ior, const ShadeConsts& c) {
  float r0 = (1.f - ior) / (1.f + ior);
  r0 = r0 * r0;
  return r0 + (1.f - r0) * powf(1.f - cosine, c.pow_exp);
}

__device__ __forceinline__ V3 ggx_importance_sample(float r1, float r2, float alpha, const ShadeConsts& c) {
  const float phi = c.two_pi * r1;
  const float cos_theta = sqrtf((1.f - r2) / (1.f + (alpha * alpha - 1.f) * r2));
  const float sin_theta = sqrtf(clamp_min(1.f - cos_theta * cos_theta, 0.f));
  return normalize(v3(sin_theta * cosf(phi), cos_theta, sin_theta * sinf(phi)), c);
}

__device__ __forceinline__ float ggx_pdf(float d_term, float ndoth, float vdoth) {
  return d_term * ndoth / (4.f * vdoth);
}

// rng.cosine_sample_hemisphere (cosine axis +y)
__device__ __forceinline__ V3 cosine_sample_hemisphere(float u1, float u2, const ShadeConsts& c) {
  const float r = sqrtf(u1);
  const float phi = c.two_pi * u2;
  const float x = r * cosf(phi);
  const float z = r * sinf(phi);
  const float y = sqrtf(clamp_min(1.f - x * x - z * z, 0.f));
  return v3(x, y, z);
}

// ---- render/texsample.py ---------------------------------------------------

// Repeat-wrapped texel coordinates of a bilinear tap at (u, v).
struct Tap {
  float x0f, y0f, s, t;
};

__device__ __forceinline__ Tap texel_coords(int width, int height, float u, float v) {
  u = u - floorf(u);
  v = v - floorf(v);
  const float x = u * static_cast<float>(width) - 0.5f;
  const float y = v * static_cast<float>(height) - 0.5f;
  Tap tap;
  tap.x0f = floorf(x);
  tap.y0f = floorf(y);
  tap.s = x - tap.x0f;
  tap.t = y - tap.y0f;
  return tap;
}

__device__ __forceinline__ float lerp2(float c00, float c10, float c01, float c11, float s, float t) {
  const float c0 = c00 + (c10 - c00) * s;
  const float c1 = c01 + (c11 - c01) * s;
  return c0 + (c1 - c0) * t;
}

__device__ __forceinline__ float byte_of(long long word, int shift, const ShadeConsts& c) {
  return static_cast<float>((word >> shift) & 0xFF) * c.inv255;
}

// The rgb (shift 0, 8, 16) of four RGBA8 corner words, bilinear.
__device__ __forceinline__ V3 lerp_rgb(const long long* q, float s, float t, const ShadeConsts& c) {
  float ch[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ch[k] = lerp2(byte_of(q[0], 8 * k, c), byte_of(q[1], 8 * k, c), byte_of(q[2], 8 * k, c),
                  byte_of(q[3], 8 * k, c), s, t);
  }
  return v3(ch[0], ch[1], ch[2]);
}

// sample_bilinear_pool: one [P,4] quad row.
__device__ __forceinline__ V3 sample_pool(const long long* quads, int offset, int width, int height, float u,
                                          float v, const ShadeConsts& c) {
  const Tap tap = texel_coords(width, height, u, v);
  const int x0 = floor_mod(to_i32(tap.x0f), width);
  const int y0 = floor_mod(to_i32(tap.y0f), height);
  const long long* q = quads + 4ll * static_cast<long long>(offset + y0 * width + x0);
  long long w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = __ldg(q + j);
  return lerp_rgb(w, tap.s, tap.t, c);
}

__device__ __forceinline__ int part1by1(int v) {
  v = v & 0xFFFF;
  v = (v | (v << 8)) & 0x00FF00FF;
  v = (v | (v << 4)) & 0x0F0F0F0F;
  v = (v | (v << 2)) & 0x33333333;
  v = (v | (v << 1)) & 0x55555555;
  return v;
}

// sample_bundle: the four kinds from one [Pb,8] row.  rgb[0] albedo,
// rgb[1] normal; scalar[0] roughness, scalar[1] metallic.
__device__ __forceinline__ void sample_bundle(const long long* bundles, int offset, int width, int height, float u,
                                              float v, bool morton, bool scrambled, bool pow2, const ShadeConsts& c,
                                              V3 rgb[2], float scalar[2]) {
  const Tap tap = texel_coords(width, height, u, v);
  int x0, y0;
  if (pow2) {
    x0 = to_i32(tap.x0f) & (width - 1);
    y0 = to_i32(tap.y0f) & (height - 1);
  } else {
    x0 = floor_mod(to_i32(tap.x0f), width);
    y0 = floor_mod(to_i32(tap.y0f), height);
  }
  long long texel;
  if (scrambled) {
    const uint32_t t_row = static_cast<uint32_t>(y0 * width + x0);
    const uint32_t wh_mask = static_cast<uint32_t>(width * height - 1);
    texel = static_cast<long long>((t_row * kScrambleMult) & wh_mask);
  } else if (morton) {
    texel = part1by1(x0) | (part1by1(y0) << 1);
  } else {
    texel = y0 * width + x0;
  }
  const long long* row = bundles + 8ll * (static_cast<long long>(offset) + texel);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    long long w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = __ldg(row + 4 * b + j);
    rgb[b] = lerp_rgb(w, tap.s, tap.t, c);
    scalar[b] = lerp2(byte_of(w[0], 24, c), byte_of(w[1], 24, c), byte_of(w[2], 24, c), byte_of(w[3], 24, c),
                      tap.s, tap.t);
  }
}

// ---- render/envmap.py ------------------------------------------------------

__device__ __forceinline__ void direction_to_uv(V3 d, const ShadeConsts& c, float& u, float& v) {
  d = normalize(d, c);
  u = 0.5f + atan2f(d.z, d.x) * c.inv_two_pi;
  v = 0.5f - asinf(clamp(d.y, -1.f, 1.f)) * c.inv_pi;
}

__device__ __forceinline__ V3 uv_to_direction(float u, float v, const ShadeConsts& c) {
  const float phi = (u - 0.5f) * c.two_pi;
  const float theta = (0.5f - v) * c.pi;
  const float y = sinf(theta);
  const float cth = cosf(theta);
  return v3(cth * cosf(phi), y, cth * sinf(phi));
}

// Bilinear fetch from the [h*w,12] quad table: x wraps, y clamps.
__device__ __forceinline__ V3 sample_equirect(const EnvParams& env, float u, float v) {
  const int h = env.h, w = env.w;
  const float x = u * static_cast<float>(w) - 0.5f;
  const float y = v * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const int xi0 = floor_mod(to_i32(x0), w);
  const int yi0 = min(max(to_i32(y0), 0), h - 1);
  long long row = yi0 * w + xi0;
  if (env.scrambled) {
    row = static_cast<long long>((static_cast<uint32_t>(row) * kScrambleMult) & static_cast<uint32_t>(h * w - 1));
  }
  const float* q = env.quads + 12ll * row;
  const float s = x - x0;
  const float t = y - y0;
  float out[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c00 = __ldg(q + k), c10 = __ldg(q + 3 + k), c01 = __ldg(q + 6 + k), c11 = __ldg(q + 9 + k);
    const float c0 = c00 + (c10 - c00) * s;
    const float c1 = c01 + (c11 - c01) * s;
    out[k] = c0 + (c1 - c0) * t;
  }
  return v3(out[0], out[1], out[2]);
}

__device__ __forceinline__ V3 sunsky(V3 direction, const ShadeConsts& c) {
  const V3 d = normalize(direction, c);
  const V3 sun_dir = normalize(load3(c.sun_axis), c);
  return dot(d, sun_dir) > c.sun_cos ? load3(c.sun_rgb) : load3(c.sky_rgb);
}

// eval_env; has_uv: the draw's exact (u, v) (equirect only).
__device__ __forceinline__ V3 eval_env(const EnvParams& env, V3 direction, bool has_uv, float u, float v,
                                       const ShadeConsts& c) {
  if (env.mode == 2) return load3(c.env_const);
  if (env.mode == 1) return sunsky(direction, c);
  if (!has_uv) direction_to_uv(direction, c, u, v);
  return sample_equirect(env, u, v);
}

// Solid-angle pdf at elevation (0.5 - v) pi of a texel of mass pmass.
__device__ __forceinline__ float alias_pdf(float pmass, float v, const EnvParams& env, const ShadeConsts& c) {
  const float cos_elev = clamp_min(cosf((0.5f - v) * c.pi), c.elev_min);
  return pmass * static_cast<float>(env.h * env.w) / (c.two_pi2 * cos_elev);
}

// sample_env_alias: direction, pdf and the draw's (u, v).
__device__ __forceinline__ V3 sample_env_alias(const EnvParams& env, float u1, float u2, float u3, float u4,
                                               const ShadeConsts& c, float& pdf, float& u, float& v) {
  const int n = env.h * env.w;
  const int i = min(to_i32(u1 * static_cast<float>(n)), n - 1);
  const float* row = env.alias + 4ll * i;
  const bool take_self = u2 < __ldg(row);
  const int texel = take_self ? i : to_i32(__ldg(row + 1));
  const float pmass = take_self ? __ldg(row + 2) : __ldg(row + 3);
  const int ty = texel / env.w;  // texel >= 0: floor division
  const int tx = texel % env.w;
  // / width and / height: products with the float32 reciprocals
  u = (static_cast<float>(tx) + u3) * (1.f / static_cast<float>(env.w));
  v = (static_cast<float>(ty) + u4) * (1.f / static_cast<float>(env.h));
  pdf = alias_pdf(pmass, v, env, c);
  return uv_to_direction(u, v, c);
}

// env_pdf_alias at an arbitrary direction.
__device__ __forceinline__ float env_pdf_alias(const EnvParams& env, V3 d, const ShadeConsts& c) {
  float u, v;
  direction_to_uv(d, c, u, v);
  const int col = min(max(to_i32(u * static_cast<float>(env.w)), 0), env.w - 1);
  const int row = min(max(to_i32(v * static_cast<float>(env.h)), 0), env.h - 1);
  const float pmass = __ldg(env.alias + 4ll * (row * env.w + col) + 2);
  return alias_pdf(pmass, v, env, c);
}

}  // namespace shade

// The NEE record the bounce kernel (bounce.cu) writes for every lane and
// the NEE kernel (nee.cu) reads: float32 [kRecord, n], stored field by
// field so that each field's loads and stores coalesce across a warp, its
// last field the lane's flags as int bits.
namespace nee_record {
constexpr int kNormal = 0;      // 3: the shading normal
constexpr int kAlpha = 3;
constexpr int kSpecProb = 4;
constexpr int kIdotN = 5;
constexpr int kBrdf = 6;        // 3: brdf_combined
constexpr int kFvec = 9;        // 3
constexpr int kDiffuse = 12;    // 3: diffuse_albedo
constexpr int kSpecDir = 15;    // 3
constexpr int kSpecPdf = 18;
constexpr int kPdf = 19;        // the light draw's pdf
constexpr int kU = 20;          // the draw's exact (u, v)
constexpr int kV = 21;
constexpr int kCosL = 22;
constexpr int kFlags = 23;
constexpr int kRecord = 24;
constexpr int kHit = 1, kCand = 2, kGlass = 4, kChooseSpec = 8;

// One lane's record: field f at lane[f * field].
struct Ref {
  float* lane;
  long long field;
  __device__ __forceinline__ float& at(int f) const { return lane[f * field]; }
  __device__ __forceinline__ shade::V3 load3(int f) const { return shade::V3{at(f), at(f + 1), at(f + 2)}; }
  __device__ __forceinline__ void store3(int f, shade::V3 v) const {
    at(f) = v.x;
    at(f + 1) = v.y;
    at(f + 2) = v.z;
  }
};
}  // namespace nee_record
