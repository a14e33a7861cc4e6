// Next-event estimation's weights, one lane a thread, for Hopper: what
// _next_event does after the shadow rays' any-hit traversal, in one launch.
//
// Replaces no TPU kernel: in the JAX package this is a fusion that XLA
// makes under jax.jit of _trace_bounce's NEE tail
// (tpu_pathtracer/render/integrator.py :635-720).  Its plain version is the
// port's eager _next_event (render/integrator.py) from the any-hit query
// on, some 200 device kernels a bounce when run op by op.
//
// What it computes, per lane, as the plain version does, from the record
// the bounce kernel (bounce.cu) wrote and the any-hit flags:
// * eval_env at the light draw's exact (u, v) (or its direction, in the
//   sunsky and constant modes), on the lanes whose light is visible;
// * the lobe-partitioned weight (1 - P_s) IdotN cos_l / (pi pdf);
// * under nee_mis_spec the spec arm at h_l (d_ggx, g_smith, ggx_pdf), the
//   balance weight w_l, p_light_s through env_pdf_alias (the defensive
//   mixture included) and w_b;
// * spec_next, the next segment's env credit (a flag, or its MIS weight);
// * the visible select into radiance: radiance + (visible ? contrib : 0)
//   on hit lanes, in place in the bounce kernel's radiance.
// Bit-equality with the plain version: see shade_math.cuh.  Built with
// -fmad=false; the float32 constants arrive from the host.
//
// What bounds it.  Bytes: every lane reads its record's flags and writes
// spec_next; a visible lane also reads the record fields its weights use,
// its shadow direction, attenuation and radiance and an env quad row, and
// writes radiance (chip_smoke.py: nee_bytes, ~0.0013 ms at 131,072 lanes
// on the headline).  A few hundred float operations a lane at most.  Bound
// by bytes on paper; on the card by latency: one thread a lane, the grid
// one wave of blocks, a lane's work a chain of dependent loads.  The
// record is stored field by field ([kRecord, n]), so a warp's load of one
// field is one coalesced 128-byte line, not 32 lines 96 bytes apart.
//
// Its design: the loads first, and a programmatic dependent of the
// any-hit traversal (launch_order.cuh).  Of what the kernel reads, only the
// any-hit byte comes from the launch just before it; the record, the
// shadow direction and radiance come from the bounce kernel, two or more
// launches back, and the rest from the loop's state and the scene.  So,
// with no branch in front: round 1 issues every load that depends on no
// other (the flags, every record field a lane may use, shadow_dir,
// attenuation, radiance, under MIS direction); round 2 the gathers whose
// addresses round 1 gave (the env texel at the draw's (u, v), a lane with
// no candidate the one at (0, 0); under MIS the alias entry at spec_dir);
// then every lane's contribution as if its light were visible.  All of
// that runs before the wait, while the traversal drains.  After it: the
// any-hit byte, applied as a select (an occluded lane's contribution may
// be inf or NaN, which a product with the flag would carry into
// radiance), and the stores.  The invariant of launch_order.cuh holds:
// before the wait the kernel reads only what was written before the
// nearest launch made without the attribute (the traversal) began, and
// it stores nothing before it.  Under NEE the path step
// (fused_schedule.cu) follows as its programmatic dependent, so the
// kernel lets it start at entry.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch_order.cuh"
#include "shade_math.cuh"

using shade::V3;

namespace {

constexpr int kThreads = 128;

}  // namespace

// The launch's arguments (mirrored by ops/bounce.py: NeeParams).
struct NeeParams {
  const float* env_quads;         // [h*w,12]
  const float* alias;             // [h*w,4]
  const float* record;            // [nee_record::kRecord, n]: field f of lane i at f*n + i
  const float* shadow_dir;        // [n,3] the light draws
  const unsigned char* occluded;  // [n] bool: the any-hit flags (read where cand)
  const float* direction;         // [n,3] the bounce's incoming rays
  const float* attenuation;       // [n,3] the attenuation the bounce began with
  float* radiance;                // [n,3] the bounce kernel's radiance, updated in place
  void* spec_next;                // [n] bool, float32 under nee_mis_spec
  int n;
  int env_h, env_w, env_mode, env_scrambled;
  int mis, defensive;
  shade::ShadeConsts c;
};

namespace {

__global__ void __launch_bounds__(kThreads) nee_kernel(const __grid_constant__ NeeParams p) {
  using namespace shade;
  namespace R = nee_record;
  launch_order::let_dependents_start();  // the path step, under NEE
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const ShadeConsts& c = p.c;
  const EnvParams env{p.env_quads, p.alias, p.env_h, p.env_w, p.env_mode, p.env_scrambled};
  const R::Ref rec{const_cast<float*>(p.record) + i, p.n};

  // Round 1: every load that depends on no other load, on every lane.
  const int flags = __float_as_int(rec.at(R::kFlags));
  const V3 normal = rec.load3(R::kNormal);
  const float pdf = rec.at(R::kPdf);
  const float spec_prob = rec.at(R::kSpecProb);
  const float idotn = rec.at(R::kIdotN);
  const float cos_l = rec.at(R::kCosL);
  const float u = rec.at(R::kU);
  const float v = rec.at(R::kV);
  const V3 brdf = rec.load3(R::kBrdf);
  const V3 env_dir = load3(p.shadow_dir + 3ll * i);
  const V3 att = load3(p.attenuation + 3ll * i);
  const V3 rad = load3(p.radiance + 3ll * i);
  V3 spec_dir = v3(0.f, 0.f, 0.f), f_vec = spec_dir, albedo = spec_dir, view = spec_dir;
  float spec_pdf = 0.f, alpha = 0.f;
  if (p.mis) {  // the launch's mode: the same on every lane
    spec_dir = rec.load3(R::kSpecDir);
    spec_pdf = rec.at(R::kSpecPdf);
    alpha = rec.at(R::kAlpha);
    f_vec = rec.load3(R::kFvec);
    albedo = rec.load3(R::kDiffuse);
    view = neg(load3(p.direction + 3ll * i));
  }
  const bool hit = flags & R::kHit;
  const bool cand = flags & R::kCand;  // the bounce kernel sets it on hit lanes only
  const bool glass = flags & R::kGlass;
  const bool choose_spec = flags & R::kChooseSpec;

  // Round 2: the gathers at round 1's addresses.  eval_env at the draw's
  // exact (u, v); a lane without a candidate reads the texel at (0, 0),
  // which every such lane shares, in place of one at a stale (u, v).
  const V3 l_env = eval_env(env, env_dir, true, cand ? u : 0.f, cand ? v : 0.f, c);
  // The BSDF arm's weight for the next segment's env credit: both
  // densities at the spec continuation, with this bounce's normal.
  float w_b = 0.f;
  if (p.mis) {
    float p_light_s = env_pdf_alias(env, spec_dir, c);
    if (p.defensive) {
      const float cos_s = clamp_min(dot(normal, spec_dir), 0.f);
      p_light_s = 0.5f * p_light_s + 0.5f * cos_s * c.inv_pi;
    }
    w_b = spec_pdf / clamp_min(spec_pdf + p_light_s, c.pdf_min);
  }

  // Every lane's contribution as if its light were visible (the any-hit
  // answer selects it below).  Lobe-partitioned estimator: the base
  // estimator's cosine-lobe share (1 - P_s) of M*IdotN*E_cos[L*vis] is
  // estimated by the light draw.
  const float weight = (1.f - spec_prob) * idotn * cos_l / (c.pi * clamp_min(pdf, c.d_min));
  V3 contrib = mul(scale(mul(att, brdf), weight), l_env);
  if (p.mis) {
    // The spec lobe's light-sampled arm on the same draw and shadow ray,
    // with the balance weight w_l = p_light / (p_light + p_ggx).
    const V3 h_l = normalize(add(view, env_dir), c);
    const float d_term_l = d_ggx(normal, h_l, alpha, c);
    const float g_term_l = g_smith(alpha, normal, view, env_dir, c);
    const float ndotv_l = dot(normal, view);
    const float denom_l = 4.f * fabsf(ndotv_l) * fabsf(dot(normal, env_dir));
    const V3 brdf_spec_l = scale(f_vec, d_term_l * g_term_l / clamp_min(denom_l, c.tiny));
    const float ndoth_l = clamp_min(dot(normal, h_l), c.tiny);
    const float vdoth_l = clamp_min(dot(view, h_l), c.tiny);
    const float p_ggx_l = ggx_pdf(d_term_l, ndoth_l, vdoth_l);
    const float w_l = pdf / clamp_min(pdf + p_ggx_l, c.pdf_min);
    const V3 inner = add(scale(brdf_spec_l, spec_prob), scale(albedo, (1.f - spec_prob) * c.pi * p_ggx_l));
    const V3 g_spec = scale(scale(inner, spec_prob), cos_l);
    contrib = add(contrib, mul(scale(mul(att, g_spec), w_l / clamp_min(pdf, c.d_min)), l_env));
  }

  // The any-hit traversal, the launch just before this one, writes the
  // flags: they are read after it has completed, and nothing is stored
  // before.
  launch_order::wait_for_launch_before();
  const bool visible = cand && !p.occluded[i];
  if (p.mis) {
    static_cast<float*>(p.spec_next)[i] = glass ? 1.f : (choose_spec ? w_b : 0.f);
  } else {
    static_cast<unsigned char*>(p.spec_next)[i] = choose_spec || glass;
  }
  // A miss lane keeps the miss program's radiance; a hit lane adds its
  // light where visible, as a select.
  if (hit) store3(p.radiance + 3ll * i, add(rad, visible ? contrib : v3(0.f, 0.f, 0.f)));
}

}  // namespace

// Launches one thread a lane on `stream`, as a programmatic dependent of
// the launch before it where `dependent` (the caller vouches that that
// launch writes nothing the kernel reads before its wait: the any-hit
// traversal of the shadow rays); returns the launch's error, or
// cudaGetLastError() after it (0 = launched).
extern "C" int nee_launch(const NeeParams* p, int dependent, void* stream) {
  if (p->n <= 0) return 0;
  const int blocks = (p->n + kThreads - 1) / kThreads;
  const cudaError_t err = launch_order::launch(nee_kernel, blocks, kThreads, static_cast<cudaStream_t>(stream),
                                               dependent != 0, *p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// sizeof(NeeParams), which the wrapper checks against its mirror.
extern "C" int nee_params_size() { return static_cast<int>(sizeof(NeeParams)); }
