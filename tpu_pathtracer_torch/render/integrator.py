"""The wavefront path-tracing integrator: closest-hit shading, one bounce
for every lane, and the frame schedules.

Counterpart of `tpu_pathtracer/render/integrator.py`: `_shade`,
`_trace_bounce` with and without next-event estimation (NEE), the
schedules `render_rays` (one lane per sample, for 1 spp),
`render_pixels_regen` (one lane per pixel), `render_pixels_stream` (a
lane pool and a work queue) and `render_pixels_stream_fused` (the same
with its post-trace tail in one kernel launch, TPU kernel 7),
`render_pixels` over the whole frame or a pixel-id array, `render_frame`
and `render_frame_stats` with `tile_pixels`, and `count_segments`.  The
estimator is the reference's (cfg.rr_mode="reference": the whole path's
radiance divided by the last survival probability, a deterministic
two-lobe BSDF blend, glass bounces that skip the attenuation update) or
textbook Russian roulette ("standard", which NEE requires).  NEE draws one environment
direction per surface hit from the alias table, traces one shadow ray
(`occluded_scene`) and adds the diffuse lobe's light; env radiance on
misses is then credited only to spec-sampled or primary segments
(`spec_last`), optionally under one-sample MIS (cfg.nee_mis_spec) and a
defensive alias/cosine mixture (cfg.nee_defensive_mix).  Multi-queue NEE
(the shadow ray riding the next closest-hit batch) was measured slower
on the TPU and is not ported.

Deferred shading (cfg.deferred_shade, `_shade_deferred`) shades only the
lanes that hit, in dense chunks; `render_pixels` also takes an affine
pixel range (base, count), which sharded renders pass.

On a CUDA device the traversal runs as hand-written kernels (the
cluster accel's, ops/intersect_cluster.py, or on a scene without one the
brute-force kernels, ops/intersect.py), and the bounce's work after it as
hand-written kernels (ops/bounce.py: the bounce kernel, with deferred
shading's chunks as its second entry point, and the NEE kernel), and so
does every camera spawn (ops/camera.py) and every schedule's step after
the trace (ops/fused_schedule.py: kernel 7 for the stream, the path step
for render_rays and render_pixels_regen); the eager code is their plain
version, which the CPU runs and, under `ops.cuda_build.plain()`, the card
(but for the fused stream's step, which keeps kernel 7).

Each schedule's loop is a per-frame set-up that writes a plan's static
buffers (render/graph_loop.py) and a step that reads and writes only
those buffers; on a CUDA device the step is captured once per (scene,
config, schedule, shape) as a CUDA graph and replayed, the counterpart of
the JAX package's jitted `lax.while_loop`s.  The host loop reads one
value from the device per iteration (whether any lane is still live, or
how many are: `_read`, the iteration's only stream sync) and caps the
iterations.  Deferred shading adds its count of hit lanes, a read inside
the step, so its loop stays eager.

The frame and loop layers record the spans of runtime/profiler.py:
`frame.render` (render_frame_stats), `frame.setup` (render_pixels up to
its schedule's loop), `loop.run` (each schedule's loop) and `loop.read`
(`_read`); `_read` counts `graph_loop.stats["reads"]`, and each
schedule hands its stats' segment counts to the recorder.
"""

from __future__ import annotations

import functools
import math

import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.ops import bounce as bounce_ops
from tpu_pathtracer_torch.ops import camera as camera_ops
from tpu_pathtracer_torch.ops import cuda_build
from tpu_pathtracer_torch.ops.fused_schedule import (STATE_KEYS, fused_stream_step, fused_stream_step_plain, path_step,
                                                     slot_pixels)
from tpu_pathtracer_torch.ops.intersect import Hit, intersect_scene, occluded_scene
from tpu_pathtracer_torch.ops.unit_sphere import random_in_unit_sphere
from tpu_pathtracer_torch.render import bsdf, graph_loop
from tpu_pathtracer_torch.render.envmap import direction_to_uv, env_pdf_alias, eval_env, sample_env_alias
from tpu_pathtracer_torch.render.texsample import material_property, sample_bundle
from tpu_pathtracer_torch.runtime import profiler
from tpu_pathtracer_torch.scene import scene as S
from tpu_pathtracer_torch.scene.scene import Scene
from tpu_pathtracer_torch.utils import math as vm
from tpu_pathtracer_torch.utils import rng
from tpu_pathtracer_torch.utils.device import constant


def _interp(w: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """Barycentric blend: w [N,3] of corners [N,3,C] -> [N,C]."""
    return (
        w[:, 0:1] * corners[:, 0] + w[:, 1:2] * corners[:, 1]
    ) + w[:, 2:3] * corners[:, 2]


# ---------------------------------------------------------------------------
# Closest-hit shading
# ---------------------------------------------------------------------------

def _shade(scene: Scene, cfg: RenderConfig, hit: Hit, origins, directions, seeds, depth):
    """Closest-hit program for every lane; callers select with the hit and
    termination masks.  Returns a dict: new_origin, new_direction,
    att_factor ([N,3], multiplied into the attenuation where att_ok),
    att_ok, emission, emissive, degenerate, done, seeds, and for NEE
    normal, diffuse_albedo, glass, choose_spec, spec_prob, idotn,
    brdf_combined, spec_dir, spec_pdf, f_vec, alpha."""
    prim = torch.clamp_min(hit.prim, 0).long()  # miss lanes read row 0
    ta = scene.tri_attrs[prim]                                  # [N,32]
    tri_v = ta[:, S.TRI_V].reshape(-1, 3, 3)
    tri_n = ta[:, S.TRI_N].reshape(-1, 3, 3)
    tri_uv = ta[:, S.TRI_UV].reshape(-1, 3, 2)
    mat = ta[:, S.TRI_MAT].to(torch.int32).long()
    m = scene.materials
    ma = m.attrs[mat]                                           # [N,40]
    n_lanes = ma.shape[0]

    ray_dir = directions
    v0, v1, v2 = tri_v[:, 0], tri_v[:, 1], tri_v[:, 2]

    # Flat geometric normal, face-forwarded against the ray.
    flat_n = vm.normalize(vm.cross(v1 - v0, v2 - v0))
    flat_n = vm.faceforward(flat_n, -ray_dir, flat_n)

    beta = hit.bary[:, 0]
    gamma = hit.bary[:, 1]
    w_interp = torch.stack([1.0 - beta - gamma, beta, gamma], dim=-1)

    uv = _interp(w_interp, tri_uv)
    tex_u = uv[:, 0]
    tex_v = (1.0 - uv[:, 1]) if cfg.flip_v else uv[:, 1]

    normal_raw = _interp(w_interp, tri_n)
    degenerate = vm.length(normal_raw) <= 0.01
    normal = vm.normalize(normal_raw)
    # A backfacing smooth normal falls back to the flat normal.
    normal = torch.where((vm.dot(normal, ray_dir) > 0.0)[:, None], flat_n, normal)

    hit_pos = origins + hit.t[:, None] * ray_dir

    # ---- texture-driven material properties --------------------------
    has_map = ma[:, S.MAT_HAS_MAP] > 0.5                        # [N,4]
    if m.bundled:
        samples = sample_bundle(
            m.texture_bundles,
            ma[:, S.MAT_BUNDLE_OFFSET].to(torch.int32),
            ma[:, S.MAT_BUNDLE_WIDTH].to(torch.int32),
            ma[:, S.MAT_BUNDLE_HEIGHT].to(torch.int32),
            tex_u, tex_v,
            morton=m.bundled_morton,
            scrambled=m.bundled_scrambled,
            pow2_dims=m.bundled_pow2_dims,
        )

        def prop(kind: int, fallback):
            return torch.where(has_map[:, kind][:, None], samples[kind], fallback)

    else:
        map_off = ma[:, S.MAT_MAP_OFFSET].to(torch.int32)
        map_w = ma[:, S.MAT_MAP_WIDTH].to(torch.int32)
        map_h = ma[:, S.MAT_MAP_HEIGHT].to(torch.int32)

        def prop(kind: int, fallback):
            return material_property(
                m.texture_quads, has_map[:, kind], map_off[:, kind],
                map_w[:, kind], map_h[:, kind], fallback, tex_u, tex_v,
            )

    diffuse_albedo = prop(0, ma[:, S.MAT_DIFFUSE])

    nmap_fallback = constant((0.0, 1.0, 0.0), torch.float32, ma.device).expand(n_lanes, 3)
    nmap = prop(2, nmap_fallback)
    # Decode 2n-1 and swap the Y/Z channels.
    decoded = vm.normalize(2.0 * nmap - 1.0)
    decoded = torch.stack([decoded[..., 0], decoded[..., 2], decoded[..., 1]], dim=-1)
    nmap = torch.where(has_map[:, 2][:, None], decoded, nmap)
    # Rotate into the shading frame and blend at a fixed strength.
    tang, binorm = vm.onb_from_normal(normal)
    nmap_world = vm.onb_transform(nmap, tang, normal, binorm)
    s = cfg.normal_map_strength
    normal = vm.normalize(s * nmap_world + (1.0 - s) * normal)

    specular_albedo = diffuse_albedo
    emission_color = ma[:, S.MAT_EMISSION]

    roughness = prop(1, ma[:, S.MAT_ROUGHNESS, None].expand(n_lanes, 3))[:, 0]
    metallicity = prop(3, ma[:, S.MAT_METALLIC, None].expand(n_lanes, 3))[:, 0]
    transparency = ma[:, S.MAT_TRANSPARENT]
    mat_ior = ma[:, S.MAT_IOR]
    ior = torch.where(mat_ior > 0.0, mat_ior, cfg.ior)

    # An emissive hit terminates the path.
    emissive = vm.length(emission_color) > 0.0001

    if cfg.seed_advance_quirk:
        seeds, _ = random_in_unit_sphere(seeds)

    roughness = torch.clamp(roughness, cfg.roughness_min, cfg.roughness_max)
    depth_done = depth <= 0

    # ---- GGX importance sampling ---------------------------------------
    seeds, r1, r2 = rng.uniform2(seeds)
    alpha = roughness * roughness
    half_local = bsdf.ggx_importance_sample(r1, r2, alpha)
    tang2, binorm2 = vm.onb_from_normal(normal)
    half_vec = vm.onb_transform(half_local, tang2, normal, binorm2)

    light_dir = vm.reflect(ray_dir, half_vec)
    seeds, r3, r4 = rng.uniform2(seeds)
    light_dir_diffuse = vm.onb_transform(
        rng.cosine_sample_hemisphere(r3, r4), tang2, normal, binorm2
    )

    # ---- specular BRDF ----------------------------------------------------
    f0_scalar = ((1.0 - ior) / (1.0 + ior)) ** 2
    f0 = f0_scalar[:, None].expand_as(diffuse_albedo)
    f0 = vm.lerp(f0, specular_albedo, metallicity[:, None])
    ndotv_raw = vm.dot(normal, -ray_dir)
    f_vec = bsdf.fresnel_schlick(torch.clamp_min(ndotv_raw, 0.0), f0)
    d_term = bsdf.d_ggx(normal, half_vec, alpha)
    g_term = bsdf.g_smith(alpha, normal, -ray_dir, light_dir)
    denom = 4.0 * torch.abs(ndotv_raw) * torch.abs(vm.dot(normal, light_dir))
    brdf_specular = f_vec * (d_term * g_term / torch.clamp_min(denom, 1e-10))[:, None]

    ndoth = torch.clamp_min(vm.dot(normal, half_vec), 1e-10)
    vdoth = torch.clamp_min(vm.dot(-ray_dir, half_vec), 1e-10)
    ndotv = torch.clamp_min(ndotv_raw, 0.0)
    # The throughput cosine is always taken against the specular direction.
    idotn = torch.abs(vm.dot(normal, vm.normalize(light_dir)))
    f_blend = bsdf.fresnel_schlick_scalar(ndotv, ior)

    # ---- lobe selection ----------------------------------------------------
    spec_prob = metallicity + (1.0 - metallicity) * f_blend
    spdf = bsdf.ggx_pdf(d_term, ndoth, vdoth)
    dpdf = 1.0 / math.pi
    seeds, u_lobe = rng.uniform(seeds)
    choose_spec = u_lobe < spec_prob
    spec_dir = vm.normalize(light_dir)
    dir_surface = torch.where(choose_spec[:, None], spec_dir, vm.normalize(light_dir_diffuse))
    # Deterministic two-lobe blend, the same whichever lobe was sampled.
    brdf_combined = spec_prob[:, None] * (
        brdf_specular / torch.clamp_min(spdf, 1e-20)[:, None]
    ) + (1.0 - spec_prob)[:, None] * (diffuse_albedo / dpdf)

    # ---- glass branch -------------------------------------------------------
    glass = transparency > 0.5
    cos_theta_i = vm.dot(normal, -ray_dir)
    inside = cos_theta_i < 0.0
    cos_i = torch.abs(cos_theta_i)
    n_glass = torch.where(inside[:, None], -normal, normal)
    eta_passed = torch.where(inside, 1.0 / ior, ior)
    reflectance = bsdf.fresnel_schlick_scalar(cos_i, ior)
    seeds, u_reflect = rng.uniform(seeds)
    # Reflection reuses the GGX half-vector, i.e. exactly `light_dir`.
    refr_dir, _ = vm.refract(ray_dir, n_glass, eta_passed)
    seeds, sphere_pt = random_in_unit_sphere(seeds)
    # The reference leaves the perturbed refraction unnormalized.
    refr_perturbed = refr_dir + cfg.glass_roughness_perturb * alpha[:, None] * sphere_pt
    glass_dir = torch.where((u_reflect < reflectance)[:, None], light_dir, refr_perturbed)

    # ---- combine ------------------------------------------------------------
    new_direction = torch.where(glass[:, None], glass_dir, dir_surface)
    brdf_ok = vm.length(brdf_combined) >= 1e-10
    att_factor = brdf_combined * idotn[:, None]
    att_ok = brdf_ok & ~glass & ~emissive & ~degenerate

    return dict(
        new_origin=hit_pos,
        new_direction=new_direction,
        att_factor=att_factor,
        att_ok=att_ok,
        emission=emission_color,
        emissive=emissive & ~degenerate,
        degenerate=degenerate,
        done=degenerate | emissive | depth_done,
        seeds=seeds,
        normal=normal,
        diffuse_albedo=diffuse_albedo,
        glass=glass,
        choose_spec=choose_spec,
        spec_prob=spec_prob,
        idotn=idotn,
        brdf_combined=brdf_combined,
        spec_dir=spec_dir,
        spec_pdf=spdf,
        f_vec=f_vec,
        alpha=alpha,
    )


# ---------------------------------------------------------------------------
# Deferred (hit-compacted) shading
# ---------------------------------------------------------------------------

# The fields of `_shade`'s dict that the bounce reads without NEE:
# [N,3] float32, [N] bool, and the seeds.
_DEFERRED_VECTORS = ("new_origin", "new_direction", "att_factor", "emission")
_DEFERRED_FLAGS = ("att_ok", "emissive", "degenerate", "done")


def _shade_deferred(scene: Scene, cfg: RenderConfig, hit: Hit, origins, directions, seeds, depth):
    """`_shade` run only on the lanes that hit, in dense chunks (the JAX
    package's `_shade_deferred`): the hit lanes are compacted in lane order
    by a prefix sum over the hit mask, shaded in ceil(n_hit / C) chunks of
    C = min(n, max(1024, n / cfg.deferred_chunk_div rounded up to 1024))
    lanes, and each chunk's outputs are scattered back to their source
    lanes.  Miss lanes hold zeros (callers select under the hit mask); the
    fields are the ones the bounce reads without NEE.  On the card each
    chunk is one launch of the bounce kernel's second entry point
    (ops/bounce.shade_lanes) outside `ops.cuda_build.plain()`.

    The slot table is padded to a whole number of chunks: its tail slots
    point at a sink row n, so every slot is shaded once (the JAX package
    instead clamps the last chunk's slice and shades some lanes twice).
    The count of hit lanes sets the number of chunks, so it is read from
    the device (`_read`): a second stream sync in every iteration, only
    when deferred shading is on.  Each lane's arithmetic and RNG chain are
    those of `_shade`, so the outputs equal the dense shade's."""
    n, dev = origins.shape[0], origins.device
    c = min(n, max(1024, -(-(n // cfg.deferred_chunk_div) // 1024) * 1024))
    pos = torch.cumsum(hit.hit, dim=0)
    n_hit = _read(pos[-1])
    slots = -(-n_hit // c) * c
    # lane_of_slot[s]: the lane of dense slot s; n for the tail.  Miss
    # lanes write to one extra entry past the table, dropped.
    dest = torch.where(hit.hit, pos - 1, slots)
    lane_of_slot = torch.full((slots + 1,), n, dtype=torch.int64, device=dev)
    lane_of_slot.scatter_(0, dest, torch.arange(n, dtype=torch.int64, device=dev))
    # Row n is the sink of the tail slots.
    out = {key: torch.zeros((n + 1, 3), dtype=torch.float32, device=dev) for key in _DEFERRED_VECTORS}
    out.update({key: torch.zeros(n + 1, dtype=torch.bool, device=dev) for key in _DEFERRED_FLAGS})
    out["seeds"] = torch.zeros(n + 1, dtype=seeds.dtype, device=dev)
    kernels = cuda_build.on_card(dev)
    for k in range(0, slots, c):
        idx = lane_of_slot[k:k + c]
        if kernels:
            bounce_ops.shade_lanes(scene, cfg, hit, origins, directions, seeds, depth, idx, out)
            continue
        src = torch.clamp_max(idx, n - 1)
        hit_c = Hit(t=hit.t[src], prim=hit.prim[src], bary=hit.bary[src], hit=idx < n)
        sh = _shade(scene, cfg, hit_c, origins[src], directions[src], seeds[src], depth[src])
        for key, v in out.items():
            v.index_copy_(0, idx, sh[key])
    return {key: v[:n] for key, v in out.items()}


# ---------------------------------------------------------------------------
# One bounce for every lane
# ---------------------------------------------------------------------------

def _light_sample(scene, cfg, sh, seeds):
    """The NEE light draw for every lane: two uniform2 pairs into the
    alias table and, under cfg.nee_defensive_mix, a third pair (its
    second value discarded) choosing between the alias draw and a cosine
    draw around the normal, with the mixture density as the pdf.  Returns
    (seeds, direction, pdf, u, v): (u, v) are the draw's exact equirect
    coordinates for eval_env(uv=...)."""
    env = scene.env
    if env.alias_table is None:
        raise ValueError(
            "env_importance_sampling requires an alias table: build the "
            "environment with envmap.with_importance_sampling(env)"
        )
    seeds, u1, u2 = rng.uniform2(seeds)
    seeds, u3, u4 = rng.uniform2(seeds)
    env_dir, pdf, env_u, env_v = sample_env_alias(env.alias_table, env.height, env.width, u1, u2, u3, u4)
    if cfg.nee_defensive_mix:
        # u3/u4 also make the cosine draw; u5 picks which one a lane takes.
        seeds, u5, _ = rng.uniform2(seeds)
        tang_n, binorm_n = vm.onb_from_normal(sh["normal"])
        dir_cos = vm.onb_transform(rng.cosine_sample_hemisphere(u3, u4), tang_n, sh["normal"], binorm_n)
        take_alias = u5 < 0.5
        env_dir = torch.where(take_alias[:, None], env_dir, dir_cos)
        u_cos, v_cos = direction_to_uv(dir_cos)
        env_u = torch.where(take_alias, env_u, u_cos)
        env_v = torch.where(take_alias, env_v, v_cos)
        p_alias = torch.where(take_alias, pdf, env_pdf_alias(env.alias_table, env.height, env.width, dir_cos))
        cos_sel = torch.clamp_min(vm.dot(sh["normal"], env_dir), 0.0)
        pdf = 0.5 * p_alias + 0.5 * cos_sel / math.pi
    return seeds, env_dir, pdf, env_u, env_v


def _shadow_candidates(hit_m, sh, env_dir):
    """(cand, cos_l): the lanes whose light draw is traced, surface hits
    that go on (not depth-truncated, glass, emissive or degenerate) with
    the draw above their shading normal, and that cosine."""
    cos_l = torch.clamp_min(vm.dot(sh["normal"], env_dir), 0.0)
    cand = hit_m & ~sh["done"] & ~sh["glass"] & ~sh["emissive"] & ~sh["degenerate"] & (cos_l > 0.0)
    return cand, cos_l


def _next_event(scene, cfg, hit_m, sh, seeds, direction, attenuation):
    """The NEE contribution of every lane.  Returns (seeds, contrib [N,3]
    to add where the light is visible, visible [N] bool, spec_next: the
    next segment's env-credit flag, or its MIS weight under
    cfg.nee_mis_spec)."""
    seeds, env_dir, env_pdf_v, env_u, env_v = _light_sample(scene, cfg, sh, seeds)
    cand, cos_l = _shadow_candidates(hit_m, sh, env_dir)
    occluded = occluded_scene(scene, sh["new_origin"], env_dir, cfg.t_min, cfg.t_max, cfg, active=cand)
    contrib, visible, spec_next = _nee_weights(scene, cfg, sh, cand, occluded, env_dir, env_pdf_v, env_u, env_v,
                                               cos_l, direction, attenuation)
    return seeds, contrib, visible, spec_next


def _nee_weights(scene, cfg, sh, cand, occluded, env_dir, env_pdf_v, env_u, env_v, cos_l, direction, attenuation):
    """`_next_event` after the any-hit traversal (the plain version of the
    NEE kernel): (contrib, visible, spec_next)."""
    env = scene.env
    visible = cand & ~occluded
    l_env = eval_env(env, env_dir, cfg, active=cand, uv=(env_u, env_v))
    # Lobe-partitioned estimator: the base estimator's cosine-lobe share
    # (1 - P_s) of M*IdotN*E_cos[L*vis] is estimated by the light draw,
    # and misses are then credited only to spec-sampled segments.
    weight = (1.0 - sh["spec_prob"]) * sh["idotn"] * cos_l / (math.pi * torch.clamp_min(env_pdf_v, 1e-12))
    contrib = attenuation * sh["brdf_combined"] * weight[:, None] * l_env
    if cfg.nee_mis_spec:
        # The spec lobe's light-sampled arm on the same draw and shadow ray,
        # with the balance weight w_l = p_light / (p_light + p_ggx).
        normal, alpha, prob = sh["normal"], sh["alpha"], sh["spec_prob"]
        view = -direction
        h_l = vm.normalize(view + env_dir)
        d_term_l = bsdf.d_ggx(normal, h_l, alpha)
        g_term_l = bsdf.g_smith(alpha, normal, view, env_dir)
        ndotv_l = vm.dot(normal, view)
        denom_l = 4.0 * torch.abs(ndotv_l) * torch.abs(vm.dot(normal, env_dir))
        brdf_spec_l = sh["f_vec"] * (d_term_l * g_term_l / torch.clamp_min(denom_l, 1e-10))[:, None]
        ndoth_l = torch.clamp_min(vm.dot(normal, h_l), 1e-10)
        vdoth_l = torch.clamp_min(vm.dot(view, h_l), 1e-10)
        p_ggx_l = bsdf.ggx_pdf(d_term_l, ndoth_l, vdoth_l)
        w_l = env_pdf_v / torch.clamp_min(env_pdf_v + p_ggx_l, 1e-20)
        g_spec = prob[:, None] * (
            prob[:, None] * brdf_spec_l
            + ((1.0 - prob) * math.pi * p_ggx_l)[:, None] * sh["diffuse_albedo"]
        ) * cos_l[:, None]
        contrib = contrib + attenuation * g_spec * (w_l / torch.clamp_min(env_pdf_v, 1e-12))[:, None] * l_env
        # The BSDF arm's weight for the next segment's env credit: both
        # densities at the spec continuation, with this bounce's normal.
        p_light_s = env_pdf_alias(env.alias_table, env.height, env.width, sh["spec_dir"])
        if cfg.nee_defensive_mix:
            cos_s = torch.clamp_min(vm.dot(normal, sh["spec_dir"]), 0.0)
            p_light_s = 0.5 * p_light_s + 0.5 * cos_s / math.pi
        w_b = sh["spec_pdf"] / torch.clamp_min(sh["spec_pdf"] + p_light_s, 1e-20)
        spec_next = torch.where(sh["glass"], 1.0, torch.where(sh["choose_spec"], w_b, 0.0))
    else:
        spec_next = sh["choose_spec"] | sh["glass"]
    return contrib, visible, spec_next


def _trace_bounce(scene, cfg, origin, direction, attenuation, radiance, seeds, depth, spec_last=None):
    """One path segment for every lane: intersect, then closest-hit shade
    or miss, and under cfg.env_importance_sampling the NEE shadow ray.
    `spec_last` (NEE only) is the env-credit flag, or MIS weight, that the
    previous bounce set.  Returns the post-trace payload before Russian
    roulette.  After the traversal, the kernels run on the card
    (`_bounce_kernels`; deferred shading keeps this eager bounce, its
    chunks shaded by the bounce kernel's second entry point), the plain
    version elsewhere (`_bounce_plain`)."""
    hit = intersect_scene(scene, origin, direction, cfg.t_min, cfg.t_max, cfg)
    if _bounce_on_card(cfg, origin.device):
        return _bounce_kernels(scene, cfg, hit, origin, direction, attenuation, radiance, seeds, depth, spec_last)
    return _bounce_plain(scene, cfg, hit, origin, direction, attenuation, radiance, seeds, depth, spec_last)


def _bounce_on_card(cfg, device) -> bool:
    """Whether `_trace_bounce` runs `_bounce_kernels`: then its last
    launch is the bounce kernel, or under NEE the NEE kernel, and the path
    step may run as that launch's programmatic dependent."""
    return cuda_build.on_card(device) and not _deferred(cfg)


def _bounce_kernels(scene, cfg, hit, origin, direction, attenuation, radiance, seeds, depth, spec_last):
    """`_bounce_plain` on the card: the bounce kernel, and under NEE the
    any-hit traversal of its shadow rays and the NEE kernel, launched as a
    programmatic dependent of the traversal (occluded_scene's last launch,
    the cluster accel's any-hit kernel or, on a scene without an accel,
    the brute-force one, which writes only the flags)."""
    b = bounce_ops.bounce(scene, cfg, hit, origin, direction, attenuation, radiance, seeds, depth, spec_last)
    spec_next = spec_last
    if cfg.env_importance_sampling:
        occluded = occluded_scene(scene, b["shadow_origin"], b["shadow_dir"], cfg.t_min, cfg.t_max, cfg,
                                  active=b["cand"])
        spec_next = bounce_ops.next_event(scene, cfg, b, occluded, direction, attenuation, dependent=True)
    return dict(radiance=b["radiance"], attenuation=b["attenuation"], origin=b["origin"], direction=b["direction"],
                done=b["done"], seeds=b["seeds"], spec_last=spec_next, hit=hit.hit)


def _bounce_plain(scene, cfg, hit, origin, direction, attenuation, radiance, seeds, depth, spec_last):
    """`_trace_bounce` after the traversal, op by op: the plain version of
    the bounce and NEE kernels."""
    nee = cfg.env_importance_sampling
    # Miss program: radiance += attenuation * env; the path ends.  Under NEE
    # only spec-sampled and primary segments take the env's light.
    env_light = attenuation * eval_env(scene.env, direction, cfg, active=~hit.hit)
    if nee and cfg.nee_mis_spec:
        radiance_miss = radiance + env_light * spec_last[:, None]
    elif nee:
        radiance_miss = radiance + torch.where(spec_last[:, None], env_light, 0.0)
    else:
        radiance_miss = radiance + env_light

    # NEE reads _shade fields that the deferred shade does not return, so
    # it keeps the dense shade.  (The JAX package also keeps it at 2^24
    # triangles and more, where its float32 prim ids lose exactness; the
    # port carries prim ids as integers.)
    if _deferred(cfg):
        sh = _shade_deferred(scene, cfg, hit, origin, direction, seeds, depth)
    else:
        sh = _shade(scene, cfg, hit, origin, direction, seeds, depth)
    seeds_out = sh["seeds"]
    hit_m = hit.hit
    radiance_hit = torch.where(
        sh["emissive"][:, None], radiance + attenuation * sh["emission"], radiance
    )
    spec_next = spec_last
    if nee:
        seeds_out, contrib, visible, spec_next = _next_event(
            scene, cfg, hit_m, sh, seeds_out, direction, attenuation
        )
        radiance_hit = radiance_hit + torch.where(visible[:, None], contrib, 0.0)
    hm = hit_m[:, None]
    return dict(
        radiance=torch.where(hm, radiance_hit, radiance_miss),
        attenuation=torch.where(
            (hit_m & sh["att_ok"])[:, None], attenuation * sh["att_factor"], attenuation
        ),
        origin=torch.where(hm, sh["new_origin"], origin),
        direction=torch.where(hm, sh["new_direction"], direction),
        done=torch.where(hit_m, sh["done"], True),
        seeds=torch.where(hit_m, seeds_out, seeds),
        spec_last=spec_next,
        hit=hit_m,
    )


# ---------------------------------------------------------------------------
# Camera paths and the loops' static buffers, shared by the schedules
# ---------------------------------------------------------------------------

def _read(x: torch.Tensor) -> int:
    """The schedule loop's one read of the device per iteration: whether
    any lane is live, or how many are.  It is the only stream sync inside
    an iteration: everything else the loop runs is queued without waiting
    for the card (on the card, one graph launch), so the host can run
    ahead of it."""
    graph_loop.stats["reads"] += 1
    with profiler.span("loop.read"):
        return int(x)


def _spawner(cam: dict, cfg: RenderConfig, subframe, sample_offset):
    """spawn(n, **lanes) -> (origins, directions, seeds): fresh camera
    paths (ops/camera.camera_paths) seeded from the global (pixel,
    sample_offset + sample, subframe) counters.  The counters are Python
    ints or 0-d integer tensors (a plan's buffers, which the same bits
    come from)."""
    return functools.partial(camera_ops.camera_paths, cam, cfg, subframe, sample_offset)


def _spec_start(cfg: RenderConfig, n: int, dev):
    """NEE's env-credit flag per lane (an MIS weight under nee_mis_spec):
    a fresh path's primary segment takes the env's light in full."""
    return torch.ones(n, dtype=torch.float32 if cfg.nee_mis_spec else torch.bool, device=dev)


def _deferred(cfg: RenderConfig) -> bool:
    """Whether the bounce shades through `_shade_deferred`, whose count of
    hit lanes is a second read of the device inside the iteration (NEE
    keeps the dense shade): such a loop is not captured."""
    return cfg.deferred_shade and not cfg.env_importance_sampling


def _inputs(cam: dict, subframe, sample_offset) -> dict:
    """A frame's inputs that a schedule's step reads: the camera's four
    vectors and the seed counters."""
    return dict(eye=cam["eye"], U=cam["U"], V=cam["V"], W=cam["W"], subframe=subframe, sample_offset=sample_offset)


def _write(st: dict, values: dict) -> None:
    """Write `values` into the static buffers of `st` in place: a tensor
    is copied, a Python number filled."""
    for k, v in values.items():
        if isinstance(v, torch.Tensor):
            st[k].copy_(v)
        else:
            st[k].fill_(v)


def _plan(scene: Scene, cfg: RenderConfig, key: tuple, fresh: dict, make_step, lanes: int) -> graph_loop.Plan:
    """The plan of this scene, config and `key` (the schedule and its
    shapes) over `lanes` lanes, its buffers set to `fresh`: the frame's
    inputs and the loop's state at its start.  make_step(buffers) -> the
    iteration, which reads and writes only the buffers.  A Python number
    in `fresh` gets a 0-d int64 buffer."""
    dev = scene.device

    def build():
        st = {k: torch.empty(v.shape, dtype=v.dtype, device=dev) if isinstance(v, torch.Tensor)
              else torch.empty((), dtype=torch.int64, device=dev) for k, v in fresh.items()}
        return st, make_step(st)

    # The key names the arm of an A/B against the plain versions: a plan
    # never replays the other arm's graph.
    plan = graph_loop.plan((id(scene), cfg, cuda_build.is_plain()) + key, scene, build, capturable=not _deferred(cfg),
                           lanes=lanes)
    _write(plan.state, fresh)
    return plan


def _counters(dev) -> dict:
    """Path and shadow segments traced, as 0-d int64 tensors."""
    return dict(segments=torch.zeros((), dtype=torch.int64, device=dev),
                shadow=torch.zeros((), dtype=torch.int64, device=dev))


def _stats(iters: int, st: dict, plan: graph_loop.Plan) -> dict:
    """A schedule's stats: iterations run, segments and shadow segments
    (copies: the buffers are the next frame's), and whether the loop
    replayed a captured graph."""
    stats = dict(iters=iters, segments=st["segments"].clone(), shadow_segments=st["shadow"].clone(),
                 graphed=plan.graphed)
    profiler.add_totals(stats["segments"], stats["shadow_segments"])
    return stats


# ---------------------------------------------------------------------------
# One lane per ray: render_rays (1 spp)
# ---------------------------------------------------------------------------

def render_rays(scene: Scene, cfg: RenderConfig, origins, directions, seeds, return_stats: bool = False):
    """Trace a batch of primary rays to completion; returns radiance [N,3].

    Every lane traces one path; the loop ends when every path has ended,
    or after max_depth + 2 bounces.  return_stats=True also returns
    {"iters", "segments", "shadow_segments", "graphed"}: bounces run, path
    segments traced, under NEE shadow rays (every live lane that hit), and
    whether the bounces replayed a captured graph."""
    n, dev = origins.shape[0], origins.device
    terminated = torch.zeros(n, dtype=torch.bool, device=dev)
    fresh = dict(
        origin=origins, direction=directions, seeds=seeds,
        attenuation=torch.ones_like(origins), radiance=torch.zeros_like(origins),
        depth=torch.full((n,), cfg.max_depth, dtype=torch.int32, device=dev),
        terminated=terminated, done=terminated.all(), result=torch.zeros_like(origins),
        spec_last=_spec_start(cfg, n, dev), **_counters(dev),
    )
    plan = _plan(scene, cfg, ("rays", n), fresh, functools.partial(_rays_step, scene, cfg), n)
    st = plan.state
    max_traces = cfg.max_depth + 2  # depth <= 0 forces done; +1 safety

    bounce = 0
    profiler.end("frame.setup")
    with profiler.span("loop.run"):
        while bounce < max_traces and not _read(st["done"]):
            plan.step()
            bounce += 1

    # Lanes that never ended (the bounce cap) give their radiance so far.
    out = torch.where(st["terminated"][:, None], st["result"], st["radiance"])
    return (out, _stats(bounce, st, plan)) if return_stats else out


def _rays_step(scene: Scene, cfg: RenderConfig, st: dict):
    """render_rays' bounce on its buffers `st`: the trace, then the path
    step (ops/fused_schedule: one kernel launch on the card, a
    programmatic dependent of the bounce or NEE kernel, the trace's last
    launch, where the kernels shade)."""
    kw = dict(schedule="rays", spp=1, max_depth=cfg.max_depth, rr_reference=cfg.rr_mode == "reference",
              nee=cfg.env_importance_sampling, dependent=_bounce_on_card(cfg, st["seeds"].device))

    def step():
        tb = _trace_bounce(scene, cfg, st["origin"], st["direction"], st["attenuation"], st["radiance"],
                           st["seeds"], st["depth"], st["spec_last"])
        path_step(tb, st, **kw)

    return step


def count_segments(scene: Scene, cam: dict, cfg: RenderConfig, subframe):
    """Ray segments traced by one launch, NEE shadow rays included
    (Mrays/s accounting), counted by the schedule that renders it."""
    _, stats = render_frame_stats(scene, cam, cfg, subframe)
    return stats["segments"] + stats["shadow_segments"]


# ---------------------------------------------------------------------------
# One lane per pixel: render_pixels_regen
# ---------------------------------------------------------------------------

def render_pixels_regen(scene: Scene, cam: dict, cfg: RenderConfig, pixel_ids, subframe, sample_offset: int, spp: int, return_stats: bool = False):
    """One lane per pixel; each lane traces its pixel's `spp` samples one
    after another, respawning a camera ray the moment a path ends.  Seeds
    are the global (pixel, sample, subframe) counters, so each sample's
    radiance is that of the other schedules.  Returns the pixel means
    [Np,3] (the sums divided by spp, as the JAX function divides), and
    with return_stats the stats of render_rays."""
    n, dev = pixel_ids.shape[0], pixel_ids.device
    origin, direction, seeds = camera_ops.camera_paths(cam, cfg, subframe, sample_offset, n, pix=pixel_ids)
    exhausted = torch.zeros(n, dtype=torch.bool, device=dev)
    fresh = dict(
        _inputs(cam, subframe, sample_offset), ids=pixel_ids,
        origin=origin, direction=direction, seeds=seeds,
        attenuation=torch.ones_like(origin), radiance=torch.zeros_like(origin),
        depth=torch.full((n,), cfg.max_depth, dtype=torch.int32, device=dev),
        sample_i=torch.zeros(n, dtype=torch.int32, device=dev), accum=torch.zeros_like(origin),
        exhausted=exhausted, regen=exhausted, done=exhausted.all(), spec_last=_spec_start(cfg, n, dev),
        **_counters(dev),
    )
    plan = _plan(scene, cfg, ("regen", n, spp), fresh, functools.partial(_regen_step, scene, cfg, spp), n)
    st = plan.state
    max_iters = spp * (cfg.max_depth + 2) + 4

    it = 0
    profiler.end("frame.setup")
    with profiler.span("loop.run"):
        while it < max_iters and not _read(st["done"]):
            plan.step()
            it += 1

    # A float32 tensor on the card: a Python scalar divisor would be
    # multiplied by its reciprocal there, a different rounding.
    out = st["accum"] / torch.full((), float(spp), dtype=torch.float32, device=dev)
    return (out, _stats(it, st, plan)) if return_stats else out


def _regen_step(scene: Scene, cfg: RenderConfig, spp: int, st: dict):
    """render_pixels_regen's iteration on its buffers `st`: the trace, the
    path step (ops/fused_schedule: one kernel launch on the card, a
    programmatic dependent of the trace's last launch as in `_rays_step`,
    its regen mask the loop's buffer st["regen"]), then the next sample's
    camera path on the lanes that just finished one."""
    spawn = _spawner(st, cfg, st["subframe"], st["sample_offset"])
    kw = dict(schedule="regen", spp=spp, max_depth=cfg.max_depth, rr_reference=cfg.rr_mode == "reference",
              nee=cfg.env_importance_sampling, dependent=_bounce_on_card(cfg, st["seeds"].device))

    def step():
        tb = _trace_bounce(scene, cfg, st["origin"], st["direction"], st["attenuation"], st["radiance"],
                           st["seeds"], st["depth"], st["spec_last"])
        regen = path_step(tb, st, **kw)
        # a programmatic dependent of the path step, which writes only the
        # lanes' samples and regen mask of what the camera kernel reads
        spawn(regen.shape[0], pix=st["ids"], sample=st["sample_i"], sample_max=spp - 1, mask=regen,
              out=(st["origin"], st["direction"], st["seeds"]), dependent=True)

    return step


# ---------------------------------------------------------------------------
# Streaming work-queue schedule
# ---------------------------------------------------------------------------

def resolve_stream_lanes(cfg: RenderConfig, n_pix: int) -> int:
    """cfg.stream_lanes, with 0 = auto: the nearest power of two to
    n_pix/16, clamped to [16384, 131072]."""
    if cfg.stream_lanes:
        return cfg.stream_lanes
    target = max(1, n_pix // 16)
    lanes = 1 << max(0, target.bit_length() - 1)
    if target - lanes > 2 * lanes - target:
        lanes *= 2
    return min(131072, max(16384, lanes))


def _stream_state(cfg: RenderConfig, spawn, slot_to_pixel, lanes: int, dev) -> dict:
    """The lane pool at the start of a launch: lane k holds slot k, the
    first sample of its pixel."""
    slot = torch.arange(lanes, dtype=torch.int32, device=dev)  # n_pix and above = retired
    pix = slot_to_pixel(slot).clone()  # its own tensor: the kernel updates both in place
    origin, direction, seeds = spawn(lanes, pix=pix)
    return dict(
        slot=slot, pix=pix, origin=origin, direction=direction, seeds=seeds,
        attenuation=torch.ones_like(origin), radiance=torch.zeros_like(origin),
        depth=torch.full((lanes,), cfg.max_depth, dtype=torch.int32, device=dev),
        sample_i=torch.zeros(lanes, dtype=torch.int32, device=dev),
        lane_accum=torch.zeros_like(origin),
        spec_last=_spec_start(cfg, lanes, dev),
    )


def _respawn(st: dict, regen, spawn, spp: int, dependent: bool = False):
    """The stream's camera respawn after a schedule step: on the lanes of
    the regen mask, a fresh camera path for the next sample of the same
    or a freshly pulled pixel, written into st's tensors in place.
    `dependent` as ops/camera.camera_paths_cuda takes it: the step's kernel
    launched just before."""
    spawn(regen.shape[0], pix=st["pix"], sample=st["sample_i"], sample_max=spp - 1, mask=regen,
          out=(st["origin"], st["direction"], st["seeds"]), dependent=dependent)


def _pixel_map(pixel_ids) -> dict:
    """The work queue's slot -> pixel map for `pixel_ids` as
    render_pixels_stream takes them, as ops.fused_schedule.slot_pixels
    takes it: an affine range (base, count) by arithmetic (no gather from
    an id table), an id tensor by a gather, and the identity for the whole
    frame (None)."""
    if pixel_ids is None:
        return {}
    if isinstance(pixel_ids, tuple):
        return dict(base=pixel_ids[0])
    return dict(ids=pixel_ids)


def render_pixels_stream(scene: Scene, cam: dict, cfg: RenderConfig, pixel_ids, subframe, sample_offset: int, spp: int, lanes: int, return_stats: bool = False, fused: bool = False):
    """A fixed pool of `lanes` persistent lanes consumes the pixel list
    (`pixel_ids` [Np] int32, an affine range (base, count) as
    `render_pixels` takes it, or None for the whole frame in order).

    A lane traces its pixel's samples one after another; when a pixel's
    last sample ends, the lane adds the pixel's mean into the image and
    takes the next pixel off a queue whose head advances by a prefix sum
    over the lanes that finished, in lane order.  Seeds are the global
    (pixel, sample, subframe) counters, so the image does not depend on
    the pool size.  Returns the pixel means [Np,3], in list order.

    After each trace one schedule step runs (ops/fused_schedule): on the
    card `fused_stream_step`, one kernel launch (TPU kernel 7, widened to
    every pixel map and to NEE), whether or not the render is fused
    (fused=True, on `_fused_stream_ok`'s envelope, only keeps the kernel
    under `ops.cuda_build.plain()`); on the CPU its plain version, eager ops.
    Both give the same bits.  Camera paths are then respawned on the
    step's regen mask through ops/camera.camera_paths, outside kernel 7 as
    in the JAX package.  The step returns the count of live lanes, the
    loop's one host read per iteration.

    return_stats=True also returns the stats of render_rays, shadow rays
    counted as the JAX schedule counts them (every live lane that hit,
    whether or not its light draw was traced)."""
    kind = "frame" if pixel_ids is None else "range" if isinstance(pixel_ids, tuple) else "ids"
    n_pix = _pixel_count(cfg, pixel_ids)
    lanes = min(lanes, n_pix)
    dev = scene.device
    fresh = _inputs(cam, subframe, sample_offset)
    if kind == "range":
        fresh["base"] = pixel_ids[0]
    elif kind == "ids":
        fresh["ids"] = pixel_ids
    fresh.update(_stream_state(cfg, _spawner(cam, cfg, subframe, sample_offset),
                               functools.partial(slot_pixels, n_pix=n_pix, **_pixel_map(pixel_ids)), lanes, dev))
    fresh.update(out=torch.zeros((n_pix + 1, 3), dtype=torch.float32, device=dev),  # +1 = sink
                 head=torch.full((), lanes, dtype=torch.int64, device=dev),
                 n_live=torch.full((), lanes, dtype=torch.int64, device=dev), **_counters(dev))
    plan = _plan(scene, cfg, ("stream_fused" if fused else "stream", kind, n_pix, spp, lanes), fresh,
                 functools.partial(_stream_step, scene, cfg, kind, n_pix, spp, fused), lanes)
    st = plan.state
    max_iters = (n_pix * spp * (cfg.max_depth + 2)) // lanes + cfg.max_depth + 16

    it, n_live = 0, lanes
    profiler.end("frame.setup")
    with profiler.span("loop.run"):
        while it < max_iters and n_live:
            plan.step()
            n_live = _read(st["n_live"])
            it += 1

    img = st["out"][:n_pix].clone()
    return (img, _stats(it, st, plan)) if return_stats else img


def _stream_step(scene: Scene, cfg: RenderConfig, kind: str, n_pix: int, spp: int, fused: bool, st: dict):
    """render_pixels_stream's iteration on its buffers `st`: trace, the
    schedule step (the kernel updates the lane state in place, the plain
    version returns new tensors, copied in), respawn.  The step is kernel
    7 on the card, fused or not, and the fused stream's under
    `ops.cuda_build.plain()` too (its plain version is the unfused stream's
    step); elsewhere the plain version."""
    nee = cfg.env_importance_sampling
    spawn = _spawner(st, cfg, st["subframe"], st["sample_offset"])
    pixels = _pixel_map(None if kind == "frame" else (st["base"], n_pix) if kind == "range" else st["ids"])
    schedule_step = fused_stream_step if fused or cuda_build.on_card(scene.device) else fused_stream_step_plain
    kw = dict(spp=spp, n_pix=n_pix, max_depth=cfg.max_depth, rr_reference=cfg.rr_mode == "reference",
              inv_spp=1.0 / spp, **pixels)
    keys = STATE_KEYS + (("spec_last",) if nee else ())

    def step():
        tb = _trace_bounce(scene, cfg, st["origin"], st["direction"], st["attenuation"], st["radiance"],
                           st["seeds"], st["depth"], st["spec_last"])
        lane = {k: st[k] for k in keys}
        new = {}
        regen, new["head"], new["segments"], new["n_live"], *shadow = schedule_step(
            tb, lane, st["out"], st["head"], st["segments"], st["shadow"] if nee else None, **kw)
        if nee:
            new["shadow"] = shadow[0]
        # The lane state first (the plain step's new tensors; the kernel
        # updates it in place, so on the card nothing), then the respawn,
        # which reads none of the counters: on the card the camera kernel
        # runs right after kernel 7, as its programmatic dependent.
        _write(st, {k: v for k, v in lane.items() if v is not st[k]})
        _respawn(st, regen, spawn, spp, dependent=schedule_step is fused_stream_step)
        _write(st, new)

    return step


def _fused_stream_ok(cfg: RenderConfig, pixel_ids, lanes: int, device) -> bool:
    """Whether this render is the fused stream ("stream_fused").  Its
    envelope is the JAX package's: the identity pixel mapping (a whole
    frame, untiled), no NEE, and a lane pool of whole 128-lane rows that
    the JAX kernel's chunks of 128 rows divide.  Camera regeneration, DOF
    included, runs outside the kernel.

    "auto" takes it on a CUDA device, at every pool size (PERF.md, the
    auto rule: ~70 fewer device kernels an iteration than the unfused
    stream's eager step).  Since the unfused stream launches the
    same kernel on the card (kernel 7 takes every pixel map and NEE), the
    two differ only under `ops.cuda_build.plain()`, where the fused stream
    keeps the kernel.  On the CPU the step would only run its plain
    version."""
    if cfg.fused_schedule == "off":
        return False
    if pixel_ids is not None or cfg.env_importance_sampling:
        return False
    if lanes % 128:
        return False
    rows = lanes // 128
    if rows % min(128, rows):
        return False
    if cfg.fused_schedule == "on":
        return True
    return torch.device(device).type == "cuda"


def render_pixels_stream_fused(scene: Scene, cam: dict, cfg: RenderConfig, subframe, sample_offset: int, spp: int, lanes: int, return_stats: bool = False):
    """render_pixels_stream over the whole frame with its schedule step in
    one kernel launch per iteration (`fused_stream_step`, TPU kernel 7),
    on the envelope of `_fused_stream_ok`; the image equals the unfused
    schedule's bit for bit."""
    return render_pixels_stream(scene, cam, cfg, None, subframe, sample_offset, spp, lanes,
                                return_stats=return_stats, fused=True)


# ---------------------------------------------------------------------------
# Frame rendering
# ---------------------------------------------------------------------------

def _pixel_count(cfg: RenderConfig, pixel_ids) -> int:
    """Pixels of `pixel_ids`: None (the whole frame), an affine range
    (base, count) or an id tensor."""
    if pixel_ids is None:
        return cfg.width * cfg.height
    if isinstance(pixel_ids, tuple):
        return pixel_ids[1]
    return pixel_ids.shape[0]


def schedule(cfg: RenderConfig, pixel_ids, n_pix: int, spp: int, device) -> str:
    """The schedule render_pixels runs for `n_pix` pixels (`pixel_ids`: an
    id tensor, an affine range (base, count), or None for the whole
    frame): "stream_fused", "stream" (the pixels outnumber the lane pool),
    "regen" (they do not) or "rays" (1 spp, or no regeneration)."""
    if not (cfg.regenerate and spp > 1):
        return "rays"
    lanes = resolve_stream_lanes(cfg, n_pix)
    if n_pix <= lanes:
        return "regen"
    return "stream_fused" if _fused_stream_ok(cfg, pixel_ids, lanes, device) else "stream"


def render_pixels(scene: Scene, cam: dict, cfg: RenderConfig, pixel_ids=None, subframe=0, sample_offset: int = 0, spp: int | None = None, return_stats: bool = False):
    """Render one launch of `spp` samples for each pixel of `pixel_ids`
    ([Np] int32 flat ids, None = the whole frame, or an affine range
    (base, count): the pixels base + arange(count)); returns the
    sample-averaged radiance [Np,3] (and the schedule's stats, with the
    schedule's name under "schedule").

    Sharded renders pass the affine range, so that the stream's slot to
    pixel map stays arithmetic.  `base` is a Python int or a 0-d integer
    tensor on the scene's device; it is never read back to the host.
    Like an id tensor, a range takes the unfused stream.

    The schedule is `schedule`'s: with regeneration and spp > 1, the
    stream (fused where `_fused_stream_ok` allows) when the pixels
    outnumber the lane pool, else one lane per pixel; otherwise one lane
    per sample (render_rays)."""
    with profiler.span("frame.setup"):  # ended by the schedule where its loop starts
        img, stats = _render_pixels(scene, cam, cfg, pixel_ids, subframe, sample_offset, spp)
    return (img, stats) if return_stats else img


def _render_pixels(scene: Scene, cam: dict, cfg: RenderConfig, pixel_ids, subframe, sample_offset: int, spp):
    if spp is None:
        spp = cfg.samples_per_launch
    dev = scene.device
    n_pix = _pixel_count(cfg, pixel_ids)
    which = schedule(cfg, pixel_ids, n_pix, spp, dev)
    if which.startswith("stream"):
        img, stats = render_pixels_stream(scene, cam, cfg, pixel_ids, subframe, sample_offset, spp,
                                          resolve_stream_lanes(cfg, n_pix), return_stats=True,
                                          fused=which == "stream_fused")
    else:
        ids = torch.arange(n_pix, dtype=torch.int32, device=dev)
        # The camera spawn's slot -> pixel map: an id table, an affine
        # range's base, or the identity.
        lanes = {} if pixel_ids is None else dict(base=pixel_ids[0]) if isinstance(pixel_ids, tuple) else dict(
            pix=pixel_ids)
        if isinstance(pixel_ids, tuple):
            pixel_ids = pixel_ids[0] + ids
        elif pixel_ids is None:
            pixel_ids = ids
        if which == "regen":
            img, stats = render_pixels_regen(scene, cam, cfg, pixel_ids, subframe, sample_offset, spp,
                                             return_stats=True)
        else:
            origins, directions, seeds = camera_ops.camera_paths(cam, cfg, subframe, sample_offset, n_pix * spp,
                                                                 per=spp, **lanes)
            radiance, stats = render_rays(scene, cfg, origins, directions, seeds, return_stats=True)
            img = radiance.reshape(n_pix, spp, 3).mean(dim=1)
    stats["schedule"] = which
    return img, stats


def render_frame_stats(scene: Scene, cam: dict, cfg: RenderConfig, subframe):
    """One full launch with the schedule's own accounting: returns
    (radiance image [H,W,3], row 0 the bottom; {"iters", "segments",
    "shadow_segments"}, summed over the tiles of cfg.tile_pixels,
    "schedule", the one render_pixels took for the frame or each tile, and
    "graphed", whether its loop replayed a captured graph)."""
    profiler.follow()
    with profiler.span("frame.render"):
        return _render_frame_stats(scene, cam, cfg, subframe)


def _render_frame_stats(scene: Scene, cam: dict, cfg: RenderConfig, subframe):
    n_pix = cfg.width * cfg.height
    tile = cfg.tile_pixels
    if not tile or tile >= n_pix:
        img, stats = render_pixels(scene, cam, cfg, None, subframe, return_stats=True)
        return img.reshape(cfg.height, cfg.width, 3), stats
    if n_pix % tile:
        raise ValueError("tile_pixels must divide width*height")
    parts, stats = [], dict(iters=0, segments=0, shadow_segments=0)
    for start in range(0, n_pix, tile):
        ids = torch.arange(start, start + tile, dtype=torch.int32, device=scene.device)
        img, tile_stats = render_pixels(scene, cam, cfg, ids, subframe, return_stats=True)
        parts.append(img)
        stats = {k: v + tile_stats[k] for k, v in stats.items()}
    # The tiles are of one size.
    stats.update(schedule=tile_stats["schedule"], graphed=tile_stats["graphed"])
    return torch.cat(parts).reshape(cfg.height, cfg.width, 3), stats


def render_frame(scene: Scene, cam: dict, cfg: RenderConfig, subframe) -> torch.Tensor:
    """One full launch: radiance image [H,W,3] (row 0 is the bottom)."""
    return render_frame_stats(scene, cam, cfg, subframe)[0]
