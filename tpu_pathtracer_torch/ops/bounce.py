"""The bounce's shading as two CUDA kernels: the bounce kernel
(`csrc/bounce.cu`: the miss program, `_shade`, the payload combine and,
under NEE, the light draw and the shadow candidates; a second entry point
shades the lanes of deferred shading's chunks) and the NEE kernel
(`csrc/nee.cu`: `_next_event`'s weights after the any-hit traversal).

Neither replaces a TPU kernel: they are the port's counterpart of the
fusions XLA makes of the JAX package's `_trace_bounce` under `jax.jit`.
Their plain versions are the port's eager code in
`render/integrator.py` (`_bounce_plain`, `_shade`, `_next_event`), which
the CPU runs.  On a CUDA device the integrator launches these kernels
(`ops.cuda_build.on_card`), except under `ops.cuda_build.plain()`, the
A/B switch that runs the plain versions on the card.  A failed build or launch raises; nothing falls back.

Each wrapper counts its launches in `.launches` (the graphed loop's
replay accounting reads them: `render/graph_loop.COUNTED`).  The float32
constants of the plain code reach the kernels from `shade_consts`: each
is the float32 rounding of the double the plain code folds, or, for a
tensor divided by a Python scalar, the float32 reciprocal of the float32
scalar, which is what the card computes.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from tpu_pathtracer_torch.ops.cuda_build import check_lanes, kernel_arg, library
from tpu_pathtracer_torch.utils import math as vm

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# Scalar fields of ShadeConsts (csrc/shade_math.cuh), in order, then its
# three-vectors.
CONST_SCALARS = (
    "eps2", "deg_len", "emis_len", "onb_y", "tiny", "d_min", "pdf_min", "elev_min", "sun_cos", "pi", "two_pi",
    "inv_two_pi", "inv_pi", "two_pi2", "inv255", "pow_exp", "inv_dpdf", "nmap_s", "nmap_1ms", "ior", "rough_min",
    "rough_max", "glass_perturb",
)
CONST_VECTORS = ("env_const", "sun_axis", "sun_rgb", "sky_rgb")


class ShadeConsts(ctypes.Structure):
    _fields_ = [(k, _F) for k in CONST_SCALARS] + [(k, _F * 3) for k in CONST_VECTORS]


def shade_consts(cfg) -> dict:
    """The plain code's float32 constants under `cfg`, by ShadeConsts
    field: numpy float32 scalars, and float32 [3] arrays."""
    f = np.float32
    s = cfg.normal_map_strength
    return dict(
        eps2=f(vm.EPS * vm.EPS), deg_len=f(0.01), emis_len=f(0.0001), onb_y=f(0.9999), tiny=f(1e-10),
        d_min=f(1e-12), pdf_min=f(1e-20), elev_min=f(1e-6), sun_cos=f(0.99),
        pi=f(math.pi), two_pi=f(2.0 * math.pi),
        # a tensor / Python scalar on the card: times 1 / float32(scalar), in float32
        inv_two_pi=f(1.0) / f(2.0 * math.pi), inv_pi=f(1.0) / f(math.pi),
        two_pi2=f(2.0 * math.pi * math.pi), inv255=f(1.0 / 255.0), pow_exp=f(5.0),
        inv_dpdf=f(1.0) / f(1.0 / math.pi),
        nmap_s=f(s), nmap_1ms=f(1.0 - s), ior=f(cfg.ior), rough_min=f(cfg.roughness_min),
        rough_max=f(cfg.roughness_max), glass_perturb=f(cfg.glass_roughness_perturb),
        env_const=np.asarray(cfg.env_constant, np.float32), sun_axis=np.asarray((0.0, 2.0, 3.0), np.float32),
        sun_rgb=np.asarray((200.0, 175.0, 125.0), np.float32), sky_rgb=np.asarray((0.4, 0.4, 0.6), np.float32),
    )


def pack_consts(cfg) -> ShadeConsts:
    c = shade_consts(cfg)
    out = ShadeConsts()
    for k in CONST_SCALARS:
        setattr(out, k, float(c[k]))
    for k in CONST_VECTORS:
        setattr(out, k, (_F * 3)(*(float(x) for x in c[k])))
    return out


class BounceParams(ctypes.Structure):
    """csrc/bounce.cu: BounceParams."""

    _fields_ = [(k, _P) for k in (
        "tri_attrs", "mat_attrs", "tex_quads", "bundles", "env_quads", "alias",
        "hit_t", "hit_prim", "hit_bary", "hit", "origin", "direction", "attenuation", "radiance", "seeds", "depth",
        "spec_last",
        "radiance_out", "attenuation_out", "origin_out", "direction_out", "done_out", "seeds_out",
        "shadow_origin", "shadow_dir", "cand", "record",
        "lane_of_slot", "d_origin", "d_direction", "d_att_factor", "d_emission", "d_att_ok", "d_emissive",
        "d_degenerate", "d_done", "d_seeds",
    )] + [(k, _I) for k in (
        "n", "slots", "env_h", "env_w", "env_mode", "env_scrambled",
        "flip_v", "bundled", "morton", "scrambled", "pow2", "quirk", "nee", "mis", "defensive",
    )] + [("c", ShadeConsts)]


class NeeParams(ctypes.Structure):
    """csrc/nee.cu: NeeParams."""

    _fields_ = [(k, _P) for k in (
        "env_quads", "alias", "record", "shadow_dir", "occluded", "direction", "attenuation", "radiance",
        "spec_next",
    )] + [(k, _I) for k in ("n", "env_h", "env_w", "env_mode", "env_scrambled", "mis", "defensive")] + [
        ("c", ShadeConsts)]


# Fields of the NEE record (csrc/shade_math.cuh: nee_record::kRecord), a
# float32 [RECORD, n] tensor stored field by field, so that a field's stores
# and loads coalesce across a warp.
RECORD = 24
ENV_MODES = {"equirect": 0, "sunsky": 1, "constant": 2}

def _scene_args(scene, cfg, dev, nee: bool):
    """The scene's tables (tensors, which the caller keeps alive over the
    launch) and flags, by BounceParams field: (tensors, ints)."""
    m, env = scene.materials, scene.env
    if nee and env.alias_table is None:
        raise ValueError(
            "env_importance_sampling requires an alias table: build the "
            "environment with envmap.with_importance_sampling(env)"
        )
    t = dict(
        tri_attrs=kernel_arg("tri_attrs", scene.tri_attrs, torch.float32, (scene.tri_attrs.shape[0], 32), dev),
        mat_attrs=kernel_arg("materials.attrs", m.attrs, torch.float32, (m.attrs.shape[0], 40), dev),
        tex_quads=kernel_arg("texture_quads", m.texture_quads, torch.int64, (m.texture_quads.shape[0], 4), dev),
        bundles=kernel_arg("texture_bundles", m.texture_bundles, torch.int64, (m.texture_bundles.shape[0], 8), dev),
        env_quads=kernel_arg("env.quads", env.quads, torch.float32, (env.height * env.width, 12), dev),
    )
    if nee:
        t["alias"] = kernel_arg("env.alias_table", env.alias_table, torch.float32, (env.height * env.width, 4), dev)
    for name, align in (("tri_attrs", 16), ("mat_attrs", 16)):
        _aligned(name, t[name], align)
    ints = dict(env_h=env.height, env_w=env.width, env_mode=ENV_MODES[cfg.env_mode],
                env_scrambled=int(env.quads_scrambled), flip_v=int(cfg.flip_v), bundled=int(m.bundled),
                morton=int(m.bundled_morton), scrambled=int(m.bundled_scrambled), pow2=int(m.bundled_pow2_dims),
                quirk=int(cfg.seed_advance_quirk), nee=int(nee), mis=int(nee and cfg.nee_mis_spec),
                defensive=int(nee and cfg.nee_defensive_mix))
    return t, ints


def _aligned(name, x, align):
    """Raise unless `x` starts on an `align`-byte boundary: the kernel reads
    its rows as 8- or 16-byte vectors."""
    if x.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _lane_args(hit, origin, direction, seeds, depth, n, dev) -> dict:
    bary = kernel_arg("hit.bary", hit.bary, torch.float32, (n, 2), dev)
    _aligned("hit.bary", bary, 8)
    return dict(
        hit_t=kernel_arg("hit.t", hit.t, torch.float32, (n,), dev),
        hit_prim=kernel_arg("hit.prim", hit.prim, torch.int32, (n,), dev),
        hit_bary=bary,
        hit=kernel_arg("hit.hit", hit.hit, torch.bool, (n,), dev),
        origin=kernel_arg("origin", origin, torch.float32, (n, 3), dev),
        direction=kernel_arg("direction", direction, torch.float32, (n, 3), dev),
        seeds=kernel_arg("seeds", seeds, torch.int64, (n,), dev),
        depth=kernel_arg("depth", depth, torch.int32, (n,), dev),
    )


def _params(cls, tensors: dict, ints: dict, consts):
    p = cls()
    for k, v in tensors.items():
        setattr(p, k, v.data_ptr() if v is not None else None)
    for k, v in ints.items():
        setattr(p, k, check_lanes(f"{cls.__name__}.{k}", v))
    if consts is not None:
        p.c = consts
    return p


def _launch(source: str, fn: str, params, *args, stream) -> None:
    lib = library(source)
    size = getattr(lib, source.replace(".cu", "_params_size"))()
    if size != ctypes.sizeof(params):
        raise RuntimeError(f"{source}: the kernel's parameters take {size} bytes, the wrapper's {ctypes.sizeof(params)}")
    err = getattr(lib, fn)(ctypes.addressof(params), *args, stream)
    if err:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")


def bounce_args(scene, cfg, hit, origin, direction, attenuation, radiance, seeds, depth, spec_last=None):
    """The bounce kernel's launch on these lanes, not yet made: (its
    BounceParams, its output tensors by `bounce`'s keys, the tensors the
    launch reads, which the caller keeps alive over it)."""
    dev = origin.device
    n = origin.shape[0]
    nee = cfg.env_importance_sampling
    scene_t, ints = _scene_args(scene, cfg, dev, nee)
    lanes = _lane_args(hit, origin, direction, seeds, depth, n, dev)
    lanes.update(attenuation=kernel_arg("attenuation", attenuation, torch.float32, (n, 3), dev),
                 radiance=kernel_arg("radiance", radiance, torch.float32, (n, 3), dev))
    if nee:
        lanes["spec_last"] = kernel_arg("spec_last", spec_last, torch.float32 if cfg.nee_mis_spec else torch.bool,
                                  (n,), dev)
    vec = lambda: torch.empty((n, 3), dtype=torch.float32, device=dev)  # noqa: E731
    out = dict(radiance=vec(), attenuation=vec(), origin=vec(), direction=vec(),
               done=torch.empty(n, dtype=torch.bool, device=dev), seeds=torch.empty(n, dtype=torch.int64, device=dev))
    if nee:
        out.update(shadow_origin=vec(), shadow_dir=vec(), cand=torch.empty(n, dtype=torch.bool, device=dev),
                   record=torch.empty((RECORD, n), dtype=torch.float32, device=dev))
    names = dict(radiance="radiance_out", attenuation="attenuation_out", origin="origin_out",
                 direction="direction_out", done="done_out", seeds="seeds_out")
    tensors = {**scene_t, **lanes, **{names.get(k, k): v for k, v in out.items()}}
    params = _params(BounceParams, tensors, dict(ints, n=n, slots=0), pack_consts(cfg))
    return params, out, tensors


def bounce(scene, cfg, hit, origin, direction, attenuation, radiance, seeds, depth, spec_last=None) -> dict:
    """Launch the bounce kernel on `hit` (the closest hits of the rays
    origin/direction): returns `_trace_bounce`'s payload (radiance,
    attenuation, origin, direction, done, seeds: new tensors; under NEE
    radiance is still without the light's share) and, under
    cfg.env_importance_sampling, the shadow rays (shadow_origin,
    shadow_dir), their candidate mask `cand` and the NEE kernel's `record`."""
    params, out, _ = bounce_args(scene, cfg, hit, origin, direction, attenuation, radiance, seeds, depth, spec_last)
    if origin.shape[0]:
        stream = torch.cuda.current_stream(origin.device).cuda_stream
        _launch("bounce.cu", "bounce_launch", params, 0, stream=stream)
        bounce.launches += 1
    return out


def shade_lanes(scene, cfg, hit, origin, direction, seeds, depth, lane_of_slot, out: dict) -> None:
    """The bounce kernel's second entry point, one launch: for each slot
    j, `_shade` of lane min(lane_of_slot[j], n - 1), written to row
    lane_of_slot[j] of `out` (`_shade_deferred`'s fields, [n+1] rows; row
    n is the sink)."""
    dev = origin.device
    n = origin.shape[0]
    scene_t, ints = _scene_args(scene, cfg, dev, False)
    lanes = _lane_args(hit, origin, direction, seeds, depth, n, dev)
    slots = lane_of_slot.shape[0]
    lanes["lane_of_slot"] = kernel_arg("lane_of_slot", lane_of_slot, torch.int64, (slots,), dev)
    shapes = dict(new_origin=(n + 1, 3), new_direction=(n + 1, 3), att_factor=(n + 1, 3), emission=(n + 1, 3))
    dst = {}
    for key, field in (("new_origin", "d_origin"), ("new_direction", "d_direction"), ("att_factor", "d_att_factor"),
                       ("emission", "d_emission")):
        dst[field] = kernel_arg(key, out[key], torch.float32, shapes[key], dev, written=True)
    for key in ("att_ok", "emissive", "degenerate", "done"):
        dst[f"d_{key}"] = kernel_arg(key, out[key], torch.bool, (n + 1,), dev, written=True)
    dst["d_seeds"] = kernel_arg("seeds", out["seeds"], torch.int64, (n + 1,), dev, written=True)
    params = _params(BounceParams, {**scene_t, **lanes, **dst}, dict(ints, n=n, slots=slots), pack_consts(cfg))
    if slots:
        _launch("bounce.cu", "bounce_launch", params, 1, stream=torch.cuda.current_stream(dev).cuda_stream)
        bounce.launches += 1


def kernel_attributes(entry: int = 0) -> dict:
    """What the card made of the bounce kernel (entry 0) or the deferred
    shade (entry 1), from cudaFuncGetAttributes: registers and local memory
    (stack and spills, bytes) a thread, static shared memory a block,
    threads a block, and the blocks an SM holds at once.  Builds the
    library if need be; launches nothing."""
    out = (ctypes.c_int * 5)()
    err = library("bounce.cu").bounce_attributes(entry, out)
    if err:
        raise RuntimeError(f"bounce_attributes failed: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm"), out))


def next_event(scene, cfg, b: dict, occluded, direction, attenuation, dependent: bool = False):
    """Launch the NEE kernel after the any-hit traversal of the bounce
    kernel's shadow rays (`b`: bounce()'s dict; `occluded`: the any-hit
    flags, read where b["cand"]): adds the visible light's share into
    b["radiance"] in place and returns spec_next, the next segment's env
    credit ([n] bool, float32 under cfg.nee_mis_spec).

    `dependent`: launch it as a programmatic dependent of the launch just
    before it on the stream (csrc/launch_order.cuh), which may then still
    be running when the kernel starts: the caller vouches that that launch
    is the any-hit traversal that writes `occluded` and writes nothing
    else the kernel reads (the record, shadow_dir, radiance, direction,
    attenuation and the env tables)."""
    if dependent and not all(x.is_contiguous() for x in (b["record"], b["shadow_dir"], direction, attenuation)):
        raise ValueError("a dependent NEE launch reads its inputs before its wait: they must be contiguous, not "
                         "copied here just before it")
    dev = direction.device
    n = direction.shape[0]
    env = scene.env
    spec = torch.empty(n, dtype=torch.float32 if cfg.nee_mis_spec else torch.bool, device=dev)
    tensors = dict(
        env_quads=kernel_arg("env.quads", env.quads, torch.float32, (env.height * env.width, 12), dev),
        alias=kernel_arg("env.alias_table", env.alias_table, torch.float32, (env.height * env.width, 4), dev),
        record=kernel_arg("record", b["record"], torch.float32, (RECORD, n), dev),
        shadow_dir=kernel_arg("shadow_dir", b["shadow_dir"], torch.float32, (n, 3), dev),
        occluded=kernel_arg("occluded", occluded, torch.bool, (n,), dev),
        direction=kernel_arg("direction", direction, torch.float32, (n, 3), dev),
        attenuation=kernel_arg("attenuation", attenuation, torch.float32, (n, 3), dev),
        radiance=kernel_arg("radiance", b["radiance"], torch.float32, (n, 3), dev, written=True),
        spec_next=spec,
    )
    ints = dict(n=n, env_h=env.height, env_w=env.width, env_mode=ENV_MODES[cfg.env_mode],
                env_scrambled=int(env.quads_scrambled), mis=int(cfg.nee_mis_spec),
                defensive=int(cfg.nee_defensive_mix))
    params = _params(NeeParams, tensors, ints, pack_consts(cfg))
    if n:
        _launch("nee.cu", "nee_launch", params, int(dependent), stream=torch.cuda.current_stream(dev).cuda_stream)
        next_event.launches += 1
    return spec


# Kernel launches since each count was last set to 0 (the deferred entry
# point counts as the bounce kernel).
bounce.launches = 0
next_event.launches = 0
