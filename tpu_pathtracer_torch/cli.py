"""Command-line renderer of the PyTorch port.  Counterpart of
`tpu_pathtracer/cli.py`, with the same flags, defaults and override rules,
plus `--device` (default "cuda"; a machine without a card is refused, the
render never falls back to the CPU quietly).  Not ported: `--shard` other
than "none" (multi-device rendering; refused) and the texture mip ladder
(`--texture-lod mip|split`; refused).

Examples:
    python -m tpu_pathtracer_torch.cli --scene-file scenes/suitcase.toml --file out.png
    python -m tpu_pathtracer_torch.cli --file out.png --dim=512x384 --scene monkey.obj --spp 64
    python -m tpu_pathtracer_torch.cli --interactive --scene ...   # web viewer
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_pathtracer_torch",
        description="wavefront path tracer (PyTorch + CUDA)",
    )
    # Flags that a --scene-file's [render] table can also set default to
    # None: "the user passed this" is then `is not None`.  The effective
    # defaults live in CLI_DEFAULTS.
    p.add_argument("--file", "-f", default="", help="output image (png/ppm/exr); empty = out.png")
    p.add_argument("--dim", default=None, help="image dimensions WxH (reference default 1600x1200)")
    p.add_argument("--launch-samples", "-s", type=int, default=None, help="samples per launch (reference: 10)")
    p.add_argument("--spp", type=int, default=0, help="total samples/pixel for offline render (0 = one launch)")
    p.add_argument("--max-depth", type=int, default=None, help="max path depth (reference: 20)")
    p.add_argument("--scene", nargs="*", default=[], help="OBJ files (default: procedural three-spheres scene)")
    p.add_argument("--scene-file", default="", help="TOML scene description (scenes/*.toml); explicit flags override its [render] table")
    p.add_argument("--scale", type=float, default=1.0, help="uniform scene scale (reference hero scene: 0.05)")
    p.add_argument("--env", default="procedural", help="HDR .exr path | procedural | sunsky | constant")
    p.add_argument("--eye", default="0,2,6", help="camera eye (reference default 0,2,6)")
    p.add_argument("--lookat", default="0,0,0", help="camera look-at")
    p.add_argument("--fov", type=float, default=50.0, help="vertical FOV degrees")
    p.add_argument("--dof", action=argparse.BooleanOptionalAction, default=None, help="thin-lens depth of field (reference default on)")
    p.add_argument("--accel", default="auto", choices=["auto", "brute", "cluster"], help="intersection structure for OBJ scenes (auto = cluster)")
    p.add_argument("--materials", default="convention", choices=["convention", "mtl"], help="material source for OBJ scenes")
    p.add_argument("--rr-mode", default=None, choices=["reference", "standard"], help="Russian-roulette estimator (default: reference, or standard when --nee is on)")
    p.add_argument("--texture-lod", default=None, choices=["auto", "off", "mip", "split"], help="texture mip policy: auto and off sample the full pool; mip and split are not ported")
    p.add_argument("--aov-prefix", default="", help="also write <prefix>_normal/_depth/_albedo.png G-buffer passes (render/aov.py)")
    p.add_argument("--denoise", action="store_true", help="edge-avoiding A-Trous denoise of the output/display image, guided by a G-buffer pass (accumulation, checkpoints and EXR stay raw)")
    p.add_argument("--nee", action="store_true", help="environment importance sampling (next-event estimation)")
    p.add_argument("--nee-defensive", action="store_true", help="with --nee: draw the light sample from a 0.5 alias + 0.5 cosine mixture (balance heuristic)")
    p.add_argument("--nee-mis", action="store_true", help="with --nee: one-sample MIS between the spec lobe and the light sample")
    p.add_argument("--tile-pixels", type=int, default=None, help="pixels per launch tile (0 = whole frame)")
    p.add_argument("--checkpoint", default="", help="checkpoint file; saved every --checkpoint-every subframes and at the end")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    p.add_argument("--shard", default="none", choices=["none", "pixels", "samples"], help="multi-device sharding mode (only none is ported)")
    p.add_argument("--profile", default="", help="write a torch.profiler trace of the render to this directory")
    p.add_argument("--interactive", action="store_true", help="serve the interactive web viewer")
    p.add_argument("--port", type=int, default=8000, help="viewer port")
    p.add_argument("--preview-budget-ms", type=float, default=125.0, help="interaction preview frame budget; the viewer picks the finest preview resolution that fits it")
    p.add_argument("--no-converge-ramp", action="store_true", help="skip the post-settle 1/2/4-spp ramp")
    p.add_argument("--seed", type=int, default=0, help="seed for random (untextured) materials")
    p.add_argument("--scene-cache", action=argparse.BooleanOptionalAction, default=True, help="packed-scene cache under ~/.cache/tpu_pathtracer_torch/scenes (warm loads skip decode and packing)")
    p.add_argument("--refresh-scene-cache", action="store_true", help="rebuild the packed-scene cache entry even if fresh")
    p.add_argument("--debug-nans", action="store_true", help="test every launch's frame for NaN/Inf and stop at the first (a host read a launch)")
    p.add_argument("--device", default="cuda", help="torch device to render on (cuda, cuda:N or cpu)")
    p.add_argument("--verbosity", type=int, default=4)
    return p


# Effective defaults of the None-sentinel flags above (one source for the
# plain path and for --scene-file override detection).
CLI_DEFAULTS = dict(
    dim="1600x1200",        # reference default
    launch_samples=10,      # reference: 10
    max_depth=20,           # reference: 20
    texture_lod="auto",
    tile_pixels=0,
    dof=True,               # reference default on
)


def parse_dim(s: str):
    try:
        w, h = s.lower().split("x")
        return int(w), int(h)
    except ValueError:
        raise SystemExit(f"invalid --dim {s!r}; expected WxH like 1600x1200")


def parse_vec3(s: str):
    parts = [float(x) for x in s.split(",")]
    if len(parts) != 3:
        raise SystemExit(f"invalid vec3 {s!r}; expected x,y,z")
    return tuple(parts)


def _check_unported(args) -> None:
    from tpu_pathtracer_torch.config import check_texture_lod

    if args.shard != "none":
        raise SystemExit(f"--shard {args.shard}: multi-device rendering is not yet ported "
                         "(ROADMAP, modules to port: sharding); use --shard none")
    try:
        check_texture_lod(args.texture_lod or CLI_DEFAULTS["texture_lod"])
    except ValueError as e:
        raise SystemExit(f"--texture-lod: {e}")


def build_from_args(args):
    """(scene, camera, cfg) from parsed CLI args, the scene on args.device."""
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.render.camera import Camera
    from tpu_pathtracer_torch.utils import logging as plog
    from tpu_pathtracer_torch.utils.device import resolve

    _check_unported(args)
    device = resolve(args.device)
    plog.set_verbosity(args.verbosity)
    if args.nee_defensive or args.nee_mis:
        args.nee = True  # both are modes of the NEE light sample
    cache_kw = dict(cache_dir="" if not args.scene_cache else None, refresh=args.refresh_scene_cache)

    if args.scene_file:
        from tpu_pathtracer_torch.scene.scenefile import load_scene_file

        # Explicit flags override the file's [render] table; the
        # NEE-implies-standard-RR rule lives in load_scene_file.
        overrides = {}
        if args.dim is not None:
            overrides["width"], overrides["height"] = parse_dim(args.dim)
        for field, val in (
            ("samples_per_launch", args.launch_samples),
            ("max_depth", args.max_depth),
            ("rr_mode", args.rr_mode),
            ("tile_pixels", args.tile_pixels),
            ("dof", args.dof),
        ):
            if val is not None:
                overrides[field] = val
        if args.nee:
            overrides["env_importance_sampling"] = True
        if args.nee_defensive:
            overrides["nee_defensive_mix"] = True
        if args.nee_mis:
            overrides["nee_mis_spec"] = True
        scene, camera, cfg = load_scene_file(args.scene_file, overrides, device=device, **cache_kw)
        plog.info(
            "scene",
            f"scene file {args.scene_file}: {scene.num_triangles} triangles, "
            f"{scene.materials.num_materials} materials",
        )
        return scene, camera.with_aspect(cfg.width, cfg.height), cfg

    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils.image import load_exr, procedural_hdr

    width, height = parse_dim(args.dim or CLI_DEFAULTS["dim"])

    env_mode = "equirect"
    env = None
    if args.env == "procedural":
        env = make_env(procedural_hdr(256, 512), device)
    elif args.env in ("sunsky", "constant"):
        env_mode = args.env
        if args.nee:
            raise SystemExit("--nee requires an equirect environment (procedural or .exr)")
    else:
        env = make_env(load_exr(args.env), device)
        plog.info("scene", f"loaded env map {args.env} {tuple(env.data.shape)}")
    if args.nee and env is not None:
        from tpu_pathtracer_torch.render.envmap import with_importance_sampling

        env = with_importance_sampling(env)

    # NEE requires standard RR; imply it unless the user picked an RR mode
    # (then validation raises its clear error).
    rr_mode = args.rr_mode
    if rr_mode is None:
        rr_mode = "standard" if args.nee else "reference"

    def dflt(v, key):
        return CLI_DEFAULTS[key] if v is None else v

    cfg = RenderConfig(
        width=width,
        height=height,
        samples_per_launch=dflt(args.launch_samples, "launch_samples"),
        max_depth=dflt(args.max_depth, "max_depth"),
        dof=dflt(args.dof, "dof"),
        env_mode=env_mode,
        rr_mode=rr_mode,
        env_importance_sampling=args.nee,
        nee_defensive_mix=args.nee_defensive,
        nee_mis_spec=args.nee_mis,
        intersector=args.accel if args.scene else "brute",
        tile_pixels=dflt(args.tile_pixels, "tile_pixels"),
    )

    if args.scene:
        from tpu_pathtracer_torch.scene.cache import load_scene_cached

        scene = load_scene_cached(
            args.scene,
            scale=args.scale,
            env=env,
            material_source=args.materials,
            rng_seed=args.seed,
            accel=None if args.accel == "brute" else "cluster",
            device=device,
            **cache_kw,
        )
        plog.info(
            "scene",
            f"loaded {scene.num_triangles} triangles, {scene.materials.num_materials} materials "
            f"from {len(args.scene)} files" + (f", {args.accel} accel" if args.accel != "brute" else ""),
        )
    else:
        from tpu_pathtracer_torch.scene.procedural import three_spheres_scene

        scene = three_spheres_scene(device=device)
        if env is not None:
            scene = scene.replace(env=env)
        plog.info("scene", f"procedural scene: {scene.num_triangles} triangles")

    camera = Camera(eye=parse_vec3(args.eye), lookat=parse_vec3(args.lookat), fov_y=args.fov).with_aspect(width, height)
    return scene, camera, cfg


def save_aovs(prefix: str, aov: dict) -> None:
    """<prefix>_normal/_depth/_albedo.png from render_aov's buffers, row 0
    at the top: normals as (n/2 + 1/2) * 255, depth scaled to its maximum,
    albedo clamped to [0,1]; each truncated to uint8."""
    from tpu_pathtracer_torch.utils.image import save_image

    n8 = ((aov["normal"] * 0.5 + 0.5) * 255.0).cpu().numpy().astype(np.uint8)
    d = aov["depth"].cpu().numpy()
    d8 = (255.0 * d / max(float(d.max()), 1e-6)).astype(np.uint8)
    d8 = np.repeat(d8[..., None], 3, axis=-1)
    a8 = (np.clip(aov["albedo"].cpu().numpy(), 0.0, 1.0) * 255.0).astype(np.uint8)
    for name, img in (("normal", n8), ("depth", d8), ("albedo", a8)):
        save_image(f"{prefix}_{name}.png", img[::-1])


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None):
    """What `main` does; returns the ProgressiveRenderer after the render
    and its outputs (None when it served the viewer)."""
    args = build_arg_parser().parse_args(argv)
    from tpu_pathtracer_torch.runtime.progressive import ProgressiveRenderer
    from tpu_pathtracer_torch.utils import logging as plog
    from tpu_pathtracer_torch.utils.image import save_image

    scene, camera, cfg = build_from_args(args)
    renderer = ProgressiveRenderer(
        scene, camera, cfg,
        preview_budget_s=args.preview_budget_ms / 1e3,
        denoise=args.denoise,
        check_finite=args.debug_nans,
    )

    if args.resume and args.checkpoint:
        renderer.load_checkpoint(args.checkpoint)

    if args.interactive:
        from tpu_pathtracer_torch.viewer import serve

        serve(renderer, port=args.port, converge_ramp=not args.no_converge_ramp)
        return None

    total_spp = args.spp if args.spp > 0 else cfg.samples_per_launch
    n_frames = max(1, -(-total_spp // cfg.samples_per_launch))

    def launches():
        while renderer.subframe < n_frames:
            renderer.step()
            if renderer.subframe % 10 == 0 or renderer.subframe == n_frames:
                st = renderer.stats()
                plog.info(
                    "render",
                    f"subframe {renderer.subframe}/{n_frames} "
                    f"({st.get('ms_per_frame', 0):.1f} ms/frame, {st.get('paths_per_sec', 0)/1e6:.2f} Mpaths/s)",
                )
            if args.checkpoint and renderer.subframe % args.checkpoint_every == 0:
                renderer.save_checkpoint(args.checkpoint)

    if args.profile:
        from tpu_pathtracer_torch.runtime.profiler import xla_trace

        with xla_trace(args.profile):
            launches()
    else:
        launches()

    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)

    if args.aov_prefix:
        from tpu_pathtracer_torch.render.aov import render_aov

        save_aovs(args.aov_prefix, render_aov(scene, renderer._cam_arrays, cfg))
        plog.info("output", f"wrote {args.aov_prefix}_{{normal,depth,albedo}}.png")

    outfile = args.file or "out.png"
    if outfile.lower().endswith(".exr"):
        # EXR gets the raw linear accumulation: never tonemapped, never
        # denoised (external denoisers need the unfiltered signal).
        save_image(outfile, renderer.image_hdr())
    else:
        save_image(outfile, renderer.image_u8())
    plog.info("output", f"wrote {outfile} ({renderer.spp} spp)")
    return renderer


if __name__ == "__main__":
    sys.exit(main())
