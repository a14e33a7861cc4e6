"""Headline benchmark of the PyTorch port: Mrays/s of one launch on one
card.  Counterpart of the repository's `bench.py`, with its presets
(BASELINE.json's benchmark configs 1-5, 0 = the headline), its flags and
defaults, its traced-ray accounting (path segments, plus shadow segments
under NEE, from the schedule's own stats) and its black-render guard, plus
`--device` (default "cuda"; a machine without a card is refused, the
benchmark never runs on the CPU unless asked).  Options that were measured
and refuted on the TPU are refused unless left at their defaults:
`--pixel-order tiled`, `--sort-rays entry`, `--mq on` and `--rpt` other
than 0.

The reference renderer's OBJ files are read from `--reference DIR` (no
default): configs 2 and 5 need them; configs 0 and 3 render its suitcase
when DIR holds suitcase.obj, else the procedural three-spheres scene.
`--accel auto` builds an accel only where `bench.py` does: for config 4
and for the OBJ presets.  The three-spheres fallback and config 1 then
render by brute force, on the card through the brute-force kernels
(`csrc/brute.cu`); pass `--accel cluster` to time the cluster kernels.

Prints ONE JSON line, last:
    {"metric": ..., "value": Mrays/s, "unit": "Mrays/s", "detail": {...}}

Usage:
    python -m tpu_pathtracer_torch.bench [--config 0..5] [--nee] [--accel cluster] [--frames N]
    python -m tpu_pathtracer_torch.bench --device cpu --width 16 --height 12 --spp 2 --depth 3 --frames 1
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from tpu_pathtracer_torch.accel.build import build_accel
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.render import graph_loop
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays
from tpu_pathtracer_torch.render.envmap import with_importance_sampling
from tpu_pathtracer_torch.render.integrator import render_frame, render_frame_stats
from tpu_pathtracer_torch.scene import procedural
from tpu_pathtracer_torch.scene.builder import load_scene
from tpu_pathtracer_torch.scene.scene import make_env
from tpu_pathtracer_torch.utils.device import resolve
from tpu_pathtracer_torch.utils.image import procedural_hdr

# Options of bench.py that steer machinery measured and refuted on the TPU
# and not ported (ROADMAP, do not port): (flag, attribute, accepted values).
REFUSED = (
    ("--pixel-order", "pixel_order", ("auto", "scanline")),
    ("--sort-rays", "sort_rays", ("auto", "off", "octant", "spatial")),
    ("--mq", "mq", ("auto", "off")),
    ("--rpt", "rpt", (0,)),
)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tpu_pathtracer_torch.bench",
                                 description="Mrays/s of one launch on one card")
    ap.add_argument("--small", action="store_true", help="tiny config: 256x192, 4 frames")
    ap.add_argument("--frames", type=int, default=8, help="timed launches")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument(
        "--spp", type=int, default=None,
        help="samples per launch (default 10, the reference's batch; config 1 defaults to its whole "
        "64-spp budget in one launch)",
    )
    ap.add_argument("--accel", default="auto", choices=["auto", "brute", "cluster"])
    ap.add_argument("--tiles", type=int, default=0, help="pixel tiles per frame (0 = auto)")
    ap.add_argument("--lanes", type=int, default=0, help="streaming lane-pool size (0 = config default)")
    ap.add_argument("--nee", action="store_true", help="env importance sampling (config 3's fidelity)")
    ap.add_argument("--pixel-order", default="auto", choices=["auto", "scanline", "tiled"],
                    help="tiled is not ported (refuted on the TPU)")
    ap.add_argument("--fused", default="auto", choices=["auto", "on", "off"],
                    help="fused schedule step (config.fused_schedule)")
    ap.add_argument("--sort-rays", default="auto", choices=["auto", "off", "octant", "spatial", "entry"],
                    help="ray coherence sort key (config.sort_rays); entry is not ported")
    ap.add_argument("--mq", default="auto", choices=["auto", "on", "off"],
                    help="multi-queue NEE: on is not ported (refuted on the TPU)")
    ap.add_argument("--rpt", type=int, default=0, help="Pallas rays per tile: only 0 (auto) is accepted")
    ap.add_argument("--tri-test", default="auto", choices=["auto", "mt", "bw"],
                    help="triangle-test formulation (config.tri_test)")
    ap.add_argument("--config", type=int, default=0, choices=range(6),
                    help="BASELINE.json benchmark config preset (1-5); 0 = headline (suitcase at the given "
                    "dims and depth, three spheres without the reference's files)")
    ap.add_argument("--reference", type=Path, default=None,
                    help="directory of the reference renderer's OBJ files (suitcase.obj, test.obj, monkey.obj, "
                    "tower.obj, fish.obj): configs 2 and 5 need it, configs 0 and 3 render the suitcase from it")
    ap.add_argument("--device", default="cuda", help="torch device to render on (cuda, cuda:N or cpu)")
    return ap


def check_refused(args) -> None:
    """Exit non-zero, naming the flag, for an option that was measured and
    refuted on the TPU and is not ported; its defaults change nothing."""
    for flag, attr, accepted in REFUSED:
        value = getattr(args, attr)
        if value not in accepted:
            raise SystemExit(f"{flag} {value}: not ported (refuted on the TPU; ROADMAP, do not port): "
                             f"use {' or '.join(map(str, accepted))}")


def build_preset(args, device):
    """(scene, camera, cfg) of the preset `args` names, the scene on
    `device`; sets args.width, height, depth, spp and frames as the preset
    and --small decide, and args.scene_name."""
    if args.small:
        args.width, args.height, args.frames = 256, 192, 4

    env = make_env(procedural_hdr(256, 512), device)
    if args.nee:
        env = with_importance_sampling(env)
    accel_kind = ("cluster" if args.accel == "auto" else args.accel) if args.accel != "brute" else None
    env_mode = "equirect"
    camera = Camera(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0))

    def obj_scene(files, scale):
        if args.reference is None:
            raise SystemExit(f"--config {args.config} loads the reference's {', '.join(files)}: "
                             "pass --reference DIR")
        return load_scene([str(args.reference / f) for f in files], scale=scale, env=env, rng_seed=0,
                          accel=accel_kind, device=device)

    if args.config == 1:
        # analytic sphere, diffuse, constant sky, 512x512 at 64 spp: the
        # whole budget in one launch, which amortises the per-launch costs
        # and the queue's drain tail over 8x the work of an 8-spp launch.
        scene = procedural.single_sphere_scene(stacks=32, slices=64, device=device)
        args.width = args.height = 512
        if args.spp is None:
            args.spp = 64
        args.depth = 8
        env_mode = "constant"
        camera = Camera()
        args.scene_name = "sphere/constant-sky"
    elif args.config == 2:
        scene = obj_scene(["monkey.obj"], 1.0)
        args.depth = 4
        camera = Camera(eye=(0, 1, 4), lookat=(0, 0.6, 0))
        args.scene_name = "monkey+env"
    elif args.config in (0, 3):
        if args.reference is not None and (args.reference / "suitcase.obj").exists():
            # the reference's hero scene
            scene = obj_scene(["suitcase.obj", "test.obj"], 0.05)
            args.scene_name = "suitcase PBR"
        else:
            scene = procedural.three_spheres_scene(device=device).replace(env=env)
            camera = Camera()
            args.scene_name = "three spheres"
    elif args.config == 4:
        # the statue and lion stand-ins: high-poly, deep traversal
        scene = procedural.high_poly_scene(total_tris=100_000, device=device).replace(env=env)
        if accel_kind:
            scene = build_accel(scene, kind=accel_kind)
        camera = Camera(eye=(0, 3, 10), lookat=(0, 1, 0))
        args.scene_name = "high-poly 100k"
    else:
        scene = obj_scene(["tower.obj", "fish.obj", "test.obj"], 1.0)
        camera = Camera(eye=(0, 1.5, 5), lookat=(0, 0.6, 0))
        args.scene_name = "tower+fish+test"

    if args.spp is None:
        args.spp = 10
    n_pix = args.width * args.height
    tiles = args.tiles
    if tiles == 0:
        if args.spp > 1:
            # the stream schedule renders the whole frame from its lane pool
            tiles = 1
        else:
            tiles = max(1, n_pix // 262144)
            while n_pix % tiles:
                tiles -= 1
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        samples_per_launch=args.spp,
        max_depth=args.depth,
        dof=False,
        env_mode=env_mode,
        env_importance_sampling=args.nee,
        # NEE requires the textbook RR estimator (config validation).
        rr_mode="standard" if args.nee else "reference",
        intersector=args.accel,
        tile_pixels=(n_pix // tiles) if tiles > 1 else 0,
        fused_schedule=args.fused,
        sort_rays=args.sort_rays,
        tri_test=args.tri_test,
        **({"stream_lanes": args.lanes} if args.lanes else {}),
    )
    # Only an explicit --accel cluster builds an accel for a procedural
    # scene without one: "auto" on such a scene is brute force.
    if args.accel not in ("brute", "auto") and scene.accel is None:
        scene = build_accel(scene, kind=args.accel)
    return scene, camera, cfg


def power_limit_watts(device: torch.device):
    """The card's power limit in watts from nvidia-smi's row of the card's
    UUID (nvidia-smi numbers cards in its own order, not CUDA's), or None
    where it does not answer."""
    try:
        uuid = f"GPU-{torch.cuda.get_device_properties(device).uuid}"
        rows = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.splitlines()
        return next(float(limit) for row_uuid, limit in (row.split(",") for row in rows)
                    if row_uuid.strip() == uuid)
    except (AttributeError, OSError, subprocess.SubprocessError, StopIteration, ValueError):
        return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    """Build the preset on args.device, render a warm frame (subframe 0;
    on the card it captures the loop's graph), count its traced rays with
    render_frame_stats, then time args.frames launches (subframes 1..N).  Returns the result line, or {"error": ...}
    when the warm frame is black."""
    try:
        device = resolve(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device: {e}") from None
    scene, camera, cfg = build_preset(args, device)
    cam = camera_arrays(camera, cfg, device)

    # A silently broken kernel path renders black and ends every path at
    # once, which would make every timing look fantastic.  On the card the
    # warm frame also captures the loop's graph, which every later frame
    # replays.
    captures, capture_s = graph_loop.stats["captures"], graph_loop.stats["capture_seconds"]
    warm = render_frame(scene, cam, cfg, 0)
    capture_s = graph_loop.stats["capture_seconds"] - capture_s
    if not float(warm.max()) > 0.0:
        return {"error": "black render — refusing to benchmark"}

    # Traced-ray accounting from inside the render schedule, NEE shadow
    # rays included.
    _, stats = render_frame_stats(scene, cam, cfg, 0)
    path_segs = int(stats["segments"])
    shadow_segs = int(stats["shadow_segments"])
    rays_per_launch = path_segs + shadow_segs

    _sync(device)
    t0 = time.perf_counter()
    for k in range(args.frames):
        render_frame(scene, cam, cfg, k + 1)
    _sync(device)
    dt = time.perf_counter() - t0
    captures = graph_loop.stats["captures"] - captures

    mrays = rays_per_launch * args.frames / dt / 1e6
    spp_per_sec = args.spp * args.frames / dt
    cuda = device.type == "cuda"
    return {
        "metric": f"Mrays/sec/chip, {args.scene_name} scene, {args.width}x{args.height}, depth {args.depth}, "
        f"{args.accel} accel ({'gpu' if cuda else 'cpu'})",
        "value": mrays,
        "unit": "Mrays/s",
        "detail": {
            "rays_per_launch": rays_per_launch,
            "path_segments": path_segs,
            "shadow_segments": shadow_segs,
            "spp_per_sec": spp_per_sec,
            "sec_per_launch": dt / args.frames,
            "triangles": int(scene.num_triangles),
            "nee": args.nee,
            "frames": args.frames,
            "device": torch.cuda.get_device_name(device) if cuda else "cpu",
            "power_limit_w": power_limit_watts(device) if cuda else None,
            "schedule": stats["schedule"],
            "iterations": int(stats["iters"]),
            # whether the timed loop replayed a captured CUDA graph, the
            # warm frame's capture seconds, and the run's captures
            "graphed": stats["graphed"],
            "capture_seconds": capture_s,
            "captures": captures,
        },
    }


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    check_refused(args)
    result = run(args)
    print(json.dumps(result))
    return 1 if "error" in result else 0


if __name__ == "__main__":
    sys.exit(main())
