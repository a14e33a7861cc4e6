"""Where a launch's time goes on the GPU: one 1080p, 10 spp, depth 8 frame
of each chip_smoke.py render (headline, config 4, the 200k scene; without
and with NEE) under torch.profiler, CUDA activity.

    python3 profile_renders.py [--only NAME ...] [--out DIR]

For each render, after one warm frame: the wall time of the profiled
frame, the device busy time (the sum of every kernel and copy on the
card, which runs one stream), the idle share, the traversal kernels'
time and launches, and the device kernels per stream iteration.  One line
per render, with the card's name and power limit; the per-kernel table
of each render goes to DIR (default build/profile/, git-ignored).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import CONFIG4_CAMERA, HEADLINE, NEE, headline_scene, high_poly, phase_device
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays
from tpu_pathtracer_torch.render.integrator import render_frame_stats

# The device functions of the six traversal kernels (csrc/).
TRAVERSAL = ("cluster_intersect_kernel", "two_level_kernel", "cluster_occluded_kernel",
             "two_level_occluded_kernel")


def _device_s(e):
    """An event's own device time in seconds (the attribute's older name
    on older PyTorch)."""
    us = getattr(e, "self_device_time_total", None)
    return (us if us is not None else e.self_cuda_time_total) / 1e6


def renders():
    cam4 = Camera(**CONFIG4_CAMERA)
    return {
        "headline": (lambda: headline_scene("cuda"), Camera(), False),
        "config4": (lambda: high_poly(100_000, "cuda"), cam4, False),
        "200k": (lambda: high_poly(200_000, "cuda"), cam4, False),
        "headline_nee": (lambda: headline_scene("cuda"), Camera(), True),
        "config4_nee": (lambda: high_poly(100_000, "cuda"), cam4, True),
        "200k_nee": (lambda: high_poly(200_000, "cuda"), cam4, True),
    }


def profile_one(name, make, camera, nee, out_dir, smi):
    cfg = RenderConfig(**{**HEADLINE, **(NEE if nee else {})})
    scene = make()
    cam = camera_arrays(camera, cfg, "cuda")
    render_frame_stats(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stats = render_frame_stats(scene, cam, cfg, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(_device_s(e) for e in events)
    kernels = sum(e.count for e in events)
    trav = [e for e in events if any(k in e.key for k in TRAVERSAL)]
    trav_s = sum(_device_s(e) for e in trav)
    trav_desc = "; ".join(f"{next(k for k in TRAVERSAL if k in e.key)} {_device_s(e):.4f} s "
                          f"({e.count} x {_device_s(e) / e.count * 1e3:.4f} ms)" for e in trav)
    iters = stats["iters"]
    with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    print(f"[{name}] wall {wall:.4f} s, device busy {busy:.4f} s, idle {1 - busy / wall:.2%}, "
          f"traversal {trav_s:.4f} s ({trav_s / busy:.2%} of busy): {trav_desc}; "
          f"{kernels} device kernels and copies, {kernels / iters:.0f} per iteration, {iters} iterations, "
          f"{int(stats['segments'])} segments, {int(stats['shadow_segments'])} shadow segments | {smi}",
          flush=True)


def main() -> int:
    all_renders = renders()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="*", choices=sorted(all_renders), help="profile only these renders")
    parser.add_argument("--out", default="build/profile", help="where the per-kernel tables go")
    args = parser.parse_args()
    smi = phase_device()
    os.makedirs(args.out, exist_ok=True)
    for name in args.only or all_renders:
        profile_one(name, *all_renders[name], args.out, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
