"""Where a launch's time goes on the GPU: one frame of each chip_smoke.py
render under torch.profiler, CUDA activity: 1080p, 10 spp, depth 8 on the
headline, config 4 and the 200k scene, without and with NEE, and the
headline and BASELINE config 1 (512x512, 64 spp) with the schedule's tail
fused (kernel 7) and unfused.

    python3 profile_renders.py [--only NAME ...] [--out DIR] [--wall]

--only runs the named renders in the order given, a name as often as it
is given (fused, unfused, unfused, fused compares two versions in one
call without favouring the first).  For each render, after one warm
frame at 2 spp: the wall time of the profiled frame, the device busy
time (the sum of every kernel, copy and memset on the card, which runs
one stream), the idle share, the traversal kernels' and the fused step's
time and launches, the device kernels per iteration (device events
only: the CUDA runtime calls that launch them are not counted) and the
stream syncs per iteration (counted over the warm frame, by PyTorch's
sync debug mode, with the lines that made them).  The
events are read straight from the trace: key_averages over the ~7
million events of a BASELINE config-1 frame takes longer than the
render.  One line per render, with the card's name and power limit; the
per-kernel table of each render goes to DIR (default build/profile/,
git-ignored).  --wall times each frame without the profiler instead and
prints its wall time (s/launch) alone.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import sys
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (
    CONFIG1,
    CONFIG4_CAMERA,
    HEADLINE,
    NEE,
    config1_scene,
    headline_scene,
    high_poly,
    phase_device,
)
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays
from tpu_pathtracer_torch.render.integrator import render_frame_stats

# The device functions of the port's kernels (csrc/): the six traversals
# (one body, with its packet-weight pre-pass), the fused schedule step and
# the unit-ball sampler.
KERNELS = ("streamed_kernel", "packet_weight_kernel", "fused_step_kernel", "unit_sphere_kernel")


def kernel_label(key):
    """The port's kernel that the device function `key` belongs to, or
    None.  streamed_kernel<kAnyHit, kVisit, ...> is told apart by its first
    two template arguments: any hit or closest, and the visit order: flat
    (kernels 1 and 4), per packet (the hier route) or ascending (the
    streamed route)."""
    name = next((k for k in KERNELS if k in key), None)
    if name == "streamed_kernel":
        any_hit, visit = (a.strip() for a in key.split("streamed_kernel<", 1)[-1].split(",")[:2])
        route = ("flat" if visit.endswith("2") or visit.endswith("kFlat")
                 else "hier" if visit.endswith("1") or visit.endswith("kPerPacket") else "streamed")
        return f"streamed_kernel ({route}, {'any' if any_hit in ('true', '(bool)1') else 'closest'} hit)"
    return name


def device_events(prof):
    """{name: [count, device seconds]} over the device's events in a
    profile: kernels, copies and memsets."""
    cuda = torch.autograd.DeviceType.CUDA
    table = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            row = table.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += e.duration_ns() / 1e9
    return table


@contextlib.contextmanager
def counting_syncs():
    """While open, records every stream sync the process makes (PyTorch's
    sync debug mode, as warnings), as chip_smoke.counting_syncs does; a
    copy here, so that this script also runs against older trees."""
    syncs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield syncs
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # The mode's own first-use notice ("... does not yet detect all
    # synchronizing operations") is not a sync.
    syncs.extend(w for w in caught if "called a synchronizing CUDA operation" in str(w.message))


def sync_sites(syncs):
    """The Python lines that made the syncs `syncs`, with their counts,
    most first: "file:line xN, ..."."""
    sites = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs)
    return ", ".join(f"{site} x{n}" for site, n in sites.most_common()) or "none"


def renders():
    """name: (scene maker, camera, config)."""
    cam4 = Camera(**CONFIG4_CAMERA)
    cfg, cfg_nee, cfg1 = HEADLINE, {**HEADLINE, **NEE}, CONFIG1
    return {
        "headline": (lambda: headline_scene("cuda"), Camera(), cfg),
        "config4": (lambda: high_poly(100_000, "cuda"), cam4, cfg),
        "200k": (lambda: high_poly(200_000, "cuda"), cam4, cfg),
        "headline_nee": (lambda: headline_scene("cuda"), Camera(), cfg_nee),
        "config4_nee": (lambda: high_poly(100_000, "cuda"), cam4, cfg_nee),
        "200k_nee": (lambda: high_poly(200_000, "cuda"), cam4, cfg_nee),
        "headline_fused": (lambda: headline_scene("cuda"), Camera(), {**cfg, "fused_schedule": "on"}),
        "headline_unfused": (lambda: headline_scene("cuda"), Camera(), {**cfg, "fused_schedule": "off"}),
        "config1_fused": (lambda: config1_scene("cuda"), Camera(), {**cfg1, "fused_schedule": "on"}),
        "config1_unfused": (lambda: config1_scene("cuda"), Camera(), {**cfg1, "fused_schedule": "off"}),
    }


def profile_one(run, name, make, camera, cfg_kw, out_dir, smi, wall_only=False):
    cfg = RenderConfig(**cfg_kw)
    scene = make()
    cam = camera_arrays(camera, cfg, "cuda")
    with counting_syncs() as syncs:
        _, warm = render_frame_stats(scene, cam, cfg.replace(samples_per_launch=2), 0)
    torch.cuda.synchronize()
    if wall_only:
        t0 = time.perf_counter()
        _, stats = render_frame_stats(scene, cam, cfg, 1)
        torch.cuda.synchronize()
        print(f"[{name}] {stats['schedule']} schedule; wall {time.perf_counter() - t0:.4f} s unprofiled, "
              f"{stats['iters']} iterations, {int(stats['segments'])} segments | {smi}", flush=True)
        return
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stats = render_frame_stats(scene, cam, cfg, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(device_events(prof).items(), key=lambda kv: -kv[1][1])
    busy = sum(s for _, (_, s) in events)
    kernels = sum(c for _, (c, _) in events)
    ours = [(kernel_label(key), c, s) for key, (c, s) in events if kernel_label(key)]
    ours_s = sum(s for _, _, s in ours)
    ours_desc = "; ".join(f"{k} {s:.4f} s ({c} x {s / c * 1e3:.4f} ms)" for k, c, s in ours)
    iters = stats["iters"]
    with open(os.path.join(out_dir, f"{run:02d}_{name}.txt"), "w") as f:
        f.write("calls  device ms  mean ms  name\n")
        f.writelines(f"{c:6d} {s * 1e3:10.3f} {s / c * 1e3:8.4f}  {key}\n" for key, (c, s) in events[:60])
    print(f"[{name}] {stats['schedule']} schedule; wall {wall:.4f} s, device busy {busy:.4f} s, "
          f"idle {1 - busy / wall:.2%}, the port's kernels {ours_s:.4f} s ({ours_s / busy:.2%} of busy): {ours_desc}; "
          f"{kernels} device kernels, copies and memsets, {kernels / iters:.0f} per iteration, "
          f"{len(syncs) / warm['iters']:.4f} stream syncs per iteration (warm frame: {len(syncs)} in "
          f"{warm['iters']} iterations, by site {sync_sites(syncs)}), {iters} iterations, "
          f"{int(stats['segments'])} segments, {int(stats['shadow_segments'])} shadow segments | {smi}",
          flush=True)


def main() -> int:
    all_renders = renders()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="*", choices=sorted(all_renders),
                        help="profile these renders, in this order")
    parser.add_argument("--out", default="build/profile", help="where the per-kernel tables go")
    parser.add_argument("--wall", action="store_true", help="time each frame without the profiler")
    args = parser.parse_args()
    smi = phase_device()
    os.makedirs(args.out, exist_ok=True)
    for run, name in enumerate(args.only or all_renders):
        profile_one(run, name, *all_renders[name], args.out, smi, wall_only=args.wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
