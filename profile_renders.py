"""Where a launch's time goes on the GPU: one frame of each chip_smoke.py
render under torch.profiler, CUDA activity: 1080p, 10 spp, depth 8 on the
headline, config 4 and the 200k scene, without and with NEE, and the
headline and BASELINE config 1 (512x512, 64 spp) with the schedule's tail
fused (kernel 7) and unfused, 1 spp in six tiles (render_rays), without
and with NEE, one lane a pixel (render_pixels_regen, 2,097,152 stream
lanes), chip_smoke.py's hero stand-in at its scene file's config, and
brute force (the brute-force kernels, csrc/brute.cu): the headline's
scene and config 1's without an accel at the bench's configs 0, 3 (NEE)
and 1 with --accel auto, and the NEE quality study's frame at its
defaults, both arms.

    python3 profile_renders.py [--only NAME ...] [--out DIR] [--wall]
    python3 profile_renders.py --ab NAME ... [--frames N]

--only runs the named renders in the order given, a name as often as it
is given (fused, unfused, unfused, fused compares two versions in one
call without favouring the first).  For each render, after one warm
frame (it captures the graph that the profiled frame replays): the wall
time of the profiled frame (traced as `chip_smoke.trace` traces: 20 ms of
host time in the window at each end, a throwaway spin kernel first, the
frame traced again, up to twice, while a launch has no device event), the
device busy time (the union of every kernel's, copy's and memset's time
on the card, which runs one stream: chip_smoke.busy_seconds), the idle
share, the traversal kernels' and the fused step's time and launches,
the device kernels per iteration (device events only: the CUDA runtime
calls that launch them are not counted) and the
stream syncs per iteration (counted over the warm frame, by PyTorch's
sync debug mode, with the lines that made them).  The
events are read straight from the trace: key_averages over the ~7
million events of a BASELINE config-1 frame takes longer than the
render.  One line per render, with the card's name and power limit; the
per-kernel table of each render goes to DIR (default build/profile/,
git-ignored).  --wall times each frame without the profiler instead and
prints its wall time (s/launch) alone.

--plain-ab NAME ... compares, on each named render at its full config,
the kernels (the bounce, NEE and camera kernels, kernel 7 off the fused
stream and the path step, the ray ordering, the default on the card)
with their plain
versions (`ops.cuda_build.plain()`; the fused stream keeps kernel 7), both
graphed: each arm's first frame at subframe 0 captures (the graph pool's
bytes), then --frames frames each way in the order plain, kernels,
kernels, plain (s/launch, images and stats bit-equal across the arms),
then one profiled frame of each arm: device busy time, idle share,
device kernels per iteration, the device time by kernel family (the
traversal kernels; the bounce, NEE and camera kernels, each its own; the
schedule steps: kernel 7 and the path step; the sampler; the ray order:
the radix sort of the rays (its one-block kernel, or its key launch and
digit passes), the restore and the packet order; and the rest: PyTorch's
eager ops, copies and memsets, and on the plain arm the library sort),
each beside its exposed time (chip_smoke.exposed_by_family), and the
largest of the rest.

--parent-ab NAME ... --parent DIR compares, on each named render at its
full config, an older checkout's kernels (DIR: its root; chip_smoke's
PARENT_SOURCES, the NEE and camera kernels and the launches before them,
the closest-hit traversals and the ray ordering, and brute force
(`brute`, `brute_nee`, `config1_brute`, `study`, `study_nee`), built
from its csrc/ and launched through this tree's wrappers, whose
launch order they then share) with this tree's, both graphed, in turns
P C C P P C C P: each turn a first frame at subframe 0 (it captures,
after every plan is dropped), an unprofiled frame at subframe 1
(s/launch; images and stats bit-equal across every turn) and a profiled
one: device busy time, device kernels per iteration, and for each kernel
family (the bounce, NEE and camera kernels each their own) its device ms
and its exposed ms an iteration (chip_smoke.exposed_by_family: what no
earlier device event covers).  One line a render: each side's s/launch
by turn, median and spread, and the medians of the rest.

--ab NAME ... compares the loop run eagerly (`graph_loop.eager()`) with
the graphed loop (each iteration one replay of a captured CUDA graph) on
each named render, at its full config: a first graphed frame at subframe
0 (it captures: its seconds, the capture's seconds and the graph pool's
bytes from the plan), then --frames frames each way in the order eager,
graphed, graphed, eager (s/launch each, their means, images and stats
bit-equal), then one frame each way under the profiler
(device busy time, idle share, device kernels and host launch calls
per iteration: the CUDA runtime's kernel and graph launch calls).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import statistics
import sys
import time
import warnings
from pathlib import Path

import torch

from chip_smoke import (
    CONFIG1,
    CONFIG4_CAMERA,
    FAMILIES,
    HEADLINE,
    NEE,
    ab_render,
    busy_seconds,
    config1_scene,
    device_events,
    family_split,
    finish_builds,
    headline_scene,
    high_poly,
    kernel_label,
    kernels_ab,
    parent_sources,
    phase_device,
    profiled,
    same_bits,
    start_builds,
    trace,
    using_libraries,
    write_hero,
)
from tpu_pathtracer_torch.render import graph_loop
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.ops import cuda_build
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays
from tpu_pathtracer_torch.render.integrator import render_frame_stats
from tpu_pathtracer_torch.scene.scenefile import load_scene_file

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
        # chip_smoke's phase 21: 1 spp in six tiles of 345,600 pixels (render_rays)
        "tiles": (lambda: headline_scene("cuda"), Camera(), {**cfg, "samples_per_launch": 1, "tile_pixels": 345_600}),
        "tiles_nee": (lambda: headline_scene("cuda"), Camera(),
                      {**cfg_nee, "samples_per_launch": 1, "tile_pixels": 345_600}),
        # chip_smoke's phase 22: one lane a pixel (render_pixels_regen on 2,073,600 lanes)
        "regen": (lambda: headline_scene("cuda"), Camera(), {**cfg, "stream_lanes": 2_097_152}),
        # the CLI's hero stand-in (chip_smoke's phase 25) at its scene file's config: camera and
        # config are the file's (None here)
        "hero": (hero_scene, None, None),
        # brute force: the bench's configs 0, 3 (NEE) and 1 at --accel auto, which builds no accel for
        # their procedural scenes; the NEE study's frame, each arm
        "brute": (lambda: headline_scene("cuda").replace(accel=None), Camera(), {**cfg, "intersector": "auto"}),
        "brute_nee": (lambda: headline_scene("cuda").replace(accel=None), Camera(),
                      {**cfg_nee, "intersector": "auto"}),
        "config1_brute": (lambda: config1_scene("cuda").replace(accel=None), Camera(),
                          {**cfg1, "intersector": "auto"}),
        "study": (lambda: study_frame(False), None, None),
        "study_nee": (lambda: study_frame(True), None, None),
    }


def hero_scene():
    """chip_smoke's hero stand-in, written under build/hero and loaded
    through its scene file: (scene, camera, config)."""
    root = Path("build", "hero")
    root.mkdir(parents=True, exist_ok=True)
    return load_scene_file(str(write_hero(root)), device="cuda", cache_dir=str(root / "cache"))


def study_frame(nee):
    """The NEE quality study's spheres frame at its defaults (160x120, 1
    spp, depth 6, brute force: tools/exp_nee_quality.py's build), BSDF or
    NEE: (scene, camera, config)."""
    from tpu_pathtracer_torch.tools import exp_nee_quality as study

    scene, _, cfg = study.build("spheres", nee, (160, 120), "cuda")
    return scene, Camera(eye=(0, 2, 8), lookat=(0, 1, 0)).with_aspect(160, 120), cfg


def setup(make, camera, cfg_kw):
    """(scene, camera arrays, config) of a render of renders()."""
    if cfg_kw is None:
        scene, camera, cfg = make()
    else:
        scene, cfg = make(), RenderConfig(**cfg_kw)
    return scene, camera_arrays(camera, cfg, "cuda"), cfg


def profile_one(run, name, make, camera, cfg_kw, out_dir, smi, wall_only=False):
    scene, cam, cfg = setup(make, camera, cfg_kw)
    # The warm frame at the render's own config: it captures the graph
    # that the profiled frame replays.
    with counting_syncs() as syncs:
        _, warm = render_frame_stats(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    if wall_only:
        t0 = time.perf_counter()
        _, stats = render_frame_stats(scene, cam, cfg, 1)
        torch.cuda.synchronize()
        print(f"[{name}] {stats['schedule']} schedule; wall {time.perf_counter() - t0:.4f} s unprofiled, "
              f"{stats['iters']} iterations, {int(stats['segments'])} segments | {smi}", flush=True)
        return
    t = trace(lambda: render_frame_stats(scene, cam, cfg, 1)[1])
    stats, wall = t["out"], t["wall"]
    events = sorted(device_events(t).items(), key=lambda kv: -kv[1][1])
    busy = busy_seconds(t)
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
          f"{int(stats['segments'])} segments, {int(stats['shadow_segments'])} shadow segments; trace "
          f"{'complete' if t['complete'] else 'INCOMPLETE'} after {t['retakes']} retakes, clock lead "
          f"{t['lead_ms']:.4f} ms | {smi}",
          flush=True)


def parent_ab(name, make, camera, cfg_kw, parent, smi, order="PCCPPCCP"):
    """One render of renders() with the parent's kernels (P: `parent`,
    finish_builds' libraries) and this tree's (C), in turns `order`: see
    the top of this file."""
    scene, cam, cfg = setup(make, camera, cfg_kw)
    rows, seen = {"P": [], "C": []}, None
    for who in order:
        graph_loop.clear()
        with using_libraries(parent if who == "P" else None):
            render_frame_stats(scene, cam, cfg, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, stats = render_frame_stats(scene, cam, cfg, 1)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            events, exposed = {}, {}
            _, busy, kernels, _, st, tr = profiled(scene, cam, cfg, 1, False, events_out=events, exposed_out=exposed)
        got = (img, {f: int(stats[f]) for f in ("iters", "segments", "shadow_segments")})
        if seen is None:
            seen = got
        elif not same_bits(seen[0], img) or seen[1] != got[1]:
            raise SystemExit(f"[parent-ab {name}] FAIL: turn {who} differs: {got[1]} vs {seen[1]}")
        iters = st["iters"]
        split = family_split(events)
        rows[who].append(dict(seconds=dt, busy=busy, kernels=kernels / iters, complete=tr["complete"],
                              split={f: split.get(f, 0.0) * 1e3 / iters for f in (*FAMILIES, "rest")},
                              exposed={f: exposed.get(f, 0.0) * 1e3 / iters for f in (*FAMILIES, "rest")}))
    graph_loop.clear()
    median = lambda xs: statistics.median(xs)  # noqa: E731
    parts = []
    for who, label in (("C", "change"), ("P", "parent")):
        r = rows[who]
        secs = [x["seconds"] for x in r]
        fams = ", ".join(f"{f} {median([x['split'][f] for x in r]):.4f} ({median([x['exposed'][f] for x in r]):.4f})"
                         for f in (*FAMILIES, "rest") if any(x["split"][f] for x in r))
        parts.append(f"{label}: s/launch {' '.join(f'{t:.4f}' for t in secs)} (median {median(secs):.4f}, spread "
                     f"{min(secs):.4f}-{max(secs):.4f}), device busy {median([x['busy'] for x in r]):.4f} s, "
                     f"{median([x['kernels'] for x in r]):.1f} device kernels per iteration, "
                     f"{sum(x['complete'] for x in r)} of {len(r)} traces complete; device ms per iteration "
                     f"(exposed), medians: {fams}")
    print(f"[parent-ab {name}] {stats['schedule']} schedule, {iters} iterations, turns {' '.join(order)}: images and "
          f"stats bit-equal in every turn; " + "; ".join(parts) + f" | {smi}", flush=True)


def main() -> int:
    all_renders = renders()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="*", choices=sorted(all_renders),
                        help="profile these renders, in this order")
    parser.add_argument("--out", default="build/profile", help="where the per-kernel tables go")
    parser.add_argument("--wall", action="store_true", help="time each frame without the profiler")
    parser.add_argument("--ab", nargs="*", choices=sorted(all_renders),
                        help="eager against graphed loop on these renders, in this order")
    parser.add_argument("--plain-ab", nargs="*", choices=sorted(all_renders),
                        help="the shading kernels against their plain versions on these renders, in this order")
    parser.add_argument("--frames", type=int, default=2, help="--ab, --plain-ab: timed frames each way per turn")
    parser.add_argument("--parent-ab", nargs="*", choices=sorted(all_renders),
                        help="an older checkout's kernels (--parent) against this tree's on these renders, in turns")
    parser.add_argument("--parent", help="--parent-ab: the root of the older checkout")
    args = parser.parse_args()
    smi = phase_device()
    os.makedirs(args.out, exist_ok=True)
    if args.parent_ab:
        if not args.parent:
            parser.error("--parent-ab needs --parent DIR")
        jobs = start_builds(parent_sources(args.parent))
        cuda_build.build_libraries()
        parent = finish_builds(jobs)
        for name in args.parent_ab:
            parent_ab(name, *all_renders[name], parent, smi)
        return 0
    if args.plain_ab:
        cuda_build.build_libraries()
        for name in args.plain_ab:
            kernels_ab(f"plain-ab {name}", *setup(*all_renders[name]), smi, frames=args.frames)
        return 0
    if args.ab:
        cuda_build.build_libraries()  # every kernel at once, before the first frame's clock
        for name in args.ab:
            ab_render(f"ab {name}", *setup(*all_renders[name]), smi, frames=args.frames)
        return 0
    for run, name in enumerate(args.only or all_renders):
        profile_one(run, name, *all_renders[name], args.out, smi, wall_only=args.wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
