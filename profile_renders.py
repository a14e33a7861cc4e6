"""Where a launch's time goes on the GPU: one frame of each chip_smoke.py
render under torch.profiler, CUDA activity: 1080p, 10 spp, depth 8 on the
headline, config 4 and the 200k scene, without and with NEE, and the
headline and BASELINE config 1 (512x512, 64 spp) with the schedule's tail
fused (kernel 7) and unfused, 1 spp in six tiles, and chip_smoke.py's
hero stand-in at its scene file's config.

    python3 profile_renders.py [--only NAME ...] [--out DIR] [--wall]
    python3 profile_renders.py --ab NAME ... [--frames N]

--only runs the named renders in the order given, a name as often as it
is given (fused, unfused, unfused, fused compares two versions in one
call without favouring the first).  For each render, after one warm
frame (it captures the graph that the profiled frame replays): the wall
time of the profiled frame, the device busy time (the sum of every kernel, copy and memset on the card, which runs
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

--plain-ab NAME ... compares, on each named render at its full config,
the kernels (the bounce, NEE and camera kernels, kernel 7 off the fused
stream and the path step, the default on the card) with their plain
versions (`ops.bounce.plain()`; the fused stream keeps kernel 7), both
graphed: each arm's first frame at subframe 0 captures (the graph pool's
bytes), then --frames frames each way in the order plain, kernels,
kernels, plain (s/launch, images and stats bit-equal across the arms),
then one profiled frame of each arm: device busy time, idle share,
device kernels per iteration, the device time by kernel family (the
traversal kernels, the shading kernels, the schedule steps: kernel 7 and
the path step, the sampler, and the rest: PyTorch's eager ops, copies and
memsets) and the largest of the rest.

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
import sys
import time
import warnings
from pathlib import Path

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
    same_bits,
    write_hero,
)
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.ops import bounce as bounce_ops
from tpu_pathtracer_torch.ops import cuda_build
from tpu_pathtracer_torch.render import graph_loop
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays
from tpu_pathtracer_torch.render.integrator import render_frame_stats
from tpu_pathtracer_torch.scene.scenefile import load_scene_file

# The device functions of the port's kernels (csrc/): the six traversals
# (one body, with its packet-weight pre-pass), the schedule steps (kernel
# 7 and the path step), the unit-ball sampler, and the shading kernels:
# the bounce kernel (and its deferred entry point), the NEE kernel and the
# camera kernel.
KERNELS = ("streamed_kernel", "packet_weight_kernel", "fused_step_kernel", "path_step_kernel", "unit_sphere_kernel",
           "bounce_kernel", "shade_lanes_kernel", "nee_kernel", "camera_kernel")
# kernel_label's families, for the device time split of --plain-ab
FAMILIES = {"traversal": ("streamed_kernel", "packet_weight_kernel"),
            "schedule step": ("fused_step_kernel", "path_step_kernel"),
            "sampler": ("unit_sphere_kernel",),
            "shading": ("bounce_kernel", "shade_lanes_kernel", "nee_kernel", "camera_kernel")}


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


def launch_calls(prof):
    """{name: count} of the host's CUDA API calls in a
    profile that launch work on the device: kernel launches and graph
    launches."""
    cuda = torch.autograd.DeviceType.CUDA
    calls = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda and e.name().startswith("cu") and "Launch" in e.name():
            calls[e.name()] += 1
    return calls


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
        # the CLI's hero stand-in (chip_smoke's phase 25) at its scene file's config: camera and
        # config are the file's (None here)
        "hero": (hero_scene, None, None),
    }


def hero_scene():
    """chip_smoke's hero stand-in, written under build/hero and loaded
    through its scene file: (scene, camera, config)."""
    root = Path("build", "hero")
    root.mkdir(parents=True, exist_ok=True)
    return load_scene_file(str(write_hero(root)), device="cuda", cache_dir=str(root / "cache"))


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


def arm(eager=False, plain=False):
    """The context of a frame: the eager loop or the graphed one, the
    plain versions of the shading kernels or the kernels."""
    stack = contextlib.ExitStack()
    if eager:
        stack.enter_context(graph_loop.eager())
    if plain:
        stack.enter_context(bounce_ops.plain())
    return stack


def frame(scene, cam, cfg, subframe, eager, plain=False):
    """One frame, eagerly or graphed: (seconds, image, stats)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with arm(eager, plain):
        img, stats = render_frame_stats(scene, cam, cfg, subframe)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, img, stats


def profiled(scene, cam, cfg, subframe, eager, plain=False, events_out=None):
    """One frame under the profiler: (wall, device busy, device kernels,
    host launch calls {name: count}, stats); `events_out`, a dict, gets
    the device events {name: [count, seconds]}."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof, arm(eager, plain):
        t0 = time.perf_counter()
        _, stats = render_frame_stats(scene, cam, cfg, subframe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    if events_out is not None:
        events_out.update(events)
    return (wall, sum(s for _, s in events.values()), sum(c for c, _ in events.values()), launch_calls(prof),
            stats)


def family(key):
    """The FAMILIES name of the device event `key`, or "rest"."""
    return next((f for f, names in FAMILIES.items() if any(n in key for n in names)), "rest")


def kernels_ab(label, scene, cam, cfg, smi, frames=1, order=(True, False, False, True)):
    """The shading kernels against their plain versions (ops.bounce.plain())
    on one render, both graphed: each arm's first frame at subframe 0
    captures (the pool's bytes of the arm's plans), then `frames` frames
    from subframe 1 in each turn of `order` (True: plain), whose images,
    iterations, segments and shadow segments must be bit-equal across
    the arms; then one profiled frame of each arm.  Prints one line;
    returns its numbers by arm ("plain", "kernels"), each with the launch
    counts of its first timed frame by wrapper name."""
    graph_loop.clear()
    out = {}
    for plain in (True, False):
        before = {p.key for p in graph_loop._plans.values()}
        first, _, _ = frame(scene, cam, cfg, 0, eager=False, plain=plain)
        plans = [p for p in graph_loop._plans.values() if p.key not in before]
        out["plain" if plain else "kernels"] = dict(first=first, pool_bytes=sum(p.pool_bytes for p in plans),
                                                   captures=len([p for p in plans if p.graph is not None]), times=[])
    seen = {}
    for plain in order:
        row = out["plain" if plain else "kernels"]
        for k in range(frames):
            counts0 = {f.__name__: f.launches for f in graph_loop.COUNTED}
            dt, img, stats = frame(scene, cam, cfg, 1 + k, eager=False, plain=plain)
            row["times"].append(dt)
            row.setdefault("counts", {f.__name__: f.launches - counts0[f.__name__] for f in graph_loop.COUNTED})
            got = (img, {f: int(stats[f]) for f in ("iters", "segments", "shadow_segments")})
            if k not in seen:
                seen[k] = got
            elif not same_bits(seen[k][0], img) or seen[k][1] != got[1]:
                raise SystemExit(f"[{label}] FAIL: frame {1 + k} differs {'plain' if plain else 'kernels'} "
                                 f"{got[1]} vs {seen[k][1]}")
            if not stats["graphed"]:
                raise SystemExit(f"[{label}] FAIL: the frame did not run graphed")
    parts = []
    for name, row in out.items():
        events = {}
        wall, busy, kernels, _, st = profiled(scene, cam, cfg, 1, False, plain=name == "plain", events_out=events)
        iters = st["iters"]
        split = collections.Counter()
        for key, (_, sec) in events.items():
            split[family(key)] += sec
        rest = sorted(((sec, c, key) for key, (c, sec) in events.items() if family(key) == "rest"), reverse=True)[:4]
        mean = sum(row["times"]) / len(row["times"])
        row.update(seconds=mean, busy=busy, idle=1 - busy / mean, kernels=kernels / iters, iters=iters,
                   split={f: sec / iters for f, sec in split.items()})
        parts.append(
            f"{name}: s/launch {' '.join(f'{t:.4f}' for t in row['times'])} (mean {mean:.4f}), first frame "
            f"{row['first']:.4f} s, graph pool {row['pool_bytes']} bytes; profiled wall {wall:.4f} s, device busy "
            f"{busy:.4f} s, idle share of the mean s/launch {row['idle']:.2%}, {row['kernels']:.1f} device kernels per "
            f"iteration; device ms per iteration: "
            + ", ".join(f"{f} {sec * 1e3 / iters:.4f}" for f, sec in split.most_common())
            + "; largest of the rest per iteration: "
            + ", ".join(f"{key[:60]} {c / iters:.1f} x {sec / c * 1e3:.4f} ms" for sec, c, key in rest)
            + f"; launches {dict((k, v) for k, v in row['counts'].items() if v)}")
    print(f"[{label}] {st['schedule']} schedule, {cfg.width}x{cfg.height} {cfg.samples_per_launch} spp depth "
          f"{cfg.max_depth}, {st['iters']} iterations: plain and kernels bit-equal (images, iterations, segments, "
          f"shadow segments) over {frames} frame(s) a turn in the order "
          f"{' '.join('P' if p else 'K' for p in order)}; " + "; ".join(parts)
          + f"; speed-up {out['plain']['seconds'] / out['kernels']['seconds']:.4f}x | {smi}", flush=True)
    graph_loop.clear()
    return out


def ab_render(label, scene, cam, cfg, smi, frames=2, order=(True, False, False, True), profile_eager=True):
    """The loop run eagerly against the graphed loop on one render: a
    first graphed frame at subframe 0 (it captures: its seconds, the
    capture's seconds and the graph pool's bytes), then `frames` frames
    from subframe 1 in each turn of `order` (True: eager), whose images,
    iterations, segments and shadow segments must be bit-equal each way;
    then one frame under the profiler graphed (and eager with
    `profile_eager`).  Prints one line; returns its numbers by loop."""
    graph_loop.clear()
    captures = graph_loop.stats["captures"]
    first, _, stats0 = frame(scene, cam, cfg, 0, eager=False)
    plans = list(graph_loop._plans.values())
    capture_s = sum(p.capture_seconds for p in plans)
    pool = sum(p.pool_bytes for p in plans)
    times, seen = {True: [], False: []}, {}
    for eager in order:
        for k in range(frames):
            dt, img, stats = frame(scene, cam, cfg, 1 + k, eager)
            times[eager].append(dt)
            got = (img, {f: int(stats[f]) for f in ("iters", "segments", "shadow_segments")})
            if k not in seen:
                seen[k] = got
            elif not same_bits(seen[k][0], img) or seen[k][1] != got[1]:
                raise SystemExit(f"[{label}] FAIL: frame {1 + k} differs {'eager' if eager else 'graphed'} "
                                 f"{got[1]} vs {seen[k][1]}")
            if stats["graphed"] == eager:
                raise SystemExit(f"[{label}] FAIL: the frame reports graphed {stats['graphed']}")
    n_captures = graph_loop.stats["captures"] - captures
    out, parts = {}, []
    for eager in (True, False):
        mean = sum(times[eager]) / len(times[eager])
        row = dict(seconds=mean, times=times[eager])
        desc = f"s/launch {' '.join(f'{t:.4f}' for t in times[eager])} (mean {mean:.4f})"
        if profile_eager or not eager:
            wall, busy, kernels, calls, st = profiled(scene, cam, cfg, 1, eager)
            row.update(busy=busy, idle=1 - busy / mean, kernels=kernels / st["iters"],
                       calls={k: v / st["iters"] for k, v in calls.items()})
            calls_desc = ", ".join(f"{k} {v:.2f}" for k, v in row["calls"].items()) or "not measured"
            desc += (f"; profiled wall {wall:.4f} s, device busy {busy:.4f} s, idle share of the mean s/launch "
                     f"{row['idle']:.2%} (of the profiled wall {1 - busy / wall:.2%}), {row['kernels']:.1f} device "
                     f"kernels per iteration, host launch calls per iteration: {calls_desc}")
        out["eager" if eager else "graphed"] = row
        parts.append(f"{'eager' if eager else 'graphed'}: {desc}")
    out.update(first=first, capture_seconds=capture_s, pool_bytes=pool, captures=n_captures, iters=stats0["iters"],
               schedule=stats0["schedule"])
    print(f"[{label}] {stats0['schedule']} schedule, {cfg.width}x{cfg.height} {cfg.samples_per_launch} spp depth "
          f"{cfg.max_depth}, {stats0['iters']} iterations at subframe 0: eager and graphed bit-equal over {frames} "
          f"frame(s) each way; first graphed frame {first:.4f} s with {n_captures} capture(s) of {capture_s:.4f} s, "
          f"graph pool {pool} bytes; " + "; ".join(parts)
          + f"; speed-up {out['eager']['seconds'] / out['graphed']['seconds']:.4f}x | {smi}", flush=True)
    graph_loop.clear()
    return out


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
    args = parser.parse_args()
    smi = phase_device()
    os.makedirs(args.out, exist_ok=True)
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
