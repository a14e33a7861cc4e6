"""Drive the PyTorch port's render paths once on an NVIDIA GPU: the
headline (flat kernels), the large-scene routes (two-level and streamed
kernels), each without and with next-event estimation (NEE: alias-table
light draws and shadow rays through the any-hit kernels).

    python3 chip_smoke.py [--image PATH]

Phases, each printing one line (any failure exits non-zero):
  1. device: the card's name, and name and power limit from nvidia-smi;
  2. build: compile every CUDA source in tpu_pathtracer_torch/csrc/, one
     nvcc each, all at once; ptxas usage per library;
  3. kernel 1 (flat closest hit) against its plain PyTorch version on
     131,072 rays of the headline scene (65,536 camera rays and their
     first bounce), sorted as the main path sorts them; Baldwin-Weber and
     Moller-Trumbore; t, prim and uv must be bit-equal; both times in ms;
  4. render: the headline through render_frame_stats, 1920x1080, 10 spp,
     depth 8, three-spheres scene with the cluster accel and a procedural
     256x512 equirect sky: one warm frame, two timed; the image must be
     finite and not black, the flat kernel must launch at least once per
     stream iteration and no other kernel may launch; Mrays/s;
  5. parity: a 128x96, 4 spp render with 1024 stream lanes on the GPU
     (kernels) and on the CPU (plain versions); SSIM after post_process
     must exceed 0.995 and segments agree within 0.5%;
  6. kernel 2 (two-level) as phase 3 on BASELINE config 4's scene,
     high_poly_scene(100_000): 98,002 triangles, 766 clusters, 6.3 MB of
     rows, camera eye (0,3,10) lookat (0,1,0);
  7. kernel 3 (streamed) as phase 3 on the same generator at 200,000
     triangles: 200,002 triangles, 1,563 clusters, 12.8 MB of rows;
  8. render config 4 as phase 4 (one warm, one timed frame), through the
     two-level kernel;
  9. render the 200k scene as phase 4 (one warm, one timed frame),
     through the streamed kernel;
 10. parity on the two-level route: high_poly_scene(13_000), 98 clusters,
     as phase 5;
 11-13. kernels 4, 5 and 6 (any hit: flat, two-level, streamed) on the
     headline, config 4 and the 200k scene: the 131,072 rays of phase 3
     intersected and shaded, one alias-table light draw each, the lanes
     that trace no shadow ray parked and the batch sorted as
     ClusterAccel.occluded does; flags bit-equal to the plain version in
     bw and mt; both times, the share of rays occluded and parked;
 14. NEE render of the headline (BASELINE config 3's path: textbook RR,
     env importance sampling), as phase 4 (one warm, two timed frames):
     kernels 1 and 4 must each launch at least once per stream iteration
     and no other kernel may launch; Mrays/s counts segments and shadow
     segments;
 15. NEE render of config 4 (kernels 2 and 5), one warm and one timed frame;
 16. NEE render of the 200k scene (kernels 3 and 6), one warm and one
     timed frame;
 17. NEE parity on the headline as phase 5, shadow segments also within
     0.5%.
Then one JSON line with every kernel's numbers (launches from its render
phase, bound from the work its plain version counts on the phase's rays),
and last the result line {"ok": true, "device": {...}}.  --image writes
the headline 1080p frame, post-processed, as a binary PPM.
"""

from __future__ import annotations

import argparse
import functools
import json
import shutil
import subprocess
import sys
import time

import numpy as np

try:
    import torch

    from tpu_pathtracer_torch.accel.build import build_accel
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.ops import cuda_build
    from tpu_pathtracer_torch.ops import intersect_cluster as ic
    from tpu_pathtracer_torch.render.camera import Camera, camera_arrays, generate_camera_rays
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.render.film import post_process, to_uint8
    from tpu_pathtracer_torch.render.integrator import (
        _light_sample,
        _shade,
        _shadow_candidates,
        render_frame_stats,
    )
    from tpu_pathtracer_torch.scene.procedural import high_poly_scene, three_spheres_scene
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils import rng
    from tpu_pathtracer_torch.utils.image import procedural_hdr
    from tpu_pathtracer_torch.utils.ssim import ssim
except ImportError as e:
    print(f"chip_smoke: cannot import the port ({e}); run from the repository root", file=sys.stderr)
    sys.exit(2)

PALLAS = "tpu_pathtracer/ops/intersect_pallas.py"
# id: (kernel name, source, TPU kernel replaced, route, any hit, wrapper, kernel entry, plain version)
KERNELS = {
    "k1": ("cluster_intersect", "tpu_pathtracer_torch/csrc/cluster_intersect.cu", f"{PALLAS}:257", "flat",
           False, ic.intersect_clusters, ic.intersect_clusters_cuda, ic.intersect_clusters_plain),
    "k2": ("cluster_hier", "tpu_pathtracer_torch/csrc/cluster_hier.cu", f"{PALLAS}:319", "hier",
           False, ic.intersect_clusters_hier, ic.intersect_clusters_hier_cuda, ic.intersect_clusters_hier_plain),
    "k3": ("cluster_streamed", "tpu_pathtracer_torch/csrc/cluster_streamed.cu", f"{PALLAS}:779", "streamed",
           False, ic.intersect_clusters_streamed, ic.intersect_clusters_streamed_cuda,
           ic.intersect_clusters_streamed_plain),
    "k4": ("cluster_occluded", "tpu_pathtracer_torch/csrc/cluster_occluded.cu", f"{PALLAS}:479", "flat",
           True, ic.occluded_clusters, ic.occluded_clusters_cuda, ic.occluded_clusters_plain),
    "k5": ("cluster_occluded_hier", "tpu_pathtracer_torch/csrc/cluster_occluded_hier.cu", f"{PALLAS}:533",
           "hier", True, ic.occluded_clusters_hier, ic.occluded_clusters_hier_cuda,
           ic.occluded_clusters_hier_plain),
    "k6": ("cluster_occluded_streamed", "tpu_pathtracer_torch/csrc/cluster_occluded_streamed.cu",
           f"{PALLAS}:979", "streamed", True, ic.occluded_clusters_streamed, ic.occluded_clusters_streamed_cuda,
           ic.occluded_clusters_streamed_plain),
}
# The kernels each route's render launches, without and with NEE.
ROUTE_KERNELS = {"flat": ("k1", "k4"), "hier": ("k2", "k5"), "streamed": ("k3", "k6")}
HEADLINE = dict(
    width=1920, height=1080, samples_per_launch=10, max_depth=8,
    dof=False, env_mode="equirect", rr_mode="reference", intersector="cluster",
)
NEE = dict(rr_mode="standard", env_importance_sampling=True)
CONFIG4_CAMERA = dict(eye=(0, 3, 10), lookat=(0, 1, 0))
CAMERA_RAYS = 65536  # and as many first bounces: 131,072 rays per kernel phase
# Bounds (H100 SXM data sheet, at the 700 W limit): float32 outside the
# tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
BW_TEST_FLOPS = 33  # bw_test in csrc/cluster_common.cuh: 17 mul, 14 add/sub, 1 div, 1 mul by rcp


@functools.lru_cache(maxsize=None)
def sky(device):
    """The procedural 256x512 equirect sky with its importance-sampling
    tables (the alias table is built once per device)."""
    return with_importance_sampling(make_env(procedural_hdr(256, 512), device))


def with_sky(scene, device):
    return build_accel(scene.replace(env=sky(device)), kind="cluster")


def headline_scene(device):
    return with_sky(three_spheres_scene(device=device), device)


def high_poly(total_tris, device):
    """BASELINE config 4's generator (its statue/lion stand-ins)."""
    return with_sky(high_poly_scene(total_tris=total_tris, device=device), device)


def set_counts_zero():
    for k in KERNELS.values():
        k[5].launches = 0


def read_counts():
    return {kid: k[5].launches for kid, k in KERNELS.items()}


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()} "
          f"| torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    return smi


def phase_build():
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    cuda_build.build_libraries()
    dt = time.perf_counter() - t0
    parts = []
    for source in cuda_build.sources():
        ic.library(source)  # loads, and sets the launch signature
        log = cuda_build.library_path(source).with_suffix(".log").read_text()
        usage = "; ".join(line.split("ptxas info    : ")[-1] for line in log.splitlines() if "Used" in line)
        parts.append(f"{source}: {usage}")
    print(f"[2 build] {len(parts)} libraries built at once in {dt:.2f} s | " + " | ".join(parts))


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bounce_batch(scene, cfg, camera):
    """131,072 rays as the main path traces them: 65,536 camera rays spread
    over the frame and, for each, its first bounce (a miss keeps its camera
    ray), sorted as ClusterAccel.intersect sorts them."""
    dev = scene.device
    acc = scene.accel
    n_cam = CAMERA_RAYS
    n_pix = cfg.width * cfg.height
    pix = torch.arange(n_cam, dtype=torch.int32, device=dev) * (n_pix // n_cam)
    seeds = rng.make_seeds(pix, torch.zeros_like(pix), 0)
    cam = camera_arrays(camera, cfg, dev)
    o, d, seeds = generate_camera_rays(cam, pix % cfg.width, pix // cfg.width, seeds, cfg)
    depth = torch.full((n_cam,), cfg.max_depth, dtype=torch.int32, device=dev)
    hit = acc.intersect(scene.vertices, o, d, cfg.t_min, cfg.t_max, cfg)
    sh = _shade(scene, cfg, hit, o, d, seeds, depth)
    o2 = torch.where(hit.hit[:, None], sh["new_origin"], o)
    d2 = torch.where(hit.hit[:, None], sh["new_direction"], d)
    o_s, d_s, _ = acc.sort(torch.cat([o, o2]), torch.cat([d, d2]), cfg)
    return o_s, d_s


def shadow_batch(scene, cfg, camera):
    """131,072 NEE shadow rays as the main path traces them: bounce_batch's
    rays intersected and shaded, one alias-table light draw each, the
    lanes that trace nothing (misses, glass, emissive, light below the
    normal) parked and the batch sorted as ClusterAccel.occluded does.
    Returns (origins, directions, share of lanes parked)."""
    acc = scene.accel
    o, d = bounce_batch(scene, cfg, camera)
    n = o.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=o.device)
    seeds = rng.make_seeds(idx, torch.zeros_like(idx), 1)
    depth = torch.full((n,), cfg.max_depth, dtype=torch.int32, device=o.device)
    hit = acc.intersect(scene.vertices, o, d, cfg.t_min, cfg.t_max, cfg)
    sh = _shade(scene, cfg, hit, o, d, seeds, depth)
    _, env_dir, _, _, _ = _light_sample(scene, cfg, sh, sh["seeds"])
    cand, _ = _shadow_candidates(hit.hit, sh, env_dir)
    o_s, d_s, _ = acc.shadow_sort(sh["new_origin"], env_dir, cfg, active=cand)
    return o_s, d_s, 1.0 - float(cand.float().mean())


def kernel_bytes(args, n, any_hit):
    """Bytes the traversal must move: every tensor argument read once
    (rays, rows, boxes, visit orders), the outputs written once (a flag
    byte per ray, or t, prim and uv: 16 bytes)."""
    read = sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))
    return read + n * (1 if any_hit else 16)


def phase_kernel(label, kid, scene, cfg, camera, smi, plain_reps):
    """The kernel against its plain version, both triangle tests, bit for
    bit; Baldwin-Weber (the main path's) timed, and its bound from the
    tests the plain version counts on these rays."""
    name, _, _, route, any_hit, _, kernel, plain = KERNELS[kid]
    acc = scene.accel
    if acc.route(cfg) != route:
        raise SystemExit(f"[{label}] FAIL: scene routes to {acc.route(cfg)}, not {route}")
    parked = None
    if any_hit:
        o_s, d_s, parked = shadow_batch(scene, cfg, camera)
    else:
        o_s, d_s = bounce_batch(scene, cfg, camera)
    n = o_s.shape[0]
    out = {}
    for tri_test in ("bw", "mt"):
        _, args = acc.traversal(o_s, d_s, cfg.t_min, cfg.t_max, cfg.replace(tri_test=tri_test))
        stats = {}
        got = kernel(*args)
        want = plain(*args, stats=stats)
        torch.cuda.synchronize()
        got, want = (got,) if any_hit else got, (want,) if any_hit else want
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            bad = sum(int((a != b).sum()) for a, b in zip(got, want))
            raise SystemExit(f"[{label}] FAIL: {name} ({tri_test}) and its plain version differ on {bad} values")
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        positive = int(got[0].sum()) if any_hit else int((got[1] != ic.MISS_PRIM).sum())
        ms = _time_ms(lambda: kernel(*args), 20)
        out[tri_test] = dict(max_abs_err=err, ms=ms, positive=positive, stats=stats)
        if tri_test == "bw":
            out["bw"]["plain_ms"] = _time_ms(lambda: plain(*args), plain_reps)
            flops = stats["tests"] * BW_TEST_FLOPS
            n_bytes = kernel_bytes(args, n, any_hit)
            t_ops, t_bytes = flops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
            out["bw"].update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                             flops=flops, n_bytes=n_bytes)
    bw, mt = out["bw"], out["mt"]
    what = (f"{bw['positive'] / n:.4%} occluded, {parked:.4%} parked" if any_hit
            else f"{bw['positive']} hits")
    print(f"[{label}] {name} ({route}{', any hit' if any_hit else ''}): {n} rays ({what}), "
          f"{acc.num_clusters} clusters of {acc.cluster_size}, {acc.tris16bw.numel() * 4} bytes of rows, "
          f"packets of {acc._rpt(cfg)}: bit-equal (0 ulp) in bw and mt; bw kernel {bw['ms']:.4f} ms, plain "
          f"{bw['plain_ms']:.4f} ms; mt kernel {mt['ms']:.4f} ms; bw work {bw['stats']['visits']} packet-cluster "
          f"visits, {bw['stats']['tests']} ray-triangle tests ({bw['stats']['tests'] / n:.1f} per ray), "
          f"{bw['flops']} FLOP, {bw['n_bytes']} bytes: bound {bw['bound_ms']:.4f} ms by {bw['bound_by']} | {smi}")
    return dict(max_abs_err=max(bw["max_abs_err"], mt["max_abs_err"]), ms=bw["ms"], plain_ms=bw["plain_ms"],
                bound_ms=bw["bound_ms"], bound_by=bw["bound_by"], library_ms=None)


def phase_render(label, scene, cfg, camera, frames, smi, image_path=None):
    """Warm frame, then `frames` timed frames with every launch count set
    to 0 just before and read just after.  The route's closest-hit kernel
    (and under NEE its any-hit kernel) must launch at least once per
    stream iteration, and no other kernel at all.  Returns the counts."""
    route = scene.accel.route(cfg)
    nee = cfg.env_importance_sampling
    want = ROUTE_KERNELS[route] if nee else ROUTE_KERNELS[route][:1]
    cam = camera_arrays(camera, cfg, scene.device)
    img, stats = render_frame_stats(scene, cam, cfg, 0)
    if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
        raise SystemExit(f"[{label}] FAIL: warm frame is non-finite or black")
    if int(stats["segments"]) <= 0 or (nee and int(stats["shadow_segments"]) <= 0):
        raise SystemExit(f"[{label}] FAIL: no segments traced")
    torch.cuda.synchronize()
    set_counts_zero()
    t0 = time.perf_counter()
    iters = seg_total = shadow_total = 0
    for k in range(frames):
        img, stats = render_frame_stats(scene, cam, cfg, k + 1)
        iters += stats["iters"]
        seg_total += int(stats["segments"])
        shadow_total += int(stats["shadow_segments"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    for kid in want:
        if counts[kid] < iters:
            raise SystemExit(f"[{label}] FAIL: {counts[kid]} {KERNELS[kid][0]} launches for {iters} stream iterations")
    others = {KERNELS[kid][0]: c for kid, c in counts.items() if kid not in want and c}
    if others:
        raise SystemExit(f"[{label}] FAIL: other kernels launched: {others}")
    if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
        raise SystemExit(f"[{label}] FAIL: timed frame is non-finite or black")
    launched = {KERNELS[kid][0]: counts[kid] for kid in want}
    rays = seg_total + shadow_total
    print(f"[{label}] {scene.num_triangles} triangles, {scene.accel.num_clusters} clusters, {route} route"
          f"{', NEE' if nee else ''}; {cfg.width}x{cfg.height} {cfg.samples_per_launch} spp depth {cfg.max_depth}: "
          f"{rays / dt / 1e6:.4f} Mrays/s (segments{' + shadow segments' if nee else ''}), "
          f"{dt / frames:.4f} s/launch, {seg_total // frames} segments/launch, "
          f"{shadow_total // frames} shadow segments/launch, {iters // frames} iterations/launch, "
          f"launches {launched} in {frames} timed frames, mean {img.mean(dim=(0, 1)).tolist()} | {smi}")
    if image_path:
        rgb = to_uint8(post_process(img, cfg)).cpu().numpy()[::-1]
        with open(image_path, "wb") as f:
            f.write(b"P6 %d %d 255\n" % (cfg.width, cfg.height) + rgb.tobytes())
    return counts


def phase_parity(label, make_scene, camera, route, nee=False):
    """128x96, 4 spp, 1024 lanes on the GPU (kernels) and the CPU (plain
    versions): SSIM after post_process above 0.995, segments (and shadow
    segments) within 0.5%."""
    cfg = RenderConfig(**{**HEADLINE, **(NEE if nee else {}), "width": 128, "height": 96,
                          "samples_per_launch": 4, "stream_lanes": 1024})
    out = {}
    for dev in ("cuda", "cpu"):
        scene = make_scene(dev)
        if scene.accel.route(cfg) != route:
            raise SystemExit(f"[{label}] FAIL: scene routes to {scene.accel.route(cfg)}, not {route}")
        img, stats = render_frame_stats(scene, camera_arrays(camera, cfg, dev), cfg, 0)
        out[dev] = (post_process(img, cfg).cpu().numpy(), int(stats["segments"]), int(stats["shadow_segments"]))
    (gpu, seg_gpu, sh_gpu), (cpu, seg_cpu, sh_cpu) = out["cuda"], out["cpu"]
    score = ssim(gpu, cpu)
    close = float(np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).mean())
    if not score > 0.995:
        raise SystemExit(f"[{label}] FAIL: GPU vs CPU SSIM {score:.6f} <= 0.995")
    if abs(seg_gpu - seg_cpu) > 0.005 * seg_cpu:
        raise SystemExit(f"[{label}] FAIL: segments {seg_gpu} on the GPU vs {seg_cpu} on the CPU")
    if nee and not (sh_cpu > 0 and abs(sh_gpu - sh_cpu) <= 0.005 * sh_cpu):
        raise SystemExit(f"[{label}] FAIL: shadow segments {sh_gpu} on the GPU vs {sh_cpu} on the CPU")
    print(f"[{label}] {route} route{', NEE' if nee else ''}, 128x96 4 spp, 1024 lanes: GPU vs CPU SSIM "
          f"{score:.6f}, {close:.4%} of values within rtol 1e-3/atol 1e-4, segments {seg_gpu} vs {seg_cpu}"
          + (f", shadow segments {sh_gpu} vs {sh_cpu}" if nee else ""))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image", help="write the headline 1080p frame here as a binary PPM")
    args = parser.parse_args()

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    cfg = RenderConfig(**HEADLINE)
    cfg_nee = RenderConfig(**{**HEADLINE, **NEE})
    cam4 = Camera(**CONFIG4_CAMERA)
    numbers, launches = {}, {}

    scene = headline_scene("cuda")
    numbers["k1"] = phase_kernel("3 kernel 1", "k1", scene, cfg, Camera(), smi, plain_reps=5)
    launches["k1"] = phase_render("4 render headline", scene, cfg, Camera(), 2, smi, args.image)["k1"]
    phase_parity("5 parity headline", headline_scene, Camera(), "flat")

    config4 = high_poly(100_000, "cuda")
    big = high_poly(200_000, "cuda")
    numbers["k2"] = phase_kernel("6 kernel 2", "k2", config4, cfg, cam4, smi, plain_reps=2)
    numbers["k3"] = phase_kernel("7 kernel 3", "k3", big, cfg, cam4, smi, plain_reps=2)
    launches["k2"] = phase_render("8 render config 4", config4, cfg, cam4, 1, smi)["k2"]
    launches["k3"] = phase_render("9 render 200k", big, cfg, cam4, 1, smi)["k3"]
    phase_parity("10 parity two-level", lambda dev: high_poly(13_000, dev), cam4, "hier")

    numbers["k4"] = phase_kernel("11 kernel 4", "k4", scene, cfg_nee, Camera(), smi, plain_reps=5)
    numbers["k5"] = phase_kernel("12 kernel 5", "k5", config4, cfg_nee, cam4, smi, plain_reps=2)
    numbers["k6"] = phase_kernel("13 kernel 6", "k6", big, cfg_nee, cam4, smi, plain_reps=2)
    launches["k4"] = phase_render("14 render headline NEE", scene, cfg_nee, Camera(), 2, smi)["k4"]
    launches["k5"] = phase_render("15 render config 4 NEE", config4, cfg_nee, cam4, 1, smi)["k5"]
    launches["k6"] = phase_render("16 render 200k NEE", big, cfg_nee, cam4, 1, smi)["k6"]
    phase_parity("17 parity headline NEE", headline_scene, Camera(), "flat", nee=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s after the device phase began")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches[kid], **numbers[kid])
        for kid, (name, source, replaces, *_) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
