"""Drive the PyTorch port's render paths once on an NVIDIA GPU: the
headline (flat kernel) and the large-scene routes (two-level and streamed
kernels).

    python3 chip_smoke.py [--image PATH]

Phases, each printing one line (any failure exits non-zero):
  1. device: the card's name, and name and power limit from nvidia-smi;
  2. build: compile every CUDA source in tpu_pathtracer_torch/csrc/, one
     nvcc each, all at once; ptxas usage per library;
  3. kernel 1 (flat) against its plain PyTorch version on 131,072 rays of
     the headline scene (65,536 camera rays and their first bounce),
     sorted as the main path sorts them; Baldwin-Weber and
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
  8. render config 4 as phase 4 (one warm, two timed frames), through the
     two-level kernel;
  9. render the 200k scene as phase 4 (one warm, one timed frame),
     through the streamed kernel;
 10. parity on the two-level route: high_poly_scene(13_000), 98 clusters,
     as phase 5.
Then one JSON line with every kernel's numbers (launches from its render
phase), and last the result line {"ok": true, "device": {...}}.  --image
writes the headline 1080p frame, post-processed, as a binary PPM.
"""

from __future__ import annotations

import argparse
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
    from tpu_pathtracer_torch.render.film import post_process, to_uint8
    from tpu_pathtracer_torch.render.integrator import _shade, render_frame_stats
    from tpu_pathtracer_torch.scene.procedural import high_poly_scene, three_spheres_scene
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils import rng
    from tpu_pathtracer_torch.utils.image import procedural_hdr
    from tpu_pathtracer_torch.utils.ssim import ssim
except ImportError as e:
    print(f"chip_smoke: cannot import the port ({e}); run from the repository root", file=sys.stderr)
    sys.exit(2)

# route: (kernel name, source, TPU kernel replaced, wrapper, kernel entry, plain version)
KERNELS = {
    "flat": ("cluster_intersect", "tpu_pathtracer_torch/csrc/cluster_intersect.cu",
             "tpu_pathtracer/ops/intersect_pallas.py:257", ic.intersect_clusters,
             ic.intersect_clusters_cuda, ic.intersect_clusters_plain),
    "hier": ("cluster_hier", "tpu_pathtracer_torch/csrc/cluster_hier.cu",
             "tpu_pathtracer/ops/intersect_pallas.py:319", ic.intersect_clusters_hier,
             ic.intersect_clusters_hier_cuda, ic.intersect_clusters_hier_plain),
    "streamed": ("cluster_streamed", "tpu_pathtracer_torch/csrc/cluster_streamed.cu",
                 "tpu_pathtracer/ops/intersect_pallas.py:779", ic.intersect_clusters_streamed,
                 ic.intersect_clusters_streamed_cuda, ic.intersect_clusters_streamed_plain),
}
HEADLINE = dict(
    width=1920, height=1080, samples_per_launch=10, max_depth=8,
    dof=False, env_mode="equirect", rr_mode="reference", intersector="cluster",
)
CONFIG4_CAMERA = dict(eye=(0, 3, 10), lookat=(0, 1, 0))
CAMERA_RAYS = 65536  # and as many first bounces: 131,072 rays per kernel phase


def with_sky(scene, device):
    scene = scene.replace(env=make_env(procedural_hdr(256, 512), device))
    return build_accel(scene, kind="cluster")


def headline_scene(device):
    return with_sky(three_spheres_scene(device=device), device)


def high_poly(total_tris, device):
    """BASELINE config 4's generator (its statue/lion stand-ins)."""
    return with_sky(high_poly_scene(total_tris=total_tris, device=device), device)


def set_counts_zero():
    for _, _, _, wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def read_counts():
    return {route: k[3].launches for route, k in KERNELS.items()}


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


def phase_kernel(label, scene, cfg, camera, route, smi, plain_reps):
    """The route's kernel against its plain version, both triangle tests,
    bit for bit; Baldwin-Weber (the main path's) timed."""
    acc = scene.accel
    if acc.route(cfg) != route:
        raise SystemExit(f"[{label}] FAIL: scene routes to {acc.route(cfg)}, not {route}")
    _, _, _, _, kernel, plain = KERNELS[route]
    o_s, d_s = bounce_batch(scene, cfg, camera)
    out = {}
    for tri_test in ("bw", "mt"):
        _, args = acc.traversal(o_s, d_s, cfg.t_min, cfg.t_max, cfg.replace(tri_test=tri_test))
        tk, pk, uvk = kernel(*args)
        tp, pp, uvp = plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(tk, tp) and torch.equal(pk, pp) and torch.equal(uvk, uvp)):
            bad = int((tk != tp).sum() + (pk != pp).sum() + (uvk != uvp).any(dim=1).sum())
            raise SystemExit(f"[{label}] FAIL: {route} kernel ({tri_test}) and plain version differ on {bad} values")
        n_hit = int((pk != ic.MISS_PRIM).sum())
        err = max(float((tk - tp).abs().max()), float((uvk - uvp).abs().max()))
        ms = _time_ms(lambda: kernel(*args), 20)
        out[tri_test] = dict(max_abs_err=err, ms=ms, n_hit=n_hit)
        if tri_test == "bw":
            out["bw"]["plain_ms"] = _time_ms(lambda: plain(*args), plain_reps)
    bw, mt = out["bw"], out["mt"]
    print(f"[{label}] {route}: {o_s.shape[0]} rays ({bw['n_hit']} hits), {acc.num_clusters} clusters of "
          f"{acc.cluster_size}, {acc.tris16bw.numel() * 4} bytes of rows, packets of {acc._rpt(cfg)}: "
          f"t/prim/uv bit-equal (0 ulp) in bw and mt; bw kernel {bw['ms']:.4f} ms, plain "
          f"{bw['plain_ms']:.4f} ms; mt kernel {mt['ms']:.4f} ms ({mt['n_hit']} hits) | {smi}")
    return dict(max_abs_err=max(bw["max_abs_err"], mt["max_abs_err"]), ms=bw["ms"], plain_ms=bw["plain_ms"])


def phase_render(label, scene, cfg, camera, route, frames, smi, image_path=None):
    """Warm frame, then `frames` timed frames with every launch count set
    to 0 just before and read just after.  The route's kernel must launch
    at least once per stream iteration and no other kernel at all."""
    if scene.accel.route(cfg) != route:
        raise SystemExit(f"[{label}] FAIL: scene routes to {scene.accel.route(cfg)}, not {route}")
    cam = camera_arrays(camera, cfg, scene.device)
    img, stats = render_frame_stats(scene, cam, cfg, 0)
    if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
        raise SystemExit(f"[{label}] FAIL: warm frame is non-finite or black")
    if int(stats["segments"]) <= 0:
        raise SystemExit(f"[{label}] FAIL: no segments traced")
    torch.cuda.synchronize()
    set_counts_zero()
    t0 = time.perf_counter()
    iters = seg_total = 0
    for k in range(frames):
        img, stats = render_frame_stats(scene, cam, cfg, k + 1)
        iters += stats["iters"]
        seg_total += int(stats["segments"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    if counts[route] < iters:
        raise SystemExit(f"[{label}] FAIL: {counts[route]} {route} launches for {iters} stream iterations")
    others = {r: n for r, n in counts.items() if r != route and n}
    if others:
        raise SystemExit(f"[{label}] FAIL: other kernels launched: {others}")
    if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
        raise SystemExit(f"[{label}] FAIL: timed frame is non-finite or black")
    print(f"[{label}] {scene.num_triangles} triangles, {scene.accel.num_clusters} clusters, {route} kernel; "
          f"{cfg.width}x{cfg.height} {cfg.samples_per_launch} spp depth {cfg.max_depth}: "
          f"{seg_total / dt / 1e6:.4f} Mrays/s, {dt / frames:.4f} s/launch, "
          f"{seg_total // frames} segments/launch, {iters // frames} iterations/launch, "
          f"launches {counts} in {frames} timed frames, mean {img.mean(dim=(0, 1)).tolist()} | {smi}")
    if image_path:
        rgb = to_uint8(post_process(img, cfg)).cpu().numpy()[::-1]
        with open(image_path, "wb") as f:
            f.write(b"P6 %d %d 255\n" % (cfg.width, cfg.height) + rgb.tobytes())
    return counts[route]


def phase_parity(label, make_scene, camera, route):
    """128x96, 4 spp, 1024 lanes on the GPU (kernels) and the CPU (plain
    versions): SSIM after post_process above 0.995, segments within 0.5%."""
    cfg = RenderConfig(**{**HEADLINE, "width": 128, "height": 96, "samples_per_launch": 4,
                          "stream_lanes": 1024})
    imgs = {}
    for dev in ("cuda", "cpu"):
        scene = make_scene(dev)
        if scene.accel.route(cfg) != route:
            raise SystemExit(f"[{label}] FAIL: scene routes to {scene.accel.route(cfg)}, not {route}")
        img, stats = render_frame_stats(scene, camera_arrays(camera, cfg, dev), cfg, 0)
        imgs[dev] = (post_process(img, cfg).cpu().numpy(), int(stats["segments"]))
    (gpu, seg_gpu), (cpu, seg_cpu) = imgs["cuda"], imgs["cpu"]
    score = ssim(gpu, cpu)
    close = float(np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).mean())
    if not score > 0.995:
        raise SystemExit(f"[{label}] FAIL: GPU vs CPU SSIM {score:.6f} <= 0.995")
    if abs(seg_gpu - seg_cpu) > 0.005 * seg_cpu:
        raise SystemExit(f"[{label}] FAIL: segments {seg_gpu} on the GPU vs {seg_cpu} on the CPU")
    print(f"[{label}] {route} route, 128x96 4 spp, 1024 lanes: GPU vs CPU SSIM {score:.6f}, "
          f"{close:.4%} of values within rtol 1e-3/atol 1e-4, segments {seg_gpu} vs {seg_cpu}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image", help="write the headline 1080p frame here as a binary PPM")
    args = parser.parse_args()

    smi = phase_device()
    phase_build()
    cfg = RenderConfig(**HEADLINE)
    cam4 = Camera(**CONFIG4_CAMERA)
    numbers, launches = {}, {}

    scene = headline_scene("cuda")
    numbers["flat"] = phase_kernel("3 kernel 1", scene, cfg, Camera(), "flat", smi, plain_reps=5)
    launches["flat"] = phase_render("4 render headline", scene, cfg, Camera(), "flat", 2, smi, args.image)
    phase_parity("5 parity headline", headline_scene, Camera(), "flat")

    config4 = high_poly(100_000, "cuda")
    big = high_poly(200_000, "cuda")
    numbers["hier"] = phase_kernel("6 kernel 2", config4, cfg, cam4, "hier", smi, plain_reps=2)
    numbers["streamed"] = phase_kernel("7 kernel 3", big, cfg, cam4, "streamed", smi, plain_reps=2)
    launches["hier"] = phase_render("8 render config 4", config4, cfg, cam4, "hier", 2, smi)
    launches["streamed"] = phase_render("9 render 200k", big, cfg, cam4, "streamed", 1, smi)
    phase_parity("10 parity two-level", lambda dev: high_poly(13_000, dev), cam4, "hier")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[route], **numbers[route])
        for route, (name, source, replaces, _, _, _) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
