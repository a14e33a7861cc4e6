"""Drive the PyTorch port's main render path once on an NVIDIA GPU.

    python3 chip_smoke.py [--image PATH]

Phases, each printing one line (any failure exits non-zero):
  1. device: the card's name, and name and power limit from nvidia-smi;
  2. build: compile the CUDA kernels from tpu_pathtracer_torch/csrc/;
  3. kernel: the packet-traversal kernel against its plain PyTorch version
     on 131,072 rays of the headline scene (65,536 camera rays and their
     first bounce), sorted as the main path sorts them; t, prim and uv must
     be bit-equal; both times in ms;
  4. render: the headline render through render_frame_stats, 1920x1080,
     10 spp, depth 8, three-spheres scene with the cluster accel and a
     procedural 256x512 equirect sky: one warm frame, two timed; the image
     must be finite and not black, and the kernel must launch at least
     once per stream iteration; Mrays/s;
  5. parity: a 128x96, 4 spp render with 1024 stream lanes on the GPU
     (kernel) and on the CPU (plain versions); SSIM after post_process
     must exceed 0.995.
Then one JSON line with every kernel's numbers, and last the result line
{"ok": true, "device": {...}}.  --image writes the 1080p frame,
post-processed, as a binary PPM.
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
    from tpu_pathtracer_torch.accel.cluster import RAYS_PER_PACKET
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.ops import cuda_build, intersect_cluster
    from tpu_pathtracer_torch.render.camera import Camera, camera_arrays, generate_camera_rays
    from tpu_pathtracer_torch.render.film import post_process, to_uint8
    from tpu_pathtracer_torch.render.integrator import _shade, render_frame_stats
    from tpu_pathtracer_torch.scene.procedural import three_spheres_scene
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils import rng
    from tpu_pathtracer_torch.utils.image import procedural_hdr
    from tpu_pathtracer_torch.utils.ssim import ssim
except ImportError as e:
    print(f"chip_smoke: cannot import the port ({e}); run from the repository root", file=sys.stderr)
    sys.exit(2)

KERNEL_SOURCE = "tpu_pathtracer_torch/csrc/cluster_intersect.cu"
KERNEL_REPLACES = "tpu_pathtracer/ops/intersect_pallas.py:257"
HEADLINE = dict(
    width=1920, height=1080, samples_per_launch=10, max_depth=8,
    dof=False, env_mode="equirect", rr_mode="reference", intersector="cluster",
)


def headline_scene(device):
    scene = three_spheres_scene(device=device).replace(
        env=make_env(procedural_hdr(256, 512), device)
    )
    return build_accel(scene, kind="cluster")


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
    intersect_cluster.library()
    dt = time.perf_counter() - t0
    log = cuda_build.library_path("cluster_intersect.cu").with_suffix(".log").read_text()
    usage = " ".join(line.split("ptxas info    : ")[-1] for line in log.splitlines() if "Used" in line)
    print(f"[2 build] cluster_intersect.cu built in {dt:.2f} s; {usage}")


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


def phase_kernel(scene, cfg, smi):
    dev = scene.device
    acc = scene.accel
    n_cam = 65536
    n_pix = cfg.width * cfg.height
    pix = torch.arange(n_cam, dtype=torch.int32, device=dev) * (n_pix // n_cam)
    seeds = rng.make_seeds(pix, torch.zeros_like(pix), 0)
    cam = camera_arrays(Camera(), cfg, dev)
    o, d, seeds = generate_camera_rays(cam, pix % cfg.width, pix // cfg.width, seeds, cfg)
    depth = torch.full((n_cam,), cfg.max_depth, dtype=torch.int32, device=dev)
    hit = acc.intersect(scene.vertices, o, d, cfg.t_min, cfg.t_max, cfg)
    sh = _shade(scene, cfg, hit, o, d, seeds, depth)
    # Misses keep their camera ray, so every bounce ray is a real one.
    o2 = torch.where(hit.hit[:, None], sh["new_origin"], o)
    d2 = torch.where(hit.hit[:, None], sh["new_direction"], d)
    o_all, d_all = torch.cat([o, o2]), torch.cat([d, d2])
    o_s, d_s, _ = intersect_cluster.octant_sort(
        o_all, d_all, acc.scene_lo, acc.scene_hi,
        spatial_bits=acc._spatial_bits(cfg), dir_bits=acc._dir_bits(cfg),
    )
    args = (acc.tris16bw, acc.aabb8, acc.order, o_s, d_s, cfg.t_min, cfg.t_max, RAYS_PER_PACKET)
    tk, pk, uvk = intersect_cluster.intersect_clusters_cuda(*args)
    tp, pp, uvp = intersect_cluster.intersect_clusters_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(tk, tp) and torch.equal(pk, pp) and torch.equal(uvk, uvp)):
        bad = int((tk != tp).sum() + (pk != pp).sum() + (uvk != uvp).any(dim=1).sum())
        raise SystemExit(f"[3 kernel] FAIL: kernel and plain version differ on {bad} values")
    err = max(float((tk - tp).abs().max()), float((uvk - uvp).abs().max()))
    n_hit = int((pk != intersect_cluster.MISS_PRIM).sum())
    ms = _time_ms(lambda: intersect_cluster.intersect_clusters_cuda(*args), 50)
    plain_ms = _time_ms(lambda: intersect_cluster.intersect_clusters_plain(*args), 5)
    print(f"[3 kernel] {o_s.shape[0]} rays ({n_hit} hits), {acc.num_clusters} clusters of "
          f"{acc.cluster_size}, packets of {RAYS_PER_PACKET}: t/prim/uv bit-equal (0 ulp); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms | {smi}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_render(scene, cfg, smi, image_path):
    cam = camera_arrays(Camera(), cfg, scene.device)
    img, stats = render_frame_stats(scene, cam, cfg, 0)
    if not bool(torch.isfinite(img).all()):
        raise SystemExit("[4 render] FAIL: non-finite pixels")
    if not float(img.max()) > 0.0:
        raise SystemExit("[4 render] FAIL: black frame")
    segs = int(stats["segments"])
    if segs <= 0:
        raise SystemExit("[4 render] FAIL: no segments traced")
    frames = 2
    torch.cuda.synchronize()
    intersect_cluster.intersect_clusters.launches = 0
    t0 = time.perf_counter()
    iters = seg_total = 0
    for k in range(frames):
        img, stats = render_frame_stats(scene, cam, cfg, k + 1)
        iters += stats["iters"]
        seg_total += int(stats["segments"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = intersect_cluster.intersect_clusters.launches
    if launches < iters:
        raise SystemExit(f"[4 render] FAIL: {launches} kernel launches for {iters} stream iterations")
    if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
        raise SystemExit("[4 render] FAIL: timed frame is non-finite or black")
    print(f"[4 render] {cfg.width}x{cfg.height} {cfg.samples_per_launch} spp depth {cfg.max_depth}: "
          f"{seg_total / dt / 1e6:.4f} Mrays/s, {dt / frames:.4f} s/launch, "
          f"{seg_total // frames} segments/launch, {iters // frames} iterations/launch, "
          f"{launches} kernel launches, mean {img.mean(dim=(0, 1)).tolist()} | {smi}")
    if image_path:
        rgb = to_uint8(post_process(img, cfg)).cpu().numpy()[::-1]
        with open(image_path, "wb") as f:
            f.write(b"P6 %d %d 255\n" % (cfg.width, cfg.height) + rgb.tobytes())
    return launches


def phase_parity():
    cfg = RenderConfig(**{**HEADLINE, "width": 128, "height": 96, "samples_per_launch": 4,
                          "stream_lanes": 1024})
    imgs = {}
    for dev in ("cuda", "cpu"):
        scene = headline_scene(dev)
        img, stats = render_frame_stats(scene, camera_arrays(Camera(), cfg, dev), cfg, 0)
        imgs[dev] = (post_process(img, cfg).cpu().numpy(), int(stats["segments"]))
    (gpu, seg_gpu), (cpu, seg_cpu) = imgs["cuda"], imgs["cpu"]
    score = ssim(gpu, cpu)
    close = float(np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).mean())
    if not score > 0.995:
        raise SystemExit(f"[5 parity] FAIL: GPU vs CPU SSIM {score:.6f} <= 0.995")
    print(f"[5 parity] 128x96 4 spp, 1024 lanes: GPU vs CPU SSIM {score:.6f}, "
          f"{close:.4%} of values within rtol 1e-3/atol 1e-4, segments {seg_gpu} vs {seg_cpu}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image", help="write the 1080p frame here as a binary PPM")
    args = parser.parse_args()

    smi = phase_device()
    phase_build()
    cfg = RenderConfig(**HEADLINE)
    scene = headline_scene("cuda")
    kernel = phase_kernel(scene, cfg, smi)
    launches = phase_render(scene, cfg, smi, args.image)
    phase_parity()
    print(json.dumps({"kernels": [dict(
        name="cluster_intersect", route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, launches=launches, **kernel,
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
