"""Drive the PyTorch port's render paths once on an NVIDIA GPU: the
headline (flat kernels), the large-scene routes (two-level and streamed
kernels), each without and with next-event estimation (NEE: alias-table
light draws and shadow rays through the any-hit kernels), the fused
schedule step (kernel 7) on the headline and BASELINE config 1, the
other frame schedules: 1 spp (render_rays, tiled) and one lane per pixel
(render_pixels_regen); the user's entry points: OBJ/MTL/PNG scene
files through the packed-scene cache, the CLI with the progressive
renderer, AOVs, denoise and checkpoints, and the viewer; and sharded
frames on torch.distributed, deferred shading and the numpy oracle.

    python3 chip_smoke.py [--image PATH]

Phases, each printing one line (any failure exits non-zero):
  1. device: the card's name, and name and power limit from nvidia-smi;
  2. build: compile every CUDA source in tpu_pathtracer_torch/csrc/, one
     nvcc each, all at once; ptxas usage per library;
  3. kernel 1 (flat closest hit) against its plain PyTorch version on
     131,072 rays of the headline scene (65,536 camera rays and their
     first bounce), sorted as the main path sorts them; Baldwin-Weber and
     Moller-Trumbore; t, prim and uv must be bit-equal; both times in ms;
     like every traversal kernel (all are streamed_kernel of
     csrc/cluster_streamed.cuh), also its launch shape (blocks per packet,
     threads per ray, registers, resident blocks per SM), its instruction
     floor beside the bound, and the same rays tiled 16 times (2,097,152
     rays, more packets than the card holds at once): every tile bit-equal
     to the plain version's result, and timed;
 3b. kernel 1 as phase 3 on BASELINE config 1's scene at its pool of
     16,384 lanes: 8,192 camera rays and their first bounce (16 packets);
  4. render: the headline through render_frame_stats, 1920x1080, 10 spp,
     depth 8, three-spheres scene with the cluster accel and a procedural
     256x512 equirect sky: one warm frame, one timed; the image must be
     finite and not black, the flat kernel (and kernel 7 where the
     schedule is the fused stream: "auto" on the card) must launch at
     least once per iteration and no other kernel may launch; Mrays/s;
  5. parity: a 128x96, 4 spp render with 1024 stream lanes on the GPU
     (kernels) and on the CPU (plain versions); SSIM after post_process
     must exceed 0.995 and segments agree within 0.5%;
  6. kernel 2 (two-level) as phase 3 on BASELINE config 4's scene,
     high_poly_scene(100_000): 98,002 triangles, 766 clusters, 6.3 MB of
     rows, camera eye (0,3,10) lookat (0,1,0);
  7. kernel 3 (streamed) as phase 6 on the same generator at 200,000
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
     bw and mt; both times, the share of rays occluded and parked; launch
     shape, instruction floor and 16 tiles as phase 3;
 14. NEE render of the headline (BASELINE config 3's path: textbook RR,
     env importance sampling), as phase 4 (one warm, one timed frame):
     kernels 1 and 4 must each launch at least once per stream iteration
     and no other kernel may launch; Mrays/s counts segments and shadow
     segments;
 15. NEE render of config 4 (kernels 2 and 5), one warm and one timed frame;
 16. NEE render of the 200k scene (kernels 3 and 6), one warm and one
     timed frame;
 17. NEE parity on the headline as phase 5, shadow segments also within
     0.5%;
 18. kernel 7 (fused schedule step) against its plain version at 131,072
     lanes on the headline's lane state and trace payload after 16
     unfused iterations, in both rr_modes, with the real queue head and
     with a head that sends some lanes past n_pix: state, image, regen
     mask, head, segments and live count bit-equal; the same at config
     1's 16,384 lanes and at 128 and 524,288; the kernel's, the plain
     version's and the unfused schedule tail's times, and the bound
     (`--parent DIR`: an older checkout's kernel 7 timed in turns); 32
     consecutive steps on one scratch, and one step repeated 4,200 times
     on it, bit-equal to the plain version;
 19. the headline fused (fused_schedule="on") and unfused, one timed frame
     each of the same subframe: images bit-equal, iterations and segments
     identical, kernels 1 and 7 at least once per iteration and nothing
     else; Mrays/s and s/launch of both;
 20. BASELINE config 1 as phase 19: single_sphere_scene(32, 64) with the
     cluster accel (flat route), 512x512, 64 spp, depth 8, constant sky,
     default camera, auto lanes (16,384);
 21. 1 spp: the headline at 1080p in six tiles of 345,600 pixels
     (bench.py's 1-spp tiling), render_rays through kernel 1;
 22. one lane per pixel: the headline at 1080p, 10 spp, 2,097,152 stream
     lanes, so render_pixels_regen runs 2,073,600 lanes;
 23. GPU-vs-CPU parity as phase 5 of the fused stream (1,024 lanes),
     render_pixels_regen (16,384 lanes) and 1 spp with NEE;
 24. scene files: write the hero stand-in (a 2,200-triangle rounded box,
     scale 0.05 making it 2 units, with three 2048x2048 convention maps,
     and test.obj, a 12-triangle cube with three 512x512 maps, under a
     copy of scenes/suitcase.toml) and config 4's high_poly_scene(100_000)
     as an OBJ, into a scratch directory under build/; load each through
     the packed-scene cache cold and warm: parse, pack, read and upload
     seconds, triangles, clusters, and the native OBJ parser on every OBJ
     of a cold load;
 25. the CLI (cli.run) at the reference's defaults on the hero's scene
     file: 1600x1200, 30 spp in launches of 10, depth 20, DOF, denoised,
     with AOVs and a checkpoint; s/launch of each launch, stream syncs per
     iteration, kernel 1's and kernel 7's launches; the output finite and
     not black; then a resume for a fourth launch, bit-equal to an
     uninterrupted four-launch run;
 26. the CLI on config 4's OBJ at 1920x1080, depth 8, no DOF: one warm and
     one timed launch, without and with --nee, on the two-level route
     (kernel 2; kernel 7 without NEE, kernel 5 with);
 27. GPU-vs-CPU parity of the CPU tests' 64x48 textured, glass and
     emissive scene, two launches through ProgressiveRenderer: SSIM after
     post_process above 0.995, segments within 0.5%, AOV hit and mat
     exact, normal, depth and albedo within rtol 1e-5 / atol 1e-5;
 28. the viewer on a free localhost port: /frame.png (decoded by the
     port's codec), /stats, /orbit, /zoom, /pan, /toggle_dof and /resize
     answer 200, /resize changes the frame's size; the server and its
     render thread stop;
 29. sharding in a NCCL group of one rank: the headline (1080p, 10 spp,
     depth 8) sharded by pixels (an affine pixel range through the
     unfused stream) must equal render_frame bit for bit, by samples
     within rtol 2e-4 / atol 2e-5; s/launch of each and of the unsharded
     frame;
 30. two ranks on the one card over gloo, each a process of its own
     (chip_smoke.py --shard-worker PORT RANK OUT): the headline at
     320x240 without and with NEE, pixels bit-equal and samples within the
     tolerance above, both ranks holding the same frame; then the CLI
     with --shard pixels (a group of one) writes the PNG that --shard none
     writes, byte for byte;
 31. deferred shading off and on, the headline and the hero stand-in:
     three frames each, bit-equal with equal segments; mean s/launch,
     stream syncs and device kernels per iteration, device busy time of
     one profiled frame;
 32. six 32x24, 2 spp, depth 4 renders through kernel 1 (kernel 4 under
     NEE) against the numpy oracle (tpu_pathtracer_torch/oracle.py) by
     tests/test_oracle.py's rule, at least 98% of pixels with relative
     difference below 1e-3: sunsky spheres, DOF and a constant sky,
     glass, NEE, NEE with the defensive mixture, NEE with MIS-spec.
Then the launches on the CLI renders of phases 25 and 26, one JSON line with every kernel's numbers (launches from its render
phase, bound from the work its plain version counts on the phase's rays),
and last the result line {"ok": true, "device": {...}}.  --image writes
the headline 1080p frame, post-processed, as a binary PPM.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np

try:
    import torch

    from tpu_pathtracer_torch.accel.build import build_accel
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.ops import cuda_build
    from tpu_pathtracer_torch.ops import fused_schedule as fs
    from tpu_pathtracer_torch.ops import intersect_cluster as ic
    from tpu_pathtracer_torch.ops import unit_sphere
    from tpu_pathtracer_torch.render.camera import Camera, camera_arrays, generate_camera_rays
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.render.film import post_process, to_uint8
    from tpu_pathtracer_torch.render.integrator import (
        _camera_paths,
        _light_sample,
        _respawn,
        _shade,
        _shadow_candidates,
        _stream_state,
        _trace_bounce,
        render_frame_stats,
        resolve_stream_lanes,
    )
    from tpu_pathtracer_torch.scene.procedural import high_poly_scene, single_sphere_scene, three_spheres_scene
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils import rng
    from tpu_pathtracer_torch.utils.image import procedural_hdr
    from tpu_pathtracer_torch.utils.ssim import ssim
    from tpu_pathtracer_torch import cli
    from tpu_pathtracer_torch.assets import native
    from tpu_pathtracer_torch.render.aov import render_aov
    from tpu_pathtracer_torch.runtime import progressive
    from tpu_pathtracer_torch.runtime.progressive import ProgressiveRenderer
    from tpu_pathtracer_torch.scene.builder import load_scene
    from tpu_pathtracer_torch.scene.cache import load_scene_cached
    from tpu_pathtracer_torch.scene.scenefile import load_scene_file
    from tpu_pathtracer_torch.utils.image import decode_png, load_png, save_png
    from tpu_pathtracer_torch.viewer import serve
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch import oracle
    from tpu_pathtracer_torch.parallel.shard import free_port, initialize_distributed, make_mesh, render_frame_sharded
    from tpu_pathtracer_torch.render.integrator import render_frame

    # the CPU tests' scene writer (it imports neither JAX nor PIL)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _torch_scenes import ORACLE_CASES, oracle_case, write_mtl_scene
except ImportError as e:
    print(f"chip_smoke: cannot import the port ({e}); run from the repository root", file=sys.stderr)
    sys.exit(2)

REPO = Path(__file__).resolve().parent
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
    "k7": ("fused_step", "tpu_pathtracer_torch/csrc/fused_schedule.cu", "tpu_pathtracer/ops/fused_schedule.py:113",
           None, False, fs.fused_stream_step, fs.fused_stream_step_cuda, fs.fused_stream_step_plain),
    # No TPU kernel: the JAX package's lax.while_loop, which the port's loop
    # could only end by reading the device.
    "ks": ("unit_sphere", "tpu_pathtracer_torch/csrc/unit_sphere.cu", "tpu_pathtracer/utils/rng.py:79", None, False,
           unit_sphere.random_in_unit_sphere, unit_sphere.random_in_unit_sphere_cuda, rng.random_in_unit_sphere_plain),
}
# The kernels each route's render launches, without and with NEE.
ROUTE_KERNELS = {"flat": ("k1", "k4"), "hier": ("k2", "k5"), "streamed": ("k3", "k6")}
HEADLINE = dict(
    width=1920, height=1080, samples_per_launch=10, max_depth=8,
    dof=False, env_mode="equirect", rr_mode="reference", intersector="cluster",
)
NEE = dict(rr_mode="standard", env_importance_sampling=True)
CONFIG4_CAMERA = dict(eye=(0, 3, 10), lookat=(0, 1, 0))
# BASELINE config 1 as bench.py --config 1 sets it: the analytic sphere,
# diffuse, constant sky, 512x512 at 64 spp, depth 8, default camera.
CONFIG1 = dict(width=512, height=512, samples_per_launch=64, max_depth=8, dof=False, env_mode="constant",
               rr_mode="reference", intersector="cluster")
CAMERA_RAYS = 65536  # and as many first bounces: 131,072 rays per kernel phase
CONFIG1_CAMERA_RAYS = 8192  # config 1's pool of 16,384 lanes
# Bounds (H100 SXM data sheet, at the 700 W limit): float32 outside the
# tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
BW_TEST_FLOPS = 33  # bw_test in csrc/cluster_common.cuh: 17 mul, 14 add/sub, 1 div, 1 mul by rcp
# The instruction floor of the two-level kernels: the instructions one
# Baldwin-Weber test costs as the arithmetic has to be written (the SASS of
# streamed_kernel's triangle loop, cuobjdump -sass on the built library:
# the one-triangle body has 77 instructions, its row address, three 16-byte
# shared loads and the IEEE division included; the body unrolled over two
# triangles has 157), at 4 warp instructions a clock on each SM at the
# card's highest SM clock.
BW_TEST_INSTRUCTIONS = 77
# The unit-ball sampler's float work a draw (csrc/unit_sphere.cu): three
# conversions and scalings, three 2u - 1 (two ops each), three squares and
# two sums, one compare.
SAMPLER_DRAW_FLOPS = 18
LARGE_TILES = 16  # the kernel phases: 16 x their rays in one launch


@functools.lru_cache(maxsize=None)
def sky(device):
    """The procedural 256x512 equirect sky with its importance-sampling
    tables (the alias table is built once per device)."""
    return with_importance_sampling(make_env(procedural_hdr(256, 512), device))


def with_sky(scene, device):
    return build_accel(scene.replace(env=sky(device)), kind="cluster")


def headline_scene(device):
    return with_sky(three_spheres_scene(device=device), device)


def config1_scene(device):
    return build_accel(single_sphere_scene(stacks=32, slices=64, device=device), kind="cluster")


def high_poly(total_tris, device):
    """BASELINE config 4's generator (its statue/lion stand-ins)."""
    return with_sky(high_poly_scene(total_tris=total_tris, device=device), device)


def set_counts_zero():
    for k in KERNELS.values():
        k[5].launches = 0


def read_counts():
    return {kid: k[5].launches for kid, k in KERNELS.items()}


@contextlib.contextmanager
def counting_syncs():
    """While open, records every stream sync the process makes (PyTorch's
    sync debug mode, as warnings): the list it yields holds one entry a
    sync once the block ends."""
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


def instruction_rate():
    """Warp instructions the card can start a second: 4 a clock on each SM
    at the highest SM clock nvidia-smi reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 4 * mhz * 1e6, mhz


@contextlib.contextmanager
def counting_visits(plain_cls, packets, device):
    """While open, counts the clusters each packet tests in the plain
    versions of `plain_cls` (ic._Packets or ic._Occlusion)."""
    counts = torch.zeros(packets, dtype=torch.int64, device=device)
    visit = plain_cls.visit

    def counted(self, idx, *rest):
        counts.index_add_(0, idx, torch.ones_like(idx))
        return visit(self, idx, *rest)

    plain_cls.visit = counted
    try:
        yield counts
    finally:
        plain_cls.visit = visit


def phase_build():
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    cuda_build.build_libraries()
    dt = time.perf_counter() - t0
    parts = []
    for source in cuda_build.sources():
        cuda_build.library(source)  # loads, and sets the launch signature
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


def bounce_batch(scene, cfg, camera, n_cam=CAMERA_RAYS):
    """2 x n_cam rays as the main path traces them: n_cam camera rays
    spread over the frame and, for each, its first bounce (a miss keeps its
    camera ray), sorted as ClusterAccel.intersect sorts them."""
    dev = scene.device
    acc = scene.accel
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


def phase_kernel(label, kid, scene, cfg, camera, smi, plain_reps, n_cam=CAMERA_RAYS):
    """The kernel against its plain version on bounce_batch's 2 x n_cam
    rays (any hit: shadow_batch's), both triangle tests, bit for bit;
    Baldwin-Weber (the main path's) timed, and its bound from the tests the
    plain version counts on these rays; then phase_streamed_sizes."""
    name, _, _, route, any_hit, _, kernel, plain = KERNELS[kid]
    acc = scene.accel
    if acc.route(cfg) != route:
        raise SystemExit(f"[{label}] FAIL: scene routes to {acc.route(cfg)}, not {route}")
    parked = None
    if any_hit:
        o_s, d_s, parked = shadow_batch(scene, cfg, camera)
    else:
        o_s, d_s = bounce_batch(scene, cfg, camera, n_cam)
    n = o_s.shape[0]
    rpt, k = acc._rpt(cfg), acc.cluster_size
    out = {}
    for tri_test in ("bw", "mt"):
        _, args = acc.traversal(o_s, d_s, cfg.t_min, cfg.t_max, cfg.replace(tri_test=tri_test))
        stats = {}
        got = kernel(*args)
        with counting_visits(ic._Occlusion if any_hit else ic._Packets, -(-n // rpt), o_s.device) as visits:
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
                             flops=flops, n_bytes=n_bytes, want=want, visits=visits)
    bw, mt = out["bw"], out["mt"]
    what = (f"{bw['positive'] / n:.4%} occluded, {parked:.4%} parked" if any_hit
            else f"{bw['positive']} hits")
    per_packet = bw["visits"].float()
    work = (f"bw work {bw['stats']['visits']} packet-cluster visits (a packet: median {int(per_packet.median())}, "
            f"mean {float(per_packet.mean()):.1f}, most {int(per_packet.max())}), "
            f"{bw['stats']['tests']} ray-triangle tests ({bw['stats']['tests'] / n:.1f} per ray")
    if any_hit:  # a ray stops at its first hit, and an occluded ray tests nothing
        work += f", {bw['stats']['tests'] / (bw['stats']['visits'] * rpt * k):.4%} of visits x rays x triangles"
    print(f"[{label}] {name} ({route}{', any hit' if any_hit else ''}): {n} rays ({what}), "
          f"{acc.num_clusters} clusters of {k}, {acc.tris16bw.numel() * 4} bytes of rows, "
          f"packets of {rpt}: bit-equal (0 ulp) in bw and mt; bw kernel {bw['ms']:.4f} ms, plain "
          f"{bw['plain_ms']:.4f} ms; mt kernel {mt['ms']:.4f} ms; {work}), "
          f"{bw['flops']} FLOP, {bw['n_bytes']} bytes: bound {bw['bound_ms']:.4f} ms by {bw['bound_by']} | {smi}")
    phase_streamed_sizes(label, name, route, any_hit, kernel, acc, cfg, o_s, d_s, bw, smi)
    return dict(max_abs_err=max(bw["max_abs_err"], mt["max_abs_err"]), ms=bw["ms"], plain_ms=bw["plain_ms"],
                bound_ms=bw["bound_ms"], bound_by=bw["bound_by"], library_ms=None)


def phase_streamed_sizes(label, name, route, any_hit, kernel, acc, cfg, o_s, d_s, bw, smi):
    """A traversal kernel's (streamed_kernel of csrc/cluster_streamed.cuh,
    on any route) launch shape and instruction floor at the phase's rays,
    and the same rays tiled LARGE_TILES times in one launch: every tile
    must equal the plain version's result, bit for bit."""
    n, rpt, k = o_s.shape[0], acc._rpt(cfg), acc.cluster_size
    if n % rpt:
        raise SystemExit(f"[{label}] FAIL: {n} rays do not tile by whole packets of {rpt}")
    rate, mhz = instruction_rate()
    floor_ms = bw["stats"]["tests"] / 32 * BW_TEST_INSTRUCTIONS / rate * 1e3
    _, args = acc.traversal(o_s.repeat(LARGE_TILES, 1), d_s.repeat(LARGE_TILES, 1), cfg.t_min, cfg.t_max, cfg)
    got = kernel(*args)
    torch.cuda.synchronize()
    got = (got,) if any_hit else got
    bad = sum(int((a.reshape(LARGE_TILES, *b.shape) != b[None]).sum()) for a, b in zip(got, bw["want"]))
    if bad:
        raise SystemExit(f"[{label}] FAIL: {name} at {n * LARGE_TILES} rays differs from the plain version on {bad} values")
    ms_large = _time_ms(lambda: kernel(*args), 5)
    shapes = []
    for rays in (n, n * LARGE_TILES):
        sh = ic.streamed_launch_shape(rays, rpt, k, "bw", any_hit, route)
        shapes.append(f"{rays} rays: {sh['packets']} packets x {sh['blocks']} blocks of {sh['threads']} threads, "
                      f"{sh['threads_per_ray']} threads per ray, {sh['registers']} registers, "
                      f"{sh['resident_blocks']} resident blocks per SM, {sh['resident_clusters']} resident packets")
    print(f"[{label}] {name} launch shape: {'; '.join(shapes)}; instruction floor {floor_ms:.4f} ms "
          f"({BW_TEST_INSTRUCTIONS} instructions a test, {rate / 1e12:.4f} T warp instructions/s at {mhz:.0f} MHz), "
          f"bound {bw['bound_ms']:.4f} ms; at {n * LARGE_TILES} rays ({LARGE_TILES} tiles, every tile bit-equal) kernel "
          f"{ms_large:.4f} ms, instruction floor {floor_ms * LARGE_TILES:.4f} ms, bound {bw['bound_ms'] * LARGE_TILES:.4f} ms | {smi}")


def draw_counts(seed, end_seed):
    """Rejection draws each lane took: its seed advanced 3 x draws PCG
    steps to `end_seed`."""
    steps, x = torch.zeros_like(seed), seed.clone()
    for k in range(1, 301):
        x = rng.pcg_hash(x)
        steps = torch.where((x == end_seed) & (steps == 0), k, steps)
        if k % 30 == 0 and bool((steps > 0).all()):
            break
    if not bool((steps > 0).all()) or bool((steps % 3 != 0).any()):
        raise SystemExit("[3c sampler] FAIL: a lane's seed chain is not whole draws")
    return steps // 3


def phase_sampler(label, scene, cfg, smi):
    """The unit-ball sampler against its plain version on the seeds that
    _shade hands it on the headline's 131,072 lanes (phase 3's rays,
    shaded): seeds and points bit-equal; both times; the bound from the
    bytes (8 in, 20 out a lane) and the draws this run's seeds take."""
    o, d = bounce_batch(scene, cfg, Camera())
    n = o.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=o.device)
    # the seed a lane brings to the sampler: its path's seed after _shade's
    # four uniform draws before it
    seed = rng.make_seeds(idx, idx % cfg.samples_per_launch, 1)
    for _ in range(4):
        seed = rng.pcg_hash(seed)
    got = unit_sphere.random_in_unit_sphere_cuda(seed)
    want = rng.random_in_unit_sphere_plain(seed)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and same_bits(got[1], want[1])):
        bad = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
        raise SystemExit(f"[{label}] FAIL: unit_sphere and its plain version differ on {bad} values")
    draws = draw_counts(seed, want[0])
    ms = _time_over(unit_sphere.random_in_unit_sphere_cuda, [seed] * 51, device_only=True)
    plain_ms = _time_ms(lambda: rng.random_in_unit_sphere_plain(seed), 5)
    n_bytes, flops = n * (8 + 8 + 12), int(draws.sum()) * SAMPLER_DRAW_FLOPS
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    numbers = dict(max_abs_err=float((got[1] - want[1]).abs().max()), ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                   library_ms=None)
    print(f"[{label}] unit_sphere: {n} lanes, draws a lane mean {float(draws.float().mean()):.4f}, most "
          f"{int(draws.max())}: seeds and points bit-equal (0 ulp); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"{n_bytes} bytes, {flops} FLOP: bound {numbers['bound_ms']:.4f} ms by {numbers['bound_by']} | {smi}")
    return numbers


def phase_render(label, scene, cfg, camera, frames, smi, image_path=None, warm=True):
    """A warm frame (unless warm=False), then `frames` timed frames with
    every launch count set to 0 just before and read just after.  The
    route's closest-hit kernel (and under NEE its any-hit kernel; on the
    fused stream, which the render reports as its schedule, kernel 7)
    must launch at least once per iteration of the schedule, the unit-ball
    sampler once per _shade (an iteration's), and no other kernel at all.
    Also counts the stream syncs inside the timed renders.  Returns the
    counts, the last image, the totals and the schedule."""
    route = scene.accel.route(cfg)
    nee = cfg.env_importance_sampling
    cam = camera_arrays(camera, cfg, scene.device)
    if warm:
        img, stats = render_frame_stats(scene, cam, cfg, 0)
        if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
            raise SystemExit(f"[{label}] FAIL: warm frame is non-finite or black")
        if int(stats["segments"]) <= 0 or (nee and int(stats["shadow_segments"]) <= 0):
            raise SystemExit(f"[{label}] FAIL: no segments traced")
    torch.cuda.synchronize()
    set_counts_zero()
    t0 = time.perf_counter()
    iters = seg_total = shadow_total = syncs = 0
    for k in range(frames):
        with counting_syncs() as frame_syncs:
            img, stats = render_frame_stats(scene, cam, cfg, k + 1)
        syncs += len(frame_syncs)
        iters += stats["iters"]
        seg_total += int(stats["segments"])
        shadow_total += int(stats["shadow_segments"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    sched = stats["schedule"]
    want = ((ROUTE_KERNELS[route] if nee else ROUTE_KERNELS[route][:1]) + ("ks",)
            + (("k7",) if sched == "stream_fused" else ()))
    for kid in want:
        if counts[kid] < iters:
            raise SystemExit(f"[{label}] FAIL: {counts[kid]} {KERNELS[kid][0]} launches for {iters} iterations")
    shades = iters * (2 if cfg.seed_advance_quirk else 1)
    if counts["ks"] != shades:
        raise SystemExit(f"[{label}] FAIL: {counts['ks']} unit_sphere launches for {shades} calls of _shade")
    others = {KERNELS[kid][0]: c for kid, c in counts.items() if kid not in want and c}
    if others:
        raise SystemExit(f"[{label}] FAIL: other kernels launched: {others}")
    if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
        raise SystemExit(f"[{label}] FAIL: timed frame is non-finite or black")
    if seg_total <= 0 or (nee and shadow_total <= 0):
        raise SystemExit(f"[{label}] FAIL: no segments traced")
    launched = {KERNELS[kid][0]: counts[kid] for kid in want}
    rays = seg_total + shadow_total
    tiles = f" in tiles of {cfg.tile_pixels}" if 0 < cfg.tile_pixels < cfg.width * cfg.height else ""
    lanes = f", {resolve_stream_lanes(cfg, cfg.width * cfg.height)} lanes" if sched.startswith("stream") else ""
    print(f"[{label}] {scene.num_triangles} triangles, {scene.accel.num_clusters} clusters, {route} route"
          f"{', NEE' if nee else ''}, {sched} schedule{tiles}{lanes}; "
          f"{cfg.width}x{cfg.height} {cfg.samples_per_launch} spp depth {cfg.max_depth}: "
          f"{rays / dt / 1e6:.4f} Mrays/s (segments{' + shadow segments' if nee else ''}), "
          f"{dt / frames:.4f} s/launch, {seg_total // frames} segments/launch, "
          f"{shadow_total // frames} shadow segments/launch, {iters // frames} iterations/launch, "
          f"{syncs / iters:.4f} stream syncs per iteration, "
          f"launches {launched} in {frames} timed frames, mean {img.mean(dim=(0, 1)).tolist()} | {smi}")
    if image_path:
        rgb = to_uint8(post_process(img, cfg)).cpu().numpy()[::-1]
        with open(image_path, "wb") as f:
            f.write(b"P6 %d %d 255\n" % (cfg.width, cfg.height) + rgb.tobytes())
    return dict(counts=counts, img=img, iters=iters, segments=seg_total, seconds=dt / frames, schedule=sched,
                syncs=syncs)


def phase_parity(label, make_scene, camera, route, nee=False, **overrides):
    """128x96, 4 spp, 1024 lanes (or `overrides`) on the GPU (kernels) and
    the CPU (plain versions): SSIM after post_process above 0.995,
    segments (and shadow segments) within 0.5%."""
    cfg = RenderConfig(**{**HEADLINE, **(NEE if nee else {}), "width": 128, "height": 96,
                          "samples_per_launch": 4, "stream_lanes": 1024, **overrides})
    out = {}
    for dev in ("cuda", "cpu"):
        scene = make_scene(dev)
        if scene.accel.route(cfg) != route:
            raise SystemExit(f"[{label}] FAIL: scene routes to {scene.accel.route(cfg)}, not {route}")
        img, stats = render_frame_stats(scene, camera_arrays(camera, cfg, dev), cfg, 0)
        out[dev] = (post_process(img, cfg).cpu().numpy(), int(stats["segments"]), int(stats["shadow_segments"]),
                    stats["schedule"])
    (gpu, seg_gpu, sh_gpu, sched_gpu), (cpu, seg_cpu, sh_cpu, sched_cpu) = out["cuda"], out["cpu"]
    score = ssim(gpu, cpu)
    close = float(np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).mean())
    if not score > 0.995:
        raise SystemExit(f"[{label}] FAIL: GPU vs CPU SSIM {score:.6f} <= 0.995")
    if abs(seg_gpu - seg_cpu) > 0.005 * seg_cpu:
        raise SystemExit(f"[{label}] FAIL: segments {seg_gpu} on the GPU vs {seg_cpu} on the CPU")
    if nee and not (sh_cpu > 0 and abs(sh_gpu - sh_cpu) <= 0.005 * sh_cpu):
        raise SystemExit(f"[{label}] FAIL: shadow segments {sh_gpu} on the GPU vs {sh_cpu} on the CPU")
    print(f"[{label}] {route} route{', NEE' if nee else ''}, {cfg.width}x{cfg.height} {cfg.samples_per_launch} spp, "
          f"{resolve_stream_lanes(cfg, cfg.width * cfg.height)} lanes, schedule {sched_gpu} on the GPU and {sched_cpu} "
          f"on the CPU: GPU vs CPU SSIM {score:.6f}, {close:.4%} of values within rtol 1e-3/atol 1e-4, "
          f"segments {seg_gpu} vs {seg_cpu}" + (f", shadow segments {sh_gpu} vs {sh_cpu}" if nee else ""))
    return sched_gpu


def same_bits(a, b):
    """Equal bit for bit; NaN where the other has NaN."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32), torch.where(nan, 0.0, b).view(torch.int32))


def step_kw(cfg):
    spp = cfg.samples_per_launch
    return dict(spp=spp, n_pix=cfg.width * cfg.height, max_depth=cfg.max_depth,
                rr_reference=cfg.rr_mode == "reference", inv_spp=1.0 / spp)


def lane_state(scene, cfg, camera, iters, retiring=False):
    """The lane pool of the unfused stream after `iters` iterations (with
    `retiring`, and then as many more as it takes until the next step
    retires a pixel) and the payload of its next trace: (state, payload,
    head, the camera-path function)."""
    dev = scene.device
    lanes = resolve_stream_lanes(cfg, cfg.width * cfg.height)
    make_path = _camera_paths(camera_arrays(camera, cfg, dev), cfg, 0, 0)
    st = _stream_state(cfg, make_path, lambda slot: slot, lanes, dev)
    out = torch.zeros((cfg.width * cfg.height + 1, 3), device=dev)
    head = torch.tensor(lanes, dtype=torch.int64, device=dev)
    seg = torch.zeros((), dtype=torch.int64, device=dev)

    def trace():
        return _trace_bounce(scene, cfg, st["origin"], st["direction"], st["attenuation"], st["radiance"],
                             st["seeds"], st["depth"])

    def retires(tb):
        copy = {k: st[k].clone() for k in fs.STATE_KEYS}
        return int(fs.fused_stream_step_plain(tb, copy, out.clone(), head, seg, **step_kw(cfg))[1]) > int(head)

    tb = trace()
    for k in range(iters + (1000 if retiring else 0)):
        if k >= iters and retires(tb):
            break
        regen, head, seg, _ = fs.fused_stream_step_plain(tb, st, out, head, seg, **step_kw(cfg))
        _respawn(st, regen, make_path, cfg.samples_per_launch)
        tb = trace()
    return st, tb, head, make_path


def step_bytes(tb, st, regen, n_pix, spp, rr_reference):
    """Bytes the schedule step must move on this lane state, by what each
    lane's fate needs (the kernel reads and writes more: every lane's
    state): every lane reads its slot and writes its regen byte; a live
    lane reads the payload's seed, done flag, attenuation and radiance and
    writes its seed; a lane that goes on reads the payload's origin and
    direction and its depth, and writes origin, direction, attenuation,
    radiance and depth; a lane whose path ends reads and writes its pixel
    sum and sample count; one that respawns writes attenuation, radiance
    and depth; one whose pixel is done reads and writes its image row and
    writes slot and pix; head and segments are read and head, segments
    and the live count written once.  Returns (bytes, live lanes, pixels
    done)."""
    live = st["slot"] < n_pix
    _, newly, adv, _, _ = fs.roulette(tb, live, rr_reference)
    done = newly & (st["sample_i"] + newly.to(torch.int32) >= spp)
    n_live, n_adv, n_newly, n_regen, n_done = (int(m.sum()) for m in (live, adv, newly, regen, done))
    n_bytes = (live.shape[0] * (4 + 1) + n_live * (8 + 1 + 12 + 12 + 8) + n_adv * (24 + 4 + 48 + 4)
               + n_newly * 2 * (12 + 4) + n_regen * (24 + 4) + n_done * (2 * 12 + 4 + 4) + 5 * 8)
    return n_bytes, n_live, n_done


def _time_over(fn, inputs, device_only=False):
    """Mean ms of fn(x) over inputs[1:], after fn(inputs[0]) as warm-up:
    each call gets its own copy of a state that the call changes.  With
    device_only, the card first spins for ~20 ms while the host queues
    every call, so the events time the queued work back to back and not
    the host's launch rate."""
    fn(inputs[0])
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if device_only:
        torch.cuda._sleep(40_000_000)  # clock cycles
    start.record()
    for x in inputs[1:]:
        fn(x)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (len(inputs) - 1)


def parent_fused_step(parent_dir):
    """Kernel 7 as an older tree built it (`parent_dir`: the root of its
    checkout; the kernel of one thread a lane whose wrapper zeroes a
    scratch of 4 + blocks words each call), with the same wrapper:
    step(tb, st, out, head, segments, **step_kw)."""
    import ctypes
    from pathlib import Path

    src = Path(parent_dir) / "tpu_pathtracer_torch" / "csrc" / "fused_schedule.cu"
    lib_path = cuda_build.BUILD_DIR / "parent" / "fused_schedule.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_step_launch.argtypes = [p] * 21 + [i] * 5 + [ctypes.c_float, p]
    lib.fused_step_launch.restype = i

    def step(tb, st, out, head, segments, *, spp, n_pix, max_depth, rr_reference, inv_spp):
        lanes = st["slot"].shape[0]
        scratch = torch.zeros(4 + -(-lanes // 256), dtype=torch.int64, device=out.device)
        regen = torch.empty(lanes, dtype=torch.bool, device=out.device)
        err = lib.fused_step_launch(
            *(tb[k].data_ptr() for k in fs.TB_KEYS), *(st[k].data_ptr() for k in fs.STATE_KEYS),
            out.data_ptr(), head.data_ptr(), segments.data_ptr(), scratch.data_ptr(), regen.data_ptr(),
            lanes, spp, n_pix, max_depth, int(rr_reference), float(inv_spp),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"parent fused_step_kernel launch failed: CUDA error {err}")
        return regen, scratch[0], scratch[1], scratch[2]

    return step


# Kernel 7's pools: (name, the lanes' frame, pool size, unfused iterations
# before the step, and then more until a step retires pixels); the first,
# the headline's 131,072, is the main path's.
FUSED_POOLS = (("headline", HEADLINE, 131_072, 16), ("config 1", CONFIG1, 16_384, 16),
               ("headline", HEADLINE, 128, 16), ("headline", HEADLINE, 524_288, 16))


def phase_fused_kernel(label, scenes, smi, parent_dir=None):
    """Kernel 7 against its plain version on real lane states: the
    headline's at 131,072 lanes (the main path's pool), BASELINE config
    1's at its 16,384 and the headline's at 128 and 524,288 lanes; both
    rr_modes, the real head and one that sends lanes past n_pix; state,
    image, regen mask, head, segments and live count bit-equal.  Timed in
    reference mode at each pool with its bound (and, with `parent_dir`,
    the parent's kernel 7 on the same states, in turns); the plain version
    and the schedule tails at the main path's pool.  Then 32 consecutive
    fused steps (trace, kernel, respawn) on one never-cleared scratch,
    bit-equal to the plain version's at every step, and one step repeated
    4,200 times on one scratch, each launch equal to the plain version."""
    parent = parent_fused_step(parent_dir) if parent_dir else None
    numbers, lines = {}, []
    for pool, (name, frame, lanes, iters) in enumerate(FUSED_POOLS):
        for rr_mode in ("reference", "standard"):
            cfg = RenderConfig(**{**frame, "rr_mode": rr_mode, "stream_lanes": lanes})
            scene = scenes[name]
            st, tb, head, make_path = lane_state(scene, cfg, Camera(), iters, retiring=True)
            n_pix, spp, dev = cfg.width * cfg.height, cfg.samples_per_launch, scene.device
            kw = step_kw(cfg)
            seg = torch.tensor(12345, dtype=torch.int64, device=dev)

            def copy():
                return {k: st[k].clone() for k in fs.STATE_KEYS}

            probe = fs.fused_stream_step_plain(tb, copy(), torch.zeros((n_pix + 1, 3), device=dev), head, seg, **kw)
            done = int(probe[1]) - int(head)
            if not done:
                raise SystemExit(f"[{label}] FAIL: no pixel retires in the step at {lanes} lanes")
            past_total = 0
            # The real head, and one that sends the last (done + 1) // 2 retiring lanes past n_pix.
            for head_in in (head, torch.tensor(n_pix - done // 2, dtype=torch.int64, device=dev)):
                st_k, st_p = copy(), copy()
                out_k, out_p = (torch.zeros((n_pix + 1, 3), device=dev) for _ in range(2))
                got = fs.fused_stream_step_cuda(tb, st_k, out_k, head_in, seg, **kw)
                want = fs.fused_stream_step_plain(tb, st_p, out_p, head_in, seg, **kw)
                torch.cuda.synchronize()
                bad = [k for k in fs.STATE_KEYS if not same_bits(st_k[k], st_p[k])]
                bad += ["out"] * (not same_bits(out_k, out_p)) + ["regen"] * (not torch.equal(got[0], want[0]))
                bad += [w for w, a, b in zip(("head", "segments", "live"), got[1:], want[1:]) if int(a) != int(b)]
                if bad:
                    raise SystemExit(f"[{label}] FAIL: fused_step ({rr_mode}, {lanes} lanes) and its plain version "
                                     f"differ in {bad}")
                past = int((st_k["slot"] >= n_pix).sum()) - int((st["slot"] >= n_pix).sum())
                past_total += past
                lines.append(f"{name} {lanes} lanes {rr_mode} head {int(head_in)}: {done} retired, {past} past n_pix, "
                             f"{int(got[0].sum())} regen, {int(got[3])} live")
            if not past_total:
                raise SystemExit(f"[{label}] FAIL: no lane retired past n_pix at {lanes} lanes")
            if rr_mode != "reference":
                continue
            out_k = torch.zeros((n_pix + 1, 3), device=dev)

            def kernel(s):
                fs.fused_stream_step_cuda(tb, s, out_k, head, seg, **kw)

            order = ("parent", "kernel", "kernel", "parent") if parent else ("kernel",)
            times = {"parent": [], "kernel": []}
            for who in order:
                fn = kernel if who == "kernel" else (lambda s: parent(tb, s, out_k, head, seg, **kw))
                times[who].append(_time_over(fn, [copy() for _ in range(21)], device_only=True))
            ms = sum(times["kernel"]) / len(times["kernel"])
            n_bytes, n_live, n_done = step_bytes(tb, st, probe[0], n_pix, spp, True)
            flops = 15 * n_live + 6 * n_done  # RR draw and estimator per live lane; the mean and the add per pixel done
            t_ops, t_bytes = flops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
            row = dict(max_abs_err=0.0, ms=ms, bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None)
            timing = (f"{name} {lanes} lanes, tiles of {fs.TILE_LANES}: kernel "
                      f"{' '.join(f'{t:.4f}' for t in times['kernel'])} ms"
                      + (f", parent {' '.join(f'{t:.4f}' for t in times['parent'])} ms" if parent else "")
                      + f"; {n_live} live lanes, {n_done} pixels done, {n_bytes} bytes the step must move, "
                        f"{flops} FLOP: bound {row['bound_ms']:.4f} ms by {row['bound_by']}")
            if pool < 2:  # the headline's and config 1's pools
                row["plain_ms"] = _time_over(lambda s: fs.fused_stream_step_plain(tb, s, out_k, head, seg, **kw),
                                             [copy() for _ in range(6)])
                timing += f"; plain {row['plain_ms']:.4f} ms"
            if pool == 0:
                def unfused_tail(s):
                    _respawn(s, fs.fused_stream_step_plain(tb, s, out_k, head, seg, **kw)[0], make_path, spp)

                def fused_tail(s):
                    _respawn(s, fs.fused_stream_step_cuda(tb, s, out_k, head, seg, **kw)[0], make_path, spp)

                timing += (f"; unfused schedule tail (plain step and respawn, eager) "
                           f"{_time_over(unfused_tail, [copy() for _ in range(6)]):.4f} ms, fused tail (kernel + "
                           f"respawn) {_time_over(fused_tail, [copy() for _ in range(6)]):.4f} ms")
                numbers = row
                steps_line = (fused_steps(label, scene, cfg, st, head, make_path) + "; "
                              + lookback_repeats(label, tb, st, head, seg, kw, n_pix))
            print(f"[{label}] fused_step timing: {timing} | {smi}")
    print(f"[{label}] fused_step: bit-equal (0 ulp) in state, image, regen mask, head, segments and live count: "
          f"{'; '.join(lines)}; {steps_line} | {smi}")
    return numbers


def fused_steps(label, scene, cfg, st, head, make_path, steps=32):
    """`steps` consecutive fused steps from lane state `st`: trace, the
    kernel on one copy and the plain version on another, respawn both;
    the two stay bit-equal, with the kernel's scratch never cleared."""
    kw, n_pix, dev = step_kw(cfg), cfg.width * cfg.height, scene.device
    st_k = {k: st[k].clone() for k in fs.STATE_KEYS}
    st_p = {k: st[k].clone() for k in fs.STATE_KEYS}
    out_k, out_p = (torch.zeros((n_pix + 1, 3), device=dev) for _ in range(2))
    head_k = head_p = head
    seg_k = seg_p = torch.zeros((), dtype=torch.int64, device=dev)
    retired = 0
    for step in range(steps):
        tb = _trace_bounce(scene, cfg, st_k["origin"], st_k["direction"], st_k["attenuation"], st_k["radiance"],
                           st_k["seeds"], st_k["depth"])
        regen_k, head_k2, seg_k, live_k = fs.fused_stream_step_cuda(tb, st_k, out_k, head_k, seg_k, **kw)
        regen_p, head_p, seg_p, live_p = fs.fused_stream_step_plain(tb, st_p, out_p, head_p, seg_p, **kw)
        retired += int(head_k2) - int(head_k)
        head_k = head_k2
        _respawn(st_k, regen_k, make_path, cfg.samples_per_launch)
        _respawn(st_p, regen_p, make_path, cfg.samples_per_launch)
        torch.cuda.synchronize()
        bad = [k for k in fs.STATE_KEYS if not same_bits(st_k[k], st_p[k])]
        bad += ["out"] * (not same_bits(out_k, out_p)) + ["regen"] * (not torch.equal(regen_k, regen_p))
        bad += [w for w, a, b in zip(("head", "segments", "live"), (head_k, seg_k, live_k), (head_p, seg_p, live_p))
                if int(a) != int(b)]
        if bad:
            raise SystemExit(f"[{label}] FAIL: fused step {step + 1} of {steps} differs from the plain version in {bad}")
    return (f"{steps} consecutive steps at {st['slot'].shape[0]} lanes (trace, kernel, respawn) on one scratch "
            f"bit-equal, {retired} pixels retired")


def lookback_repeats(label, tb, st, head, seg, kw, n_pix, launches=4200):
    """The same step launched `launches` times on one never-cleared
    scratch, more than the 4,095 tags a status word cycles through, each
    launch from a fresh copy of lane state `st`: every launch's new slots,
    regen mask, head', segments' and live count equal the plain
    version's.  The tiles start in whatever order the card runs them, so
    a race in the look-back shows as a launch that differs."""
    st_k = {k: st[k].clone() for k in fs.STATE_KEYS}
    st_p = dict(st_k)  # the plain version rebinds its entries and leaves st_k's tensors alone
    want = fs.fused_stream_step_plain(tb, st_p, torch.zeros((n_pix + 1, 3), device=seg.device), head, seg, **kw)
    out_k = torch.zeros((n_pix + 1, 3), device=seg.device)
    bad = torch.zeros((), dtype=torch.int64, device=seg.device)
    for _ in range(launches):
        for k in fs.STATE_KEYS:
            st_k[k].copy_(st[k])
        regen, head2, seg2, live2 = fs.fused_stream_step_cuda(tb, st_k, out_k, head, seg, **kw)
        bad += (st_k["slot"] != st_p["slot"]).sum() + (regen != want[0]).sum()
        bad += (head2 != want[1]).long() + (seg2 != want[2]).long() + (live2 != want[3]).long()
    if int(bad):
        raise SystemExit(f"[{label}] FAIL: {int(bad)} values differ over {launches} repeats of one fused step")
    return f"one step {launches} times on one scratch, every launch equal to the plain version"


def phase_fused_render(label, scene, cfg, camera, smi):
    """The same subframe fused and unfused, one timed frame each: images
    bit-equal, iterations and segments identical."""
    fused = phase_render(f"{label} fused", scene, cfg.replace(fused_schedule="on"), camera, 1, smi, warm=False)
    unfused = phase_render(f"{label} unfused", scene, cfg.replace(fused_schedule="off"), camera, 1, smi, warm=False)
    if not torch.equal(fused["img"], unfused["img"]):
        bad = int((fused["img"] != unfused["img"]).sum())
        raise SystemExit(f"[{label}] FAIL: fused and unfused images differ on {bad} values")
    if (fused["iters"], fused["segments"]) != (unfused["iters"], unfused["segments"]):
        raise SystemExit(f"[{label}] FAIL: iterations/segments {fused['iters']}/{fused['segments']} fused vs "
                         f"{unfused['iters']}/{unfused['segments']} unfused")
    print(f"[{label}] fused and unfused images bit-equal, {fused['iters']} iterations and {fused['segments']} "
          f"segments each; s/launch fused {fused['seconds']:.4f} vs unfused {unfused['seconds']:.4f} | {smi}")
    return fused["counts"]["k7"]


# ---------------------------------------------------------------------------
# Phases 24-28: the user's entry points (scene files and cache, the CLI,
# the progressive renderer, AOVs and denoise, the viewer)

# The hero stand-in's rounded box: a superellipsoid of HERO_GRID stacks x
# slices (2 x 25 x 44 = 2,200 triangles, the reference's suitcase.obj has
# 2,204 faces), half-extent 20 so that the scene file's scale 0.05 makes
# it 2 units; its maps 2048x2048.  The reference ships three maps for it
# (its albedo is missing, SURVEY.md's asset table): a fourth 2048x2048
# map with test.obj's three 512x512 ones would pass the 2^24 texels a
# pool may hold (scene.make_material_table), in the JAX package too.
HERO_GRID = (25, 44)
HERO_MAPS = ("roughness", "metallic", "normal")
HERO_MAP_SIZE = 2048
TEST_MAPS = ("albedo", "roughness", "normal")
TEST_MAP_SIZE = 512


def map_pattern(rs, size, kind):
    """A seeded [size,size,3] uint8 map: bands and noise (normal maps near
    +z)."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    fx, fy = rs.uniform(2.0, 9.0, 2)
    base = 0.5 + 0.3 * np.sin(2 * np.pi * fx * x) * np.cos(2 * np.pi * fy * y)
    img = base[..., None] * rs.uniform(0.5, 1.0, 3).astype(np.float32) + 0.1 * rs.rand(size, size, 3)
    if kind == "normal":
        img = np.concatenate([0.5 + 0.2 * (img[..., :2] - 0.5), np.ones((size, size, 1), np.float32)], axis=-1)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_obj(path, v, vt, vn, faces):
    """OBJ text: v, vt (optional), vn and triangles of shared 0-based ids."""
    with open(path, "w") as f:
        np.savetxt(f, v, fmt="v %.9g %.9g %.9g")
        if vt is not None:
            np.savetxt(f, vt, fmt="vt %.9g %.9g")
        np.savetxt(f, vn, fmt="vn %.9g %.9g %.9g")
        ids = np.asarray(faces, np.int64) + 1
        if vt is not None:
            np.savetxt(f, np.repeat(ids, 3, axis=1), fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
        else:
            np.savetxt(f, np.repeat(ids, 2, axis=1), fmt="f %d//%d %d//%d %d//%d")


def write_hero(root):
    """The hero stand-in under `root`: suitcase.obj (the rounded box) and
    its maps, test.obj (a 12-triangle cube) and its maps, and hero.toml,
    scenes/suitcase.toml with these two objects.  Returns the toml's path."""
    rs = np.random.RandomState(0)
    stacks, slices = HERO_GRID
    phi = np.pi * np.arange(stacks + 1) / stacks
    theta = 2 * np.pi * np.arange(slices + 1) / slices
    n = np.stack(np.broadcast_arrays(np.sin(phi)[:, None] * np.cos(theta), np.cos(phi)[:, None],
                                     np.sin(phi)[:, None] * np.sin(theta)), -1).reshape(-1, 3)
    p = np.sign(n) * np.abs(n) ** 0.3                        # a superellipsoid: the rounded box
    g = np.sign(p) * np.abs(p) ** (2 / 0.3 - 1)              # its surface's gradient
    vn = g / np.linalg.norm(g, axis=1, keepdims=True)
    v = p * 20.0 + [0.0, 20.0, 0.0]
    vt = np.stack(np.broadcast_arrays(np.arange(slices + 1) / slices,
                                      1.0 - np.arange(stacks + 1)[:, None] / stacks), -1).reshape(-1, 2)
    a = (np.arange(stacks)[:, None] * (slices + 1) + np.arange(slices)).reshape(-1)
    b = a + slices + 1
    faces = np.concatenate([np.stack([a, b, a + 1], 1), np.stack([a + 1, b, b + 1], 1)])
    write_obj(root / "suitcase.obj", v, vt, vn, faces)
    # test.obj: a cube of 6 faces x 2 triangles, 10 units a side, at (-30, 0, 0)
    cv, cvt, cvn, cf = [], [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u, w = [k for k in range(3) if k != axis]
            for du, dw in ((0, 0), (1, 0), (1, 1), (0, 1)):
                q = np.zeros(3)
                q[axis], q[u], q[w] = (sign + 1) / 2, du, dw
                cv.append(q * 10.0 + [-35.0, 0.0, -5.0])
                cvt.append((du, dw))
                cvn.append(np.eye(3)[axis] * sign)
            k = len(cv) - 4
            cf += [(k, k + 1, k + 2), (k, k + 2, k + 3)]
    write_obj(root / "test.obj", np.array(cv), np.array(cvt, float), np.array(cvn), cf)
    for stem, kinds, size in (("suitcase", HERO_MAPS, HERO_MAP_SIZE), ("test", TEST_MAPS, TEST_MAP_SIZE)):
        for kind in kinds:
            save_png(str(root / f"{stem}_{kind}.png"), map_pattern(rs, size, kind))
    toml = (REPO / "scenes" / "suitcase.toml").read_text()
    start = toml.index("objects = ")
    toml = toml[:start] + 'objects = ["suitcase.obj", "test.obj"]' + toml[toml.index("\n", start):]
    (root / "hero.toml").write_text(toml)
    return root / "hero.toml"


def write_config4(root):
    """BASELINE config 4's stand-in, high_poly_scene(100_000)'s triangles,
    as config4.obj (v, vn, f)."""
    s = high_poly_scene(total_tris=100_000, device="cpu")
    v = s.vertices.numpy().reshape(-1, 3)
    write_obj(root / "config4.obj", v, None, s.normals.numpy().reshape(-1, 3), np.arange(len(v)).reshape(-1, 3))
    return root / "config4.obj"


@contextlib.contextmanager
def watching_launches():
    """While open, every launch the progressive renderer renders is
    recorded: its schedule's stats and the stream syncs it made."""
    real, log = progressive.render_frame, []

    def watched(scene, cam, cfg, subframe):
        with counting_syncs() as syncs:
            img, stats = render_frame_stats(scene, cam, cfg, subframe)
        log.append(dict(stats, segments=int(stats["segments"]), shadow_segments=int(stats["shadow_segments"]),
                        syncs=len(syncs)))
        return img

    progressive.render_frame = watched
    try:
        yield log
    finally:
        progressive.render_frame = real


def phase_scene_files(label, root, smi):
    """Write the hero stand-in and config 4's OBJ, then load each through
    the packed-scene cache cold and warm (the hero through its scene
    file): seconds of each step, triangles, clusters, and the native
    parser used for every OBJ of a cold load."""
    t0 = time.perf_counter()
    hero, obj4 = write_hero(root), write_config4(root)
    written = time.perf_counter() - t0
    cache_dir = str(root / "cache")
    loads = (
        ("hero", 2, lambda t: load_scene_file(str(hero), device="cuda", cache_dir=cache_dir, timings=t)[0]),
        ("config 4", 1, lambda t: load_scene_cached([str(obj4)], accel="cluster", device="cuda", cache_dir=cache_dir,
                                                    timings=t)),
    )
    parts = []
    for name, n_objs, load in loads:
        for want in ("miss", "hit"):
            before, timings = native.used_native(), {}
            t1 = time.perf_counter()
            scene = load(timings)
            torch.cuda.synchronize()
            total = time.perf_counter() - t1
            parsed = native.used_native() - before
            if timings["cache"] != want:
                raise SystemExit(f"[{label}] FAIL: {name} load was a cache {timings['cache']}, not a {want}")
            if want == "miss" and parsed != n_objs:
                raise SystemExit(f"[{label}] FAIL: the native OBJ parser served {parsed} of {n_objs} files")
            steps = ", ".join(f"{k} {v:.4f} s" for k, v in timings.items() if k != "cache")
            parts.append(f"{name} {want}: {total:.4f} s ({steps}), native parser {parsed} files")
        m = scene.materials
        parts.append(f"{name}: {scene.num_triangles} triangles, {scene.accel.num_clusters} clusters, "
                     f"{m.num_materials} materials, {m.texture_quads.shape[0]} texels, bundled {m.bundled}")
    print(f"[{label}] wrote the scenes in {written:.2f} s; " + "; ".join(parts) + f" | {smi}")
    return hero, obj4


def cli_launches(label, argv):
    """cli.run(argv) with every launch count set to 0 just before and read
    just after, and every launch recorded: (renderer, counts, launch log)."""
    set_counts_zero()
    with watching_launches() as log:
        renderer = cli.run([str(a) for a in argv])
    torch.cuda.synchronize()
    counts = read_counts()
    return renderer, counts, log


def check_launches(label, counts, log, want, extra=0):
    """Each kernel of `want` launched at least once per iteration (plus
    `extra`, the AOV passes'), the sampler once per iteration, nothing
    else."""
    iters = sum(entry["iters"] for entry in log)
    for kid in want:
        if counts[kid] < iters + (extra if kid in ("k1", "k2", "k3") else 0):
            raise SystemExit(f"[{label}] FAIL: {counts[kid]} {KERNELS[kid][0]} launches for {iters} iterations")
    if counts["ks"] != iters:
        raise SystemExit(f"[{label}] FAIL: {counts['ks']} unit_sphere launches for {iters} iterations")
    others = {KERNELS[kid][0]: c for kid, c in counts.items() if kid not in want + ("ks",) and c}
    if others:
        raise SystemExit(f"[{label}] FAIL: other kernels launched: {others}")
    return iters


def phase_cli_hero(label, hero, root, smi):
    """The CLI at the reference's defaults on the hero stand-in's scene
    file: 1600x1200, 30 spp in launches of 10, depth 20, DOF on, the
    cluster accel, denoised, with AOVs and a checkpoint; then a resume
    for a fourth launch, bit-equal to an uninterrupted four-launch run."""
    out, ck, prefix = root / "hero.png", root / "hero_ck.npz", root / "hero"
    r, counts, log = cli_launches(label, ["--scene-file", hero, "--file", out, "--spp", "30", "--denoise",
                                          "--aov-prefix", prefix, "--checkpoint", ck, "--no-scene-cache"])
    cfg = r.cfg
    if (cfg.width, cfg.height, cfg.samples_per_launch, cfg.max_depth, cfg.dof) != (1600, 1200, 10, 20, True):
        raise SystemExit(f"[{label}] FAIL: not the reference's defaults: {cfg}")
    route = r.scene.accel.route(cfg)
    if route != "flat" or {e["schedule"] for e in log} != {"stream_fused"} or not r.subframe == len(log) == 3:
        raise SystemExit(f"[{label}] FAIL: route {route}, schedules {[e['schedule'] for e in log]}, {r.subframe} launches")
    # The AOV pass runs twice (the denoiser's guide, the AOV files): kernel 1 on its centre rays.
    iters = check_launches(label, counts, log, ("k1", "k7"), extra=2)
    img = load_png(str(out))
    aovs = [load_png(f"{prefix}_{k}.png").shape for k in ("normal", "depth", "albedo")]
    if img.shape != (1200, 1600, 3) or not img.mean() > 0 or aovs != [img.shape] * 3:
        raise SystemExit(f"[{label}] FAIL: output {img.shape}, mean {img.mean()}, AOVs {aovs}")
    if not bool(torch.isfinite(r.accum).all()) or not float(r.accum.max()) > 0.0:
        raise SystemExit(f"[{label}] FAIL: the accumulation is non-finite or black")
    resumed, _, _ = cli_launches(label, ["--scene-file", hero, "--file", root / "hero4.png", "--spp", "40",
                                         "--checkpoint", ck, "--resume", "--no-scene-cache"])
    whole, _, _ = cli_launches(label, ["--scene-file", hero, "--file", root / "hero4u.png", "--spp", "40",
                                       "--no-scene-cache"])
    if resumed.subframe != 4 or not torch.equal(resumed.accum, whole.accum):
        raise SystemExit(f"[{label}] FAIL: the resumed fourth launch differs from an uninterrupted run")
    print(f"[{label}] {r.scene.num_triangles} triangles, {r.scene.accel.num_clusters} clusters, {route} route, "
          f"stream_fused, {cfg.width}x{cfg.height} {cfg.samples_per_launch} spp depth {cfg.max_depth} DOF, 3 launches: "
          f"s/launch {' '.join(f'{t:.4f}' for t in r.frame_times)}; {iters} iterations, "
          f"{sum(e['segments'] for e in log)} segments, "
          f"{sum(e['syncs'] for e in log) / iters:.4f} stream syncs per iteration; launches cluster_intersect "
          f"{counts['k1']}, fused_step {counts['k7']}, unit_sphere {counts['ks']}; out {img.shape}, mean "
          f"{img.mean():.4f}; resumed fourth launch bit-equal to an uninterrupted 4-launch run "
          f"(s/launch {' '.join(f'{t:.4f}' for t in whole.frame_times)}) | {smi}")
    return counts


def phase_cli_config4(label, obj4, root, smi):
    """The CLI on config 4's OBJ at 1920x1080, 10 spp, depth 8, no DOF:
    one warm launch and one timed, without and with --nee; the two-level
    route (kernel 2; kernel 5 under NEE; kernel 7 without)."""
    out = {}
    for nee in (False, True):
        argv = ["--scene", obj4, "--eye", "0,3,10", "--lookat", "0,1,0", "--dim", "1920x1080", "--max-depth", "8",
                "--no-dof", "--spp", "20", "--no-scene-cache", "--file", root / f"config4_{int(nee)}.png"]
        r, counts, log = cli_launches(label, argv + (["--nee"] if nee else []))
        if len(log) != 2:
            raise SystemExit(f"[{label}] FAIL: {len(log)} launches, not 2")
        acc = r.scene.accel
        route, rows = acc.route(r.cfg), acc.tris16bw.numel() * 4
        if route != "hier" or acc.num_clusters != 766 or rows != 6_275_072:
            raise SystemExit(f"[{label}] FAIL: route {route}, {acc.num_clusters} clusters, {rows} bytes of rows")
        want = ("k2", "k5") if nee else ("k2", "k7")
        iters = check_launches(label, counts, log, want)
        if not log[1]["segments"] > 0 or (nee and not log[1]["shadow_segments"] > 0):
            raise SystemExit(f"[{label}] FAIL: no segments traced")
        out["nee" if nee else "plain"] = counts
        print(f"[{label}{' NEE' if nee else ''}] {r.scene.num_triangles} triangles, {acc.num_clusters} clusters, "
              f"{rows} bytes of rows, {route} route, {log[1]['schedule']} schedule, 1920x1080 10 spp depth 8: "
              f"s/launch warm {r.frame_times[0]:.4f}, timed {r.frame_times[1]:.4f}; {iters} iterations in 2 launches, "
              f"{sum(e['syncs'] for e in log) / iters:.4f} stream syncs per iteration; launches cluster_hier "
              f"{counts['k2']}, cluster_occluded_hier {counts['k5']}, fused_step {counts['k7']} | {smi}")
    return out


def phase_parity_textured(label, root, smi):
    """The CPU tests' 64x48 textured, glass and emissive scene, two launches
    through ProgressiveRenderer on the card and on the CPU: SSIM after
    post_process above 0.995, segments within 0.5%; the AOVs' hit and mat
    exact, normal, depth and albedo within rtol 1e-5 / atol 1e-5."""
    d = root / "parity"
    d.mkdir()
    paths = [write_mtl_scene(str(d), tex=16)]
    cfg = RenderConfig(width=64, height=48, samples_per_launch=2, max_depth=4, dof=True, dof_blurriness=0.05,
                       env_mode="equirect", intersector="cluster")
    cam = Camera(eye=(0.0, 2.0, 5.0), lookat=(0.0, 0.6, 0.0))
    out = {}
    for dev in ("cuda", "cpu"):
        scene = load_scene(paths, env=make_env(procedural_hdr(32, 64), dev), material_source="mtl", accel="cluster",
                           device=dev)
        with watching_launches() as log:
            r = ProgressiveRenderer(scene, cam, cfg)
            r.step()
            r.step()
        aov = {k: v.cpu().numpy() for k, v in render_aov(scene, r._cam_arrays, cfg).items()}
        out[dev] = (post_process(r.accum, cfg).cpu().numpy(), sum(e["segments"] for e in log), aov)
    (gpu, seg_gpu, g_aov), (cpu, seg_cpu, c_aov) = out["cuda"], out["cpu"]
    score = ssim(gpu, cpu)
    if not score > 0.995:
        raise SystemExit(f"[{label}] FAIL: GPU vs CPU SSIM {score:.6f} <= 0.995")
    if abs(seg_gpu - seg_cpu) > 0.005 * seg_cpu:
        raise SystemExit(f"[{label}] FAIL: segments {seg_gpu} on the GPU vs {seg_cpu} on the CPU")
    for k in ("hit", "mat"):
        if not np.array_equal(g_aov[k], c_aov[k]):
            raise SystemExit(f"[{label}] FAIL: AOV {k} differs on {int((g_aov[k] != c_aov[k]).sum())} pixels")
    errs = {}
    for k in ("normal", "depth", "albedo"):
        if not np.allclose(g_aov[k], c_aov[k], rtol=1e-5, atol=1e-5):
            raise SystemExit(f"[{label}] FAIL: AOV {k} beyond rtol 1e-5 / atol 1e-5")
        errs[k] = float(np.abs(g_aov[k] - c_aov[k]).max())
    print(f"[{label}] textured, glass and emissive scene, 64x48, 2 launches of 2 spp, DOF: GPU vs CPU SSIM "
          f"{score:.6f}, segments {seg_gpu} vs {seg_cpu}; AOV hit and mat exact ({int(g_aov['hit'].sum())} hits, "
          f"materials {sorted(set(np.unique(g_aov['mat']).tolist()))}), max abs differences "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" | {smi}")
    return paths


def phase_viewer(label, paths, smi):
    """The viewer on a renderer on the card, on a free localhost port:
    every endpoint answers 200, /frame.png decodes with the port's codec,
    /resize changes the frame's size; then the server and its render
    thread stop."""
    import urllib.request

    scene = load_scene(paths, env=make_env(procedural_hdr(32, 64), "cuda"), material_source="mtl", accel="cluster",
                       device="cuda")
    cfg = RenderConfig(width=320, height=240, samples_per_launch=2, max_depth=4, dof=False, env_mode="equirect")
    renderer = ProgressiveRenderer(scene, Camera(eye=(0.0, 2.0, 5.0), lookat=(0.0, 0.6, 0.0)), cfg)
    httpd, stop = serve(renderer, port=0, block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    got = []

    def get(path):
        t0 = time.perf_counter()
        with urllib.request.urlopen(base + path, timeout=120) as resp:
            if resp.status != 200:
                raise SystemExit(f"[{label}] FAIL: {path} answered {resp.status}")
            body = resp.read()
        got.append(f"{path.split('?')[0]} {1e3 * (time.perf_counter() - t0):.1f} ms")
        return body

    try:
        before = decode_png(get("/frame.png")).shape
        stats = json.loads(get("/stats"))
        for path in ("/orbit?dyaw=10&dpitch=5", "/zoom?f=0.9", "/pan?dx=0.1&dy=0.05", "/toggle_dof",
                     "/resize?w=160&h=96"):
            get(path)
        after = decode_png(get("/frame.png")).shape
    finally:
        stop.set()
        httpd.shutdown()
        httpd.server_close()
        for t in threading.enumerate():
            if t.name == "viewer-render":
                t.join(timeout=120)
        torch.cuda.synchronize()
    if before != (240, 320, 3) or after != (96, 160, 3):
        raise SystemExit(f"[{label}] FAIL: frame {before} before /resize, {after} after")
    print(f"[{label}] 200 from every endpoint ({', '.join(got)}); frame {before} -> {after} after /resize; "
          f"stats keys {sorted(stats)}; accumulation on {renderer.accum.device} | {smi}")


# ---------------------------------------------------------------------------
# Sharding, deferred shading and the oracle (phases 29-32)
# ---------------------------------------------------------------------------

SHARD_TOLERANCE = dict(rtol=2e-4, atol=2e-5)  # sample sharding: the JAX package's tests/test_parallel.py


def timed(fn):
    """(fn()'s result, its seconds, the launch counts it made): counts set
    to 0 just before, read just after, the device synchronised at both
    ends."""
    torch.cuda.synchronize()
    set_counts_zero()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts()


def check_kernels(label, counts, want):
    """Each kernel of `want` and the sampler launched, no other kernel."""
    for kid in want + ("ks",):
        if not counts[kid]:
            raise SystemExit(f"[{label}] FAIL: {KERNELS[kid][0]} never launched")
    extra = {KERNELS[kid][0]: c for kid, c in counts.items() if c and kid not in want + ("ks",)}
    if extra:
        raise SystemExit(f"[{label}] FAIL: other kernels launched: {extra}")


def launched(counts):
    return ", ".join(f"{KERNELS[kid][0]} {n}" for kid, n in counts.items() if n)


def phase_shard_one(label, scene, cfg, smi):
    """A NCCL group of one rank on the card: the headline (1080p, 10 spp,
    depth 8) sharded by pixels and by samples.  Pixels must equal this
    process's render_frame bit for bit, samples within rtol 2e-4 / atol
    2e-5; s/launch of each beside the unsharded frame's.  Pixel sharding
    passes an affine range, which takes the unfused stream (kernel 1, not
    kernel 7); sample sharding renders the whole frame (fused stream)."""
    initialize_distributed("cuda", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        backend, mesh = dist.get_backend(), make_mesh()
        # The communicator is set up at its first collective: outside the timed frames.
        dist.all_reduce(torch.ones(1, device="cuda"))
        cam = camera_arrays(Camera(), cfg, "cuda")
        single, t_single, c_single = timed(lambda: render_frame(scene, cam, cfg, 1))
        pixels, t_pixels, c_pixels = timed(lambda: render_frame_sharded(scene, cam, cfg, 1, mesh, mode="pixels"))
        samples, t_samples, c_samples = timed(lambda: render_frame_sharded(scene, cam, cfg, 1, mesh, mode="samples"))
    finally:
        dist.destroy_process_group()
    if backend != "nccl":
        raise SystemExit(f"[{label}] FAIL: the group of one on the card talks {backend}, not NCCL")
    if not bool(torch.isfinite(single).all()) or not float(single.max()) > 0.0:
        raise SystemExit(f"[{label}] FAIL: the unsharded frame is non-finite or black")
    if not same_bits(pixels, single):
        raise SystemExit(f"[{label}] FAIL: pixel-sharded frame differs from render_frame on "
                         f"{int((pixels != single).sum())} values")
    if not torch.allclose(samples, single, **SHARD_TOLERANCE):
        raise SystemExit(f"[{label}] FAIL: sample-sharded frame beyond rtol 2e-4 / atol 2e-5: "
                         f"max abs difference {float((samples - single).abs().max())}")
    check_kernels(label, c_single, ("k1", "k7"))
    check_kernels(label, c_pixels, ("k1",))
    check_kernels(label, c_samples, ("k1", "k7"))
    print(f"[{label}] NCCL group of one, 1920x1080 10 spp depth 8: pixels bit-equal to render_frame, samples max "
          f"abs difference {float((samples - single).abs().max()):.3g} (rtol 2e-4 / atol 2e-5); s/launch unsharded "
          f"{t_single:.4f}, pixels {t_pixels:.4f}, samples {t_samples:.4f}; launches unsharded: {launched(c_single)}; "
          f"pixels: {launched(c_pixels)}; samples: {launched(c_samples)} | {smi}")
    return c_pixels


SHARD_WORLD = 2
SHARD_CASES = ("plain", "nee")


def shard_worker(port, rank, out):
    """One of phase 30's ranks (chip_smoke.py --shard-worker PORT RANK OUT):
    a gloo group of SHARD_WORLD processes, every rank on cuda:0.  Renders
    the headline at 320x240, 10 spp, depth 8, without and with NEE, sharded
    by pixels and by samples (launch counts set to 0 before each and read
    after), rank 0 also unsharded, and writes OUT.<rank>.npz."""
    dev = initialize_distributed("cuda", backend="gloo", init_method=f"tcp://localhost:{port}",
                                 world_size=SHARD_WORLD, rank=rank)
    res = {}
    try:
        mesh, scene = make_mesh(), headline_scene(dev)
        for case in SHARD_CASES:
            cfg = RenderConfig(**{**HEADLINE, **(NEE if case == "nee" else {}), "width": 320, "height": 240})
            cam = camera_arrays(Camera(), cfg, dev)
            for mode in ("pixels", "samples"):
                img, dt, counts = timed(lambda: render_frame_sharded(scene, cam, cfg, 1, mesh, mode=mode))
                res[f"{case}_{mode}"] = img.cpu().numpy()
                res[f"{case}_{mode}_seconds"] = dt
                res[f"{case}_{mode}_counts"] = np.array([counts[kid] for kid in KERNELS])
            if rank == 0:
                res[f"{case}_single"] = render_frame(scene, cam, cfg, 1).cpu().numpy()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(f"{out}.{rank}.npz", **res)
    return 0


def phase_shard_two(label, root, paths, smi):
    """Two ranks on the one card over gloo (shard_worker, in processes of
    their own): pixels bit-equal to render_frame, samples within rtol 2e-4
    / atol 2e-5, both ranks holding the same frame, the route's kernels
    launched (kernel 4 under NEE).  Then the CLI on phase 27's textured
    scene (its OBJ takes the cluster accel) with --shard pixels (a group
    of one) against --shard none: the same PNG bytes."""
    port, out = free_port(), root / "shard"
    procs = [subprocess.Popen([sys.executable, __file__, "--shard-worker", str(port), str(rank), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(SHARD_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"[{label}] FAIL: rank {rank} exited {p.returncode}:\n{log[-4000:]}")
    ranks = [dict(np.load(f"{out}.{rank}.npz")) for rank in range(SHARD_WORLD)]
    parts = []
    for case in SHARD_CASES:
        single = ranks[0][f"{case}_single"]
        for mode in ("pixels", "samples"):
            key = f"{case}_{mode}"
            img = ranks[0][key]
            if any(not np.array_equal(r[key], img) for r in ranks[1:]):
                raise SystemExit(f"[{label}] FAIL: the ranks hold different {key} frames")
            if mode == "pixels" and not np.array_equal(img.view(np.int32), single.view(np.int32)):
                raise SystemExit(f"[{label}] FAIL: {key} differs from render_frame on {int((img != single).sum())} values")
            if mode == "samples" and not np.allclose(img, single, **SHARD_TOLERANCE):
                raise SystemExit(f"[{label}] FAIL: {key} beyond rtol 2e-4 / atol 2e-5")
            for rank, r in enumerate(ranks):
                counts = dict(zip(KERNELS, r[f"{key}_counts"].tolist()))
                want = ("k1", "k4") if case == "nee" else ("k1", "k7") if mode == "samples" else ("k1",)
                check_kernels(f"{label} rank {rank} {key}", counts, want)
            secs = " ".join(f"{float(r[key + '_seconds']):.4f}" for r in ranks)
            rank0 = launched(dict(zip(KERNELS, ranks[0][key + "_counts"].tolist())))
            parts.append(f"{key}: {secs} s ({rank0} on rank 0)")
    argv = ["--scene", *paths, "--materials", "mtl", "--eye", "0,2,5", "--lookat", "0,0.6,0", "--dim", "320x240",
            "-s", "10", "--spp", "10", "--max-depth", "8", "--no-dof", "--no-scene-cache", "--verbosity", "2"]
    sharded, t_sharded, c_sharded = timed(lambda: cli.run(argv + ["--shard", "pixels", "--file", str(root / "s.png")]))
    plain, t_plain, _ = timed(lambda: cli.run(argv + ["--file", str(root / "n.png")]))
    if (root / "s.png").read_bytes() != (root / "n.png").read_bytes():
        raise SystemExit(f"[{label}] FAIL: the CLI's --shard pixels PNG differs from --shard none's")
    if sharded.mesh is None or sharded.mesh.size != 1 or dist.is_initialized():
        raise SystemExit(f"[{label}] FAIL: the CLI did not render in a group of one, or left it")
    check_kernels(label, c_sharded, ("k1",))
    print(f"[{label}] gloo, {SHARD_WORLD} ranks on cuda:0, 320x240 10 spp depth 8: pixels bit-equal to render_frame, "
          f"samples within rtol 2e-4 / atol 2e-5, every rank the same frame; s/launch by rank: {'; '.join(parts)}; "
          f"CLI --shard pixels (group of one) PNG byte-equal to --shard none (cli.run {t_sharded:.4f} vs "
          f"{t_plain:.4f} s, scene load and group set-up included; launches {launched(c_sharded)}) | {smi}")


def phase_deferred(label, hero, root, smi):
    """The headline (fused stream) and the hero stand-in (textured, DOF,
    through its scene file) with deferred_shade off and on: three frames
    each (no warm frame: both scenes rendered in earlier phases), which
    must be bit-equal with equal iterations and segments; the
    mean s/launch of the three, stream syncs and device kernels per
    iteration, and the device busy time of a fourth frame under
    torch.profiler (device events, as profile_renders.py reads them)."""
    from profile_renders import device_events

    hero_scene, hero_camera, hero_cfg = load_scene_file(str(hero), device="cuda", cache_dir=str(root / "cache"))
    cases = (("headline", headline_scene("cuda"), Camera(), RenderConfig(**HEADLINE)),
             ("hero", hero_scene, hero_camera, hero_cfg))
    for name, scene, camera, cfg in cases:
        cam = camera_arrays(camera, cfg, "cuda")
        res = {}
        for on in (False, True):
            c = cfg.replace(deferred_shade=on)
            frames, syncs = [], 0
            torch.cuda.synchronize()
            set_counts_zero()
            for k in (1, 2, 3):
                with counting_syncs() as frame_syncs:
                    t0 = time.perf_counter()
                    img, stats = render_frame_stats(scene, cam, c, k)
                    torch.cuda.synchronize()
                frames.append((img, stats, time.perf_counter() - t0))
                syncs += len(frame_syncs)
            counts = read_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, pstats = render_frame_stats(scene, cam, c, 4)
                torch.cuda.synchronize()
            events = device_events(prof)
            iters = sum(f[1]["iters"] for f in frames)
            want = ("k1", "k7") if frames[0][1]["schedule"] == "stream_fused" else ("k1",)
            check_kernels(f"{label} {name}", counts, want)
            res[on] = dict(frames=frames, iters=iters, syncs=syncs / iters, counts=counts,
                           busy=sum(sec for _, sec in events.values()),
                           kernels=sum(n for n, _ in events.values()) / pstats["iters"])
        off, on = res[False], res[True]
        equal = all(same_bits(a[0], b[0]) for a, b in zip(off["frames"], on["frames"]))
        segments = [int(f[1]["segments"]) for f in off["frames"]], [int(f[1]["segments"]) for f in on["frames"]]
        if not equal or segments[0] != segments[1] or off["iters"] != on["iters"]:
            raise SystemExit(f"[{label} {name}] FAIL: deferred and dense differ: images bit-equal {equal}, "
                             f"segments {segments[0]} vs {segments[1]}")
        mean = {k: float(np.mean([f[2] for f in v["frames"]])) for k, v in res.items()}
        print(f"[{label} {name}] {scene.num_triangles} triangles, {cfg.width}x{cfg.height} "
              f"{cfg.samples_per_launch} spp depth {cfg.max_depth}{' DOF' if cfg.dof else ''}, "
              f"{off['frames'][0][1]['schedule']} schedule: deferred on vs off images bit-equal {equal}, segments "
              f"equal {segments[0] == segments[1]} ({sum(segments[0])} in 3 frames, {off['iters']} iterations); "
              f"s/launch (mean of 3) off {mean[False]:.4f} ({' '.join(f'{f[2]:.4f}' for f in off['frames'])}), "
              f"on {mean[True]:.4f} ({' '.join(f'{f[2]:.4f}' for f in on['frames'])}); stream syncs per iteration "
              f"off {off['syncs']:.4f}, on {on['syncs']:.4f}; device kernels per iteration off {off['kernels']:.1f}, "
              f"on {on['kernels']:.1f}; device busy (one profiled frame) off {off['busy']:.4f} s, on "
              f"{on['busy']:.4f} s; launches off: {launched(off['counts'])}; on: {launched(on['counts'])} | {smi}")


def phase_oracle(label, smi):
    """32x24 frames, 2 spp, depth 4, rendered on the card through the
    cluster accel's flat route (kernel 1; kernel 4 under NEE) and held
    against the numpy oracle (tpu_pathtracer_torch/oracle.py) by
    tests/test_oracle.py's rule, on that file's cases (ORACLE_CASES of
    tests/_torch_scenes.py): at least 98% of pixels with relative
    difference below 1e-3."""
    parts = []
    for name in ORACLE_CASES:
        scene, kw, eye = oracle_case(name, "cuda")
        cfg = RenderConfig(**{**dict(width=32, height=24, samples_per_launch=2, max_depth=4, dof=False), **kw})
        scene = build_accel(scene, kind="cluster")
        if scene.accel.route(cfg) != "flat":
            raise SystemExit(f"[{label}] FAIL: {name} routes to {scene.accel.route(cfg)}, not flat")
        cam = camera_arrays(Camera(**eye), cfg, "cuda")
        img, _, counts = timed(lambda: render_frame(scene, cam, cfg, 0))
        check_kernels(f"{label} {name}", counts, ("k1", "k4") if cfg.env_importance_sampling else ("k1",))
        t0 = time.perf_counter()
        want = oracle.render(scene, cam, cfg, range(cfg.width * cfg.height), 0)
        t_oracle = time.perf_counter() - t0
        got = img.reshape(-1, 3).cpu().numpy()
        rel = np.abs(got - want).max(axis=1) / (1.0 + np.abs(got).max(axis=1))
        frac = float((rel < 1e-3).mean())
        if not frac >= 0.98 or not got.max() > 0:
            raise SystemExit(f"[{label}] FAIL: {name}: {frac:.2%} of pixels match the oracle (at least 98%)")
        parts.append(f"{name} {frac:.2%} ({launched(counts)}; oracle {t_oracle:.1f} s)")
    print(f"[{label}] card vs numpy oracle, 32x24 2 spp depth 4, pixels with relative difference < 1e-3: "
          + "; ".join(parts) + f" | {smi}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image", help="write the headline 1080p frame here as a binary PPM")
    parser.add_argument("--parent", help="the root of an older checkout: phase 18 also times its kernel 7")
    parser.add_argument("--shard-worker", nargs=3, metavar=("PORT", "RANK", "OUT"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.shard_worker:
        port, rank, out = args.shard_worker
        return shard_worker(int(port), int(rank), out)

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    cfg = RenderConfig(**HEADLINE)
    cfg_nee = RenderConfig(**{**HEADLINE, **NEE})
    cam4 = Camera(**CONFIG4_CAMERA)
    numbers, launches = {}, {}

    scene = headline_scene("cuda")
    numbers["k1"] = phase_kernel("3 kernel 1", "k1", scene, cfg, Camera(), smi, plain_reps=5)
    phase_kernel("3b kernel 1 config 1", "k1", config1_scene("cuda"), RenderConfig(**CONFIG1), Camera(), smi,
                 plain_reps=5, n_cam=CONFIG1_CAMERA_RAYS)
    numbers["ks"] = phase_sampler("3c sampler", scene, cfg, smi)
    headline = phase_render("4 render headline", scene, cfg, Camera(), 1, smi, args.image)
    launches["k1"], launches["ks"] = headline["counts"]["k1"], headline["counts"]["ks"]
    phase_parity("5 parity headline", headline_scene, Camera(), "flat")

    config4 = high_poly(100_000, "cuda")
    big = high_poly(200_000, "cuda")
    numbers["k2"] = phase_kernel("6 kernel 2", "k2", config4, cfg, cam4, smi, plain_reps=2)
    numbers["k3"] = phase_kernel("7 kernel 3", "k3", big, cfg, cam4, smi, plain_reps=2)
    launches["k2"] = phase_render("8 render config 4", config4, cfg, cam4, 1, smi)["counts"]["k2"]
    launches["k3"] = phase_render("9 render 200k", big, cfg, cam4, 1, smi)["counts"]["k3"]
    phase_parity("10 parity two-level", lambda dev: high_poly(13_000, dev), cam4, "hier")

    numbers["k4"] = phase_kernel("11 kernel 4", "k4", scene, cfg_nee, Camera(), smi, plain_reps=5)
    numbers["k5"] = phase_kernel("12 kernel 5", "k5", config4, cfg_nee, cam4, smi, plain_reps=2)
    numbers["k6"] = phase_kernel("13 kernel 6", "k6", big, cfg_nee, cam4, smi, plain_reps=2)
    launches["k4"] = phase_render("14 render headline NEE", scene, cfg_nee, Camera(), 1, smi)["counts"]["k4"]
    launches["k5"] = phase_render("15 render config 4 NEE", config4, cfg_nee, cam4, 1, smi)["counts"]["k5"]
    launches["k6"] = phase_render("16 render 200k NEE", big, cfg_nee, cam4, 1, smi)["counts"]["k6"]
    phase_parity("17 parity headline NEE", headline_scene, Camera(), "flat", nee=True)
    del config4, big

    numbers["k7"] = phase_fused_kernel("18 kernel 7", {"headline": scene, "config 1": config1_scene("cuda")}, smi,
                                       args.parent)
    launches["k7"] = phase_fused_render("19 render headline", scene, cfg, Camera(), smi)
    phase_fused_render("20 render config 1", config1_scene("cuda"), RenderConfig(**CONFIG1), Camera(), smi)
    one_spp = cfg.replace(samples_per_launch=1, tile_pixels=345_600)
    if phase_render("21 render 1 spp", scene, one_spp, Camera(), 1, smi, warm=False)["schedule"] != "rays":
        raise SystemExit("[21 render 1 spp] FAIL: the frame did not take render_rays")
    per_pixel = cfg.replace(stream_lanes=2_097_152)
    if phase_render("22 render one lane per pixel", scene, per_pixel, Camera(), 1, smi, warm=False)["schedule"] != "regen":
        raise SystemExit("[22 render one lane per pixel] FAIL: the frame did not take render_pixels_regen")
    for label, overrides, want in (
        ("23a parity fused", dict(fused_schedule="on"), "stream_fused"),
        ("23b parity one lane per pixel", dict(stream_lanes=16_384), "regen"),
        ("23c parity 1 spp NEE", dict(samples_per_launch=1), "rays"),
    ):
        got = phase_parity(label, headline_scene, Camera(), "flat", nee=label.endswith("NEE"), **overrides)
        if got != want:
            raise SystemExit(f"[{label}] FAIL: the GPU render took {got}, not {want}")
    # The user's entry points, in a scratch directory under the git-ignored build/.
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR.parent, prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        hero, obj4 = phase_scene_files("24 scene files", root, smi)
        cli_counts = {"hero": phase_cli_hero("25 CLI hero", hero, root, smi)}
        cli_counts.update(phase_cli_config4("26 CLI config 4", obj4, root, smi))
        paths = phase_parity_textured("27 parity textured", root, smi)
        phase_viewer("28 viewer", paths, smi)
        phase_shard_one("29 shard one rank", scene, cfg, smi)
        phase_shard_two("30 shard two ranks", root, paths, smi)
        phase_deferred("31 deferred", hero, root, smi)
        phase_oracle("32 oracle", smi)
    print("[launches on the CLI renders] " + "; ".join(
        f"{name}: " + ", ".join(f"{KERNELS[kid][0]} {n}" for kid, n in counts.items() if n)
        for name, counts in cli_counts.items()))
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
