"""Drive the PyTorch port's render paths once on an NVIDIA GPU: the
headline (flat kernels), the large-scene routes (two-level and streamed
kernels), each without and with next-event estimation (NEE: alias-table
light draws and shadow rays through the any-hit kernels), the fused
schedule step (kernel 7) on the headline and BASELINE config 1, the
other frame schedules: 1 spp (render_rays, tiled) and one lane per pixel
(render_pixels_regen); the user's entry points: OBJ/MTL/PNG scene
files through the packed-scene cache, the CLI with the progressive
renderer, AOVs, denoise and checkpoints, and the viewer; and sharded
frames on torch.distributed, deferred shading and the numpy oracle; and
the benchmark entry point.

    python3 chip_smoke.py [--image PATH] [--parent DIR]
    python3 chip_smoke.py --ray-order   # phases 1, 2 and 38 only
    python3 chip_smoke.py --nee-camera [--parent DIR]   # phases 1, 2, 36 and 37 only
    python3 chip_smoke.py --path-step [--parent DIR]   # phases 1, 2, 18c, 21 and 22 only
    python3 chip_smoke.py --nee-quality   # phases 1, 2 and 39 only
    python3 chip_smoke.py --brute   # phases 1, 2 and 40 only
    python3 chip_smoke.py --large   # phases 1, 2 and 41 only

--parent DIR (the root of an older checkout, e.g. unpacked with git
archive under build/) builds its NEE and camera kernels and the launches
before them (PARENT_SOURCES) beside this tree's, and phases 11-13, 18,
18c, 36 and 37 time them through the same wrappers, in turns.

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
 4b. the benchmark entry point at phase 33's first preset (config 0 on
     the cluster accel), checked as phase 33 checks it: the bench's
     s/launch right after phase 4;
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
     shape, instruction floor and 16 tiles as phase 3; with --parent
     the parent's kernel timed in turns (the launches before the NEE
     kernel, which let it start at their entry);
 14. NEE render of the headline (BASELINE config 3's path: textbook RR,
     env importance sampling), as phase 4 (one warm, one timed frame):
     kernels 1 and 4 must each launch at least once per stream iteration,
     kernel 7 exactly once (the unfused stream's step), and no other
     kernel may launch; Mrays/s counts segments and shadow segments;
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
     (--parent: the parent's kernel 7 timed in turns); 32
     consecutive steps on one scratch, and one step repeated 4,200 times
     on it, bit-equal to the plain version;
 18b. kernel 7 off the fused stream's envelope, at 131,072 lanes of the
     unfused stream's real lane states: under NEE (the shadow count and
     the env credit), on an affine range (the frame's second half) and on
     an id list (every other pixel, last first); state, image, regen mask,
     head, segments, live and shadow counts bit-equal; the kernel's time
     with the L2 flushed, the plain version's, the byte bound;
 18c. the path step (render_rays at a 1-spp tile's 345,600 lanes after
     two iterations, with and without NEE, and after 0 and 6;
     render_pixels_regen at 131,072 lanes, with and without NEE, and at
     phase 22's 2,073,600) against path_step_plain on real buffers of
     those schedules: every buffer and the regen mask bit-equal, launched
     alone and as a programmatic dependent of the bounce kernel (the NEE
     kernel under NEE), the captured edge into it programmatic; times and
     bound as 18b, and, but for the 0- and 6-iteration tiles, the time it
     adds behind that launch, exposed (six paired rounds, median and
     quartiles), beside that of a dependent kernel that only waits, at the
     same grid (its floor); --parent: the parent's path step the same
     ways, in turns;
 19. the headline fused (fused_schedule="on", kernels 1 and 7 at least
     once per iteration and nothing else) and unfused under
     ops.cuda_build.plain() (the plain step and shading, no step or shading
     kernel launched), one frame each of the same subframe: images
     bit-equal, iterations and segments identical; s/launch of both;
 20. BASELINE config 1 as phase 19: single_sphere_scene(32, 64) with the
     cluster accel (flat route), 512x512, 64 spp, depth 8, constant sky,
     default camera, auto lanes (16,384);
 21. 1 spp: the headline at 1080p in six tiles of 345,600 pixels
     (bench.py's 1-spp tiling), render_rays through kernel 1 and the path
     step (once an iteration);
 22. one lane per pixel: the headline at 1080p, 10 spp, 2,097,152 stream
     lanes, so render_pixels_regen runs 2,073,600 lanes (the path step
     once an iteration);
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
     unfused stream, kernel 7 once an iteration) must equal render_frame
     bit for bit, by samples
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
     glass, NEE, NEE with the defensive mixture, NEE with MIS-spec;
 33. the benchmark entry point (tpu_pathtracer_torch/bench.py's main, in
     this process) at five presets: config 0 and config 3 with NEE on the
     cluster accel (2 timed frames), config 4 without and with NEE (2),
     config 1 on the cluster accel (1): one JSON line each with a positive
     Mrays/s; the route's kernels (and the schedule's step) at least
     once per iteration of every frame the bench rendered and nothing
     else; path and shadow segments, triangles and schedule equal to the
     frame at subframe 0 of phase 4, 14, 8, 15 or 20 (whose fused and
     unfused frames render subframe 0) on the same RenderConfig; each
     line names the card and its power limit as nvidia-smi gives them;
     then config 0, config 3 with NEE and config 1 at their defaults
     (--accel auto builds no accel for their procedural scenes: brute
     force), graphed: one JSON line each; the brute-force closest hit once
     an iteration (and the any hit under NEE), the step and the shading
     kernels, nothing else, no call of a plain brute-force version, and
     the device kernels an iteration of the bench's plan;
 33b. phase 4's render timed again (two frames): its s/launch and the
     bench's config 0 line of phase 33 beside phase 4's and phase 4b's,
     which tells an overhead of the bench's own from one of the process's
     state after phases 24-32.
34. every schedule and route eagerly and graphed (the headline fused and
    with NEE, config 1, config 4 with NEE, the 200k scene, 1 spp in six
    tiles, the hero stand-in): one frame each way after a capturing one,
    images, iterations and segments bit-equal, one capture each and one
    graph launch per iteration; s/launch both ways, idle share, capture
    seconds and graph pool bytes; then each of them graphed with the
    shading kernels' plain versions (ops.cuda_build.plain()) and with the
    kernels: bit-equal, s/launch, device kernels per iteration, device
    time by kernel family, graph pool bytes (kernels_ab), the plain arm
    launching no shading or ray-order kernel, the kernels' arm no restore
    kernel (its profile's device events) and the traversal's caller-order
    store in its place; each profile traced as `trace` traces (a margin
    at each end, a spin kernel first), once a frame, whether it is
    complete printed;
35. the bounce kernel (csrc/bounce.cu: the miss program, _shade and the
    payload combine; under NEE the light draw, the shadow candidates and
    the NEE record) against _bounce_plain on two sets of lanes at 131,072
    and 16,384 (bounce_lane_sets): the headline's camera rays and their
    first bounces (phase 3's rays), and the headline's pool in the middle
    of a frame, and config 1's; then the hero stand-in's (textures,
    glass, DOF), config 4 with NEE and the headline with NEE, MIS-spec and
    the defensive mixture: every field bit-equal; ms, plain ms, bound,
    the share of hits and of warps that mix hits and misses; first the
    kernel's registers, local memory and blocks an SM
    (cudaFuncGetAttributes) and nvcc's spills;
36. the NEE kernel (csrc/nee.cu) against _nee_weights and the visible
    select after the any-hit traversal, on the headline, config 4 and the
    headline with MIS-spec and the defensive mixture: radiance and
    spec_next bit-equal, launched alone and as a programmatic dependent of
    the traversal (csrc/launch_order.cuh), the captured graph's edge into
    it programmatic; ms with the L2 flushed and warm, the timing method's
    floor at its grid (an empty and a one-load kernel), plain ms, bound;
    on the headline and config 4 its exposed time behind the traversal
    (the pair less the traversal, six paired rounds, median and
    quartiles); --parent: the parent's the same ways, in turns;
37. the camera kernel (csrc/camera.cu) against camera_paths_plain at
    1080p on 131,072 lanes: the stream's respawn with and without DOF and
    the 1-spp set-up on an affine range, bit-equal; then behind kernel 7,
    as a programmatic dependent, on the step's real regen mask of the
    headline's pool (131,072 lanes) and config 1's (16,384) mid-render:
    bit-equal, the captured edge programmatic, its exposed time behind
    kernel 7; times, floors and --parent as phase 36.
    Phases 35-37 time each kernel launch with the L2 flushed before it
    (_time_cold), and count the bytes each lane's class needs of the
    function (bounce_bytes, nee_bytes), so that ms and bound are both HBM
    numbers;
38. the ray ordering (csrc/ray_sort.cu: the radix sort of the rays with
    the key and the shadow rays' parking, the packet order; the restore
    into a Hit or the any-hit flags, which the traversal kernels do in
    their store through perm) against its plain versions on the
    main path's rays in lane order: config 1's 16,384, the headline's
    131,072 and its shadow rays (a mask), config 4's and its shadow rays,
    a 1-spp tile's 345,600, and the one-lane-a-pixel pool's 2,073,600 of
    the headline (phase 22's render, 2,025 packets) and of config 4
    (4,050 packets): every output bit-equal, perm equal to torch.sort's
    stable permutation of the key; each kernel's ms with the L2 flushed
    (the restore's: the traversal with perm less the traversal alone, the
    median of six paired rounds of turns, with its quartiles and whether
    they resolve it; bound: the perm read and the hit byte the store adds),
    plain ms, bound (bytes by lane class) and the PyTorch call that
    computes the same function (torch.sort of the int32 key for the
    sort, index_put_, argsort); the sort's and torch.sort's device ms and
    device kernels a call (the profiler's, warm);
39. the NEE quality study (python -m tpu_pathtracer_torch.tools.
    exp_nee_quality: three spheres under the procedural HDR, brute force,
    render_rays at 1 spp, depth 6) at its defaults (160x120, 48 frames an
    arm) with --timed for pure NEE, the defensive mixture, MIS-spec and
    both, and pure NEE with --denoised: each JSON line beside the card's
    name and power limit, every number finite, seconds a frame above 0;
    in each arm the brute-force closest hit, the bounce kernel and the
    path step once an iteration, the camera kernel once a frame, the
    brute-force any hit and the NEE kernel once an iteration of the NEE
    arm only, no other kernel; then the study at 32x24,
    4 frames, on the card against the CPU, each arm's mean frame SSIM
    above 0.995 after post_process; --scene monkey refused, naming
    monkey.obj, before any render;
40. the brute-force kernels (csrc/brute.cu: closest hit with the Hit's
    finalize, any hit with the active mask): nvcc's -Xptxas -v report and
    the launch shape; each against its plain version at 0, 1, 19,200,
    131,072 and 345,600 rays (camera rays and their first bounces; any hit
    from their first hits, on the headline toward the NEE light draw with
    its candidate mask) on the headline, config 1's sphere and the hero
    stand-in (2,214 triangles): the Hit bit for bit, the flags on the
    active lanes, False off them; exact ties (every triangle twice, in one
    tile and in two); grazing rays and segments (aimed at the triangles'
    vertices and edges, from around the scene and from points on
    triangles; segments ending on the edge: t_max 1) on the headline and
    config 1's sphere, both kernels bit-equal; ms with the L2 flushed and
    warm, plain ms and the bound at the main path's shapes (the
    headline's pool, the NEE study's 19,200 lanes, config 1's pool, a
    1-spp tile's 345,600; any hit on the headline's and the study's
    shadow rays); a graphed 320x240, 2-spp frame by brute force
    without and with NEE, bit-equal between the kernels and
    ops.cuda_build.plain(), one launch of each kernel an iteration; the
    CLI without --scene (brute force) at the reference's defaults, two
    launches with AOVs: its s/launch, no plain brute-force call;
41. frames past the old 32-bit counters and kernel 7's narrow status
    words: the
    headline on the cluster accel at 4096x2160 (DCI 4K), 1 spp, depth 8,
    without and with NEE (8,847,360 lanes: one sort a trace of more rays
    than 32-bit status words count), and config 1's sphere on the cluster
    accel at 1920x1080, 17 spp, regenerate=False (35,251,200 lanes: the
    path step's two-word count), one render_rays batch each; the headline
    at 8192x4320, 2 spp, depth 8, stream_lanes 2^25 (35,389,440 pixels:
    the stream with a pool of 33,554,432 lanes, kernel 7's two status
    words a tile), without NEE (the fused stream) and with it (the
    unfused stream); each through render_frame_stats, graphed,
    every launch counted, bit-equal to ops.cuda_build.plain() (image,
    iterations, segments, shadow segments; the streams' plain arm the
    unfused stream's plain step), s/launch, Mrays/s and the peak bytes a
    lane (torch.cuda.max_memory_allocated), and from them the most lanes
    the card holds; on the first trace's rays of the DCI-4K, the 17-spp
    and the 8K frames the sort (perm equal to torch.sort's stable order
    over all n, rows to the gather) and the packet order (8,640, 34,425
    and 32,768 packets) against their plain versions, timed with the L2
    flushed beside their bounds, torch.sort and argsort, and the
    traversal the order orders; the path step at 35,251,200 lanes after
    two iterations against path_step_plain, timed beside its bound;
    kernel 7 on a pool of 2^25 lanes after 2 iterations of the unfused
    stream (and until a step retires pixels): on the 8K frame's identity
    map, and on a 16384x4320 panorama's second pixel shard of two (an
    affine range) and its id list of every other pixel, both
    rr_modes and under NEE, against fused_stream_step_plain with the real
    head and one that sends lanes past n_pix, timed with the L2 flushed
    beside the bound of the bytes the step must move; the CLI on the hero
    stand-in's scene file at --dim 4096x2160, one sample a launch: one
    capture, the PNG finite and not black.
Every render runs graphed (render/graph_loop.py: each schedule's
iteration captured once as a CUDA graph and replayed) but deferred
shading's, and its phase checks so: a CLI run, a bench preset and the
viewer's session each capture once per plan, and the launch counts keep
their meaning through the plan's accounting of each replay.
On the card the bounce's shading, NEE's weights and every camera spawn
run the three shading kernels, which every render phase expects: the
bounce kernel once an iteration, the NEE kernel once an iteration under
NEE, the camera kernel once a stream or regen iteration and once a
render_pixels call's set-up (and a graph captured from one step of the
render's plan holds a programmatic edge into the NEE kernel under NEE,
one into the path step on the rays and regen schedules and one into the
camera kernel on the stream and regen schedules, and no other:
step_dependents); every schedule's step runs a kernel once
an iteration (STEP_KERNEL): kernel 7 on every stream, fused or not, the
path step on render_rays and render_pixels_regen; every sorted trace
runs the ray-order kernels (check_ray_order: the sort's launches for the
trace's pool, trace_sort_launches, 1 to 5 where pools mix, and the
restore, the traversal's caller-order store, once; the packet order
where the pool has more packets than the
card holds at once); the unit-ball
sampler's loop runs inside the bounce kernel, so the sampler launches only on the plain versions' path
(phase 34's plain arm, whose count the kernels line gives it).
Then the launches on the CLI renders of phases 25 and 26, one JSON line with every kernel's numbers (launches from its render
phase, bound from the work its plain version counts on the phase's rays),
and last the result line {"ok": true, "device": {...}}.  --image writes
the headline 1080p frame, post-processed, as a binary PPM.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import math
import shutil
import statistics
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
    from tpu_pathtracer_torch.ops import bounce as bounce_ops
    from tpu_pathtracer_torch.ops import camera as camera_ops
    from tpu_pathtracer_torch.ops import cuda_build
    from tpu_pathtracer_torch.ops import fused_schedule as fs
    from tpu_pathtracer_torch.ops import intersect as brute_ops
    from tpu_pathtracer_torch.ops import intersect_cluster as ic
    from tpu_pathtracer_torch.ops import ray_sort
    from tpu_pathtracer_torch.ops import unit_sphere
    from tpu_pathtracer_torch.ops.intersect import Hit
    from tpu_pathtracer_torch.render.camera import Camera, camera_arrays, generate_camera_rays
    from tpu_pathtracer_torch.render import graph_loop
    from tpu_pathtracer_torch.render.envmap import direction_to_uv, with_importance_sampling
    from tpu_pathtracer_torch.render.film import post_process, to_uint8
    from tpu_pathtracer_torch.render.integrator import (
        _bounce_kernels,
        _bounce_plain,
        _light_sample,
        _nee_weights,
        _pixel_count,
        _pixel_map,
        _respawn,
        _shade,
        _shadow_candidates,
        _spawner,
        _spec_start,
        _stream_state,
        _trace_bounce,
        render_frame_stats,
        resolve_stream_lanes,
    )
    from tpu_pathtracer_torch.render.integrator import schedule as frame_schedule
    from tpu_pathtracer_torch.scene.procedural import high_poly_scene, single_sphere_scene, three_spheres_scene
    from tpu_pathtracer_torch.scene.scene import SCRAMBLE_MULT, make_env
    from tpu_pathtracer_torch.utils import rng
    from tpu_pathtracer_torch.utils.image import procedural_hdr
    from tpu_pathtracer_torch.utils.ssim import ssim
    from tpu_pathtracer_torch import bench, cli
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
    from tpu_pathtracer_torch.tools import exp_nee_quality as nee_quality

    # the CPU tests' scene writer (it imports neither JAX nor PIL)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _torch_scenes import ORACLE_CASES, oracle_case, write_mtl_scene
except ImportError as e:
    print(f"chip_smoke: cannot import the port ({e}); run from the repository root", file=sys.stderr)
    sys.exit(2)

REPO = Path(__file__).resolve().parent
PALLAS = "tpu_pathtracer/ops/intersect_pallas.py"
RAY_SORT = "tpu_pathtracer_torch/csrc/ray_sort.cu"
BRUTE = "tpu_pathtracer_torch/csrc/brute.cu"
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
    # No TPU kernel: XLA's fusion of the loop bodies of render_rays (:870)
    # and render_pixels_regen (:1031) after the trace.
    "kp": ("path_step", "tpu_pathtracer_torch/csrc/fused_schedule.cu", "tpu_pathtracer/render/integrator.py:870",
           None, False, fs.path_step, fs.path_step_cuda, fs.path_step_plain),
    # No TPU kernel: the JAX package's lax.while_loop, which the port's loop
    # could only end by reading the device.
    "ks": ("unit_sphere", "tpu_pathtracer_torch/csrc/unit_sphere.cu", "tpu_pathtracer/utils/rng.py:79", None, False,
           unit_sphere.random_in_unit_sphere, unit_sphere.random_in_unit_sphere_cuda, rng.random_in_unit_sphere_plain),
    # No TPU kernel either: the fusions XLA makes of the JAX package's bounce
    # (_trace_bounce after the traversal), NEE tail and camera spawn.  The
    # bounce kernel runs the sampler's loop inline, so on the kernels' path
    # the sampler launches only under ops.cuda_build.plain().
    "kb": ("bounce", "tpu_pathtracer_torch/csrc/bounce.cu", "tpu_pathtracer/render/integrator.py:548", None, False,
           bounce_ops.bounce, bounce_ops.bounce, _bounce_plain),
    "kn": ("nee", "tpu_pathtracer_torch/csrc/nee.cu", "tpu_pathtracer/render/integrator.py:635", None, False,
           bounce_ops.next_event, bounce_ops.next_event, _nee_weights),
    "kc": ("camera", "tpu_pathtracer_torch/csrc/camera.cu", "tpu_pathtracer/render/integrator.py:57", None, False,
           camera_ops.camera_paths, camera_ops.camera_paths, camera_ops.camera_paths_plain),
    # No TPU kernel either: the traversal's ray ordering, which XLA fuses
    # around the Pallas kernels (the key, the packed one-row gather, the
    # parking and the packed restore; the sort between is lax.sort_key_val
    # in sort_by_key).  The packet order has no JAX counterpart (the TPU's
    # grid takes packets in order): it orders the packets of the traversal
    # launch it names, in place of an argsort.
    "kx": ("sort_rays", RAY_SORT, f"{PALLAS}:1392", None, False, ray_sort.sort_rays, ray_sort.sort_rays_cuda,
           ray_sort.sort_rays_plain),
    # The restore into caller order is the traversal kernels' store (a
    # wrapper's restore=True, through perm): no launch of its own, its
    # count the launches that stored so, its time what they add.
    "kr": ("caller_order_store", "tpu_pathtracer_torch/csrc/cluster_streamed.cuh",
           "tpu_pathtracer/accel/cluster.py:294", None, False, ic.caller_order_stores, None,
           ray_sort.restore_hits_plain),
    "ko": ("packet_order", RAY_SORT, f"{PALLAS}:1512", None, False, ray_sort.packet_order,
           ray_sort.packet_order_cuda, ray_sort.packet_order_plain),
    # No TPU kernel either: XLA's fusion of the JAX package's brute-force
    # lax.scan, which scenes without an accel take: intersect_brute with its
    # finalize_hit, and occluded_brute.
    "kbc": ("brute_closest", BRUTE, "tpu_pathtracer/ops/intersect.py:117", None, False, brute_ops.intersect_brute,
            brute_ops.intersect_brute_cuda, brute_ops.intersect_brute_plain),
    "kba": ("brute_any", BRUTE, "tpu_pathtracer/ops/intersect.py:215", None, True, brute_ops.occluded_brute,
            brute_ops.occluded_brute_cuda, brute_ops.occluded_brute_plain),
}
# The kernels each route's render launches, without and with NEE.
ROUTE_KERNELS = {"flat": ("k1", "k4"), "hier": ("k2", "k5"), "streamed": ("k3", "k6")}
# The step each schedule launches once an iteration on the card: kernel 7
# on every stream (fused or not, any pixel map, NEE or not), the path step
# on render_rays and render_pixels_regen.
STEP_KERNEL = {"stream_fused": "k7", "stream": "k7", "regen": "kp", "rays": "kp"}


# The ray ordering's kernels (ops/ray_sort.py): on every sorted trace the
# sort (1 launch up to 16,384 rays, else 1 + its digit passes, at most 5)
# and the restore, in the traversal's store; the packet order on every
# trace with more packets than the card holds at once.
RAY_ORDER = ("kx", "kr", "ko")


def trace_sort_launches(scene, cfg, sched):
    """The sort's launches on one trace of a render of cfg on `scene` by
    the schedule `sched`: of the rays a trace sorts (the stream's lane
    pool, a lane a pixel on regen, a lane a sample on rays; of a tile
    where cfg tiles the frame), at the key's bits."""
    acc = scene.accel
    n_pix = cfg.width * cfg.height
    if 0 < cfg.tile_pixels < n_pix:
        n_pix = cfg.tile_pixels
    n = (resolve_stream_lanes(cfg, n_pix) if sched.startswith("stream") else
         n_pix if sched == "regen" else n_pix * cfg.samples_per_launch)
    spatial = acc._spatial_bits(cfg) if acc._want_sort(cfg) == "spatial" else 0
    return ray_sort.sort_launches(n, spatial, acc._dir_bits(cfg))


def check_ray_order(label, counts, traces, sort_each=None):
    """The ray-order kernels on `traces` sorted traces: the restore (the
    traversal's caller-order store) once each; the sort's launches `sort_each` each (trace_sort_launches) or,
    where traces of more than one size mix (sort_each None), 1 to 5 each;
    the packet order on each of them or, where `sort_each` is given (one
    pool size), on each or none (its packets fit the card at once or do
    not), else on at most `traces`."""
    got = [counts[k] for k in RAY_ORDER]
    exact = sort_each is not None
    sort_ok = got[0] == traces * sort_each if exact else traces <= got[0] <= 5 * traces
    order_ok = got[2] in (0, traces) if exact else got[2] <= traces
    if got[1] != traces or not sort_ok or not order_ok:
        raise SystemExit(f"[{label}] FAIL: ray-order launches {dict(zip((KERNELS[k][0] for k in RAY_ORDER), got))} "
                         f"for {traces} sorted traces" + (f" of {sort_each} sort launches each" if exact else ""))


def shading_kernels(nee):
    """The shading kernels every render launches on the card: the bounce
    and camera kernels, and the NEE kernel under NEE."""
    return ("kb", "kc") + (("kn",) if nee else ())


def check_shading(label, counts, iters, nee, spawns=None):
    """The bounce kernel once an iteration, the NEE kernel once an
    iteration under NEE and never without, the camera kernel `spawns`
    times (at least once when not given), the sampler never (its loop
    runs inside the bounce kernel)."""
    if counts["kb"] != iters or counts["kn"] != (iters if nee else 0):
        raise SystemExit(f"[{label}] FAIL: {counts['kb']} bounce and {counts['kn']} nee launches for {iters} "
                         f"iterations")
    if (counts["kc"] != spawns) if spawns is not None else not counts["kc"]:
        raise SystemExit(f"[{label}] FAIL: {counts['kc']} camera launches, expected {spawns or 'some'}")
    if counts["ks"]:
        raise SystemExit(f"[{label}] FAIL: the sampler launched {counts['ks']} times beside the bounce kernel")


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
CONFIG1_POOL = 2 * CONFIG1_CAMERA_RAYS
REGEN_POOL = 2_073_600  # one lane a pixel at 1080p (phase 22's render_pixels_regen)
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
STORE_ROUNDS = 6  # rounds of paired turns (paired_rounds)


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


def phase_build(parent_dir=None):
    """Every csrc/ source, one nvcc each, all at once, and beside them the
    timing floor's kernels (FLOOR_SOURCE) and, with `parent_dir`, the
    parent's PARENT_SOURCES.  Returns the parent's libraries (None
    without it)."""
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    jobs = start_builds({"floor.cu": None} | (parent_sources(parent_dir) if parent_dir else {}))
    cuda_build.build_libraries()
    side = finish_builds(jobs)
    dt = time.perf_counter() - t0
    parts = []
    for source in cuda_build.sources():
        cuda_build.library(source)  # loads, and sets the launch signature
        log = cuda_build.library_path(source).with_suffix(".log").read_text()
        usage = "; ".join(line.split("ptxas info    : ")[-1] for line in log.splitlines() if "Used" in line)
        parts.append(f"{source}: {usage}")
    floor = side.pop("floor.cu")
    floor.floor_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    floor.floor_launch.restype = ctypes.c_int
    floor.floor_dependent_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    floor.floor_dependent_launch.restype = ctypes.c_int
    FLOOR["lib"] = floor
    print(f"[2 build] {len(parts)} libraries built at once in {dt:.2f} s"
          f"{f' (and the parent {parent_dir} of {len(side)} sources)' if parent_dir else ''} | " + " | ".join(parts))
    return side or None


# ---------------------------------------------------------------------------
# Older kernels beside the change's (--parent), the timing method's floor,
# and the edges of a captured graph
# ---------------------------------------------------------------------------

# The sources --parent builds from an older checkout: the kernels launched
# as programmatic dependents (the NEE and camera kernels, the path step)
# and the launches they depend on (the any-hit traversals, kernel 7), the
# closest-hit traversals and the ray ordering, and brute force, whose C
# interfaces are the change's (an older fused_schedule.cu's adapted:
# load_library).
PARENT_SOURCES = ("nee.cu", "camera.cu", "cluster_intersect.cu", "cluster_hier.cu", "cluster_streamed.cu",
                  "cluster_occluded.cu", "cluster_occluded_hier.cu", "cluster_occluded_streamed.cu",
                  "fused_schedule.cu", "ray_sort.cu", "brute.cu")


def parent_sources(parent_dir):
    """{source: its path} of PARENT_SOURCES in the checkout `parent_dir`
    (one from before brute.cu has none)."""
    paths = {s: Path(parent_dir) / "tpu_pathtracer_torch" / "csrc" / s for s in PARENT_SOURCES}
    return {s: path for s, path in paths.items() if path.exists()}
# The timing method's floor: an empty kernel, and one that loads 4 bytes a
# lane (a value never found, so nothing is stored), at a kernel's grid.
FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel(int n) {}
__global__ void one_load_kernel(const float* x, float* sink, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && x[i] == 1234.5f) *sink = x[i];
}
__global__ void wait_kernel(int n) { asm volatile("griddepcontrol.wait;" ::: "memory"); }
// A kernel that only waits, launched as a programmatic dependent of the
// launch before it: what a dependent's exposed time cannot go below.
extern "C" int floor_dependent_launch(int n, int threads, void* stream) {
  cudaLaunchAttribute attribute = {};
  attribute.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n + threads - 1) / threads);
  config.blockDim = dim3(threads);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attribute;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, wait_kernel, n));
}
extern "C" int floor_launch(int load, const float* x, float* sink, int n, int threads, void* stream) {
  const int blocks = (n + threads - 1) / threads;
  if (load) {
    one_load_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(x, sink, n);
  } else {
    empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(n);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
FLOOR = {}  # "lib": the floor's library, once phase_build has built it


def start_builds(sources, side=None):
    """nvcc on each {name: source path, or None for FLOOR_SOURCE} into
    `side` (by default build/tpu_pathtracer_torch/side/), all at once: the
    jobs."""
    side = side or cuda_build.BUILD_DIR / "side"
    side.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, src in sources.items():
        if src is None:
            src = side / name
            src.write_text(FLOOR_SOURCE)
        out = side / f"{Path(name).stem}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)]
        jobs.append((name, src, out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                      text=True)))
    return jobs


class _OlderStep:
    """A fused_schedule.cu library from before the path step took
    `dependent` and the library sized the steps' scratch (it has no
    fused_step_scratch_words), called as this tree's wrappers call it: the
    argument dropped, a scratch of 3 + n words for n lanes whatever the
    entry, more than any older layout used (kernel 7's 3 + tiles; the path
    step's 4, or 1 + tiles).  A library whose fused_step_scratch_words
    reads its second argument as tiles (before kernel 7 took two words a
    tile) is given lanes there, and sizes a scratch larger than it uses."""

    def __init__(self, lib):
        self._lib = lib

    def fused_step_launch(self, p, entry, dependent, stream):
        return self._lib.fused_step_launch(p, entry, stream)

    @staticmethod
    def fused_step_scratch_words(entry, n):
        return 3 + n

    def __getattr__(self, name):
        return getattr(self._lib, name)


def load_library(name, out):
    """The library `out`, built from a csrc/`name`: each launch function's
    and helper's signature set as cuda_build sets the change's, an older
    fused_schedule.cu adapted (_OlderStep)."""
    lib = ctypes.CDLL(str(out))
    if name not in cuda_build.LAUNCHERS:
        return lib
    launcher, argtypes = cuda_build.LAUNCHERS[name]
    older = name == "fused_schedule.cu" and not hasattr(lib, "fused_step_scratch_words")
    for fn, types in {launcher: argtypes[:-2] + argtypes[-1:] if older else argtypes,
                      **cuda_build.HELPERS.get(name, {})}.items():
        if not (older and fn == "fused_step_scratch_words"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = types, ctypes.c_int
    return _OlderStep(lib) if older else lib


def finish_builds(jobs):
    """{name: the loaded library} of start_builds' jobs (load_library);
    raises with nvcc's output if a build failed."""
    libs = {}
    for name, src, out, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"FAIL: nvcc on {src}:\n{log[-4000:]}")
        libs[name] = load_library(name, out)
    return libs


@contextlib.contextmanager
def using_libraries(libs):
    """Within the block the wrappers launch the kernels of `libs` ({source:
    library}, finish_builds') in place of the change's: the shading kernels
    and the steps through ops/bounce.py's `library`, the traversals
    through ops/intersect_cluster.py's and ops/intersect.py's (brute
    force), the ray ordering through ops/ray_sort.py's; the steps' scratch is sized by the
    library in use.  None: the change's.  A graph captured within the
    block must not outlive it."""
    if not libs:
        yield
        return
    mods = (bounce_ops, ic, brute_ops, ray_sort)
    saved = [m.library for m in mods]
    pick = lambda source: libs[source] if source in libs else cuda_build.library(source)  # noqa: E731
    for m in mods:
        m.library = pick
    try:
        yield
    finally:
        for m, lib in zip(mods, saved):
            m.library = lib


def method_floor(n, threads):
    """The timing method's floor at a kernel's grid (n lanes, `threads` a
    block): an empty kernel and one loading 4 bytes a lane, each timed
    with the L2 flushed before each launch (_time_cold) and warm, back to
    back (_time_over).  Returns {"empty", "load"}: (cold ms, warm ms)."""
    lib = FLOOR["lib"]
    x = torch.ones(n, dtype=torch.float32, device="cuda")
    sink = torch.zeros(1, dtype=torch.float32, device="cuda")
    out = {}
    for name, load in (("empty", 0), ("load", 1)):
        def fn(_):
            err = lib.floor_launch(load, x.data_ptr(), sink.data_ptr(), n, threads,
                                   torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"FAIL: floor_launch: CUDA error {err}")
        out[name] = (_time_cold(fn, [None] * 51), _time_over(fn, [None] * 51, device_only=True))
    return out


def floor_text(floor):
    return ", ".join(f"{k} {c:.4f} ({w:.4f})" for k, (c, w) in floor.items())


class _EdgeData(ctypes.Structure):
    """CUgraphEdgeData."""
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte), ("type", ctypes.c_ubyte),
                ("reserved", ctypes.c_ubyte * 5)]


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p)] + [(k, ctypes.c_uint) for k in (
        "grid_x", "grid_y", "grid_z", "block_x", "block_y", "block_z", "shared")] + [
        (k, ctypes.c_void_p) for k in ("params", "extra", "kern", "ctx")]


CU_GRAPH_NODE_TYPE_KERNEL = 0
CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC = 1


@contextlib.contextmanager
def captured_graph(fn, warm=True):
    """A CUDA graph captured from one call of fn (after a warm-up call,
    unless not `warm`), the wrappers' launch counts left as they were:
    yields (libcuda, the raw graph) for the driver API to read; the graph
    is reset after."""
    if warm:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)

    def capture():
        with torch.cuda.graph(graph):
            fn()

    graph_loop.record_launches(capture)
    try:
        yield ctypes.CDLL("libcuda.so.1"), ctypes.c_void_p(graph.raw_cuda_graph())
    finally:
        graph.reset()


def node_type(cu, node):
    kind = ctypes.c_int()
    if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
        raise SystemExit("FAIL: cuGraphNodeGetType")
    return kind.value


def captured_edges(fn, warm=True):
    """The edges between kernel nodes of the graph a CUDA stream capture
    records from one call of fn (captured_graph), read through the driver
    API: a list of dicts, `from` and `to` (each node's (blocks, threads a
    block)), `sink` (the node after it has no edge out) and `programmatic`
    (CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC, what a launch made as a
    programmatic dependent of the kernel before it records)."""
    with captured_graph(fn, warm) as (cu, raw):
        count = ctypes.c_size_t(0)
        if cu.cuGraphGetEdges_v2(raw, None, None, None, ctypes.byref(count)):
            raise SystemExit("FAIL: cuGraphGetEdges_v2")
        src, dst = (ctypes.c_void_p * count.value)(), (ctypes.c_void_p * count.value)()
        data = (_EdgeData * count.value)()
        if count.value and cu.cuGraphGetEdges_v2(raw, src, dst, data, ctypes.byref(count)):
            raise SystemExit("FAIL: cuGraphGetEdges_v2")
        shapes = {}

        def shape(node):
            if node not in shapes:
                shapes[node] = None
                if node_type(cu, node) == CU_GRAPH_NODE_TYPE_KERNEL:
                    params = _KernelNodeParams()
                    if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)):
                        raise SystemExit("FAIL: cuGraphKernelNodeGetParams_v2")
                    shapes[node] = (params.grid_x * params.grid_y * params.grid_z,
                                    params.block_x * params.block_y * params.block_z)
            return shapes[node]

        sources = set(src)
        return [dict(**{"from": shape(a), "to": shape(b)}, sink=b not in sources,
                     programmatic=d.type == CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC)
                for a, b, d in zip(src, dst, data) if shape(a) and shape(b)]


def programmatic_into_sink(label, fn, shape):
    """fn's captured graph (captured_edges) must end in one kernel node of
    `shape` (blocks, threads) whose one edge in is programmatic.  Returns
    the edge's description."""
    into = [e for e in captured_edges(fn) if e["sink"]]
    if len(into) != 1 or into[0]["to"] != shape or not into[0]["programmatic"]:
        raise SystemExit(f"[{label}] FAIL: the captured edge into the {shape} launch is not one programmatic edge: "
                         f"{into}")
    return f"{into[0]['from']} -> {into[0]['to']} programmatic"


def step_dependents(label, sched, nee):
    """The programmatic edges of a graph captured from one step of the
    plan that rendered last: one into the NEE kernel under NEE, one into
    the path step (behind the bounce kernel, or the NEE kernel) on the
    rays and regen schedules, one into the camera kernel on the stream and
    regen schedules, none else, each into a launch of that kernel's shape
    over the plan's lanes."""
    plan = next(reversed(graph_loop._plans.values()))
    lanes = plan.state["seeds"].shape[0]
    got = sorted(e["to"] for e in captured_edges(plan._step, warm=False) if e["programmatic"])
    tiles = (-(-lanes // 256), 256)
    want = sorted(([(-(-lanes // 128), 128)] if nee else []) + ([tiles] if sched in ("rays", "regen") else [])
                  + ([tiles] if sched != "rays" else []))
    if got != want:
        raise SystemExit(f"[{label}] FAIL: programmatic edges into {got} in the step's graph, expected {want}")
    return got


def paired_rounds(turn, arms=(None,), rounds=STORE_ROUNDS):
    """What a launch adds to the launches before it, from `rounds` rounds
    of turns: in each round every arm of `arms` in turn (their order
    reversed every other round), each arm's turns alone, paired, paired,
    alone (turn(arm, paired) -> mean device ms), the round's difference
    its two paired turns less its two alone, so that a drift across the
    round cancels.  Returns {arm: dict}: `alone_ms` and `paired_ms` (means
    over every turn), the rounds' differences (`rounds_ms`), their median
    and quartiles, `resolved` (the quartiles' spread below the median: a
    cost this run resolves) and `ms`, the median, or 0 where the median is
    below 0 (a cost under the turns' resolution)."""
    runs = {arm: ([], [], []) for arm in arms}
    for r in range(rounds):
        for arm in arms if r % 2 == 0 else arms[::-1]:
            a0, w0, w1, a1 = turn(arm, False), turn(arm, True), turn(arm, True), turn(arm, False)
            alone, paired, diffs = runs[arm]
            alone += [a0, a1]
            paired += [w0, w1]
            diffs.append((w0 + w1 - a0 - a1) / 2)
    out = {}
    for arm, (alone, paired, diffs) in runs.items():
        q1, median, q3 = statistics.quantiles(diffs, n=4, method="inclusive")
        out[arm] = dict(ms=max(median, 0.0), median_ms=median, q1_ms=q1, q3_ms=q3, rounds_ms=diffs,
                        resolved=q3 - q1 < median, alone_ms=sum(alone) / len(alone),
                        paired_ms=sum(paired) / len(paired))
    return out


def exposed_text(e):
    return (f"{e['median_ms']:.4f} ms ({e['q1_ms']:.4f} to {e['q3_ms']:.4f}"
            f"{'' if e['resolved'] else ', unresolved'}; alone {e['alone_ms']:.4f}, paired {e['paired_ms']:.4f})")


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


def trace_rays(scene, cfg, camera, n_cam=CAMERA_RAYS):
    """2 x n_cam rays as the main path traces them, in lane order: n_cam
    camera rays spread over the frame and, for each, its first bounce (a
    miss keeps its camera ray)."""
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
    return torch.cat([o, o2]), torch.cat([d, d2])


def bounce_batch(scene, cfg, camera, n_cam=CAMERA_RAYS):
    """trace_rays' rays sorted as ClusterAccel.intersect sorts them."""
    o_s, d_s, _ = scene.accel.sort(*trace_rays(scene, cfg, camera, n_cam), cfg)
    return o_s, d_s


def shadow_rays(scene, cfg, camera):
    """131,072 NEE shadow rays as the main path makes them: bounce_batch's
    rays intersected and shaded, one alias-table light draw each; and the
    mask of the lanes that trace one (the others: misses, glass, emissive,
    light below the normal).  Returns (origins, directions, mask)."""
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
    return sh["new_origin"], env_dir, cand


def shadow_batch(scene, cfg, camera):
    """shadow_rays' rays with the lanes that trace nothing parked and the
    batch sorted as ClusterAccel.occluded does.  Returns (origins,
    directions, share of lanes parked)."""
    o, d, cand = shadow_rays(scene, cfg, camera)
    o_s, d_s, _ = scene.accel.sort(o, d, cfg, active=cand)
    return o_s, d_s, 1.0 - float(cand.float().mean())


def kernel_bytes(args, n, any_hit):
    """Bytes the traversal must move: every tensor argument read once
    (rays, rows, boxes, visit orders), the outputs written once (a flag
    byte per ray, or t, prim and uv: 16 bytes)."""
    read = sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))
    return read + n * (1 if any_hit else 16)


def phase_kernel(label, kid, scene, cfg, camera, smi, plain_reps, n_cam=CAMERA_RAYS, parent=None):
    """The kernel against its plain version on bounce_batch's 2 x n_cam
    rays (any hit: shadow_batch's), both triangle tests, bit for bit;
    Baldwin-Weber (the main path's) timed, and its bound from the tests the
    plain version counts on these rays; then phase_streamed_sizes.  With
    `parent` (its libraries: any hit only) the parent's kernel and this
    one timed in turns, P C C P, warm."""
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
    turns = ""
    if parent and any_hit:
        _, args = acc.traversal(o_s, d_s, cfg.t_min, cfg.t_max, cfg)
        times = {"parent": [], "kernel": []}
        for who in ("parent", "kernel", "kernel", "parent"):
            with using_libraries(parent if who == "parent" else None):
                times[who].append(_time_ms(lambda: kernel(*args), 20))
        bw["parent_ms"] = sum(times["parent"]) / 2
        turns = (f"; in turns, bw kernel {' '.join(f'{t:.4f}' for t in times['kernel'])} ms, parent "
                 f"{' '.join(f'{t:.4f}' for t in times['parent'])} ms (mean {bw['parent_ms']:.4f}, "
                 f"{sum(times['kernel']) / 2 / bw['parent_ms'] - 1:+.2%})")
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
          f"{bw['plain_ms']:.4f} ms; mt kernel {mt['ms']:.4f} ms{turns}; {work}), "
          f"{bw['flops']} FLOP, {bw['n_bytes']} bytes: bound {bw['bound_ms']:.4f} ms by {bw['bound_by']} | {smi}")
    phase_streamed_sizes(label, name, route, any_hit, kernel, acc, cfg, o_s, d_s, bw, smi)
    return dict(max_abs_err=max(bw["max_abs_err"], mt["max_abs_err"]), ms=bw["ms"], plain_ms=bw["plain_ms"],
                bound_ms=bw["bound_ms"], bound_by=bw["bound_by"], library_ms=None,
                **({"parent_ms": bw["parent_ms"]} if "parent_ms" in bw else {}))


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


def phase_render(label, scene, cfg, camera, frames, smi, image_path=None, warm=True, subframe=1):
    """A warm frame at subframe 0 (unless warm=False), then `frames` timed
    frames from `subframe` on, with every launch count set to 0 just
    before and read just after.  The
    route's closest-hit kernel (and under NEE its any-hit kernel) must
    launch at least once per iteration of the schedule, the schedule's
    step (STEP_KERNEL: kernel 7 on every stream, the path step on rays
    and regen), the bounce kernel (and under NEE the NEE kernel) exactly
    once, the camera kernel
    once an iteration of the stream and regen schedules and once a
    render_pixels call's set-up, and no other kernel at all (the unit-ball
    sampler's loop runs inside the bounce kernel).
    Also counts the stream syncs inside the timed renders, and reads the
    programmatic edges of a graph captured from one step of the render's
    plan (step_dependents: the NEE kernel's under NEE, the camera
    kernel's on the stream and regen schedules).  Returns the
    counts, the last image, the totals, the schedule and the traced-ray
    accounting of the frame at subframe 0 (None if none was rendered)."""
    route = scene.accel.route(cfg)
    nee = cfg.env_importance_sampling
    cam = camera_arrays(camera, cfg, scene.device)
    first = None
    captures = graph_loop.stats["captures"]
    if warm:
        img, stats = render_frame_stats(scene, cam, cfg, 0)
        if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
            raise SystemExit(f"[{label}] FAIL: warm frame is non-finite or black")
        if int(stats["segments"]) <= 0 or (nee and int(stats["shadow_segments"]) <= 0):
            raise SystemExit(f"[{label}] FAIL: no segments traced")
        first = accounting(stats)
    torch.cuda.synchronize()
    set_counts_zero()
    t0 = time.perf_counter()
    iters = seg_total = shadow_total = syncs = 0
    for k in range(frames):
        with counting_syncs() as frame_syncs:
            img, stats = render_frame_stats(scene, cam, cfg, subframe + k)
        syncs += len(frame_syncs)
        if subframe + k == 0:
            first = accounting(stats)
        iters += stats["iters"]
        seg_total += int(stats["segments"])
        shadow_total += int(stats["shadow_segments"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    sched = stats["schedule"]
    # The graphed loop is the default on the card, deferred shading's aside.
    if stats["graphed"] != (not (cfg.deferred_shade and not nee)):
        raise SystemExit(f"[{label}] FAIL: the loop reports graphed {stats['graphed']}")
    captures = graph_loop.stats["captures"] - captures
    n_pix = cfg.width * cfg.height
    spawn_calls = frames * (n_pix // cfg.tile_pixels if 0 < cfg.tile_pixels < n_pix else 1)
    want = check_frame_launches(label, scene, cfg, counts, iters, sched, spawn_calls)
    dependents = step_dependents(label, sched, nee) if stats["graphed"] else []
    if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
        raise SystemExit(f"[{label}] FAIL: timed frame is non-finite or black")
    if seg_total <= 0 or (nee and shadow_total <= 0):
        raise SystemExit(f"[{label}] FAIL: no segments traced")
    launched = {KERNELS[kid][0]: counts[kid] for kid in want if counts[kid]}
    rays = seg_total + shadow_total
    tiles = f" in tiles of {cfg.tile_pixels}" if 0 < cfg.tile_pixels < cfg.width * cfg.height else ""
    lanes = f", {resolve_stream_lanes(cfg, cfg.width * cfg.height)} lanes" if sched.startswith("stream") else ""
    print(f"[{label}] {scene.num_triangles} triangles, {scene.accel.num_clusters} clusters, {route} route"
          f"{', NEE' if nee else ''}, {sched} schedule{tiles}{lanes}; "
          f"{cfg.width}x{cfg.height} {cfg.samples_per_launch} spp depth {cfg.max_depth}: "
          f"{rays / dt / 1e6:.4f} Mrays/s (segments{' + shadow segments' if nee else ''}), "
          f"{dt / frames:.4f} s/launch, {seg_total // frames} segments/launch, "
          f"{shadow_total // frames} shadow segments/launch, {iters // frames} iterations/launch, "
          f"{syncs / iters:.4f} stream syncs per iteration, graphed {stats['graphed']} ({captures} capture(s)), "
          f"launches {launched} in {frames} timed frames, programmatic edges in a step's captured graph into "
          f"(blocks, threads) {dependents}, mean {img.mean(dim=(0, 1)).tolist()} | {smi}")
    if image_path:
        rgb = to_uint8(post_process(img, cfg)).cpu().numpy()[::-1]
        with open(image_path, "wb") as f:
            f.write(b"P6 %d %d 255\n" % (cfg.width, cfg.height) + rgb.tobytes())
    return dict(counts=counts, img=img, iters=iters, segments=seg_total, seconds=dt / frames, schedule=sched,
                syncs=syncs, cfg=cfg, triangles=scene.num_triangles, first=first)


def check_frame_launches(label, scene, cfg, counts, iters, sched, spawn_calls):
    """The launches of `iters` iterations of frames of the schedule `sched`
    that made `spawn_calls` render_pixels calls: the route's closest-hit
    kernel (and under NEE its any-hit kernel) at least once an iteration,
    the schedule's step (STEP_KERNEL) exactly once, the shading kernels as
    check_shading says (the camera kernel once a call's set-up, and once
    an iteration but on rays), the ray ordering as check_ray_order says,
    and no other kernel.  Returns the kernels that launched."""
    nee = cfg.env_importance_sampling
    route = scene.accel.route(cfg)
    step = STEP_KERNEL[sched]
    want = (ROUTE_KERNELS[route] if nee else ROUTE_KERNELS[route][:1]) + shading_kernels(nee) + (step,)
    for kid in want:
        if counts[kid] < (iters if kid != "kc" else 1):
            raise SystemExit(f"[{label}] FAIL: {counts[kid]} {KERNELS[kid][0]} launches for {iters} iterations")
    if counts[step] != iters:
        raise SystemExit(f"[{label}] FAIL: {counts[step]} {KERNELS[step][0]} launches for {iters} iterations of "
                         f"the {sched} schedule, not one an iteration")
    check_shading(label, counts, iters, nee, spawns=spawn_calls + (iters if sched != "rays" else 0))
    check_ray_order(label, counts, iters * (2 if nee else 1), trace_sort_launches(scene, cfg, sched))
    want += RAY_ORDER
    others = {KERNELS[kid][0]: c for kid, c in counts.items() if kid not in want and c}
    if others:
        raise SystemExit(f"[{label}] FAIL: other kernels launched: {others}")
    return want


def accounting(stats):
    """What bench.py reports of render_frame_stats's stats."""
    return dict(path_segments=int(stats["segments"]), shadow_segments=int(stats["shadow_segments"]),
                schedule=stats["schedule"])


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


def step_kw(cfg, pixels=None):
    """The stream step's keywords for `cfg` over `pixels` (None: the whole
    frame; an affine range (base, count); an id tensor)."""
    spp = cfg.samples_per_launch
    return dict(spp=spp, n_pix=_pixel_count(cfg, pixels), max_depth=cfg.max_depth,
                rr_reference=cfg.rr_mode == "reference", inv_spp=1.0 / spp, **_pixel_map(pixels))


def state_keys(cfg):
    """The stream's lane state that the step reads and writes."""
    return fs.STATE_KEYS + (("spec_last",) if cfg.env_importance_sampling else ())


def lane_state(scene, cfg, camera, iters, retiring=False, pixels=None):
    """The lane pool of the unfused stream over `pixels` (as step_kw takes
    them) after `iters` iterations (with `retiring`, and then as many more
    as it takes until the next step retires a pixel) and the payload of its
    next trace: (state, payload, head, the camera-path function); under
    NEE also the shadow count so far (else None) last."""
    dev = scene.device
    kw = step_kw(cfg, pixels)
    n_pix = kw["n_pix"]
    lanes = min(resolve_stream_lanes(cfg, n_pix), n_pix)
    spawn = _spawner(camera_arrays(camera, cfg, dev), cfg, 0, 0)
    st = _stream_state(cfg, spawn, functools.partial(fs.slot_pixels, n_pix=n_pix, **_pixel_map(pixels)), lanes, dev)
    out = torch.zeros((n_pix + 1, 3), device=dev)
    head = torch.tensor(lanes, dtype=torch.int64, device=dev)
    seg = torch.zeros((), dtype=torch.int64, device=dev)
    shadow = seg.clone() if cfg.env_importance_sampling else None
    keys = state_keys(cfg)

    def trace():
        return _trace_bounce(scene, cfg, st["origin"], st["direction"], st["attenuation"], st["radiance"],
                             st["seeds"], st["depth"], st["spec_last"])

    def retires(tb):
        copy = {k: st[k].clone() for k in keys}
        return int(fs.fused_stream_step_plain(tb, copy, out.clone(), head, seg, shadow, **kw)[1]) > int(head)

    tb = trace()
    for k in range(iters + (1000 if retiring else 0)):
        if k >= iters and retires(tb):
            break
        lane = {key: st[key] for key in keys}
        regen, head, seg, _, *shadow_n = fs.fused_stream_step_plain(tb, lane, out, head, seg, shadow, **kw)
        shadow = shadow_n[0] if shadow_n else None
        st.update(lane)
        _respawn(st, regen, spawn, cfg.samples_per_launch)
        tb = trace()
    return (st, tb, head, spawn) + ((shadow,) if cfg.env_importance_sampling else ())


def step_bytes(tb, st, regen, n_pix, spp, rr_reference, nee=False, ids=False):
    """Bytes the schedule step must move on this lane state, by what each
    lane's fate needs (the kernel reads and writes more: every lane's
    state): every lane reads its slot and writes its regen byte; a live
    lane reads the payload's seed, done flag, attenuation and radiance and
    writes its seed; a lane that goes on reads the payload's origin and
    direction and its depth, and writes origin, direction, attenuation,
    radiance and depth; a lane whose path ends reads and writes its pixel
    sum and sample count; one that respawns writes attenuation, radiance
    and depth; one whose pixel is done reads and writes its image row and
    writes slot and pix (and with `ids` reads its table entry); head and
    segments are read and head, segments and the live count written once.
    Under NEE every lane also writes its env credit and reads the
    payload's (1 B each, 4 B under MIS: 2 or 8), and a live lane reads
    its hit flag (1 B); the shadow count is read and written once.
    Returns (bytes, live lanes, pixels done)."""
    live = st["slot"] < n_pix
    _, newly, adv, _, _ = fs.roulette(tb, live, rr_reference)
    done = newly & (st["sample_i"] + newly.to(torch.int32) >= spp)
    n_live, n_adv, n_newly, n_regen, n_done = (int(m.sum()) for m in (live, adv, newly, regen, done))
    n_bytes = (live.shape[0] * (4 + 1) + n_live * (8 + 1 + 12 + 12 + 8) + n_adv * (24 + 4 + 48 + 4)
               + n_newly * 2 * (12 + 4) + n_regen * (24 + 4) + n_done * (2 * 12 + 4 + 4 + 4 * ids) + 5 * 8)
    if nee:
        n_bytes += live.shape[0] * 2 * st["spec_last"].element_size() + n_live + 2 * 8
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


L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def _time_cold(fn, inputs):
    """Mean device ms of fn(x) over inputs[1:], after fn(inputs[0]) as
    warm-up, each call timed by its own pair of events with the L2 flushed
    just before it (a 256 MB buffer zeroed outside the pair), so that no
    call reads from L2 what the one before left there: a time to set
    beside a bound in HBM bytes.  The card first spins while the host
    queues every call, so a pair times the kernel and not the host; if the
    spin ends before the host has queued the last call, it tries again
    with a spin four times as long."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn(inputs[0])
    torch.cuda.synchronize()
    cycles = 40_000_000
    for _ in range(3):
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in inputs[1:]]
        spun = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        spun.record()
        for (start, stop), x in zip(pairs, inputs[1:]):
            flush.zero_()
            start.record()
            fn(x)
            stop.record()
        late = spun.query()  # the spin was over before the last call was queued
        torch.cuda.synchronize()
        if not late:
            return sum(start.elapsed_time(stop) for start, stop in pairs) / len(pairs)
        cycles *= 4
    raise SystemExit("FAIL: the host could not queue the timed calls ahead of the card")


# Kernel 7's pools: (name, the lanes' frame, pool size, unfused iterations
# before the step, and then more until a step retires pixels); the first,
# the headline's 131,072, is the main path's.
FUSED_POOLS = (("headline", HEADLINE, 131_072, 16), ("config 1", CONFIG1, 16_384, 16),
               ("headline", HEADLINE, 128, 16), ("headline", HEADLINE, 524_288, 16))


def phase_fused_kernel(label, scenes, smi, parent=None):
    """Kernel 7 against its plain version on real lane states: the
    headline's at 131,072 lanes (the main path's pool), BASELINE config
    1's at its 16,384 and the headline's at 128 and 524,288 lanes; both
    rr_modes, the real head and one that sends lanes past n_pix; state,
    image, regen mask, head, segments and live count bit-equal.  Timed in
    reference mode at each pool with its bound (and, with `parent`, the
    parent's libraries, its kernel 7 on the same states, in turns); the plain version
    and the schedule tails at the main path's pool.  Then 32 consecutive
    fused steps (trace, kernel, respawn) on one never-cleared scratch,
    bit-equal to the plain version's at every step, and one step repeated
    4,200 times on one scratch, each launch equal to the plain version."""
    numbers, lines = {}, []
    for pool, (name, frame, lanes, iters) in enumerate(FUSED_POOLS):
        for rr_mode in ("reference", "standard"):
            cfg = RenderConfig(**{**frame, "rr_mode": rr_mode, "stream_lanes": lanes})
            scene = scenes[name]
            st, tb, head, spawn = lane_state(scene, cfg, Camera(), iters, retiring=True)
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
                with using_libraries(parent if who == "parent" else None):
                    times[who].append(_time_over(kernel, [copy() for _ in range(21)], device_only=True))
            ms = sum(times["kernel"]) / len(times["kernel"])
            n_bytes, n_live, n_done = step_bytes(tb, st, probe[0], n_pix, spp, True)
            flops = 15 * n_live + 6 * n_done  # RR draw and estimator per live lane; the mean and the add per pixel done
            t_ops, t_bytes = flops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
            row = dict(max_abs_err=0.0, ms=ms, bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None)
            if parent:
                row["parent_ms"] = sum(times["parent"]) / len(times["parent"])
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
                    _respawn(s, fs.fused_stream_step_plain(tb, s, out_k, head, seg, **kw)[0], spawn, spp)

                def fused_tail(s):
                    _respawn(s, fs.fused_stream_step_cuda(tb, s, out_k, head, seg, **kw)[0], spawn, spp)

                timing += (f"; unfused schedule tail (plain step and respawn, eager) "
                           f"{_time_over(unfused_tail, [copy() for _ in range(6)]):.4f} ms, fused tail (kernel + "
                           f"respawn) {_time_over(fused_tail, [copy() for _ in range(6)]):.4f} ms")
                numbers = row
                steps_line = (fused_steps(label, scene, cfg, st, head, spawn) + "; "
                              + lookback_repeats(label, tb, st, head, seg, kw, n_pix))
            print(f"[{label}] fused_step timing: {timing} | {smi}")
    print(f"[{label}] fused_step: bit-equal (0 ulp) in state, image, regen mask, head, segments and live count: "
          f"{'; '.join(lines)}; {steps_line} | {smi}")
    return numbers


def fused_steps(label, scene, cfg, st, head, spawn, steps=32):
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
        _respawn(st_k, regen_k, spawn, cfg.samples_per_launch)
        _respawn(st_p, regen_p, spawn, cfg.samples_per_launch)
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


# Kernel 7 off the fused stream's envelope: (name, RenderConfig fields over
# HEADLINE, pixels as render_pixels takes them: "ids" is every other pixel
# of the frame, last first).
STREAM_STEP_CASES = (
    ("headline NEE", NEE, None),
    ("headline range", {}, (1_036_800, 1_036_800)),  # the second of two pixel shards
    ("headline ids", {}, "ids"),
)


def phase_stream_step(label, scene, smi):
    """Kernel 7 widened (every pixel map, NEE) against its plain version
    on real lane states of the unfused stream at the headline's 131,072
    lanes after 16 iterations (and until a step retires pixels): under NEE
    (the shadow count and the env credit), on an affine range (the second
    half of the frame, as the second of two pixel shards renders it) and
    on an id list (every other pixel, last first); both rr_modes where NEE
    allows, the real head and one that sends lanes past n_pix; state,
    image, regen mask, head, segments, live count and shadow count
    bit-equal.  Timed with the L2 flushed before each launch
    (_time_cold), beside the plain version and the bound of the bytes the
    step must move (step_bytes).  Returns the numbers of each case."""
    n_frame = HEADLINE["width"] * HEADLINE["height"]
    numbers = {}
    for name, over, pixels in STREAM_STEP_CASES:
        if pixels == "ids":
            pixels = torch.arange(n_frame - 1, -1, -2, dtype=torch.int32, device="cuda")
        elif isinstance(pixels, tuple):  # the base as the render's plan holds it: a 0-d tensor on the card
            pixels = (torch.tensor(pixels[0], dtype=torch.int64, device="cuda"), pixels[1])
        nee = "env_importance_sampling" in over
        for rr_mode in ("standard",) if nee else ("reference", "standard"):
            cfg = RenderConfig(**{**HEADLINE, **over, "rr_mode": rr_mode, "stream_lanes": 131_072})
            st, tb, head, _, *shadow = lane_state(scene, cfg, Camera(), 16, retiring=True, pixels=pixels)
            shadow = shadow[0] if shadow else None
            kw, keys, dev = step_kw(cfg, pixels), state_keys(cfg), scene.device
            n_pix = kw["n_pix"]
            seg = torch.tensor(12345, dtype=torch.int64, device=dev)

            def copy():
                return {k: st[k].clone() for k in keys}

            probe = fs.fused_stream_step_plain(tb, copy(), torch.zeros((n_pix + 1, 3), device=dev), head, seg, shadow,
                                               **kw)
            done = int(probe[1]) - int(head)
            if not done:
                raise SystemExit(f"[{label} {name}] FAIL: no pixel retires in the step")
            lines = []
            for head_in in (head, torch.tensor(n_pix - done // 2, dtype=torch.int64, device=dev)):
                st_k, st_p = copy(), copy()
                out_k, out_p = (torch.zeros((n_pix + 1, 3), device=dev) for _ in range(2))
                got = fs.fused_stream_step_cuda(tb, st_k, out_k, head_in, seg, shadow, **kw)
                want = fs.fused_stream_step_plain(tb, st_p, out_p, head_in, seg, shadow, **kw)
                torch.cuda.synchronize()
                bad = [k for k in keys if not same_bits(st_k[k], st_p[k])]
                bad += ["out"] * (not same_bits(out_k, out_p)) + ["regen"] * (not torch.equal(got[0], want[0]))
                bad += [w for w, a, b in zip(("head", "segments", "live", "shadow"), got[1:], want[1:])
                        if int(a) != int(b)]
                if bad or len(got) != len(want):
                    raise SystemExit(f"[{label} {name}] FAIL: fused_step ({rr_mode}) and its plain version differ in "
                                     f"{bad}")
                past = int((st_k["slot"] >= n_pix).sum()) - int((st["slot"] >= n_pix).sum())
                lines.append(f"head {int(head_in)}: {done} retired, {past} past n_pix, {int(got[0].sum())} regen, "
                             f"{int(got[3])} live" + (f", shadow {int(got[4]) - int(shadow)}" if nee else ""))
            timing = ""
            if rr_mode == ("standard" if nee else "reference"):
                out_k = torch.zeros((n_pix + 1, 3), device=dev)
                ms = _time_cold(lambda s_: fs.fused_stream_step_cuda(tb, s_, out_k, head, seg, shadow, **kw),
                                [copy() for _ in range(21)])
                plain_ms = _time_over(lambda s_: fs.fused_stream_step_plain(tb, s_, out_k, head, seg, shadow, **kw),
                                      [copy() for _ in range(6)])
                n_bytes, n_live, n_done = step_bytes(tb, st, probe[0], n_pix, cfg.samples_per_launch,
                                                     cfg.rr_mode == "reference", nee=nee,
                                                     ids=isinstance(pixels, torch.Tensor))
                flops = 15 * n_live + 6 * n_done
                bound_ms, bound_by = bound(n_bytes, flops)
                numbers[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=None)
                timing = (f"; kernel {ms:.4f} ms (L2 flushed before each launch), plain {plain_ms:.4f} ms; "
                          f"{n_live} live lanes, {n_done} pixels done, {n_bytes} bytes the step must move, {flops} "
                          f"FLOP: bound {bound_ms:.4f} ms by {bound_by}")
            print(f"[{label} {name}] {st['slot'].shape[0]} lanes over {n_pix} pixels, {rr_mode}: state, image, regen "
                  f"mask, head, segments, live{' and shadow' if nee else ''} count bit-equal (0 ulp): "
                  f"{'; '.join(lines)}{timing} | {smi}")
    return numbers


def path_lane_state(scene, cfg, camera, schedule, n, iters, per=None):
    """render_rays' (schedule "rays": n camera rays, one a pixel, or `per`
    a pixel as render_pixels spawns them) or render_pixels_regen's
    ("regen": n lanes, one a pixel) buffers after `iters` iterations of
    trace, plain path step and (regen) respawn, and the payload of the
    next trace: (buffers, payload, the step's keywords)."""
    dev = scene.device
    cam = camera_arrays(camera, cfg, dev)
    spp = cfg.samples_per_launch
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    o, d, seeds = camera_ops.camera_paths(cam, cfg, 0, 0, n, **(dict(per=per) if per else dict(pix=ids)))
    zeros = torch.zeros((), dtype=torch.int64, device=dev)
    st = dict(origin=o, direction=d, seeds=seeds, attenuation=torch.ones_like(o), radiance=torch.zeros_like(o),
              depth=torch.full((n,), cfg.max_depth, dtype=torch.int32, device=dev),
              done=torch.zeros((), dtype=torch.bool, device=dev), segments=zeros, shadow=zeros.clone(),
              spec_last=_spec_start(cfg, n, dev))
    ended = torch.zeros(n, dtype=torch.bool, device=dev)
    if schedule == "rays":
        st.update(terminated=ended, result=torch.zeros_like(o))
    else:
        st.update(exhausted=ended, sample_i=torch.zeros(n, dtype=torch.int32, device=dev), accum=torch.zeros_like(o),
                  regen=torch.zeros(n, dtype=torch.bool, device=dev))
    kw = dict(schedule=schedule, spp=spp, max_depth=cfg.max_depth, rr_reference=cfg.rr_mode == "reference",
              nee=cfg.env_importance_sampling)

    def trace():
        return _trace_bounce(scene, cfg, st["origin"], st["direction"], st["attenuation"], st["radiance"],
                             st["seeds"], st["depth"], st["spec_last"])

    tb = trace()
    for _ in range(iters):
        regen = fs.path_step_plain(tb, st, **kw)
        if regen is not None:
            camera_ops.camera_paths(cam, cfg, 0, 0, n, pix=ids, sample=st["sample_i"], sample_max=spp - 1,
                                    mask=regen, out=(st["origin"], st["direction"], st["seeds"]))
        tb = trace()
    return st, tb, kw


def path_bytes(tb, st, kw):
    """Bytes the path step must move on this state, by what each lane
    needs: every lane reads its ended flag (1 B); a live lane writes, in
    regen, its regen byte (1 B: the loop's buffer already holds an ended
    lane's 0); a live lane reads the payload's seed, done flag,
    attenuation and radiance and writes its seed (41 B), under NEE also
    its hit flag (1 B); a lane that goes on reads the payload's origin and
    direction and its depth and writes origin, direction, attenuation,
    radiance and depth (80 B), under NEE reads the payload's env credit
    and writes its own (2 B, 8 B under MIS); a lane whose path ends writes
    its ended flag if it ends (1 B) and its result (12 B) in rays, in
    regen reads and writes its pixel sum and sample count (32 B), and if
    it respawns writes attenuation, radiance and depth (28 B) and its env
    credit; segments (and shadow) are read and written once, `done`
    written once.  Returns (bytes, live lanes, paths ended)."""
    regen_schedule = kw["schedule"] == "regen"
    flag = st["exhausted" if regen_schedule else "terminated"]
    live = ~flag
    _, newly, adv, _, _ = fs.roulette(tb, live, kw["rr_reference"])
    spec = st["spec_last"].element_size() if kw["nee"] else 0
    n, n_live, n_adv, n_newly = flag.shape[0], int(live.sum()), int(adv.sum()), int(newly.sum())
    n_bytes = n + n_live * (41 + (1 if kw["nee"] else 0)) + n_adv * (80 + 2 * spec) + 16 + 1
    if kw["nee"]:
        n_bytes += 16
    if regen_schedule:
        exhausted = newly & (st["sample_i"] + newly.to(torch.int32) >= kw["spp"])
        n_regen = n_newly - int(exhausted.sum())
        n_bytes += n_live + n_newly * 32 + int(exhausted.sum()) + n_regen * (28 + spec)
    else:
        n_bytes += n_newly * (1 + 12)
    return n_bytes, n_live, n_newly


# The path step's pools: (name, the schedule, RenderConfig fields over
# HEADLINE, lanes, iterations before the timed step, whether its exposed
# time behind the launch before it is measured).  The first is the 1-spp
# tile of phase 21 (render_rays at 345,600 lanes) after two bounces, then
# the same tile fresh (every lane live) and after six (nearly every lane
# ended); the last phase 22's one lane per pixel (render_pixels_regen at
# 2,073,600 lanes).
PATH_STEP_CASES = (
    ("rays, a 1-spp tile", "rays", dict(samples_per_launch=1), 345_600, 2, True),
    ("rays, a 1-spp tile after 0 iterations", "rays", dict(samples_per_launch=1), 345_600, 0, False),
    ("rays, a 1-spp tile after 6 iterations", "rays", dict(samples_per_launch=1), 345_600, 6, False),
    ("rays, a 1-spp tile, NEE", "rays", dict(NEE, samples_per_launch=1), 345_600, 2, True),
    ("regen", "regen", {}, 131_072, 6, True),
    ("regen NEE", "regen", NEE, 131_072, 6, True),
    ("regen, one lane per pixel", "regen", {}, REGEN_POOL, 6, True),
)


def phase_path_step(label, scene, smi, parent=None):
    """The path step of render_rays and render_pixels_regen against
    path_step_plain on real buffers of those schedules (PATH_STEP_CASES,
    the headline at 1080p, 10 spp; regen with the loop's regen buffer):
    every buffer (the merges, result or pixel sums and sample counts, the
    ended flags, segments, shadow, the 0-d done flag) and the regen mask
    bit-equal, launched alone and as the main path launches it, a
    programmatic dependent of the trace's last launch (the bounce kernel,
    under NEE the NEE kernel behind the any-hit traversal:
    integrator._bounce_kernels), whose captured graph's edge into it must
    be programmatic; timed with the L2 flushed before each launch
    (_time_cold), beside the plain version and the bound of the bytes the
    step must move (path_bytes); on the paired cases its exposed time
    behind that launch (paired_rounds: the bounce kernels alone, and the
    bounce kernels and the step); with `parent` (its libraries) the
    parent's path step the same ways, in turns P C C P.  Returns the
    numbers of the first case (phase 21's shape), the others under
    `cases`."""
    import tpu_pathtracer_torch.render.integrator as integrator

    first, rows = None, []
    for name, schedule, over, n, iters, paired in PATH_STEP_CASES:
        cfg = RenderConfig(**{**HEADLINE, **over})
        st, tb, kw = path_lane_state(scene, cfg, Camera(), schedule, n, iters)
        hit = integrator.intersect_scene(scene, st["origin"], st["direction"], cfg.t_min, cfg.t_max, cfg)

        def copy():
            return {k: v.clone() for k, v in st.items()}

        def trace(s_):
            return _bounce_kernels(scene, cfg, hit, s_["origin"], s_["direction"], s_["attenuation"],
                                   s_["radiance"], s_["seeds"], s_["depth"], s_["spec_last"])

        def behind(s_):
            return fs.path_step_cuda(trace(s_), s_, dependent=True, **kw)

        st_k, st_p, st_d = copy(), copy(), copy()
        regen_k = fs.path_step_cuda(tb, st_k, **kw)
        regen_p = fs.path_step_plain(tb, st_p, **kw)
        regen_d = behind(st_d)
        torch.cuda.synchronize()
        for how, got, regen in (("alone", st_k, regen_k), ("behind the trace's last launch", st_d, regen_d)):
            bad = [k for k in st if not same_bits(got[k], st_p[k])]
            if regen_p is not None and not torch.equal(regen, regen_p):
                bad.append("regen")
            if bad:
                raise SystemExit(f"[{label} {name}] FAIL: path_step launched {how} and its plain version differ in "
                                 f"{bad}")
        edge = programmatic_into_sink(f"{label} {name}", lambda: behind(copy()), (-(-n // 256), 256))
        reps = 21 if n < 1_000_000 else 11
        times = {"parent": [], "kernel": []}
        for who in ("parent", "kernel", "kernel", "parent") if parent else ("kernel",):
            with using_libraries(parent if who == "parent" else None):
                times[who].append(_time_cold(lambda s_: fs.path_step_cuda(tb, s_, **kw),
                                             [copy() for _ in range(reps)]))
        ms = sum(times["kernel"]) / len(times["kernel"])
        turns = (f" (in turns: kernel {' '.join(f'{t:.4f}' for t in times['kernel'])}, parent "
                 f"{' '.join(f'{t:.4f}' for t in times['parent'])})" if parent else "")
        exposed = None
        if paired:
            def waits(s_):  # the floor: a dependent that only waits, at the step's grid
                trace(s_)
                err = FLOOR["lib"].floor_dependent_launch(n, 256, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"FAIL: floor_dependent_launch: CUDA error {err}")

            def turn(arm, with_step):  # each turn on fresh copies: the step writes the buffers
                with using_libraries(parent if arm == "parent" else None):
                    step = waits if arm == "floor" else behind
                    return _time_cold(step if with_step else trace, [copy() for _ in range(reps)])

            exposed = paired_rounds(turn, (("parent", "change") if parent else (None,)) + ("floor",))
            turns += "; exposed behind the " + ("NEE" if kw["nee"] else "bounce") + " kernel " + ", ".join(
                f"{arm or 'change'} {exposed_text(e)}" for arm, e in exposed.items())
        plain_ms = _time_over(lambda s_: fs.path_step_plain(tb, s_, **kw), [copy() for _ in range(6)])
        n_bytes, n_live, n_newly = path_bytes(tb, st, kw)
        flops = 15 * n_live + 3 * n_newly
        bound_ms, bound_by = bound(n_bytes, flops)
        print(f"[{label} {name}] {schedule}, {n} lanes after {iters} iterations, {cfg.rr_mode}: every buffer, done "
              f"({bool(st_k['done'])}), segments (+{int(st_k['segments']) - int(st['segments'])})"
              f"{', shadow (+' + str(int(st_k['shadow']) - int(st['shadow'])) + ')' if kw['nee'] else ''}"
              f"{' and the regen mask (' + str(int(regen_k.sum())) + ' lanes)' if regen_k is not None else ''} "
              f"bit-equal (0 ulp) alone and behind the trace's last launch (captured edge {edge}); {n_live} live "
              f"lanes, {n_newly} paths ended; kernel {ms:.4f} ms (L2 flushed before each launch){turns}, plain "
              f"{plain_ms:.4f} ms; {n_bytes} bytes, {flops} FLOP: bound {bound_ms:.4f} ms by {bound_by} | {smi}",
              flush=True)
        row = dict(name=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, live=n_live)
        if parent:
            row["parent_ms"] = sum(times["parent"]) / len(times["parent"])
        if exposed:
            e = exposed[None if not parent else "change"]
            row.update(exposed_ms=e["median_ms"], exposed_q_ms=[e["q1_ms"], e["q3_ms"]],
                       exposed_floor_ms=exposed["floor"]["median_ms"])
            if parent:
                e = exposed["parent"]
                row.update(parent_exposed_ms=e["median_ms"], parent_exposed_q_ms=[e["q1_ms"], e["q3_ms"]])
        rows.append(row)
        if first is None:
            first = dict(max_abs_err=0.0, bound_by=bound_by, library_ms=None,
                         **{k: v for k, v in row.items() if k not in ("name", "live")})
        del st, tb, st_k, st_p, st_d, hit
    first["cases"] = rows[1:]
    return first


def phase_fused_render(label, scene, cfg, camera, smi):
    """Subframe 0 with the fused stream (kernel 7 every iteration) and with
    the unfused stream under ops.cuda_build.plain() (its plain step and the
    shading's plain versions: no step or shading kernel launches), one
    frame each: images bit-equal, iterations and segments identical, so
    kernel 7 is held against plain code at the render's full size.
    Returns the fused render's phase_render record."""
    fused = phase_render(f"{label} fused", scene, cfg.replace(fused_schedule="on"), camera, 1, smi, warm=False,
                         subframe=0)
    cfg_p = cfg.replace(fused_schedule="off")
    cam = camera_arrays(camera, cfg_p, scene.device)
    torch.cuda.synchronize()
    set_counts_zero()
    t0 = time.perf_counter()
    with cuda_build.plain():
        img, stats = render_frame_stats(scene, cam, cfg_p, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    kernels = {KERNELS[k][0]: counts[k] for k in ("k7", "kp") + shading_kernels(cfg.env_importance_sampling)
               + RAY_ORDER if counts[k]}
    if stats["schedule"] != "stream" or kernels:
        raise SystemExit(f"[{label}] FAIL: the plain arm took the {stats['schedule']} schedule and launched {kernels}")
    plain = dict(img=img, iters=stats["iters"], segments=int(stats["segments"]))
    if not torch.equal(fused["img"], plain["img"]):
        bad = int((fused["img"] != plain["img"]).sum())
        raise SystemExit(f"[{label}] FAIL: the fused kernels' and the unfused plain images differ on {bad} values")
    if (fused["iters"], fused["segments"]) != (plain["iters"], plain["segments"]):
        raise SystemExit(f"[{label}] FAIL: iterations/segments {fused['iters']}/{fused['segments']} fused vs "
                         f"{plain['iters']}/{plain['segments']} unfused plain")
    print(f"[{label}] the fused stream (kernel 7) and the unfused stream's plain step (ops.cuda_build.plain(), no step "
          f"or shading kernel launched) give bit-equal images, {fused['iters']} iterations and {fused['segments']} "
          f"segments each; s/launch fused {fused['seconds']:.4f} vs unfused plain {dt:.4f} (one frame each, its "
          f"graph capture included) | {smi}")
    return fused


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
    just after, and every launch recorded: (renderer, counts, launch log).
    The run's launches must all replay one captured graph: one capture
    for the run, every launch graphed."""
    set_counts_zero()
    captures = graph_loop.stats["captures"]
    with watching_launches() as log:
        renderer = cli.run([str(a) for a in argv])
    torch.cuda.synchronize()
    counts = read_counts()
    captures = graph_loop.stats["captures"] - captures
    if captures != 1 or not all(e["graphed"] for e in log):
        raise SystemExit(f"[{label}] FAIL: {captures} captures for {len(log)} launches, graphed "
                         f"{[e['graphed'] for e in log]}")
    return renderer, counts, log


def check_launches(label, counts, log, want, extra=0):
    """Each kernel of `want` launched at least once per iteration (plus
    `extra`, the AOV passes'), the shading kernels as check_shading says,
    nothing else."""
    iters = sum(entry["iters"] for entry in log)
    for kid in want:
        if counts[kid] < iters + (extra if kid in ("k1", "k2", "k3") else 0):
            raise SystemExit(f"[{label}] FAIL: {counts[kid]} {KERNELS[kid][0]} launches for {iters} iterations")
    nee = any(kid in want for kid in ("k4", "k5", "k6"))
    check_shading(label, counts, iters, nee)
    check_ray_order(label, counts, iters * (2 if nee else 1) + extra)
    others = {KERNELS[kid][0]: c for kid, c in counts.items()
              if kid not in want + shading_kernels(nee) + RAY_ORDER and c}
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
        want = ("k2", "k5", "k7") if nee else ("k2", "k7")
        iters = check_launches(label, counts, log, want)
        if not log[1]["segments"] > 0 or (nee and not log[1]["shadow_segments"] > 0):
            raise SystemExit(f"[{label}] FAIL: no segments traced")
        out["nee" if nee else "plain"] = counts
        print(f"[{label}{' NEE' if nee else ''}] {r.scene.num_triangles} triangles, {acc.num_clusters} clusters, "
              f"{rows} bytes of rows, {route} route, {log[1]['schedule']} schedule, 1920x1080 10 spp depth 8: "
              f"s/launch warm {r.frame_times[0]:.4f}, timed {r.frame_times[1]:.4f}; {iters} iterations in 2 launches, "
              f"{sum(e['syncs'] for e in log) / iters:.4f} stream syncs per iteration; launches cluster_hier "
              f"{counts['k2']}, cluster_occluded_hier {counts['k5']}, fused_step {counts['k7']} (an unfused stream "
              f"under NEE) | {smi}")
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
    captured = dict(graph_loop.captured)
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
    # Camera moves change a plan's buffers, not its key: each (config,
    # schedule, shape) the session rendered was captured once.
    session = {k: n - captured.get(k, 0) for k, n in graph_loop.captured.items() if n - captured.get(k, 0)}
    if not session or max(session.values()) != 1:
        raise SystemExit(f"[{label}] FAIL: captures per plan {sorted(session.values())}")
    print(f"[{label}] 200 from every endpoint ({', '.join(got)}); frame {before} -> {after} after /resize; "
          f"stats keys {sorted(stats)}; accumulation on {renderer.accum.device}; {renderer.subframe} launches since "
          f"the last reset, {len(session)} plans each captured once (schedules and shapes: "
          f"{sorted((k[2], *k[3:]) for k in session)}) | {smi}")


# ---------------------------------------------------------------------------
# Device profiles and A/B renders (phases 31, 34 and 38; profile_renders.py
# imports these)
# ---------------------------------------------------------------------------

# The device functions of the port's kernels (csrc/): the six traversals
# (one body, with its packet-weight pre-pass) and brute force (closest and
# any hit, one body), the schedule steps (kernel
# 7 and the path step), the unit-ball sampler, and the shading kernels:
# the bounce kernel (and its deferred entry point), the NEE kernel and the
# camera kernel; and the ray ordering around the traversal.
RAY_ORDER_FUNCTIONS = ("sort_cluster_kernel", "sort_keys_kernel", "sort_pass_kernel", "packet_order_kernel")
DEVICE_FUNCTIONS = ("streamed_kernel", "packet_weight_kernel", "brute_kernel", "fused_step_kernel",
                    "path_step_kernel", "unit_sphere_kernel", "bounce_kernel", "shade_lanes_kernel", "nee_kernel",
                    "camera_kernel") + RAY_ORDER_FUNCTIONS
# kernel_label's families, for the device time split of --plain-ab; the
# shading kernels each a family of its own.  A programmatic dependent's
# traced time (the NEE and camera kernels') begins when its blocks start,
# while the launch before it still runs, and holds its wait: what it adds
# is its exposed time (exposed_by_family).
FAMILIES = {"traversal": ("streamed_kernel", "packet_weight_kernel", "brute_kernel"),
            "schedule step": ("fused_step_kernel", "path_step_kernel"),
            "sampler": ("unit_sphere_kernel",),
            "bounce": ("bounce_kernel", "shade_lanes_kernel"),
            "nee": ("nee_kernel",),
            "camera": ("camera_kernel",),
            "ray order": RAY_ORDER_FUNCTIONS}


def kernel_label(key):
    """The port's kernel that the device function `key` belongs to, or
    None.  streamed_kernel<kAnyHit, kVisit, ...> is told apart by its first
    two template arguments: any hit or closest, and the visit order: flat
    (kernels 1 and 4), per packet (the hier route) or ascending (the
    streamed route); brute_kernel<kAnyHit, ...> by its first."""
    name = next((k for k in DEVICE_FUNCTIONS if k in key), None)
    if name == "brute_kernel":
        any_hit = key.split("brute_kernel<", 1)[-1].split(">")[0].split(",")[0].strip()
        return f"brute_kernel ({'any' if any_hit in ('true', '(bool)1') else 'closest'} hit)"
    if name == "streamed_kernel":
        any_hit, visit = (a.strip() for a in key.split("streamed_kernel<", 1)[-1].split(",")[:2])
        route = ("flat" if visit.endswith("2") or visit.endswith("kFlat")
                 else "hier" if visit.endswith("1") or visit.endswith("kPerPacket") else "streamed")
        return f"streamed_kernel ({route}, {'any' if any_hit in ('true', '(bool)1') else 'closest'} hit)"
    return name


# Host seconds a profile's window holds before the first launch and after
# the card is done.  The trace keeps only device events whose times, moved
# onto the host's clock, fall inside its window, and the move can be off by
# milliseconds (kernels traced before the host call that launched them:
# _profiled's `lead_ms`, PERF.md): without the margin a trace loses its
# first kernels, or all of them.
PROFILE_MARGIN_S = 0.02


def trace(run, retakes=2):
    """run() under torch.profiler (CUDA activity), as every trace here is
    taken: PROFILE_MARGIN_S of host time in the window before the first
    launch and after the card is done, a throwaway spin kernel first (a
    trace's first kernel can go untraced, PERF.md §6), and the trace taken
    again, up to `retakes` times, while some host launch after the spin
    has no device event.  Returns a dict: `out` (run()'s result), `wall`
    (its seconds, to the card done), `device` (the device events but the
    spin's: kernels, copies, memsets), `launches` (the host's kernel and
    graph launch calls after the spin), `complete` (every one of them has
    a device event), `retakes` (short traces before it), `spin_lost`
    (traces whose spin went untraced) and `lead_ms` (the most that a
    kernel's traced start came before the host call that launched it: the
    trace's clock error)."""
    cuda = torch.autograd.DeviceType.CUDA
    spin_lost = 0
    for k in range(retakes + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            torch.cuda._sleep(1000)
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_MARGIN_S)
        events = list(prof.profiler.kineto_results.events())
        launches = sorted((e for e in events
                           if e.device_type() != cuda and e.name().startswith("cu") and "Launch" in e.name()),
                          key=lambda e: e.start_ns())
        spin = launches[0].correlation_id() if launches else None
        device = [e for e in events if e.device_type() == cuda and e.correlation_id() != spin]
        started = {}
        for e in device:  # a graph launch's kernels share its correlation id
            started[e.correlation_id()] = min(e.start_ns(), started.get(e.correlation_id(), e.start_ns()))
        spin_lost += len(device) == sum(e.device_type() == cuda for e in events)
        complete = bool(device) and all(e.correlation_id() in started for e in launches[1:])
        if complete or k == retakes:
            lead = max([0, *(e.start_ns() - started[e.correlation_id()] for e in launches[1:]
                             if e.correlation_id() in started)])
            return dict(out=out, wall=wall, device=device, launches=launches[1:], complete=complete, retakes=k,
                        spin_lost=spin_lost, lead_ms=lead / 1e6)


def device_events(t):
    """{name: [count, device seconds]} over a trace's device events
    (`trace`): kernels, copies and memsets."""
    table = {}
    for e in t["device"]:
        row = table.setdefault(e.name(), [0, 0.0])
        row[0] += 1
        row[1] += e.duration_ns() / 1e9
    return table


def busy_seconds(t):
    """Device busy seconds of a trace (`trace`): the union of its device
    events' intervals, so that a programmatic dependent, whose traced
    time begins while the launch before it still runs, is not counted
    twice (without overlap, the sum of their times)."""
    busy, last = 0, None
    for e in sorted(t["device"], key=lambda e: e.start_ns()):
        end = e.start_ns() + e.duration_ns()
        busy += max(0, end - max(e.start_ns(), last if last is not None else e.start_ns()))
        last = end if last is None else max(last, end)
    return busy / 1e9


def exposed_by_family(t):
    """{family: device seconds} of a trace's device events (`trace`) that
    no earlier event covers: each event's end less the latest end of the
    events that started before it (0 where that is later), so that a
    kernel that overlaps the one before it (a programmatic dependent)
    counts only what it adds, and one that follows a gap counts the gap.
    The card runs one stream."""
    out = collections.Counter()
    last = None
    for e in sorted(t["device"], key=lambda e: e.start_ns()):
        end = e.start_ns() + e.duration_ns()
        out[family(e.name())] += max(0, end - (e.start_ns() if last is None else last)) / 1e9
        last = end if last is None else max(last, end)
    return out


def launch_calls(t):
    """{name: count} of a trace's host calls that launch work on the
    device: kernel launches and graph launches."""
    return collections.Counter(e.name() for e in t["launches"])


def arm(eager=False, plain=False):
    """The context of a frame: the eager loop or the graphed one, the
    plain versions of the shading kernels or the kernels."""
    stack = contextlib.ExitStack()
    if eager:
        stack.enter_context(graph_loop.eager())
    if plain:
        stack.enter_context(cuda_build.plain())
    return stack


def frame(scene, cam, cfg, subframe, eager, plain=False):
    """One frame, eagerly or graphed: (seconds, image, stats)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with arm(eager, plain):
        img, stats = render_frame_stats(scene, cam, cfg, subframe)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, img, stats


def profiled(scene, cam, cfg, subframe, eager, plain=False, events_out=None, retakes=2, exposed_out=None):
    """One frame under the profiler, traced as `trace` traces (its margin,
    its spin, up to `retakes` retakes): (wall, device busy, device kernels,
    host launch calls {name: count}, stats, the trace's `complete`,
    `retakes` and `lead_ms`); `events_out`, a dict, gets the device events
    {name: [count, seconds]}, `exposed_out` the exposed device seconds by
    family (exposed_by_family)."""
    with arm(eager, plain):
        t = trace(lambda: render_frame_stats(scene, cam, cfg, subframe)[1], retakes)
    events = device_events(t)
    if events_out is not None:
        events_out.update(events)
    if exposed_out is not None:
        exposed_out.update(exposed_by_family(t))
    return (t["wall"], busy_seconds(t), sum(c for c, _ in events.values()), launch_calls(t),
            t["out"], {k: t[k] for k in ("complete", "retakes", "lead_ms")})


def family(key):
    """The FAMILIES name of the device event `key`, or "rest"."""
    return next((f for f, names in FAMILIES.items() if any(n in key for n in names)), "rest")


def family_split(events):
    """Device seconds by family of device_events' table."""
    split = collections.Counter()
    for key, (_, sec) in events.items():
        split[family(key)] += sec
    return split


def kernels_ab(label, scene, cam, cfg, smi, frames=1, order=(True, False, False, True), retakes=2):
    """The shading kernels against their plain versions (ops.cuda_build.plain())
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
        events, exposed = {}, {}
        wall, busy, kernels, _, st, tr = profiled(scene, cam, cfg, 1, False, plain=name == "plain", events_out=events,
                                                  retakes=retakes, exposed_out=exposed)
        iters = st["iters"]
        split = family_split(events)
        rest = sorted(((sec, c, key) for key, (c, sec) in events.items() if family(key) == "rest"), reverse=True)[:4]
        mean = sum(row["times"]) / len(row["times"])
        row.update(seconds=mean, busy=busy, idle=1 - busy / mean, kernels=kernels / iters, iters=iters,
                   split={f: sec / iters for f, sec in split.items()},
                   exposed={f: sec / iters for f, sec in exposed.items()}, events=events)
        parts.append(
            f"{name}: s/launch {' '.join(f'{t:.4f}' for t in row['times'])} (mean {mean:.4f}), first frame "
            f"{row['first']:.4f} s, graph pool {row['pool_bytes']} bytes; profiled wall {wall:.4f} s, device busy "
            f"{busy:.4f} s, idle share of the mean s/launch {row['idle']:.2%}, {row['kernels']:.1f} device kernels per "
            f"iteration (trace {'complete' if tr['complete'] else 'INCOMPLETE'} after {tr['retakes']} retakes, "
            f"clock lead {tr['lead_ms']:.4f} ms); device ms per iteration (exposed): "
            + ", ".join(f"{f} {sec * 1e3 / iters:.4f} ({exposed.get(f, 0.0) * 1e3 / iters:.4f})"
                        for f, sec in split.most_common())
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


def ab_render(label, scene, cam, cfg, smi, frames=2, order=(True, False, False, True), profile_eager=True,
              retakes=2):
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
            wall, busy, kernels, calls, st, tr = profiled(scene, cam, cfg, 1, eager, retakes=retakes)
            row.update(busy=busy, idle=1 - busy / mean, kernels=kernels / st["iters"],
                       calls={k: v / st["iters"] for k, v in calls.items()})
            calls_desc = ", ".join(f"{k} {v:.2f}" for k, v in row["calls"].items()) or "not measured"
            desc += (f"; profiled wall {wall:.4f} s, device busy {busy:.4f} s, idle share of the mean s/launch "
                     f"{row['idle']:.2%} (of the profiled wall {1 - busy / wall:.2%}), {row['kernels']:.1f} device "
                     f"kernels per iteration (trace {'complete' if tr['complete'] else 'INCOMPLETE'} after "
                     f"{tr['retakes']} retakes), host launch calls per iteration: {calls_desc}")
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



def phase_graph_ab(label, scene, hero, root, smi):
    """Every schedule and route of the main path run eagerly
    (`graph_loop.eager()`) and graphed, one frame each way after a first
    graphed frame that captures (ab_render): the
    headline on the fused stream and with NEE (unfused stream, kernels 1
    and 4), BASELINE config 1, config 4 with NEE (kernels 2 and 5), the
    200k scene (kernel 3), 1 spp in six tiles (render_rays) and the hero
    stand-in at its scene file's config.  Images, iterations and segments
    bit-equal; one capture each; every iteration of the profiled graphed
    frame one graph launch; s/launch both ways, the graphed frame's idle
    share, capture seconds and graph pool bytes.  Then each render graphed
    with the shading kernels' plain versions (ops.cuda_build.plain()) and
    with the kernels (kernels_ab): bit-equal, the plain
    arm launching the sampler and no shading kernel, the kernels' arm the
    reverse.  Returns the plain arm's launch counts on the headline (the
    sampler's, for the kernels line)."""
    cfg, cfg_nee, cam4 = RenderConfig(**HEADLINE), RenderConfig(**{**HEADLINE, **NEE}), Camera(**CONFIG4_CAMERA)
    hero_scene, hero_camera, hero_cfg = load_scene_file(str(hero), device="cuda", cache_dir=str(root / "cache"))
    cases = (
        ("headline fused", lambda: scene, Camera(), cfg),
        ("headline NEE", lambda: scene, Camera(), cfg_nee),
        ("config 1", lambda: config1_scene("cuda"), Camera(), RenderConfig(**CONFIG1)),
        ("config 4 NEE", lambda: high_poly(100_000, "cuda"), cam4, cfg_nee),
        ("200k", lambda: high_poly(200_000, "cuda"), cam4, cfg),
        ("1 spp tiles", lambda: scene, Camera(), cfg.replace(samples_per_launch=1, tile_pixels=345_600)),
        ("hero", lambda: hero_scene, hero_camera, hero_cfg),
    )
    summary, plain_summary, plain_counts = [], [], None
    for name, make, camera, c in cases:
        scene_n, cam = make(), camera_arrays(camera, c, "cuda")
        # One trace a profiled frame here: a retake repeats the frame and the
        # reading of its trace, which took minutes over phase 34 and mostly
        # came short again (PERF.md §7); profile_renders.py retakes.
        row = ab_render(f"{label} {name}", scene_n, cam, c, smi, frames=1, order=(True, False), profile_eager=False,
                        retakes=0)
        graph_launches = row["graphed"]["calls"].get("cudaGraphLaunch")
        if row["captures"] != 1 or graph_launches != 1.0:
            raise SystemExit(f"[{label} {name}] FAIL: {row['captures']} captures, {graph_launches} graph launches "
                             f"per iteration")
        summary.append(f"{name} {row['eager']['seconds']:.4f} -> {row['graphed']['seconds']:.4f} "
                       f"({row['eager']['seconds'] / row['graphed']['seconds']:.2f}x, idle {row['graphed']['idle']:.1%})")
        # The shading kernels against their plain versions (ops.cuda_build.plain()), both graphed.
        ab = kernels_ab(f"{label} {name} plain vs kernels", scene_n, cam, c, smi, frames=1, order=(True, False),
                        retakes=0)
        counts = {arm: ab[arm]["counts"] for arm in ("plain", "kernels")}
        if counts["kernels"]["random_in_unit_sphere"] or not counts["plain"]["random_in_unit_sphere"] or any(
                counts["plain"][k] for k in ("bounce", "next_event", "camera_paths", "path_step", "sort_rays",
                                             "caller_order_stores", "packet_order")) or not all(
                counts["kernels"][k] for k in ("sort_rays", "caller_order_stores")):
            raise SystemExit(f"[{label} {name}] FAIL: launches plain {counts['plain']}, kernels {counts['kernels']}")
        # the restore is the traversal's store: no restore kernel on the kernels' arm
        restores = {k: c for k, (c, _) in ab["kernels"]["events"].items() if "restore" in k}
        if restores:
            raise SystemExit(f"[{label} {name}] FAIL: restore kernels launched on the kernels' arm: {restores}")
        if name == "headline fused":
            plain_counts = counts["plain"]
        plain_summary.append(f"{name} {ab['plain']['seconds']:.4f} -> {ab['kernels']['seconds']:.4f} "
                             f"({ab['plain']['kernels']:.1f} -> {ab['kernels']['kernels']:.1f} device kernels per "
                             f"iteration)")
        del scene_n
    print(f"[{label}] s/launch eager -> graphed: " + "; ".join(summary) + f" | {smi}")
    print(f"[{label}] s/launch plain -> kernels (graphed): " + "; ".join(plain_summary) + f" | {smi}")
    return plain_counts


# ---------------------------------------------------------------------------
# The shading kernels against their plain versions (phases 35-37)
# ---------------------------------------------------------------------------

# Float operations a lane at least, counted from the sources (the bounce
# kernel's shade without texture taps, extra sampler draws or NEE; the NEE
# kernel without MIS; the camera kernel without DOF).  The bounds are set
# by bytes either way.
BOUNCE_LANE_FLOPS = 500
NEE_LANE_FLOPS = 100
CAMERA_LANE_FLOPS = 40


def bound(n_bytes, flops):
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def shade_inputs(scene, cfg, camera, n_cam, seed=17):
    """bounce_batch's 2 x n_cam rays (camera rays and their first bounce,
    sorted as the accel sorts them), their closest hits and a seeded lane
    state: attenuation in [0.2, 1.2), radiance in [0, 0.5), seeds from the
    (lane, 0, seed) counters, depth max_depth with 0 on a tenth, NEE's env
    credit.  Returns the argument tuple of _bounce_kernels."""
    o, d = bounce_batch(scene, cfg, camera, n_cam)
    n, dev = o.shape[0], o.device
    hit = scene.accel.intersect(scene.vertices, o, d, cfg.t_min, cfg.t_max, cfg)
    rs = np.random.RandomState(seed)
    att = torch.as_tensor((rs.rand(n, 3) + 0.2).astype(np.float32), device=dev)
    rad = torch.as_tensor((rs.rand(n, 3) * 0.5).astype(np.float32), device=dev)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    seeds = rng.make_seeds(idx, torch.zeros_like(idx), seed)
    depth = torch.as_tensor(np.where(rs.rand(n) < 0.1, 0, cfg.max_depth).astype(np.int32), device=dev)
    spec = None
    if cfg.env_importance_sampling:
        spec = torch.as_tensor(rs.rand(n).astype(np.float32) if cfg.nee_mis_spec else rs.rand(n) < 0.5, device=dev)
    return scene, cfg, hit, o, d, att, rad, seeds, depth, spec


def render_pool(scene, cfg, camera):
    """The arguments of `_bounce_kernels` in the middle iteration of one
    eager frame at subframe 1 (the iteration count from a graphed frame
    first), the lane state copied: the lanes as the bounce kernel gets them
    mid-render.  The eager loop is bit-equal to the graphed one (phase
    34).  Returns (the arguments, that iteration, the frame's iterations)."""
    import tpu_pathtracer_torch.render.integrator as integrator

    cam = camera_arrays(camera, cfg, "cuda")
    _, stats = render_frame_stats(scene, cam, cfg, 1)
    mid, calls, pool = stats["iters"] // 2, [0], {}
    real = integrator._bounce_kernels

    def spy(*args):
        calls[0] += 1
        if calls[0] == mid:
            pool["args"] = tuple(x.clone() if isinstance(x, torch.Tensor) else
                                 Hit(*(y.clone() for y in (x.t, x.prim, x.bary, x.hit))) if isinstance(x, Hit) else x
                                 for x in args)
        return real(*args)

    integrator._bounce_kernels = spy
    try:
        with graph_loop.eager():
            render_frame_stats(scene, cam, cfg, 1)
    finally:
        integrator._bounce_kernels = real
    return pool["args"], mid, stats["iters"]


def first_lanes(args, n):
    """_bounce_kernels' arguments cut to their first n lanes."""
    return tuple(x[:n].contiguous() if isinstance(x, torch.Tensor) else
                 Hit(*(y[:n].contiguous() for y in (x.t, x.prim, x.bary, x.hit))) if isinstance(x, Hit) else x
                 for x in args)


def bounce_lane_sets(scene, config1):
    """The bounce kernel's two sets of lanes at 16,384 and 131,072 lanes:
    [(name, _bounce_kernels' arguments)]: "camera", shade_inputs' camera
    rays and their first bounces on the headline (`scene`; nearly every
    camera ray hits), and "render", the headline's fused-stream pool in
    the middle iteration of a frame (render_pool) and its first 16,384
    lanes, and BASELINE config 1's pool (`config1`) in the middle of its
    frame."""
    cfg = RenderConfig(**HEADLINE)
    sizes = (2 * CAMERA_RAYS, CONFIG1_POOL)
    sets = [(f"camera {n}", shade_inputs(scene, cfg, Camera(), n // 2)) for n in sizes]
    pool, mid, iters = render_pool(scene, cfg, Camera())
    sets += [(f"render {n} (headline, iteration {mid} of {iters})", first_lanes(pool, n)) for n in sizes]
    pool1, mid1, iters1 = render_pool(config1, RenderConfig(**CONFIG1), Camera())
    sets.append((f"render {pool1[3].shape[0]} (config 1, iteration {mid1} of {iters1})", pool1))
    return sets


def hit_shares(args):
    """The share of the lanes that hit, and of the warps (32 lanes) that
    mix hits and misses."""
    hit = args[2].hit
    n = hit.shape[0]
    warps = hit[: n - n % 32].reshape(-1, 32).to(torch.int32).sum(dim=1)
    return float(hit.float().mean()), float(((warps > 0) & (warps < 32)).float().mean())


def distinct_rows(index, row_bytes):
    return int(torch.unique(index).numel()) * row_bytes


def env_rows(scene, cfg, directions):
    """The equirect quad rows eval_env reads for `directions` (none in the
    other modes), as sample_equirect computes them."""
    if cfg.env_mode != "equirect" or directions.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=directions.device)
    env = scene.env
    u, v = direction_to_uv(directions)
    xi0 = torch.remainder(torch.floor(u * env.width - 0.5).to(torch.int32), env.width)
    yi0 = torch.clamp(torch.floor(v * env.height - 0.5).to(torch.int32), 0, env.height - 1)
    rows = (yi0 * env.width + xi0).to(torch.int64)
    if env.quads_scrambled:
        rows = ((rows & 0xFFFFFFFF) * SCRAMBLE_MULT) & (env.height * env.width - 1)
    return rows


def bounce_bytes(args, cand=None):
    """Bytes the bounce must move on these lanes, by what each lane needs:
    every lane reads its hit flag, origin, direction, attenuation,
    radiance and seed (57 B) and writes its payload (57 B); a hit also
    reads t, prim, uv and depth (20 B), its tri_attrs row (128 B) and
    material row (160 B), a miss its env quad row (48 B) and, under NEE,
    its env credit (1 B, or 4 B under nee_mis_spec); each distinct row
    counts once.  Under NEE (`cand`: the candidate mask) every lane writes
    its candidate flag (1 B) and a candidate its shadow ray (24 B); the
    96 B record is the port's own intermediate, left out (the NEE kernel
    counts the fields it must read).  Texture and alias-table rows are
    not counted: a lower bound."""
    scene, cfg, hit, o, d = args[:5]
    n, n_hit = o.shape[0], int(hit.hit.sum())
    n_bytes = n * (57 + 57) + n_hit * 20
    if cfg.env_importance_sampling:
        n_bytes += (n - n_hit) * (4 if cfg.nee_mis_spec else 1) + n + int(cand.sum()) * 24
    prim = hit.prim[hit.hit].long()
    mats = scene.tri_attrs[prim, 24].long()
    return (n_bytes + distinct_rows(prim, 128) + distinct_rows(mats, 160)
            + distinct_rows(env_rows(scene, cfg, d[~hit.hit]), 48))


NEE_FLAG_GLASS, NEE_FLAG_CHOOSE_SPEC = 4, 8  # csrc/shade_math.cuh: nee_record


def nee_bytes(args, b, visible):
    """Bytes the NEE function must move on these lanes, by what each lane
    needs: every lane its flags (4 B) and spec_next (1 B, or 4 B under
    nee_mis_spec); a candidate its any-hit flag (1 B); a visible lane its
    light draw (direction, pdf, u, v, cos_l: 28 B), spec_prob, IdotN and
    brdf (20 B), attenuation (12 B), radiance read and written (24 B) and
    its env quad row (48 B, each distinct row once); under nee_mis_spec a
    visible lane also its alpha, f_vec, albedo and ray direction (40 B),
    a lane that chose the spec lobe off glass its spec_dir and spec_pdf
    (16 B), and either its normal (12 B) where it uses it (visible lanes,
    and those spec lanes under the defensive mixture).  The record is the
    port's own intermediate: only the fields a lane needs count.
    Alias-table rows are not counted: a lower bound."""
    scene, cfg = args[:2]
    n, mis = b["record"].shape[1], cfg.nee_mis_spec
    n_vis = int(visible.sum())
    n_bytes = n * (4 + (4 if mis else 1)) + int(b["cand"].sum()) + n_vis * (28 + 20 + 12 + 24)
    if mis:
        flags = b["record"][23].view(torch.int32)
        w_b = ((flags & NEE_FLAG_CHOOSE_SPEC) != 0) & ((flags & NEE_FLAG_GLASS) == 0)
        normal = visible | w_b if cfg.nee_defensive_mix else visible
        n_bytes += n_vis * 40 + int(w_b.sum()) * 16 + int(normal.sum()) * 12
    return n_bytes + distinct_rows(env_rows(scene, cfg, b["shadow_dir"][visible]), 48)


def bounce_checked(args):
    """The bounce kernels (_bounce_kernels) and _bounce_plain on `args`:
    (the bounce kernel's outputs under NEE, else None; the payload fields,
    and under NEE the shadow rays, candidates and record fields, that
    differ from the plain version)."""
    scene, cfg, hit, o, d, att, rad, seeds, depth, spec = args
    got = _bounce_kernels(*args)
    want = _bounce_plain(*args)
    torch.cuda.synchronize()
    bad = [k for k, w in want.items() if w is not None and not same_bits(got[k], w)]
    if not cfg.env_importance_sampling:
        return None, bad
    b = bounce_ops.bounce(*args)
    sh = _shade(scene, cfg, hit, o, d, seeds, depth)
    _, env_dir, pdf, u, v = _light_sample(scene, cfg, sh, sh["seeds"])
    cand, cos_l = _shadow_candidates(hit.hit, sh, env_dir)
    rec = b["record"].T
    pairs = dict(shadow_origin=(b["shadow_origin"], sh["new_origin"]), shadow_dir=(b["shadow_dir"], env_dir),
                 cand=(b["cand"], cand), normal=(rec[:, 0:3], sh["normal"]), alpha=(rec[:, 3], sh["alpha"]),
                 spec_prob=(rec[:, 4], sh["spec_prob"]), idotn=(rec[:, 5], sh["idotn"]),
                 brdf=(rec[:, 6:9], sh["brdf_combined"]), f_vec=(rec[:, 9:12], sh["f_vec"]),
                 albedo=(rec[:, 12:15], sh["diffuse_albedo"]), spec_dir=(rec[:, 15:18], sh["spec_dir"]),
                 spec_pdf=(rec[:, 18], sh["spec_pdf"]), pdf=(rec[:, 19], pdf), u=(rec[:, 20], u),
                 v=(rec[:, 21], v), cos_l=(rec[:, 22], cos_l))
    torch.cuda.synchronize()
    return b, bad + [k for k, (g, w) in pairs.items() if not same_bits(g.contiguous(), w)]


def phase_bounce_kernel(label, cases, smi):
    """The bounce kernel (with, under NEE, the any-hit traversal of its
    shadow rays and the NEE kernel) against its plain version,
    _bounce_plain, on each case's lanes (`cases`: name, _bounce_kernels'
    arguments from shade_inputs or bounce_lane_sets): every payload field
    bit-equal, and under NEE the shadow rays, candidates and record equal
    _shade's, _light_sample's and _shadow_candidates' (bounce_checked);
    the kernel's device time (the bounce kernel alone, 50 launches each
    after an L2 flush: _time_cold), the plain version's (under NEE: both
    kernels against _bounce_plain, the any-hit answer fixed on both
    sides), the bound, and each case's share of hits and of warps that mix
    hits and misses.  First what the card made of the kernel: registers,
    local memory and blocks an SM (cudaFuncGetAttributes), and nvcc's
    spills.  Returns the numbers of the first case."""
    import tpu_pathtracer_torch.render.integrator as integrator

    log = cuda_build.library_path("bounce.cu").with_suffix(".log").read_text()
    spills = {k: v for name, v in cuda_build.ptxas_report(log).items() for k in ("bounce_kernel", "shade_lanes_kernel")
              if k in name}
    for entry, kernel in enumerate(("bounce_kernel", "shade_lanes_kernel")):
        print(f"[{label}] {kernel}: {bounce_ops.kernel_attributes(entry)} (cudaFuncGetAttributes); nvcc -Xptxas -v: "
              f"{spills.get(kernel)}", flush=True)
    first = None
    for name, args in cases:
        scene, cfg, hit, o, d, att, rad, seeds, depth, spec = args
        nee = cfg.env_importance_sampling
        b, bad = bounce_checked(args)
        if bad:
            raise SystemExit(f"[{label} {name}] FAIL: the bounce kernel and its plain version differ in {bad}")
        n = o.shape[0]
        if nee:
            ms = _time_cold(lambda a: bounce_ops.bounce(*a), [args] * 51)
            occ = scene.accel.occluded(scene.vertices, b["shadow_origin"], b["shadow_dir"], cfg.t_min, cfg.t_max, cfg,
                                       active=b["cand"])
            real = integrator.occluded_scene
            integrator.occluded_scene = lambda *a, **k: occ
            try:
                plain_ms = _time_ms(lambda: _bounce_plain(*args), 5)
            finally:
                integrator.occluded_scene = real
            pair_ms = _time_cold(lambda bb: bounce_ops.next_event(scene, cfg, bb, occ, d, att),
                                 [dict(b, radiance=b["radiance"].clone()) for _ in range(51)]) + ms
            what = (f"bounce kernel {ms:.4f} ms, with the NEE kernel {pair_ms:.4f} ms (L2 flushed before each "
                    f"launch); plain (occlusion fixed) {plain_ms:.4f} ms")
        else:
            ms = _time_cold(lambda a: bounce_ops.bounce(*a), [args] * 51)
            warm = _time_over(lambda a: bounce_ops.bounce(*a), [args] * 51, device_only=True)
            plain_ms = _time_ms(lambda: _bounce_plain(*args), 5)
            what = (f"kernel {ms:.4f} ms (L2 flushed before each launch; warm, back to back {warm:.4f}), plain "
                    f"{plain_ms:.4f} ms")
        n_bytes = bounce_bytes(args, b["cand"] if nee else None)
        bound_ms, bound_by = bound(n_bytes, n * BOUNCE_LANE_FLOPS)
        m = hit.hit
        mats = torch.unique(scene.tri_attrs[hit.prim[m].long(), 24].long()).numel()
        hits, mixed = hit_shares(args)
        print(f"[{label} {name}] {n} lanes ({int(m.sum())} hits on {mats} materials, hit share {hits:.4f}, "
              f"warps mixing hits and misses {mixed:.4f}), {cfg.env_mode}"
              f"{', NEE' if nee else ''}{', MIS-spec' if cfg.nee_mis_spec else ''}"
              f"{', defensive' if cfg.nee_defensive_mix else ''}: every field bit-equal (0 ulp){' (record too)' if nee else ''}; "
              f"{what}; {n_bytes} bytes, {n * BOUNCE_LANE_FLOPS} FLOP: bound {bound_ms:.4f} ms by {bound_by} | {smi}")
        if first is None:
            first = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None)
    return first


def arms_of(parent):
    """The arms a timing runs in turns: the parent's libraries and this
    tree's kernels, P C C P, or this tree's alone."""
    return ("parent", "change", "change", "parent") if parent else ("change",)


def timed_alone(fn, inputs, parent):
    """fn over `inputs` with the L2 flushed before each launch (_time_cold)
    and warm, back to back (_time_over), each arm in turns (arms_of).
    Returns {arm: (mean cold ms, mean warm ms)}."""
    got = {}
    for arm in arms_of(parent):
        with using_libraries(parent if arm == "parent" else None):
            got.setdefault(arm, []).append((_time_cold(fn, inputs), _time_over(fn, inputs, device_only=True)))
    return {arm: tuple(sum(x) / len(x) for x in zip(*runs)) for arm, runs in got.items()}


def turn_text(times, exposed=None):
    """A kernel's times by arm: cold (warm), and exposed behind the launch
    before it (paired_rounds)."""
    parts = []
    for arm, (cold, warm) in times.items():
        part = f"{arm} {cold:.4f} ms L2 flushed, {warm:.4f} warm"
        if exposed:
            part += f", exposed {exposed_text(exposed[arm])}"
        parts.append(part)
    return "; ".join(parts)


def kernel_row(times, exposed, floor):
    """The kernels line's timing keys of one case: ms (cold), warm_ms,
    exposed_ms (with its quartiles), the floor, and the parent's."""
    row = dict(ms=times["change"][0], warm_ms=times["change"][1], floor_ms=floor)
    if exposed:
        e = exposed["change"]
        row.update(exposed_ms=e["median_ms"], exposed_q_ms=[e["q1_ms"], e["q3_ms"]])
    if "parent" in times:
        row.update(parent_ms=times["parent"][0], parent_warm_ms=times["parent"][1])
        if exposed:
            e = exposed["parent"]
            row.update(parent_exposed_ms=e["median_ms"], parent_exposed_q_ms=[e["q1_ms"], e["q3_ms"]])
    return row


def phase_nee_kernel(label, cases, smi, parent=None):
    """The NEE kernel against its plain version (_nee_weights and the
    visible select into radiance) after the bounce kernel and the any-hit
    traversal on each case's rays (`cases`: name, scene, config, camera,
    camera rays, paired): radiance and spec_next bit-equal to
    _bounce_plain's with the same any-hit answer, launched alone and as
    the main path launches it, a programmatic dependent of the traversal,
    whose captured graph's edge into it must be programmatic; its time
    alone with the L2 flushed before each launch and warm (timed_alone),
    the timing method's floor at its grid (method_floor), the plain
    version's time and the bound; on the paired cases its exposed time
    behind the traversal (paired_rounds: the traversal alone, and the
    traversal and the kernel).  With `parent` (its libraries) the
    parent's NEE kernel and traversal the same ways, in turns.  Returns
    the numbers of the first case, the others under `cases`."""
    import tpu_pathtracer_torch.render.integrator as integrator

    first, rows = None, []
    floor = method_floor(2 * CAMERA_RAYS, 128)
    print(f"[{label}] the timing method's floor at the NEE kernel's grid ({2 * CAMERA_RAYS} lanes, blocks of 128), "
          f"ms L2 flushed (warm): {floor_text(floor)} | {smi}", flush=True)
    for name, scene, cfg, camera, n_cam, paired in cases:
        args = shade_inputs(scene, cfg, camera, n_cam)
        _, _, hit, o, d, att, rad, seeds, depth, spec = args
        b = bounce_ops.bounce(*args)

        def traverse():
            return scene.accel.occluded(scene.vertices, b["shadow_origin"], b["shadow_dir"], cfg.t_min, cfg.t_max,
                                        cfg, active=b["cand"])

        occ = traverse()
        pre = b["radiance"].clone()
        real = integrator.occluded_scene
        integrator.occluded_scene = lambda *a, **k: occ
        try:
            want = _bounce_plain(*args)
        finally:
            integrator.occluded_scene = real

        def dependent(x):
            return bounce_ops.next_event(scene, cfg, x, traverse(), d, att, dependent=True)

        got_spec = bounce_ops.next_event(scene, cfg, b, occ, d, att)
        x = dict(b, radiance=pre.clone())
        dep_spec = dependent(x)
        torch.cuda.synchronize()
        for how, r, sp in (("alone", b["radiance"], got_spec), ("behind the traversal", x["radiance"], dep_spec)):
            if not (same_bits(r, want["radiance"]) and same_bits(sp, want["spec_last"])):
                raise SystemExit(f"[{label} {name}] FAIL: the NEE kernel launched {how} and its plain version differ")
        n = o.shape[0]
        edge = programmatic_into_sink(f"{label} {name}", lambda: dependent(dict(b, radiance=pre.clone())),
                                      (-(-n // 128), 128))
        sh = _shade(scene, cfg, hit, o, d, seeds, depth)
        _, env_dir, pdf, u, v = _light_sample(scene, cfg, sh, sh["seeds"])
        cand, cos_l = _shadow_candidates(hit.hit, sh, env_dir)

        def plain():
            contrib, visible, spec_next = _nee_weights(scene, cfg, sh, cand, occ, env_dir, pdf, u, v, cos_l, d, att)
            return torch.where(hit.hit[:, None], pre + torch.where(visible[:, None], contrib, 0.0), pre), spec_next

        r_p, s_p = plain()
        torch.cuda.synchronize()
        if not (same_bits(r_p, want["radiance"]) and same_bits(s_p, want["spec_last"])):
            raise SystemExit(f"[{label} {name}] FAIL: _nee_weights differs from _bounce_plain")
        inputs = [dict(b, radiance=pre.clone()) for _ in range(51)]
        times = timed_alone(lambda x: bounce_ops.next_event(scene, cfg, x, occ, d, att), inputs, parent)
        exposed = None
        if paired:
            def turn(arm, with_nee):
                with using_libraries(parent if arm == "parent" else None):
                    return _time_cold(dependent if with_nee else (lambda _: traverse()), inputs[:21])

            exposed = paired_rounds(turn, tuple(dict.fromkeys(arms_of(parent))))
        plain_ms = _time_ms(plain, 10)
        visible = b["cand"] & ~occ
        n_bytes = nee_bytes(args, b, visible)
        bound_ms, bound_by = bound(n_bytes, n * NEE_LANE_FLOPS)
        print(f"[{label} {name}] {n} lanes, {int(b['cand'].sum())} shadow rays traced, {int(visible.sum())} visible"
              f"{', MIS-spec' if cfg.nee_mis_spec else ''}{', defensive' if cfg.nee_defensive_mix else ''}: radiance "
              f"and spec_next bit-equal (0 ulp) alone and behind the traversal (captured edge {edge}); "
              f"{turn_text(times, exposed)}; plain {plain_ms:.4f} ms; {n_bytes} bytes, "
              f"{n * NEE_LANE_FLOPS} FLOP: bound {bound_ms:.4f} ms by {bound_by} | {smi}", flush=True)
        row = dict(name=name, **kernel_row(times, exposed, floor), plain_ms=plain_ms, bound_ms=bound_ms)
        rows.append(row)
        if first is None:
            first = dict(max_abs_err=0.0, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                         **{k: v for k, v in row.items() if k not in ("name", "plain_ms", "bound_ms")})
    first["cases"] = rows[1:]
    return first


CAMERA_POOL_ITERS = 16  # unfused iterations before the pool's step (as phase 18's pools)


def camera_pool(scene, cfg):
    """A stream's lane pool mid-render (lane_state after
    CAMERA_POOL_ITERS iterations and until a step retires a pixel) and
    what respawns it: (state, payload, head, step keywords, the frame's
    camera arrays, counters as device tensors)."""
    st, tb, head = lane_state(scene, cfg, Camera(), CAMERA_POOL_ITERS, retiring=True)[:3]
    dev = scene.device
    counters = (torch.tensor(1, dtype=torch.int64, device=dev), torch.tensor(0, dtype=torch.int64, device=dev))
    return st, tb, head, step_kw(cfg), camera_arrays(Camera(), cfg, dev), counters


def phase_camera_kernel(label, pools, smi, parent=None, n=131_072):
    """The camera kernel against camera_paths_plain: at the headline's
    1080p on n lanes, the stream's respawn (pixel and sample tables, a
    40% mask, into buffers it leaves alone elsewhere) with and without
    DOF, and the 1-spp set-up on an affine range (base + lane // 10); and
    on `pools` (name, scene, config: camera_pool's lanes mid-render at
    131,072 on the headline and at config 1's 16,384), the respawn behind
    kernel 7 on the step's real regen mask, launched as the main path
    launches it, a programmatic dependent of kernel 7, whose captured
    graph's edge into it must be programmatic.  Origins, directions and
    seeds bit-equal; times alone with the L2 flushed and warm
    (timed_alone), the timing method's floor at each grid, the plain
    version's time and the bound; on the pools the exposed time behind
    kernel 7 (paired_rounds: kernel 7 alone, and kernel 7 and the
    respawn).  With `parent` (its libraries) the parent's camera kernel
    and kernel 7 the same ways, in turns.  Returns the numbers of the
    respawn with DOF, the others under `cases`."""
    dev = torch.device("cuda")
    rs = np.random.RandomState(19)
    pix = torch.as_tensor(rs.randint(0, 1920 * 1080, n).astype(np.int32), device=dev)
    sample = torch.as_tensor(rs.randint(0, 12, n).astype(np.int32), device=dev)
    mask = torch.as_tensor(rs.rand(n) < 0.4, device=dev)
    counters = torch.tensor(3, device=dev), torch.tensor(20, device=dev)
    cases = (("respawn DOF", True, dict(pix=pix, sample=sample, sample_max=9, mask=mask)),
             ("respawn", False, dict(pix=pix, sample=sample, sample_max=9, mask=mask)),
             ("affine range", False, dict(per=10, base=torch.tensor(777, device=dev))))
    first, rows, floors = None, [], {}

    def floor_at(lanes):
        if lanes not in floors:
            floors[lanes] = method_floor(lanes, 256)
            print(f"[{label}] the timing method's floor at the camera kernel's grid ({lanes} lanes, blocks of 256), "
                  f"ms L2 flushed (warm): {floor_text(floors[lanes])} | {smi}", flush=True)
        return floors[lanes]

    def spawn_bytes(lanes, kw, written):
        # the mask on every lane; tables and outputs on the lanes spawned;
        # the camera's four vectors and three counters
        return lanes * ("mask" in kw) + written * (4 * ("pix" in kw) + 4 * ("sample" in kw) + 32) + 4 * 12 + 3 * 8

    for name, dof, kw in cases:
        cfg = RenderConfig(**{**HEADLINE, "dof": dof, "dof_blurriness": 0.05})
        cam = camera_arrays(Camera(), cfg, dev)
        outs = []
        for fn in (camera_ops.camera_paths, camera_ops.camera_paths_plain):
            out = (torch.zeros((n, 3), device=dev), torch.zeros((n, 3), device=dev),
                   torch.zeros(n, dtype=torch.int64, device=dev))
            fn(cam, cfg, *counters, n, out=out, **kw)
            outs.append(out)
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(*outs)):
            raise SystemExit(f"[{label} {name}] FAIL: the camera kernel and its plain version differ")
        out = outs[0]
        floor = floor_at(n)
        times = timed_alone(lambda _: camera_ops.camera_paths(cam, cfg, *counters, n, out=out, **kw), [None] * 51,
                            parent)
        plain_ms = _time_ms(lambda: camera_ops.camera_paths_plain(cam, cfg, *counters, n, out=out, **kw), 10)
        written = int(kw["mask"].sum()) if "mask" in kw else n
        n_bytes = spawn_bytes(n, kw, written)
        bound_ms, bound_by = bound(n_bytes, written * CAMERA_LANE_FLOPS)
        print(f"[{label} {name}] {n} lanes, {written} spawned: origins, directions and seeds bit-equal (0 ulp); "
              f"{turn_text(times)}; plain {plain_ms:.4f} ms; {n_bytes} bytes: bound {bound_ms:.4f} ms by {bound_by} "
              f"| {smi}", flush=True)
        row = dict(name=name, **kernel_row(times, None, floor), plain_ms=plain_ms, bound_ms=bound_ms)
        rows.append(row)
        if first is None:
            first = dict(max_abs_err=0.0, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                         **{k: v for k, v in row.items() if k not in ("name", "plain_ms", "bound_ms")})
    for name, scene, cfg in pools:
        st, tb, head, kw, cam, counters = camera_pool(scene, cfg)
        lanes, spp = st["slot"].shape[0], cfg.samples_per_launch
        image = torch.zeros((kw["n_pix"] + 1, 3), device=dev)
        seg = torch.zeros((), dtype=torch.int64, device=dev)

        def copy():
            return {k: st[k].clone() for k in fs.STATE_KEYS}

        def step(s_):
            return fs.fused_stream_step_cuda(tb, s_, image, head, seg, **kw)[0]

        def respawn(s_, regen, dependent=False, plain=False):
            lanes_kw = dict(pix=s_["pix"], sample=s_["sample_i"], sample_max=spp - 1, mask=regen,
                            out=(s_["origin"], s_["direction"], s_["seeds"]))
            if plain:
                camera_ops.camera_paths_plain(cam, cfg, *counters, lanes, **lanes_kw)
            else:
                camera_ops.camera_paths(cam, cfg, *counters, lanes, dependent=dependent, **lanes_kw)

        got, want = copy(), copy()
        respawn(got, step(got), dependent=True)
        regen = step(want)
        respawn(want, regen, plain=True)
        torch.cuda.synchronize()
        bad = [k for k in ("origin", "direction", "seeds") if not same_bits(got[k], want[k])]
        if bad:
            raise SystemExit(f"[{label} {name}] FAIL: the camera kernel behind kernel 7 and its plain version differ "
                             f"in {bad}")
        held = copy()
        edge = programmatic_into_sink(f"{label} {name}", lambda: respawn(held, step(held), dependent=True),
                                      (-(-lanes // 256), 256))
        floor = floor_at(lanes)
        alone_in = [dict(copy(), regen=regen) for _ in range(21)]
        times = timed_alone(lambda s_: respawn(s_, s_["regen"]), alone_in, parent)

        def turn(arm, with_camera):
            def fn(s_):
                r = step(s_)
                if with_camera:
                    respawn(s_, r, dependent=True)

            with using_libraries(parent if arm == "parent" else None):
                return _time_cold(fn, [copy() for _ in range(21)])

        exposed = paired_rounds(turn, tuple(dict.fromkeys(arms_of(parent))))
        plain_ms = _time_ms(lambda: respawn(alone_in[0], regen, plain=True), 10)
        written = int(regen.sum())
        n_bytes = spawn_bytes(lanes, dict(pix=1, sample=1, mask=1), written)
        bound_ms, bound_by = bound(n_bytes, written * CAMERA_LANE_FLOPS)
        print(f"[{label} {name}] {lanes} lanes after {CAMERA_POOL_ITERS}+ unfused iterations, {written} respawned by "
              f"kernel 7's regen mask: origins, directions and seeds bit-equal (0 ulp) behind kernel 7 (captured edge "
              f"{edge}); {turn_text(times, exposed)}; plain {plain_ms:.4f} ms; {n_bytes} bytes: bound "
              f"{bound_ms:.4f} ms by {bound_by} | {smi}", flush=True)
        rows.append(dict(name=name, **kernel_row(times, exposed, floor), plain_ms=plain_ms, bound_ms=bound_ms))
    first["cases"] = rows[1:]
    return first


# ---------------------------------------------------------------------------
# The ray ordering against its plain versions (phase 38)
# ---------------------------------------------------------------------------

def ray_order_bytes(n, active, any_hit):
    """Bytes each ray-order kernel must move on n rays (each input read
    once, each output written once), by lane class.  The sort (rays to
    sorted rays and perm): a lane outside the mask reads its mask byte,
    any other lane its ray (24 B) and the mask byte if there is one; each
    lane writes a sorted ray and its perm entry (32 B); the scene box (24
    B) once.  The restore, which is the traversal's store through perm:
    what it adds to the traversal, which writes t, prim and uv (or the
    flags) in any case: each lane reads its perm entry (8 B) and, closest
    hit, writes the hit byte (1 B)."""
    mask = 0 if active is None else n
    n_act = n if active is None else int(active.sum())
    return dict(sort=n_act * 24 + mask + n * 32 + 24, restore=n * (8 if any_hit else 9))


def store_cost(time_traversal, rounds=STORE_ROUNDS):
    """What the caller-order store adds to a traversal (paired_rounds:
    turns alone, with perm, with perm, alone; time_traversal(with_perm),
    its mean device ms), with the traversal's ms alone and with perm as
    `traversal_ms` and `traversal_perm_ms`."""
    got = paired_rounds(lambda _, with_perm: time_traversal(with_perm), rounds=rounds)[None]
    return dict(got, traversal_ms=got["alone_ms"], traversal_perm_ms=got["paired_ms"])


def order_compares(packets):
    """Compares the packet order's function needs: a sort of P weights,
    P log2 P (the kernel itself makes P^2)."""
    return round(packets * math.log2(packets)) if packets > 1 else 0




def _profiled(fn, calls=10):
    """fn's device time a call from torch.profiler's device events
    (kernels, copies, memsets) over `calls` calls after a warm-up call:
    the sum of the events' times, so no host gap counts; each trace taken
    as `trace` takes it, up to five times.  Returns None if five in a row
    were short, else a dict: `kernels` and `ms` a call, `by_name` (ms a
    call by event name), `out` (the last call's result), and `trace`'s
    `retakes`, `spin_lost` and `lead_ms`."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            out = fn()
        return out

    t = trace(run, retakes=4)
    if not t["complete"]:
        return None
    by_name = collections.Counter()
    for e in t["device"]:
        by_name[e.name()] += e.duration_ns() / 1e6 / calls
    return dict(kernels=len(t["device"]) / calls, ms=sum(by_name.values()), by_name=dict(by_name), out=t["out"],
                retakes=t["retakes"], spin_lost=t["spin_lost"], lead_ms=t["lead_ms"])


def graph_kernels(fn):
    """Kernel launches of one call of fn, counted without the wrappers'
    counts or the profiler: the kernel nodes of a CUDA graph captured
    from the call (after a warm-up call outside the capture)."""
    with captured_graph(fn) as (cu, raw):
        count = ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(raw, None, ctypes.byref(count)):
            raise SystemExit("FAIL: cuGraphGetNodes")
        nodes = (ctypes.c_void_p * count.value)()
        if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)):
            raise SystemExit("FAIL: cuGraphGetNodes")
        return sum(node_type(cu, node) == CU_GRAPH_NODE_TYPE_KERNEL for node in nodes)


def ray_order_inputs(scene, cfg, camera, n_cam, any_hit):
    """A phase 38 case's sort inputs: (origins, directions, mask or None,
    scene box, (spatial bits, direction bits)), the rays in lane order as
    the schedule traces them (any hit: the NEE shadow rays and the mask of
    the lanes that trace one)."""
    acc = scene.accel
    if any_hit:
        o, d, active = shadow_rays(scene, cfg, camera)
    else:
        (o, d), active = trace_rays(scene, cfg, camera, n_cam), None
    return o, d, active, (acc.scene_lo, acc.scene_hi), (acc._spatial_bits(cfg), acc._dir_bits(cfg))


def phase_ray_order(label, cases, smi):
    """The ray-order kernels (csrc/ray_sort.cu) against their plain
    versions (ops/ray_sort.py) on the main path's rays, in lane order as
    the schedule traces them (`cases`: name, scene, RenderConfig, camera,
    camera rays, any hit): the radix sort of the rays (shadow rays: the
    lanes that trace nothing parked by the mask) against the key,
    torch.sort's stable permutation and the gather, the restore into
    caller order, which the route's traversal kernel does in its store on
    the sorted rays (restore=True, through perm; closest hit also without
    one: the Hit), against restore_hits_plain of its raw outputs, and the
    packet order of that launch's pre-pass weights: every output
    bit-equal.  Each kernel timed with the L2 flushed before each launch
    (_time_cold), the restore as what it adds to the traversal (store_cost:
    the traversal with perm less the traversal alone, 13 launches a turn,
    paired within each of six rounds of turns alone, with, with, alone;
    their median and quartiles), beside the plain version, the bound (the
    bytes of each lane's class, ray_order_bytes; the packet order's also by its
    compares, order_compares) and the one PyTorch call that computes the
    same function on the same inputs (torch.sort of the int32 key, which
    leaves the rays unsorted; index_put_ of t, prim and uv; argsort).  The
    sort and torch.sort also by the profiler's device ms and device
    kernels a call (warm; _time_cold cannot queue torch.sort ahead of the
    card), in turns.  The sort's launches three ways, which must agree:
    its wrapper's count, the kernels of a CUDA graph captured from one
    call (graph_kernels), and each complete trace's kernels a call, whose
    last call's output must also be the plain version's.  Returns each
    kernel's numbers on the first case."""
    first = {}
    for name, scene, cfg, camera, n_cam, any_hit in cases:
        acc = scene.accel
        o, d, active, box, bits = ray_order_inputs(scene, cfg, camera, n_cam, any_hit)
        n = o.shape[0]
        # the sort, against the key, torch.sort and the gather
        set_counts_zero()
        o_s, d_s, perm = ray_sort.sort_rays_cuda(o, d, *box, *bits, active)
        launches = ray_sort.sort_rays.launches
        key = ray_sort.sort_key_plain(o, d, *box, *bits, active)
        sort_want = ray_sort.sort_rays_plain(o, d, *box, *bits, active)
        if not (torch.equal(perm, torch.sort(key, stable=True).indices)
                and all(same_bits(g, w) for g, w in zip((o_s, d_s, perm), sort_want))):
            raise SystemExit(f"[{label} {name}] FAIL: the sort kernel and its plain version differ")
        nodes = graph_kernels(lambda: ray_sort.sort_rays_cuda(o, d, *box, *bits, active))
        if not launches == nodes == ray_sort.sort_launches(n, *bits) <= (1 if n <= ray_sort.SMALL_MAX else 5):
            raise SystemExit(f"[{label} {name}] FAIL: {launches} sort launches counted, {nodes} kernels in a "
                             f"captured sort, for {n} rays")
        # the route's traversal on the sorted rays: its raw outputs, and the
        # restore into caller order in its store
        route, args = acc.traversal(o_s, d_s, cfg.t_min, cfg.t_max, cfg)
        kid = ROUTE_KERNELS[route][int(any_hit)]
        traverse = KERNELS[kid][6]
        outputs = traverse(*args)
        for rows in (perm,) if any_hit else (perm, None):
            hit = traverse(*args, restore=True, perm=rows)
            want = ray_sort.restore_hits_plain(outputs, rows)
            same = (torch.equal(hit, want) if any_hit else
                    all(same_bits(getattr(hit, f), getattr(want, f)) for f in ("t", "prim", "bary", "hit")))
            if not same:
                raise SystemExit(f"[{label} {name}] FAIL: the traversal's caller-order store "
                                 f"({'perm' if rows is not None else 'no perm'}) and restore_hits_plain differ")
        # the packet order of that launch's pre-pass
        rpt = acc._rpt(cfg)
        stem = ic._STEMS[route, any_hit]
        supers = args[1] if route == "flat" else args[2]
        weights = ic.packet_weights(getattr(cuda_build.library(f"{stem}.cu"), f"{stem}_weights"), supers, o_s, d_s,
                                    cfg.t_min, cfg.t_max, rpt)
        order = ray_sort.packet_order_cuda(weights)
        if not torch.equal(order, ray_sort.packet_order_plain(weights)):
            raise SystemExit(f"[{label} {name}] FAIL: the packet order kernel and its plain version differ")
        torch.cuda.synchronize()
        # times: kernel (L2 flushed), plain, library
        cold = [None] * 51
        sorted_out = (outputs,) if any_hit else outputs
        scatter = [torch.empty_like(x) for x in sorted_out]
        kernels = dict(
            sort=(lambda _: ray_sort.sort_rays_cuda(o, d, *box, *bits, active),
                  lambda: ray_sort.sort_rays_plain(o, d, *box, *bits, active), None),
            restore=(None, lambda: ray_sort.restore_hits_plain(outputs, perm),
                     lambda _: [dst.index_put_((perm,), x) for dst, x in zip(scatter, sorted_out)]),
            order=(lambda _: ray_sort.packet_order_cuda(weights), lambda: ray_sort.packet_order_plain(weights),
                   lambda _: torch.argsort(weights, descending=True, stable=True)),
        )
        n_bytes = ray_order_bytes(n, active, any_hit)
        packets = weights.shape[0]
        n_bytes["order"] = packets * 8
        ops = dict(order=order_compares(packets))
        # the restore: the traversal alone and with perm, in turns
        store = store_cost(lambda with_perm: _time_cold(
            lambda _: traverse(*args, restore=with_perm, perm=perm if with_perm else None), [None] * 14))
        numbers = {}
        for k, (kernel, plain, library) in kernels.items():
            bound_ms, bound_by = bound(n_bytes[k], ops.get(k, 0))
            numbers[k] = dict(max_abs_err=0.0, ms=store["ms"] if kernel is None else _time_cold(kernel, cold),
                              plain_ms=_time_ms(plain, 10), bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None if library is None else _time_cold(library, cold))
        numbers["restore"].update({k: v for k, v in store.items() if k != "ms"},
                                  below_library=store["q3_ms"] < numbers["restore"]["library_ms"])
        # the sort against torch.sort alone: device ms and device kernels
        # a call, in turns, warm
        warm = [("sort_rays", lambda: ray_sort.sort_rays_cuda(o, d, *box, *bits, active)),
                ("torch.sort", lambda: torch.sort(key, stable=True))]
        runs = {what: [] for what, _ in warm}
        for what, fn in warm + warm[::-1]:
            runs[what].append(_profiled(fn))
        for run in runs["sort_rays"]:  # each complete trace: every launch traced, the last call's output right
            if run is not None and (run["kernels"] != launches
                                    or not all(same_bits(g, w) for g, w in zip(run["out"], sort_want))):
                raise SystemExit(f"[{label} {name}] FAIL: the profiler traced {run['kernels']} kernels a sort for "
                                 f"{launches} launches, or the last profiled sort differs from the plain version")
        profiled = {what: None if None in r else (sum(x["kernels"] for x in r) / len(r),
                                                  sum(x["ms"] for x in r) / len(r))
                    for what, r in runs.items()}
        traces = [x for r in runs.values() for x in r if x is not None]
        clock = (f"; the traces: {sum(x['retakes'] for x in traces)} retaken for a launch without its kernel, "
                 f"{sum(x['spin_lost'] for x in traces)} of {sum(x['retakes'] + 1 for x in traces)} lost their "
                 f"first kernel (the spin), kernels traced up to {max(x['lead_ms'] for x in traces):.4f} ms before "
                 f"their launch call" if traces else "")
        numbers["sort"]["library_ms"] = None if profiled["torch.sort"] is None else profiled["torch.sort"][1]
        numbers["sort"]["warm_ms"] = None if profiled["sort_rays"] is None else profiled["sort_rays"][1]
        numbers["sort"]["sort_launches"] = launches
        calls = dict(sort="torch.sort (device ms, warm)", restore=f"index_put_ x {len(sorted_out)}",
                     order="argsort")
        r = numbers["restore"]
        what = dict(sort="sort", restore=(
            f"restore in the traversal's store (the {KERNELS[kid][0]} kernel {r['traversal_ms']:.4f} ms alone, "
            f"{r['traversal_perm_ms']:.4f} with perm; added, by round: "
            f"{', '.join(f'{x:+.4f}' for x in r['rounds_ms'])}, median {r['median_ms']:+.4f}, quartiles "
            f"{r['q1_ms']:+.4f} to {r['q3_ms']:+.4f}, "
            f"{'resolved' if r['resolved'] else 'unresolved (the quartiles spread wider than the median)'}; "
            f"upper quartile {'below' if r['below_library'] else 'not below'} {calls['restore']}):"),
                    order="packet order")
        warm_ms = ", ".join(f"{k_} not measured (no complete trace)" if v_ is None else
                            f"{k_} {v_[1]:.4f} ms in {v_[0]:.1f} device kernels" for k_, v_ in profiled.items())
        parts = "; ".join(
            f"{what[k]} {v['ms']:{'+' if k == 'restore' else ''}.4f} ms, plain {v['plain_ms']:.4f}, "
            + (f"{calls[k]} {v['library_ms']:.4f}, " if v["library_ms"] is not None else
               f"{calls[k]} not measured, ")
            + f"bound {v['bound_ms']:.4f} by {v['bound_by']} ({n_bytes[k]} B{', %d ops' % ops[k] if k in ops else ''})"
            for k, v in numbers.items())
        print(f"[{label} {name}] {n} rays{f', {int(active.sum())} active' if active is not None else ''}, "
              f"{route} route{', any hit' if any_hit else ''}, {bits[0]} spatial and "
              f"{ray_sort.key_dir_bits(*bits)} direction bits ({int(key.unique().numel())} distinct keys, "
              f"{ray_sort.key_width(*bits)} bits), {packets} packets of {rpt}: sort ({launches} launches by its "
              f"count and in a captured graph), restore and packet order bit-equal (0 ulp); {parts} (L2 flushed "
              f"before each kernel and library launch but torch.sort's); device time a call, warm, in turns: "
              f"{warm_ms}{clock} | {smi}")
        if not first:
            first = numbers
    return first


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
    """Each kernel of `want`, the shading kernels and the restore (the
    traversal's caller-order store) launched,
    no other kernel but the rest of the ray ordering."""
    want = want + shading_kernels(any(kid in want for kid in ("k4", "k5", "k6"))) + ("kr",)
    for kid in want:
        if not counts[kid]:
            raise SystemExit(f"[{label}] FAIL: {KERNELS[kid][0]} never launched")
    extra = {KERNELS[kid][0]: c for kid, c in counts.items() if c and kid not in want + RAY_ORDER}
    if extra:
        raise SystemExit(f"[{label}] FAIL: other kernels launched: {extra}")


def launched(counts):
    return ", ".join(f"{KERNELS[kid][0]} {n}" for kid, n in counts.items() if n)


def phase_shard_one(label, scene, cfg, smi):
    """A NCCL group of one rank on the card: the headline (1080p, 10 spp,
    depth 8) sharded by pixels and by samples.  Pixels must equal this
    process's render_frame bit for bit, samples within rtol 2e-4 / atol
    2e-5; s/launch of each beside the unsharded frame's.  Pixel sharding
    passes an affine range, which takes the unfused stream (kernel 7
    reads the range's base on the device); sample sharding renders the
    whole frame (fused stream).  Kernel 7 launches once an iteration of
    each."""
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
    for counts in (c_single, c_pixels, c_samples):
        check_kernels(label, counts, ("k1", "k7"))
        if counts["k7"] != counts["kb"]:  # the bounce kernel launches once an iteration
            raise SystemExit(f"[{label}] FAIL: {counts['k7']} fused_step launches in {counts['kb']} iterations")
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
                want = ("k1", "k4", "k7") if case == "nee" else ("k1", "k7")
                check_kernels(f"{label} rank {rank} {key}", counts, want)
                if counts["k7"] != counts["kb"]:  # the bounce kernel launches once an iteration
                    raise SystemExit(f"[{label} rank {rank} {key}] FAIL: {counts['k7']} fused_step launches in "
                                     f"{counts['kb']} iterations")
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
    check_kernels(label, c_sharded, ("k1", "k7"))
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
    torch.profiler (device events, device_events)."""
    hero_scene, hero_camera, hero_cfg = load_scene_file(str(hero), device="cuda", cache_dir=str(root / "cache"))
    cases = (("headline", headline_scene("cuda"), Camera(), RenderConfig(**HEADLINE)),
             ("hero", hero_scene, hero_camera, hero_cfg))
    for name, scene, camera, cfg in cases:
        cam = camera_arrays(camera, cfg, "cuda")
        res = {}
        for on in (False, True):
            c = cfg.replace(deferred_shade=on)
            frames, syncs = [], 0
            render_frame_stats(scene, cam, c, 0)  # warm: the graphed loop captures here
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
            t = trace(lambda: render_frame_stats(scene, cam, c, 4)[1], retakes=0)
            pstats, events = t["out"], device_events(t)
            iters = sum(f[1]["iters"] for f in frames)
            check_kernels(f"{label} {name}", counts, ("k1", STEP_KERNEL[frames[0][1]["schedule"]]))
            res[on] = dict(frames=frames, iters=iters, syncs=syncs / iters, counts=counts,
                           busy=busy_seconds(t),
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
        (img, stats), _, counts = timed(lambda: render_frame_stats(scene, cam, cfg, 0))
        check_kernels(f"{label} {name}", counts, ("k1", STEP_KERNEL[stats["schedule"]])
                      + (("k4",) if cfg.env_importance_sampling else ()))
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


# ---------------------------------------------------------------------------
# Phase 33: the benchmark entry point, python -m tpu_pathtracer_torch.bench

# (bench arguments, the render phase whose frame at subframe 0 renders the
# same preset, the RenderConfig fields that differ from that phase's and
# pick between paths that trace the same rays: the intersector "auto" is
# the cluster accel on a scene with one, and the fused stream is bit-equal
# to the unfused one)
BENCH_PRESETS = (
    (("--config", "0", "--accel", "cluster", "--frames", "2"), "4", ()),
    (("--config", "3", "--nee", "--accel", "cluster", "--frames", "2"), "14", ()),
    (("--config", "4", "--frames", "2"), "8", ("intersector",)),
    (("--config", "4", "--nee", "--frames", "2"), "15", ("intersector",)),
    (("--config", "1", "--accel", "cluster", "--frames", "1"), "20", ("fused_schedule",)),
)
# The presets at their defaults (--accel auto) on the procedural scenes,
# which build no accel: brute force.  (name, bench arguments)
BENCH_BRUTE = (
    ("config 0", ("--config", "0", "--frames", "2")),
    ("config 3 NEE", ("--config", "3", "--nee", "--frames", "2")),
    ("config 1", ("--config", "1", "--frames", "1")),
)


@contextlib.contextmanager
def watching_bench():
    """While open, the bench module's presets and the stats of every frame
    it renders (its render_frame is render_frame_stats's image) are
    recorded: (presets built, stats of each frame)."""
    real = bench.build_preset, bench.render_frame, bench.render_frame_stats
    built, frames = [], []

    def build_preset(args, device):
        built.append(real[0](args, device))
        return built[-1]

    def frame_stats(scene, cam, cfg, subframe):
        img, stats = render_frame_stats(scene, cam, cfg, subframe)
        frames.append(stats)
        return img, stats

    bench.build_preset, bench.render_frame_stats = build_preset, frame_stats
    bench.render_frame = lambda *a: frame_stats(*a)[0]
    try:
        yield built, frames
    finally:
        bench.build_preset, bench.render_frame, bench.render_frame_stats = real


def bench_preset(name, argv, phase, differ, renders, smi):
    """bench.main on the card at one of BENCH_PRESETS, in this process,
    with every launch count set to 0 just before and read just after: one
    JSON line with a positive value, the card's name and its power limit;
    the route's kernels (and kernel 7 on the fused stream) at least once
    per iteration of every frame the bench rendered, the shading kernels
    as check_shading says, nothing else; path and shadow segments, triangles and
    schedule equal to the earlier phase's frame at subframe 0 on the same
    RenderConfig.  Returns the bench's line."""
    out = io.StringIO()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    set_counts_zero()
    with watching_bench() as (built, frames), contextlib.redirect_stdout(out):
        rc = bench.main(list(argv))
    torch.cuda.synchronize()
    counts, seconds = read_counts(), time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        raise SystemExit(f"[{name}] FAIL: exit {rc}, output {lines}")
    line = json.loads(lines[0])
    detail = line["detail"]
    if not line["value"] > 0:
        raise SystemExit(f"[{name}] FAIL: {line['value']} Mrays/s")
    if detail["graphed"] is not True or detail["captures"] != 1:
        raise SystemExit(f"[{name}] FAIL: graphed {detail['graphed']}, {detail['captures']} captures in the run")
    card = (torch.cuda.get_device_name(0), float(smi.rsplit(",", 1)[1].split()[0]))
    if (detail["device"], detail["power_limit_w"]) != card:
        raise SystemExit(f"[{name}] FAIL: the line names {detail['device']}, {detail['power_limit_w']} W, "
                         f"not {card[0]}, {card[1]} W")
    (scene, _, cfg), = built
    ref = renders[phase]
    want_cfg = dataclasses.replace(cfg, **{f: getattr(ref["cfg"], f) for f in differ})
    if want_cfg != ref["cfg"] or scene.accel is None:
        raise SystemExit(f"[{name}] FAIL: the preset is not phase {phase}'s RenderConfig: {cfg}")
    got = dict(path_segments=detail["path_segments"], shadow_segments=detail["shadow_segments"],
               schedule=detail["schedule"])
    if got != ref["first"] or detail["triangles"] != ref["triangles"]:
        raise SystemExit(f"[{name}] FAIL: {got}, {detail['triangles']} triangles; phase {phase} at subframe "
                         f"0: {ref['first']}, {ref['triangles']} triangles")
    route, nee = scene.accel.route(cfg), cfg.env_importance_sampling
    iters = sum(int(stats["iters"]) for stats in frames)
    want = (ROUTE_KERNELS[route] if nee else ROUTE_KERNELS[route][:1]) + (STEP_KERNEL[detail["schedule"]],)
    for kid in want:
        if counts[kid] < iters:
            raise SystemExit(f"[{name}] FAIL: {counts[kid]} {KERNELS[kid][0]} launches for {iters} iterations")
    check_shading(name, counts, iters, nee)
    check_ray_order(name, counts, iters * (2 if nee else 1), trace_sort_launches(scene, cfg, detail["schedule"]))
    others = {KERNELS[kid][0]: c for kid, c in counts.items()
              if kid not in want + shading_kernels(nee) + RAY_ORDER and c}
    if others:
        raise SystemExit(f"[{name}] FAIL: other kernels launched: {others}")
    print(f"[{name}] {lines[0]} | segments equal phase {phase}'s at subframe 0"
          f"{' (' + ', '.join(differ) + ' aside)' if differ else ''}; {len(frames)} frames, {iters} iterations, "
          f"launches {launched(counts)}; {seconds:.1f} s | {smi}")
    return line


@contextlib.contextmanager
def counting_plain_brute():
    """While open, the calls of the brute-force plain versions
    (ops/intersect.py) are counted: the Counter it yields, by function."""
    calls = collections.Counter()
    real = {name: getattr(brute_ops, name) for name in ("intersect_brute_plain", "occluded_brute_plain")}

    def counted(name):
        def call(*args, **kw):
            calls[name] += 1
            return real[name](*args, **kw)
        return call

    for name in real:
        setattr(brute_ops, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(brute_ops, name, fn)


def bench_brute(name, argv, smi):
    """bench.main on the card at a preset that renders by brute force, in
    this process, every launch count set to 0 just before and read just
    after: one JSON line with a positive value, graphed, naming the card
    and its power limit; the scene without an accel; the closest-hit
    kernel once an iteration (and the any-hit kernel under NEE), the
    schedule's step, the shading kernels as check_shading says, no
    ray-order or other kernel, and no call of a plain brute-force version
    (counting_plain_brute); the device kernels an iteration of the bench's
    plan (its step's graph).  Returns (the line, the counts)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    set_counts_zero()
    with watching_bench() as (built, frames), counting_plain_brute() as plain_calls, \
            contextlib.redirect_stdout(out):
        rc = bench.main(list(argv))
    torch.cuda.synchronize()
    counts, seconds = read_counts(), time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        raise SystemExit(f"[{name}] FAIL: exit {rc}, output {lines}")
    line = json.loads(lines[0])
    detail = line["detail"]
    card = (torch.cuda.get_device_name(0), float(smi.rsplit(",", 1)[1].split()[0]))
    if not line["value"] > 0 or detail["graphed"] is not True or detail["captures"] != 1:
        raise SystemExit(f"[{name}] FAIL: {line['value']} Mrays/s, graphed {detail['graphed']}, "
                         f"{detail['captures']} captures")
    if (detail["device"], detail["power_limit_w"]) != card:
        raise SystemExit(f"[{name}] FAIL: the line names {detail['device']}, {detail['power_limit_w']} W")
    (scene, _, cfg), = built
    if scene.accel is not None:
        raise SystemExit(f"[{name}] FAIL: the preset built an accel")
    nee = cfg.env_importance_sampling
    iters = sum(int(stats["iters"]) for stats in frames)
    step = STEP_KERNEL[detail["schedule"]]
    want = (("kbc", "kba") if nee else ("kbc",)) + (step,)
    if counts["kbc"] != iters or counts["kba"] != (iters if nee else 0) or counts[step] < iters:
        raise SystemExit(f"[{name}] FAIL: {launched(counts)} for {iters} iterations")
    check_shading(name, counts, iters, nee)
    others = {KERNELS[kid][0]: c for kid, c in counts.items() if kid not in want + shading_kernels(nee) and c}
    if others or plain_calls:
        raise SystemExit(f"[{name}] FAIL: other kernels launched {others}; plain brute force called {plain_calls}")
    plan = next(reversed(graph_loop._plans.values()))
    per_iter = graph_kernels(plan._step)
    print(f"[{name}] {lines[0]} | {len(frames)} frames, {iters} iterations, launches {launched(counts)}; "
          f"no plain brute-force call; {per_iter} device kernels an iteration (the plan's step graph); "
          f"{seconds:.1f} s | {smi}", flush=True)
    return line, counts


def phase_bench(label, renders, smi):
    """bench_preset at each of BENCH_PRESETS, then bench_brute at each of
    BENCH_BRUTE.  Returns the cluster presets' lines and {name: launch
    counts} of the brute-force presets."""
    t_phase = time.perf_counter()
    lines = [bench_preset(f"{label} {' '.join(argv)}", argv, phase, differ, renders, smi)
             for argv, phase, differ in BENCH_PRESETS]
    brute_counts = {name: bench_brute(f"{label} {' '.join(argv)}", argv, smi)[1] for name, argv in BENCH_BRUTE}
    print(f"[{label}] {len(BENCH_PRESETS) + len(BENCH_BRUTE)} presets in {time.perf_counter() - t_phase:.1f} s "
          f"| {smi}")
    return lines, brute_counts


def phase_bench_position(label, scene, cfg, early, late, smi):
    """Phase 4's render timed again after phase 33, beside the bench's
    config 0 right after phase 4 (`early`) and in phase 33 (`late`): tells
    an overhead of the bench's own from one of the process's state after
    the phases between them (the CLI, NCCL and gloo groups, the
    profiler)."""
    again = phase_render(f"{label} render headline again", scene, cfg, Camera(), 2, smi)
    first = early["render"]["seconds"]
    bench_early, bench_late = (line["detail"]["sec_per_launch"] for line in (early["bench"], late))
    print(f"[{label}] s/launch, headline 1080p 10 spp depth 8 on the cluster accel: after phase 4 render "
          f"{first:.4f}, bench {bench_early:.4f} ({bench_early / first:.3f}x); after phase 33 render "
          f"{again['seconds']:.4f}, bench {bench_late:.4f} ({bench_late / again['seconds']:.3f}x); late / early: "
          f"render {again['seconds'] / first:.3f}x, bench {bench_late / bench_early:.3f}x | {smi}")


# ---------------------------------------------------------------------------
# Phase 39: the NEE quality study, python -m tpu_pathtracer_torch.tools.exp_nee_quality

# (name, the study's arguments beside --timed at its defaults): the four NEE
# arms, and pure NEE once more through the denoiser.
NEE_QUALITY_RUNS = (
    ("NEE", ()),
    ("defensive", ("--defensive",)),
    ("MIS", ("--mis",)),
    ("defensive MIS", ("--defensive", "--mis")),
    ("NEE denoised", ("--denoised",)),
)
# The study's brute-force renders run the brute-force closest hit, the
# bounce kernel and the path step once an iteration, the camera kernel once
# a frame (render_rays' set-up), the brute-force any hit and the NEE kernel
# once an iteration of the NEE arm; no cluster traversal or ray-order
# kernel.
NEE_QUALITY_KERNELS = ("kbc", "kb", "kc", "kp")


@contextlib.contextmanager
def counting_arms():
    """While open, the launch counts of each arm the NEE quality study
    renders: the list it yields gets (nee, counts) an arm, the counts set to
    0 just before the arm's run_arm and read just after."""
    arms = []
    run_arm = nee_quality.run_arm

    def counted(scene_name, nee, *rest):
        out, _, counts = timed(lambda: run_arm(scene_name, nee, *rest))
        arms.append((bool(nee), counts))
        return out

    nee_quality.run_arm = counted
    try:
        yield arms
    finally:
        nee_quality.run_arm = run_arm


def nee_quality_line(argv):
    """The study's main on `argv` in this process: (its JSON line, each
    arm's (nee, launch counts))."""
    out = io.StringIO()
    with counting_arms() as arms, contextlib.redirect_stdout(out):
        nee_quality.main(list(argv))
    return json.loads(out.getvalue().strip().splitlines()[-1]), arms


def json_numbers(obj):
    """Every float of a JSON object, nested ones included (booleans are
    not numbers here)."""
    if isinstance(obj, dict):
        for v in obj.values():
            yield from json_numbers(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from json_numbers(v)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield float(obj)


def check_nee_quality_arms(label, arms, frames):
    """Two arms, BSDF then NEE: the brute-force closest hit, the bounce
    kernel and the path step once an iteration (the same count), the camera
    kernel once a frame, the brute-force any hit and the NEE kernel once an
    iteration of the NEE arm and never in the BSDF arm, no other kernel."""
    if [nee for nee, _ in arms] != [False, True]:
        raise SystemExit(f"[{label}] FAIL: arms rendered {[nee for nee, _ in arms]}, not BSDF then NEE")
    for nee, counts in arms:
        want = NEE_QUALITY_KERNELS + (("kba", "kn") if nee else ())
        extra = {KERNELS[kid][0]: n for kid, n in counts.items() if n and kid not in want}
        per_iter = counts["kb"] if nee else 0
        if extra or not counts["kb"] or counts["kp"] != counts["kb"] or counts["kbc"] != counts["kb"] or (
                counts["kc"] != frames or counts["kn"] != per_iter or counts["kba"] != per_iter):
            raise SystemExit(f"[{label}] FAIL: {'NEE' if nee else 'BSDF'} arm of {frames} frames launched "
                             f"{launched(counts) or 'nothing'}; other kernels {extra}")


def nee_quality_parity(label, tmp, size="32x24", frames=4):
    """The study's frames on the card against the same run on the CPU: each
    arm's mean frame after post_process, SSIM above 0.995 (the rule of the
    GPU-vs-CPU render phases)."""
    frames_of, lines = {}, {}
    for dev in ("cuda", "cpu"):
        path = Path(tmp) / f"nee_quality_{dev}.npz"
        lines[dev], arms = nee_quality_line(["--size", size, "--frames", str(frames), "--spp", "1",
                                             "--device", dev, "--save-frames", str(path)])
        if dev == "cuda":
            check_nee_quality_arms(label, arms, frames)
        elif any(n for _, counts in arms for n in counts.values()):
            raise SystemExit(f"[{label}] FAIL: the CPU run launched {[launched(c) for _, c in arms]}")
        with np.load(path) as f:
            frames_of[dev] = {arm: f[arm] for arm in ("bsdf", "nee")}
    w, h = (int(v) for v in size.split("x"))
    cfg = nee_quality.build("spheres", False, (w, h), "cpu")[2]
    parts = []
    for arm in ("bsdf", "nee"):
        gpu, cpu = (post_process(torch.as_tensor(frames_of[dev][arm].mean(axis=0)), cfg).numpy()
                    for dev in ("cuda", "cpu"))
        score = ssim(gpu, cpu)
        close = np.isclose(frames_of["cuda"][arm], frames_of["cpu"][arm], rtol=1e-3, atol=1e-4)
        pixels = float(close.all(axis=-1).mean())
        if not score > 0.995:
            raise SystemExit(f"[{label}] FAIL: {arm} arm's mean frame, GPU vs CPU SSIM {score:.6f} <= 0.995; "
                             f"{1 - pixels:.4%} of the frames' pixels differ beyond rtol 1e-3 / atol 1e-4")
        parts.append(f"{arm} SSIM {score:.6f}, {pixels:.4%} of pixels within rtol 1e-3/atol 1e-4")
    var = {dev: (lines[dev]["var_bsdf_1spp"], lines[dev]["var_nee_1spp"]) for dev in lines}
    print(f"[{label}] {size}, {frames} frames an arm, the card against the CPU: " + "; ".join(parts)
          + f"; var_bsdf_1spp, var_nee_1spp {var['cuda'][0]:.6f}, {var['cuda'][1]:.6f} on the card, "
          f"{var['cpu'][0]:.6f}, {var['cpu'][1]:.6f} on the CPU")


def phase_nee_quality(label, tmp, smi):
    """The NEE quality study on the card (tpu_pathtracer_torch/tools/
    exp_nee_quality.py's main in this process): at its defaults (spheres,
    160x120, 48 1-spp frames an arm, depth 6, brute force) with --timed for
    the four NEE arms and once more for pure NEE with --denoised; each JSON
    line printed beside the card's name and power limit, every number in it
    finite, both seconds a frame above 0, each arm's launches as
    check_nee_quality_arms says.  Then the study at 32x24, 4 frames, on the
    card against the CPU (nee_quality_parity), and --scene monkey refused,
    naming monkey.obj, without --reference (in a process of its own: a
    non-zero exit) and with an empty one (naming the path), before any
    render.  Returns the JSON lines by run."""
    t0 = time.perf_counter()
    results = {}
    for name, extra in NEE_QUALITY_RUNS:
        t_run = time.perf_counter()
        line, arms = nee_quality_line(("--timed",) + extra)
        check_nee_quality_arms(f"{label} {name}", arms, line["frames"])
        bad = [x for x in json_numbers(line) if not math.isfinite(x)]
        if bad or not min(line["sec_per_frame"].values()) > 0:
            raise SystemExit(f"[{label} {name}] FAIL: numbers not finite {bad} or seconds a frame "
                             f"{line['sec_per_frame']} not above 0")
        print(f"[{label} {name}] {smi} | {time.perf_counter() - t_run:.1f} s; launches: BSDF arm "
              f"{launched(arms[0][1])}; NEE arm {launched(arms[1][1])}")
        print(json.dumps(line), flush=True)
        results[name] = line
    nee_quality_parity(f"{label} parity", tmp)
    proc = subprocess.run([sys.executable, "-m", "tpu_pathtracer_torch.tools.exp_nee_quality", "--scene", "monkey"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode == 0 or "monkey.obj" not in proc.stderr:
        raise SystemExit(f"[{label}] FAIL: --scene monkey without --reference exited {proc.returncode}: "
                         f"{proc.stderr.strip()[-300:]}")
    empty = Path(tmp) / "no_reference"
    empty.mkdir()
    with counting_arms() as arms:
        try:
            nee_quality.main(["--scene", "monkey", "--reference", str(empty)])
        except SystemExit as e:
            refused = str(e.code)
        else:
            refused = ""
    if str(empty / "monkey.obj") not in refused or arms:
        raise SystemExit(f"[{label}] FAIL: --scene monkey --reference {empty}: {refused!r}, {len(arms)} arms rendered")
    print(f"[{label}] --scene monkey refused before any render: exit {proc.returncode}, "
          f"{proc.stderr.strip().splitlines()[-1]!r}; with an empty --reference: {refused!r} | "
          f"{time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    return results


# ---------------------------------------------------------------------------
# Phase 40: the brute-force kernels (csrc/brute.cu) against their plain
# versions, timed, and in graphed renders

# Rays a brute-force case runs: none, one, the NEE study's 160x120 lanes,
# the headline's pool, a 1-spp tile (the plain versions' [N, 256]
# temporaries keep every plain run at or below it).
BRUTE_COUNTS = (0, 1, 19_200, 131_072, 345_600)
STUDY_LANES = 19_200
# Moller-Trumbore's float operations a test (mt_test in
# csrc/cluster_common.cuh): 27 multiplications, 18 additions and
# subtractions (u + v included), one IEEE division; the compares aside.
MT_TEST_FLOPS = 46


def brute_rays(scene, cfg, camera, n):
    """n rays in lane order as a trace hands them to brute force:
    ceil(n / 2) camera rays spread over the frame and each one's first
    bounce (trace_rays, through the scene's accel), the first n."""
    if n == 0:
        empty = torch.zeros((0, 3), dtype=torch.float32, device=scene.device)
        return empty, empty.clone()
    o, d = trace_rays(scene, cfg, camera, n_cam=-(-n // 2))
    return o[:n].contiguous(), d[:n].contiguous()


def brute_shadow_rays(scene, cfg, camera, n, seed=41):
    """n any-hit queries in lane order: from the first hit of each of
    brute_rays' rays toward its NEE light draw, and the mask of the lanes
    that trace one (shadow_rays' rule), on a scene whose sky has the alias
    table; elsewhere along the bounce direction, the mask a seeded 60% of
    the lanes that hit.  Returns (origins, directions, mask)."""
    o, d = brute_rays(scene, cfg, camera, n)
    if n == 0:
        return o, d, torch.zeros(0, dtype=torch.bool, device=o.device)
    idx = torch.arange(n, dtype=torch.int32, device=o.device)
    seeds = rng.make_seeds(idx, torch.zeros_like(idx), 1)
    depth = torch.full((n,), cfg.max_depth, dtype=torch.int32, device=o.device)
    hit = scene.accel.intersect(scene.vertices, o, d, cfg.t_min, cfg.t_max, cfg)
    sh = _shade(scene, cfg, hit, o, d, seeds, depth)
    if cfg.env_importance_sampling:
        _, env_dir, _, _, _ = _light_sample(scene, cfg, sh, sh["seeds"])
        cand, _ = _shadow_candidates(hit.hit, sh, env_dir)
        return sh["new_origin"].contiguous(), env_dir.contiguous(), cand
    keep = torch.as_tensor(np.random.RandomState(seed).rand(n) < 0.6, device=o.device)
    return sh["new_origin"].contiguous(), sh["new_direction"].contiguous(), hit.hit & keep


def hit_bits_equal(a, b):
    """Two Hits bit for bit (t, prim, bary, hit)."""
    return all(same_bits(getattr(a, f), getattr(b, f)) for f in ("t", "prim", "bary", "hit"))


def any_hit_tests(vertices, o, d, t_min, t_max, active):
    """The ray-triangle tests an any-hit scan in triangle order needs on
    these rays: each active ray up to its first occluding triangle (all T
    where none does), an inactive ray none."""
    t_count = vertices.shape[0]
    first = torch.full((o.shape[0],), t_count, dtype=torch.int64, device=o.device)
    for base in range(0, t_count, 256):
        _, _, _, valid = brute_ops._mt_block(o, d, vertices[base:base + 256], t_min, t_max)
        first = torch.where((first == t_count) & valid.any(dim=1), base + valid.int().argmax(dim=1), first)
    return int(torch.where(active, torch.clamp(first + 1, max=t_count), 0).sum())


def grazing_rays(vertices, n, seed):
    """n rays aimed at the triangles' vertices and edges ([T,3,3] on the
    card): each at a random triangle's vertex, an edge's midpoint or a
    random point of an edge, from a point around the scene (half) or from
    a random triangle's centroid (half, as a shadow ray leaves a surface),
    in float32.  Returns (origins, unit directions, the segments from the
    origin to the target: t = 1 at the edge)."""
    rs = np.random.RandomState(seed)
    v = vertices.cpu().numpy().astype(np.float32)
    k, i = rs.randint(0, v.shape[0], n), rs.randint(0, 3, n)
    kind = rs.randint(0, 3, n)
    frac = np.where(kind == 0, 0.0, np.where(kind == 1, 0.5, rs.rand(n))).astype(np.float32)[:, None]
    a, b = v[k, i], v[k, (i + 1) % 3]
    target = a + frac * (b - a)
    around = (rs.randn(n, 3) * np.array([5.0, 2.0, 5.0]) + np.array([0.0, 2.5, 0.0])).astype(np.float32)
    on = v[rs.randint(0, v.shape[0], n)].mean(axis=1, dtype=np.float32)
    o = np.where((rs.rand(n) < 0.5)[:, None], around, on).astype(np.float32)
    seg = (target - o).astype(np.float32)
    unit = (seg / np.linalg.norm(seg, axis=1, keepdims=True)).astype(np.float32)
    dev = vertices.device
    return tuple(torch.as_tensor(x, device=dev).contiguous() for x in (o, unit, seg))


def brute_grazing(label, cases, n=131_072):
    """Both kernels against their plain versions on grazing_rays of each
    case's scene: rays (t_max the config's) and segments ending on the
    edge (t_max 1); the any hit with a seeded 70% of the rays active.
    Returns a line's text."""
    parts = []
    for name, scene, cfg, _ in cases:
        v = scene.vertices
        o, unit, seg = grazing_rays(v, n, 43)
        active = torch.as_tensor(np.random.RandomState(44).rand(n) < 0.7, device=o.device)
        counts = []
        for what, d, t_max in (("rays", unit, cfg.t_max), ("segments", seg, 1.0)):
            got = brute_ops.intersect_brute_cuda(v, o, d, cfg.t_min, t_max)
            want = brute_ops.intersect_brute_plain(v, o, d, cfg.t_min, t_max, cfg.intersect_block)
            occ = brute_ops.occluded_brute_cuda(v, o, d, cfg.t_min, t_max, active)
            occ_p = brute_ops.occluded_brute_plain(v, o, d, cfg.t_min, t_max, cfg.intersect_block)
            torch.cuda.synchronize()
            if not hit_bits_equal(got, want):
                raise SystemExit(f"[{label}] FAIL: grazing {what} on {name}: the closest-hit kernel and its plain "
                                 f"version differ on {int((got.prim != want.prim).sum())} prims")
            if not torch.equal(occ[active], occ_p[active]) or bool(occ[~active].any()):
                raise SystemExit(f"[{label}] FAIL: grazing {what} on {name}: the any-hit kernel's flags differ from "
                                 f"the plain version's on {int((occ != occ_p)[active].sum())} active lanes, or an "
                                 f"inactive lane is True")
            counts.append(f"{what} {int(got.hit.sum())} hits, {int(occ.sum())} of {int(active.sum())} occluded")
        parts.append(f"{name} ({n} rays): " + ", ".join(counts))
    return "; ".join(parts)


def brute_timed_cases(scene, config1):
    """The brute-force kernels' timed cases: (what, scene, cfg, camera, n,
    any hit) at the main path's shapes: the closest hit on the headline's
    pool, the NEE study's lanes, config 1's pool and a 1-spp tile, the any
    hit on the headline's and the study's NEE shadow rays (`scene`:
    (the headline, its NEE cfg, camera); `config1`: brute_config1())."""
    headline, cfg_nee, camera = scene
    cfg = cfg_nee.replace(env_importance_sampling=False, rr_mode="reference")
    return (("closest, headline pool", headline, cfg, camera, 131_072, False),
            ("closest, NEE study", headline, cfg, camera, STUDY_LANES, False),
            ("closest, config 1 pool", *config1, CONFIG1_POOL, False),
            ("closest, 1-spp tile", headline, cfg, camera, 345_600, False),
            ("any, headline NEE", headline, cfg_nee, camera, 131_072, True),
            ("any, NEE study", headline, cfg_nee, camera, STUDY_LANES, True))


def brute_bound(vertices, o, d, t_min, t_max, active):
    """(bound ms, "bytes" or "operations", tests, bytes) of one call:
    closest hit (active None) N x T tests, any hit any_hit_tests; bytes
    the rays (24 B), the triangles (36 B), the mask and the outputs (17 B
    a ray closest, 1 any) once each."""
    n, t_count = o.shape[0], vertices.shape[0]
    if active is None:
        tests, out = n * t_count, 17 * n
    else:
        tests, out = any_hit_tests(vertices, o, d, t_min, t_max, active), 2 * n
    n_bytes = 24 * n + 36 * t_count + out
    t_ops, t_bytes = tests * MT_TEST_FLOPS / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", tests, n_bytes


def brute_parity(label, cases):
    """Each kernel against its plain version on every case's scene at each
    of BRUTE_COUNTS: the Hit bit for bit, the flags on the active lanes
    and False off them.  Returns a line's text."""
    parts = []
    for name, scene, cfg, camera in cases:
        v, counts = scene.vertices, []
        for n in BRUTE_COUNTS:
            o, d = brute_rays(scene, cfg, camera, n)
            got = brute_ops.intersect_brute_cuda(v, o, d, cfg.t_min, cfg.t_max)
            want = brute_ops.intersect_brute_plain(v, o, d, cfg.t_min, cfg.t_max, cfg.intersect_block)
            so, sd, active = brute_shadow_rays(scene, cfg, camera, n)
            occ = brute_ops.occluded_brute_cuda(v, so, sd, cfg.t_min, cfg.t_max, active)
            occ_p = brute_ops.occluded_brute_plain(v, so, sd, cfg.t_min, cfg.t_max, cfg.intersect_block)
            torch.cuda.synchronize()
            if not hit_bits_equal(got, want):
                raise SystemExit(f"[{label}] FAIL: {name}, {n} rays: the closest-hit kernel and its plain version "
                                 f"differ")
            if not torch.equal(occ[active], occ_p[active]) or bool(occ[~active].any()):
                raise SystemExit(f"[{label}] FAIL: {name}, {n} rays: the any-hit kernel's flags differ from the plain "
                                 f"version's on {int((occ != occ_p)[active].sum())} active lanes, or an inactive lane "
                                 f"is True")
            counts.append(f"{n}: {int(got.hit.sum())} hits, {int(occ.sum())} of {int(active.sum())} occluded")
            del o, d, got, want, so, sd, occ, occ_p
        parts.append(f"{name} ({v.shape[0]} triangles) " + ", ".join(counts))
    return "; ".join(parts)


def brute_ties(label, scene, cfg, camera):
    """Exact ties: the headline's triangles twice, each at 2k and 2k + 1
    (one tile of the kernel; different threads of a ray where it has
    several) and at k and k + T (different tiles), at the study's and the
    headline's ray counts: each kernel bit-equal to its plain version, every
    hit on the lower copy, with the single copy's t and bary."""
    v = scene.vertices
    parts = []
    layouts = (("one tile", torch.repeat_interleave(v, 2, dim=0), lambda p: torch.where(p >= 0, 2 * p, p)),
               ("two tiles", torch.cat([v, v]), lambda p: p))
    for layout, v2, lower in layouts:
        for n in (STUDY_LANES, 131_072):
            o, d = brute_rays(scene, cfg, camera, n)
            single = brute_ops.intersect_brute_cuda(v, o, d, cfg.t_min, cfg.t_max)
            got = brute_ops.intersect_brute_cuda(v2, o, d, cfg.t_min, cfg.t_max)
            want = brute_ops.intersect_brute_plain(v2, o, d, cfg.t_min, cfg.t_max, cfg.intersect_block)
            occ = brute_ops.occluded_brute_cuda(v2, o, d, cfg.t_min, cfg.t_max)
            occ_p = brute_ops.occluded_brute_plain(v2, o, d, cfg.t_min, cfg.t_max, cfg.intersect_block)
            torch.cuda.synchronize()
            ok = (hit_bits_equal(got, want) and torch.equal(got.prim, lower(single.prim))
                  and all(same_bits(getattr(got, f), getattr(single, f)) for f in ("t", "bary", "hit"))
                  and torch.equal(occ, occ_p))
            if not ok:
                raise SystemExit(f"[{label}] FAIL: ties ({layout}, {n} rays): kernel {hit_bits_equal(got, want)}, "
                                 f"lower copy {torch.equal(got.prim, lower(single.prim))}, any hit "
                                 f"{torch.equal(occ, occ_p)}")
            parts.append(f"{layout} at {n}: {int(got.hit.sum())} hits on the lower copy")
    return "; ".join(parts)


def brute_timed(label, cases):
    """Each kernel at the main path's shapes: ms with the L2 flushed before
    each launch and warm (back to back), the plain version's ms, the bound
    (brute_bound).  Returns {kind: numbers of its main-path case}, the
    first case of each kind, and a line's text."""
    numbers, parts = {}, []
    for what, scene, cfg, camera, n, any_hit in cases:
        v = scene.vertices
        if any_hit:
            o, d, active = brute_shadow_rays(scene, cfg, camera, n)
        else:
            (o, d), active = brute_rays(scene, cfg, camera, n), None

        def kernel(_=None):
            if any_hit:
                return brute_ops.occluded_brute_cuda(v, o, d, cfg.t_min, cfg.t_max, active)
            return brute_ops.intersect_brute_cuda(v, o, d, cfg.t_min, cfg.t_max)

        def plain():
            fn = brute_ops.occluded_brute_plain if any_hit else brute_ops.intersect_brute_plain
            return fn(v, o, d, cfg.t_min, cfg.t_max, cfg.intersect_block)

        cold = _time_cold(kernel, [None] * 11)
        warm = _time_over(kernel, [None] * 21, device_only=True)
        plain_ms = _time_ms(plain, 2)
        bound_ms, bound_by, tests, n_bytes = brute_bound(v, o, d, cfg.t_min, cfg.t_max, active)
        shape = brute_ops.brute_launch_shape(n, any_hit)
        kind = "any" if any_hit else "closest"
        if kind not in numbers:
            numbers[kind] = dict(max_abs_err=0.0, ms=cold, warm_ms=warm, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=None, rays=n, triangles=v.shape[0])
        parts.append(f"{what}: {n} rays x {v.shape[0]} triangles, {shape['threads_per_ray']} threads a ray, "
                     f"{shape['rays_per_block']} rays a block, {shape['blocks']} blocks: kernel {cold:.4f} ms L2-flushed, {warm:.4f} warm; plain "
                     f"{plain_ms:.4f}; bound {bound_ms:.4f} by {bound_by} ({tests} tests, {n_bytes} B); "
                     f"roofline share {bound_ms / warm:.1%} warm")
        del o, d
    return numbers, "; ".join(parts)


def brute_render_ab(label, scene, camera, smi):
    """A graphed 320x240, 2-spp frame of the headline's scene without its
    accel (brute force), without and with NEE, with the kernels and under
    ops.cuda_build.plain(): images, iterations, segments and shadow
    segments bit-equal; the kernels' arm one closest-hit launch an
    iteration (and one any-hit launch under NEE), the plain arm none; the
    programmatic edges of a step's graph (step_dependents); device kernels
    an iteration of each arm (graph_kernels of the plan's step).  Returns
    a line's text."""
    parts = []
    for nee in (False, True):
        cfg = RenderConfig(**{**HEADLINE, **(NEE if nee else {}), "width": 320, "height": 240,
                              "samples_per_launch": 2, "intersector": "auto"})
        cam = camera_arrays(camera, cfg, "cuda")
        runs = {}
        for arm in ("kernels", "plain"):
            with cuda_build.plain() if arm == "plain" else contextlib.nullcontext():
                render_frame_stats(scene, cam, cfg, 0)  # captures the plan's graph
                (img, stats), seconds, counts = timed(lambda: render_frame_stats(scene, cam, cfg, 1))
                plan = next(reversed(graph_loop._plans.values()))
                per_iter = graph_kernels(plan._step)
                edges = step_dependents(label, stats["schedule"], nee) if arm == "kernels" else None
            runs[arm] = (img, stats, counts, per_iter, seconds, edges)
        (img, st, counts, k_iter, k_s, edges), (img_p, st_p, counts_p, p_iter, p_s, _) = runs["kernels"], runs["plain"]
        iters = int(st["iters"])
        if not same_bits(img, img_p) or any(int(st[k]) != int(st_p[k]) for k in ("iters", "segments",
                                                                                  "shadow_segments")):
            raise SystemExit(f"[{label}] FAIL: {'NEE ' if nee else ''}render with the kernels differs from plain()")
        if not st["graphed"] or not st_p["graphed"]:
            raise SystemExit(f"[{label}] FAIL: a render ran eagerly")
        if (counts["kbc"], counts["kba"]) != (iters, iters if nee else 0) or counts_p["kbc"] or counts_p["kba"]:
            raise SystemExit(f"[{label}] FAIL: brute launches {counts['kbc']}, {counts['kba']} for {iters} "
                             f"iterations; plain arm {counts_p['kbc']}, {counts_p['kba']}")
        if not float(img.max()) > 0 or not bool(torch.isfinite(img).all()):
            raise SystemExit(f"[{label}] FAIL: the frame is black or not finite")
        parts.append(f"{'NEE' if nee else 'no NEE'} ({st['schedule']}, {iters} iterations, {int(st['segments'])} "
                     f"segments, {int(st['shadow_segments'])} shadow): bit-equal; kernels {k_s:.4f} s, "
                     f"{k_iter} device kernels an iteration, launches {launched(counts)}, programmatic edges into "
                     f"{edges}; plain() {p_s:.4f} s, {p_iter} device kernels an iteration")
    return "; ".join(parts)


def brute_cli(label, root):
    """The CLI without --scene (the procedural three spheres: brute force)
    at the reference's defaults, 1600x1200, depth 20, DOF, in two launches
    of 10 spp, with AOVs: the brute-force closest hit once an iteration and
    once for the AOV pass, the step and the shading kernels, nothing else,
    and no call of a plain brute-force version.  Returns (a line's text,
    the launch counts)."""
    out, prefix = root / "cli_brute.png", root / "cli_brute"
    with counting_plain_brute() as calls:
        r, counts, log = cli_launches(label, ["--file", out, "--spp", "20", "--aov-prefix", prefix])
    cfg = r.cfg
    if r.scene.accel is not None or cfg.intersector != "brute" or r.subframe != 2 or len(log) != 2 or (
            cfg.width, cfg.height, cfg.samples_per_launch, cfg.max_depth, cfg.dof) != (1600, 1200, 10, 20, True):
        raise SystemExit(f"[{label}] FAIL: not brute force at the reference's defaults: {cfg}, {len(log)} launches")
    iters = sum(e["iters"] for e in log)
    step = STEP_KERNEL[log[0]["schedule"]]
    if counts["kbc"] != iters + 1 or counts["kba"] or counts[step] < iters or calls:
        raise SystemExit(f"[{label}] FAIL: {launched(counts)} for {iters} iterations and an AOV pass; plain "
                         f"brute force called {dict(calls)}")
    check_shading(label, counts, iters, False)
    want = ("kbc", step) + shading_kernels(False)
    others = {KERNELS[kid][0]: c for kid, c in counts.items() if c and kid not in want}
    img = load_png(str(out))
    if others or img.shape != (1200, 1600, 3) or not img.mean() > 0:
        raise SystemExit(f"[{label}] FAIL: other kernels {others}; output {img.shape}, mean {img.mean()}")
    return (f"CLI without --scene ({r.scene.num_triangles} triangles, {log[0]['schedule']}, 1600x1200 10 spp depth "
            f"20 DOF, 2 launches and the AOV pass): s/launch {' '.join(f'{t:.4f}' for t in r.frame_times)}, "
            f"{iters} iterations, launches {launched(counts)}, no plain brute-force call"), counts


def phase_brute(label, scene, config1, hero, root, smi):
    """The brute-force kernels (csrc/brute.cu): nvcc's -Xptxas -v report and
    the launch shape at each ray count; brute_parity on the headline
    (`scene`: (scene, cfg, camera), its sky with the alias table, under
    NEE), config 1's sphere and the hero stand-in (2,214 triangles);
    brute_ties; brute_timed at the main path's shapes (the headline's pool
    and the NEE study's lanes, config 1's pool, a 1-spp tile; any hit on
    the headline's and the study's shadow rays); brute_grazing on the
    headline and config 1's sphere; brute_render_ab; brute_cli, writing under
    `root`.  Returns ({"kbc": ..., "kba": ...}, the kernels line's
    numbers; the CLI's launch counts)."""
    t0 = time.perf_counter()
    report = cuda_build.ptxas_report(cuda_build.library_path("brute.cu").with_suffix(".log").read_text())
    usage = "; ".join(f"{k}: {v['registers']} registers, {v.get('spill_stores', 0)} B spill stores, "
                      f"{v.get('spill_loads', 0)} B spill loads, {v.get('stack', 0)} B stack"
                      for k, v in report.items() if "brute_kernel" in k)
    shapes = ", ".join(f"{n}: " + " / ".join(
        f"{s['threads_per_ray']} a ray, {s['blocks']} blocks" for s in
        (brute_ops.brute_launch_shape(n, any_hit) for any_hit in (False, True))) for n in BRUTE_COUNTS)
    any_shape = brute_ops.brute_launch_shape(1, False)
    print(f"[{label} shape] ptxas: {usage}; blocks of {any_shape['threads']}, {any_shape['registers']} registers, "
          f"{any_shape['resident_blocks']} blocks an SM; rays: closest / any hit {shapes}", flush=True)
    headline, cfg_nee, camera = scene
    cases = (("headline", headline, cfg_nee, camera), ("config 1", *config1), ("hero", *hero))
    print(f"[{label} parity] bit-equal at {BRUTE_COUNTS} rays: {brute_parity(label, cases)}", flush=True)
    print(f"[{label} ties] {brute_ties(label, headline, cfg_nee, camera)}", flush=True)
    print(f"[{label} grazing] bit-equal: {brute_grazing(label, cases[:2])}", flush=True)
    numbers, text = brute_timed(label, brute_timed_cases(scene, config1))
    print(f"[{label} timed] {text} | {smi}", flush=True)
    text = brute_render_ab(label, headline.replace(accel=None), camera, smi)
    print(f"[{label} renders] {text} | {smi}", flush=True)
    text, cli_counts = brute_cli(label, root)
    print(f"[{label} CLI] {text} | {time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    return {"kbc": numbers["closest"], "kba": numbers["any"]}, cli_counts


# ---------------------------------------------------------------------------
# Phase 41: frames past the old 32-bit counters
# ---------------------------------------------------------------------------

# A DCI-4K frame at 1 spp: 8,847,360 rays in one render_rays batch and one
# sort a trace, past the 8,388,607 keys the sort's 32-bit status words count.
DCI_4K = dict(width=4096, height=2160, samples_per_launch=1)
# BASELINE config 1's sphere at 1080p, 17 spp, without regeneration:
# 35,251,200 lanes in one render_rays batch (the path step's two-word
# count from 2^25 lanes on; the sort's 64-bit status words).
UNREGENERATED = dict(CONFIG1, width=1920, height=1080, samples_per_launch=17, regenerate=False)
# The 8K full-format frame at 2 spp with an explicit pool of 2^25 lanes
# (bench --lanes): 35,389,440 pixels, so the stream schedule runs with a
# pool past kernel 7's narrow status words (two words a tile from 2^25).
STREAM_8K = dict(width=8192, height=4320, samples_per_launch=2, stream_lanes=2**25)
# Unfused iterations before kernel 7's lane states: the pool still full
# (by the 8th of the frame's 18 iterations the queue is spent and fewer
# than 1% of the lanes live).
STREAM_8K_ITERS = 2


def large_cases():
    """Phase 41's frames: (name, scene, RenderConfig, camera, the schedule
    render_pixels takes)."""
    headline = headline_scene("cuda")
    return (("DCI 4K", headline, RenderConfig(**{**HEADLINE, **DCI_4K}), Camera(), "rays"),
            ("DCI 4K NEE", headline, RenderConfig(**{**HEADLINE, **NEE, **DCI_4K}), Camera(), "rays"),
            ("1080p 17 spp unregenerated", config1_scene("cuda"), RenderConfig(**UNREGENERATED), Camera(), "rays"),
            ("8K stream", headline, RenderConfig(**{**HEADLINE, **STREAM_8K}), Camera(), "stream_fused"),
            ("8K stream NEE", headline, RenderConfig(**{**HEADLINE, **NEE, **STREAM_8K}), Camera(), "stream"))


def first_trace(cfg):
    """The rays of a frame's first trace as render_pixels spawns them:
    (count, samples a pixel): the stream's pool, one sample of each of
    its first pixels; else every pixel's samples."""
    n_pix, spp = cfg.width * cfg.height, cfg.samples_per_launch
    if frame_schedule(cfg, None, n_pix, spp, "cuda").startswith("stream"):
        return min(resolve_stream_lanes(cfg, n_pix), n_pix), 1
    return n_pix * spp, spp


def large_ray_order(label, scene, cfg, camera, smi):
    """The sort and the packet order on a large frame's first trace's rays
    as the main path sorts and traverses them: the sort's perm equal to
    torch.sort(key, stable=True).indices over all n and its rows to the
    gather, its launches the wrapper's count; the packet order of the
    route's pre-pass weights equal to its plain version.  Times with the
    L2 flushed: the sort beside its bound (the rows' bytes, ray_order_bytes)
    and the bytes its passes move through the keys and indices (16 B a ray
    a pass), plain, torch.sort of the key; the packet order beside the
    traversal it orders (that launch with its pre-pass and order), its
    plain version and argsort.  Returns {"sort": ..., "order": ...}."""
    acc = scene.accel
    n, per = first_trace(cfg)
    o, d, _ = camera_ops.camera_paths(camera_arrays(camera, cfg, scene.device), cfg, 0, 0, n, per=per)
    box = (acc.scene_lo, acc.scene_hi)
    bits = (acc._spatial_bits(cfg) if acc._want_sort(cfg) == "spatial" else 0, acc._dir_bits(cfg))
    set_counts_zero()
    o_s, d_s, perm = ray_sort.sort_rays_cuda(o, d, *box, *bits)
    launches = ray_sort.sort_rays.launches
    key = ray_sort.sort_key_plain(o, d, *box, *bits)
    want = torch.sort(key, stable=True).indices
    o_p, d_p = ray_sort.gather_rays_plain(o, d, want)
    if not (torch.equal(perm, want) and same_bits(o_s, o_p) and same_bits(d_s, d_p)):
        raise SystemExit(f"[{label}] FAIL: the sort of {n} rays and torch.sort's stable order and gather differ")
    if launches != ray_sort.sort_launches(n, *bits) or not ray_sort.wide_status(n):
        raise SystemExit(f"[{label}] FAIL: {launches} sort launches for {n} rays")
    del o_p, d_p, want
    passes = ray_sort.digit_passes(*bits)
    sort_ms = _time_cold(lambda _: ray_sort.sort_rays_cuda(o, d, *box, *bits), [None] * 6)
    plain_ms = _time_ms(lambda: ray_sort.sort_rays_plain(o, d, *box, *bits), 2)
    library_ms = _time_ms(lambda: torch.sort(key, stable=True), 3)
    rows = ray_order_bytes(n, None, False)["sort"]
    bound_ms, bound_by = bound(rows, 0)
    pass_bytes = rows + 16 * n * passes
    route, args = acc.traversal(o_s, d_s, cfg.t_min, cfg.t_max, cfg)
    traverse = KERNELS[ROUTE_KERNELS[route][0]][6]
    stem = ic._STEMS[route, False]
    weights = ic.packet_weights(getattr(cuda_build.library(f"{stem}.cu"), f"{stem}_weights"),
                                args[1] if route == "flat" else args[2], o_s, d_s, cfg.t_min, cfg.t_max,
                                acc._rpt(cfg))
    if not torch.equal(ray_sort.packet_order_cuda(weights), ray_sort.packet_order_plain(weights)):
        raise SystemExit(f"[{label}] FAIL: the packet order kernel and its plain version differ")
    packets = weights.shape[0]
    order_ms = _time_cold(lambda _: ray_sort.packet_order_cuda(weights), [None] * 11)
    order_plain_ms = _time_ms(lambda: ray_sort.packet_order_plain(weights), 5)
    argsort_ms = _time_cold(lambda _: torch.argsort(weights, descending=True, stable=True), [None] * 11)
    traversal_ms = _time_cold(lambda _: traverse(*args), [None] * 3)
    order_bound_ms, order_by = bound(packets * 8, order_compares(packets))
    print(f"[{label}] {n} rays, {bits[0]} spatial and {ray_sort.key_dir_bits(*bits)} direction bits, {passes} "
          f"passes, 64-bit status words: perm equal to torch.sort's stable order, rows to the gather (0 ulp), "
          f"{launches} launches; sort {sort_ms:.4f} ms ({sort_ms * 1e6 / n:.4f} ns a ray), plain {plain_ms:.4f}, "
          f"torch.sort of the key {library_ms:.4f}; bound {bound_ms:.4f} ms by {bound_by} ({rows} B), with the "
          f"passes' keys and indices {pass_bytes / PEAK_BYTES * 1e3:.4f} ms ({pass_bytes} B); packet order of "
          f"{packets} packets bit-equal, {order_ms:.4f} ms, plain {order_plain_ms:.4f}, argsort {argsort_ms:.4f}, "
          f"bound {order_bound_ms:.5f} by {order_by}, beside the {route} traversal it orders {traversal_ms:.4f} "
          f"ms ({100 * order_ms / traversal_ms:.2f}%) | {smi}", flush=True)
    return dict(sort=dict(rays=n, ms=sort_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by, pass_bound_ms=pass_bytes / PEAK_BYTES * 1e3),
                order=dict(packets=packets, ms=order_ms, plain_ms=order_plain_ms, library_ms=argsort_ms,
                           bound_ms=order_bound_ms, bound_by=order_by, traversal_ms=traversal_ms))


def large_render(label, scene, cfg, camera, sched, smi):
    """A large frame with the kernels, graphed: the frame at subframe 0
    that captures the plan, then the same frame timed (replays), its
    schedule `sched` (one render_rays batch, or the stream over its pool),
    every launch counted as phase_render counts them (check_frame_launches:
    the route's closest hit, and any hit under NEE, the schedule's step
    and the bounce kernel once an iteration, the NEE kernel once an
    iteration under NEE, the camera kernel once and once a stream
    iteration, the sort's launches for the trace's pool once a trace, the
    caller-order store, no other kernel); then the frame under
    ops.cuda_build.plain() (a stream with its unfused plain step, so that
    no kernel 7 runs there): image, iterations, segments and shadow
    segments bit-equal.  The peak bytes a lane of each arm
    (torch.cuda.max_memory_allocated over the frame that builds the plan,
    less what was allocated before it), and from the kernels' the most
    lanes the card's memory holds.  Returns the numbers."""
    nee = cfg.env_importance_sampling
    cam = camera_arrays(camera, cfg, scene.device)
    n_pix = cfg.width * cfg.height
    stream = sched.startswith("stream")
    lanes = min(resolve_stream_lanes(cfg, n_pix), n_pix) if stream else n_pix * cfg.samples_per_launch

    def peak_frame(plain=False):
        graph_loop.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cfg_ = cfg.replace(fused_schedule="off") if plain and stream else cfg
        with cuda_build.plain() if plain else contextlib.nullcontext():
            t0 = time.perf_counter()
            img, stats = render_frame_stats(scene, cam, cfg_, 0)
            torch.cuda.synchronize()
        return img, stats, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base, base

    captures = graph_loop.stats["captures"]
    _, _, first_s, peak, base = peak_frame()
    set_counts_zero()
    t0 = time.perf_counter()
    img, stats = render_frame_stats(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    iters, segs, shadow = stats["iters"], int(stats["segments"]), int(stats["shadow_segments"])
    if stats["schedule"] != sched or not stats["graphed"] or graph_loop.stats["captures"] - captures != 1:
        raise SystemExit(f"[{label}] FAIL: schedule {stats['schedule']}, not {sched}; graphed {stats['graphed']}")
    route = scene.accel.route(cfg)
    check_frame_launches(label, scene, cfg, counts, iters, sched, 1)
    if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
        raise SystemExit(f"[{label}] FAIL: the frame is non-finite or black")
    img = img.clone()
    set_counts_zero()
    img_p, stats_p, plain_s, plain_peak, _ = peak_frame(plain=True)
    plain_steps = read_counts()["k7"]
    same = (same_bits(img, img_p) and stats_p["iters"] == iters and int(stats_p["segments"]) == segs
            and int(stats_p["shadow_segments"]) == shadow)
    if not same or plain_steps:
        raise SystemExit(f"[{label}] FAIL: the kernels' frame and plain()'s differ (iterations {iters} and "
                         f"{stats_p['iters']}, segments {segs} and {int(stats_p['segments'])}; {plain_steps} kernel 7 "
                         f"launches under plain())")
    del img_p
    graph_loop.clear()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    per_lane = peak / lanes
    most = int((total - base) // per_lane)
    holds = (f"at most {most} lanes in a pool" if stream else
             f"at most {most} lanes ({most // (1920 * 1080)} spp unregenerated at 1080p, a 1-spp frame of {most} "
             f"pixels)")
    batch = (f"the {sched} schedule with a pool of {lanes} lanes over {n_pix} pixels" if stream else
             f"{lanes} lanes in one render_rays batch")
    print(f"[{label}] {scene.num_triangles} triangles, {route} route{', NEE' if nee else ''}, {cfg.width}x"
          f"{cfg.height} {cfg.samples_per_launch} spp depth {cfg.max_depth}: {batch}, graphed; {iters} iterations, "
          f"{segs} segments, {shadow} shadow segments; "
          f"{dt:.4f} s/launch (replays; {(segs + shadow) / dt / 1e6:.4f} Mrays/s), the capturing frame "
          f"{first_s:.4f} s, plain() {plain_s:.4f} s; image, iterations and segments bit-equal to plain(); "
          f"launches {launched(counts)}; peak {peak} B over the frame's set-up, {per_lane:.1f} B a lane "
          f"(plain() {plain_peak / lanes:.1f}); {total} B on the card, {base} B before the frame: {holds} | {smi}",
          flush=True)
    return dict(lanes=lanes, iters=iters, segments=segs, shadow_segments=shadow, seconds=dt,
                mrays=(segs + shadow) / dt / 1e6, bytes_per_lane=per_lane, plain_bytes_per_lane=plain_peak / lanes,
                most_lanes=most, counts=counts)


def large_path_step(label, scene, cfg, camera, smi):
    """The path step on the unregenerated frame's buffers after two
    iterations (35,251,200 lanes: the two-word count), against
    path_step_plain: every buffer bit-equal; ms with the L2 flushed beside
    the plain version and the bound of the bytes it must move
    (path_bytes)."""
    n = cfg.width * cfg.height * cfg.samples_per_launch
    st, tb, kw = path_lane_state(scene, cfg, camera, "rays", n, 2, per=cfg.samples_per_launch)
    st_k, st_p = ({k: v.clone() for k, v in st.items()} for _ in range(2))
    set_counts_zero()
    fs.path_step_cuda(tb, st_k, **kw)
    fs.path_step_plain(tb, st_p, **kw)
    torch.cuda.synchronize()
    bad = [k for k in st if not same_bits(st_k[k], st_p[k])]
    if bad or fs.path_step.launches != 1:
        raise SystemExit(f"[{label}] FAIL: the path step at {n} lanes and its plain version differ in {bad}")
    del st_k, st_p
    ms = _time_cold(lambda s_: fs.path_step_cuda(tb, s_, **kw), [{k: v.clone() for k, v in st.items()}
                                                                  for _ in range(4)])
    plain_ms = _time_over(lambda s_: fs.path_step_plain(tb, s_, **kw), [{k: v.clone() for k, v in st.items()}
                                                                         for _ in range(3)])
    n_bytes, n_live, n_newly = path_bytes(tb, st, kw)
    bound_ms, bound_by = bound(n_bytes, 15 * n_live + 3 * n_newly)
    print(f"[{label}] rays, {n} lanes after 2 iterations (two-word count): every buffer, done and segments "
          f"bit-equal (0 ulp); {n_live} live lanes, {n_newly} paths ended; {ms:.4f} ms (L2 flushed), plain "
          f"{plain_ms:.4f}; {n_bytes} B: bound {bound_ms:.4f} ms by {bound_by} | {smi}", flush=True)
    return dict(lanes=n, live=n_live, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


# Kernel 7 on a pool of 2^25 lanes: (name, RenderConfig fields over the 8K
# frame's, pixels as render_pixels takes them).  A map's pixels must
# outnumber the pool, so the range and the id list are a 16384x4320
# panorama's (70,778,880 pixels): "range" the second of its two pixel
# shards, "ids" every other pixel of it, last first.
PANORAMA = dict(width=16384)
STREAM_8K_STEPS = (("identity", {}, None), ("range", PANORAMA, "range"), ("ids", PANORAMA, "ids"),
                   ("NEE identity", NEE, None), ("NEE range", {**NEE, **PANORAMA}, "range"),
                   ("NEE ids", {**NEE, **PANORAMA}, "ids"))


def large_stream_step(label, scene, cfg, smi):
    """Kernel 7 alone on real lane states of the 8K frame's pool (2^25
    lanes, two status words a tile): the unfused stream's lanes after
    STREAM_8K_ITERS iterations and until a step retires pixels, on the 8K
    frame's identity map, and on a 16384x4320 panorama's second pixel
    shard of two (an affine range whose base the kernel reads on the
    card) and id list (every other pixel, last first), without NEE in
    both rr_modes and under NEE (the shadow
    count and the env credit); state, image, regen mask, head, segments,
    live and shadow counts bit-equal to fused_stream_step_plain with the
    real head and with one that sends lanes past n_pix.  The identity's
    reference mode and each map under NEE timed with the L2 flushed before
    each launch beside the plain version and the bound of the bytes the
    step must move (step_bytes); the identity's also beside the narrow
    layout's kernel on the same lanes but the last (2^25 - 1: one status
    word a tile, the same tiles).  Returns the numbers of each."""
    numbers = {}
    for name, over, kind in STREAM_8K_STEPS:
        n_frame = over.get("width", cfg.width) * cfg.height
        pixels = (None if kind is None else
                  (torch.tensor(n_frame // 2, dtype=torch.int64, device="cuda"), n_frame - n_frame // 2)
                  if kind == "range" else torch.arange(n_frame - 1, -1, -2, dtype=torch.int32, device="cuda"))
        nee = "env_importance_sampling" in over
        for rr_mode in ("standard",) if nee else ("reference", "standard"):
            cfg_ = cfg.replace(**{**over, "rr_mode": rr_mode})
            st, tb, head, _, *shadow = lane_state(scene, cfg_, Camera(), STREAM_8K_ITERS, retiring=True,
                                                  pixels=pixels)
            shadow = shadow[0] if shadow else None
            kw, keys, dev = step_kw(cfg_, pixels), state_keys(cfg_), scene.device
            n_pix, lanes = kw["n_pix"], st["slot"].shape[0]
            seg = torch.tensor(12345, dtype=torch.int64, device=dev)

            def copy():
                return {k: st[k].clone() for k in keys}

            probe = fs.fused_stream_step_plain(tb, copy(), torch.zeros((n_pix + 1, 3), device=dev), head, seg,
                                               shadow, **kw)
            done = int(probe[1]) - int(head)
            if not done or lanes < fs.NARROW_LANES:
                raise SystemExit(f"[{label} {name}] FAIL: {done} pixels retire in the step at {lanes} lanes")
            lines = []
            for head_in in (head, torch.tensor(n_pix - done // 2, dtype=torch.int64, device=dev)):
                st_k, st_p = copy(), copy()
                out_k, out_p = (torch.zeros((n_pix + 1, 3), device=dev) for _ in range(2))
                set_counts_zero()
                got = fs.fused_stream_step(tb, st_k, out_k, head_in, seg, shadow, **kw)
                launches = fs.fused_stream_step.launches
                want = fs.fused_stream_step_plain(tb, st_p, out_p, head_in, seg, shadow, **kw)
                torch.cuda.synchronize()
                bad = [k for k in keys if not same_bits(st_k[k], st_p[k])]
                bad += ["out"] * (not same_bits(out_k, out_p)) + ["regen"] * (not torch.equal(got[0], want[0]))
                bad += [w for w, a, b in zip(("head", "segments", "live", "shadow"), got[1:], want[1:])
                        if int(a) != int(b)]
                if bad or len(got) != len(want) or launches != 1:
                    raise SystemExit(f"[{label} {name}] FAIL: fused_step ({rr_mode}, {lanes} lanes) and its plain "
                                     f"version differ in {bad}")
                past = int((st_k["slot"] >= n_pix).sum()) - int((st["slot"] >= n_pix).sum())
                lines.append(f"head {int(head_in)}: {done} retired, {past} past n_pix, {int(got[0].sum())} regen, "
                             f"{int(got[3])} live" + (f", shadow {int(got[4]) - int(shadow)}" if nee else ""))
                del st_k, st_p, out_k, out_p
            timing = ""
            if rr_mode == ("standard" if nee else "reference") and (nee or kind is None):
                out_k = torch.zeros((n_pix + 1, 3), device=dev)
                ms = _time_cold(lambda s_: fs.fused_stream_step_cuda(tb, s_, out_k, head, seg, shadow, **kw),
                                [copy() for _ in range(5)])
                plain_ms = _time_over(lambda s_: fs.fused_stream_step_plain(tb, s_, out_k, head, seg, shadow, **kw),
                                      [copy() for _ in range(3)])
                n_bytes, n_live, n_done = step_bytes(tb, st, probe[0], n_pix, cfg_.samples_per_launch,
                                                     rr_mode == "reference", nee=nee, ids=kind == "ids")
                flops = 15 * n_live + 6 * n_done
                bound_ms, bound_by = bound(n_bytes, flops)
                numbers[name] = dict(lanes=lanes, max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by, library_ms=None)
                timing = (f"; kernel {ms:.4f} ms (L2 flushed before each launch), plain {plain_ms:.4f} ms; "
                          f"{n_live} live lanes, {n_done} pixels done, {n_bytes} bytes the step must move, {flops} "
                          f"FLOP: bound {bound_ms:.4f} ms by {bound_by}")
                if kind is None and not nee:  # the narrow layout at one lane fewer, the same tiles
                    fewer = {k: v[:-1] for k, v in tb.items()}
                    narrow_ms = _time_cold(
                        lambda s_: fs.fused_stream_step_cuda(fewer, s_, out_k, head, seg, shadow, **kw),
                        [{k: v[:-1].clone() for k, v in st.items() if k in keys} for _ in range(5)])
                    numbers[name]["narrow_ms_one_lane_fewer"] = narrow_ms
                    timing += f"; the narrow layout at {lanes - 1} lanes {narrow_ms:.4f} ms"
                del out_k
            print(f"[{label} {name}] {lanes} lanes (two status words a tile) over {n_pix} pixels, {rr_mode}: state, "
                  f"image, regen mask, head, segments, live{' and shadow' if nee else ''} count bit-equal (0 ulp): "
                  f"{'; '.join(lines)}{timing} | {smi}", flush=True)
            del st, tb, probe
            torch.cuda.empty_cache()
    return numbers


def large_cli(label, hero, root, smi):
    """The CLI on the hero stand-in's scene file at 4096x2160, one sample a
    launch (render_rays over 8,847,360 lanes, depth 20, DOF, the flat
    route): one capture, every launch counted (check_launches), the PNG
    and the accumulation finite and not black."""
    out = root / "hero_dci.png"
    r, counts, log = cli_launches(label, ["--scene-file", hero, "--dim", "4096x2160", "-s", "1", "--spp", "1",
                                          "--file", out, "--no-scene-cache"])
    cfg = r.cfg
    if (cfg.width, cfg.height, cfg.samples_per_launch) != (4096, 2160, 1) or [e["schedule"] for e in log] != ["rays"]:
        raise SystemExit(f"[{label}] FAIL: {cfg.width}x{cfg.height}, {cfg.samples_per_launch} spp, schedules "
                         f"{[e['schedule'] for e in log]}")
    iters = check_launches(label, counts, log, (ROUTE_KERNELS[r.scene.accel.route(cfg)][0], "kp"))
    img = load_png(str(out))
    if img.shape != (2160, 4096, 3) or not img.mean() > 0:
        raise SystemExit(f"[{label}] FAIL: output {img.shape}, mean {img.mean()}")
    if not bool(torch.isfinite(r.accum).all()) or not float(r.accum.max()) > 0.0:
        raise SystemExit(f"[{label}] FAIL: the accumulation is non-finite or black")
    print(f"[{label}] hero stand-in, {r.scene.accel.route(cfg)} route, 4096x2160, 1 spp a launch, depth "
          f"{cfg.max_depth}, DOF {cfg.dof}: s/launch {' '.join(f'{t:.4f}' for t in r.frame_times)}; {iters} "
          f"iterations, {sum(e['segments'] for e in log)} segments; launches {launched(counts)}; out {img.shape}, "
          f"mean {img.mean():.4f}, finite | {smi}", flush=True)


def phase_large(label, hero, root, smi):
    """Frames past the old 32-bit counters and kernel 7's narrow status
    words (large_cases): the sort and the packet order on the DCI-4K, the
    unregenerated and the 8K frame's first trace (large_ray_order); the
    five frames against plain() (large_render); the path step at
    35,251,200 lanes (large_path_step); kernel 7 on the 8K frame's pool
    (large_stream_step); the CLI at 4096x2160 (large_cli).  Returns the
    numbers for the kernels line."""
    t0 = time.perf_counter()
    graph_loop.clear()
    torch.cuda.empty_cache()
    cases = large_cases()
    c1, c1_cfg, cam1 = cases[2][1:4]
    out = {"order": {}, "renders": {}}
    for name, sc, cfg_, camera, _ in (cases[0], cases[2], cases[3]):
        got = large_ray_order(f"{label} ray order {name}", sc, cfg_, camera, smi)
        out["sort_" + name], out["order"][name] = got["sort"], got["order"]
        torch.cuda.empty_cache()
    for name, sc, cfg_, camera, sched in cases:
        out["renders"][name] = large_render(f"{label} render {name}", sc, cfg_, camera, sched, smi)
    out["path_step"] = large_path_step(f"{label} path step", c1, c1_cfg, cam1, smi)
    torch.cuda.empty_cache()
    out["stream_step"] = large_stream_step(f"{label} kernel 7", cases[3][1], cases[3][2], smi)
    torch.cuda.empty_cache()
    large_cli(f"{label} CLI", hero, root, smi)
    graph_loop.clear()
    torch.cuda.empty_cache()
    print(f"[{label}] {time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    return out


def ray_order_cases(scene, config4):
    """Phase 38's rays: (name, scene, RenderConfig, camera, camera rays,
    any hit) of the headline (`scene`) and config 4 (`config4`)."""
    cfg, cfg_nee, cam4 = RenderConfig(**HEADLINE), RenderConfig(**{**HEADLINE, **NEE}), Camera(**CONFIG4_CAMERA)
    return (
        ("headline", scene, cfg, Camera(), CAMERA_RAYS, False),
        ("config 1", config1_scene("cuda"), RenderConfig(**CONFIG1), Camera(), CONFIG1_CAMERA_RAYS, False),
        ("headline NEE shadow rays", scene, cfg_nee, Camera(), CAMERA_RAYS, True),
        ("config 4", config4, cfg, cam4, CAMERA_RAYS, False),
        ("config 4 NEE shadow rays", config4, cfg_nee, cam4, CAMERA_RAYS, True),
        ("1-spp tile", scene, cfg, Camera(), 172_800, False),
        ("headline regen pool", scene, cfg, Camera(), REGEN_POOL // 2, False),
        ("config 4 regen pool", config4, cfg, cam4, REGEN_POOL // 2, False),
    )


def nee_cases(scene, config4):
    """Phase 36's cases: the headline and config 4 with NEE (each also
    paired with its traversal), and the headline with MIS-spec and the
    defensive mixture."""
    cfg_nee = RenderConfig(**{**HEADLINE, **NEE})
    return (("headline", scene, cfg_nee, Camera(), CAMERA_RAYS, True),
            ("config 4", config4, cfg_nee, Camera(**CONFIG4_CAMERA), CAMERA_RAYS, True),
            ("headline MIS defensive", scene, cfg_nee.replace(nee_mis_spec=True, nee_defensive_mix=True), Camera(),
             CAMERA_RAYS, False))


def brute_config1():
    """Phase 40's config 1 case: (its sphere, RenderConfig, camera)."""
    return config1_scene("cuda"), RenderConfig(**CONFIG1), Camera()


def camera_pools(scene):
    """Phase 37's pools: the headline's 131,072 lanes and BASELINE config
    1's 16,384, mid-render."""
    return (("headline pool", scene, RenderConfig(**HEADLINE)),
            ("config 1 pool", config1_scene("cuda"), RenderConfig(**CONFIG1)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image", help="write the headline 1080p frame here as a binary PPM")
    parser.add_argument("--parent", help="the root of an older checkout: phases 11-13, 18, 18c, 36 and 37 also "
                                         "time its kernels, in turns")
    parser.add_argument("--ray-order", action="store_true",
                        help="run phase 38 alone (after the device and build phases)")
    parser.add_argument("--nee-camera", action="store_true",
                        help="run phases 36 and 37 alone (after the device and build phases)")
    parser.add_argument("--path-step", action="store_true",
                        help="run phases 18c, 21 and 22 alone (after the device and build phases)")
    parser.add_argument("--nee-quality", action="store_true",
                        help="run phase 39 alone (after the device and build phases)")
    parser.add_argument("--brute", action="store_true",
                        help="run phase 40 alone (after the device and build phases)")
    parser.add_argument("--large", action="store_true",
                        help="run phase 41 alone (after the device and build phases)")
    parser.add_argument("--shard-worker", nargs=3, metavar=("PORT", "RANK", "OUT"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.shard_worker:
        port, rank, out = args.shard_worker
        return shard_worker(int(port), int(rank), out)

    t_start = time.perf_counter()
    smi = phase_device()
    parent = phase_build(args.parent)
    if args.ray_order:
        phase_ray_order("38 ray order", ray_order_cases(headline_scene("cuda"), high_poly(100_000, "cuda")), smi)
        return 0
    if args.nee_camera:
        scene = headline_scene("cuda")
        phase_nee_kernel("36 NEE kernel", nee_cases(scene, high_poly(100_000, "cuda")), smi, parent)
        phase_camera_kernel("37 camera kernel", camera_pools(scene), smi, parent)
        return 0
    if args.path_step:
        scene = headline_scene("cuda")
        print(json.dumps({"path_step": phase_path_step("18c path step", scene, smi, parent)}), flush=True)
        for label, over in (("21 render 1 spp", dict(samples_per_launch=1, tile_pixels=345_600)),
                            ("21b render 1 spp NEE", dict(NEE, samples_per_launch=1, tile_pixels=345_600)),
                            ("22 render one lane per pixel", dict(stream_lanes=2_097_152))):
            phase_render(label, scene, RenderConfig(**{**HEADLINE, **over}), Camera(), 1, smi, warm=False)
        return 0
    if args.nee_quality:
        with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR.parent, prefix="chip_smoke_") as tmp:
            phase_nee_quality("39 NEE quality", tmp, smi)
        return 0
    if args.brute:
        with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR.parent, prefix="chip_smoke_") as tmp:
            hero = write_hero(Path(tmp))
            hero_scene, hero_camera, hero_cfg = load_scene_file(str(hero), device="cuda", cache_dir=f"{tmp}/cache")
            phase_brute("40 brute force", (headline_scene("cuda"), RenderConfig(**{**HEADLINE, **NEE}), Camera()),
                        brute_config1(), (hero_scene, hero_cfg, hero_camera), Path(tmp), smi)
        return 0
    if args.large:
        with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR.parent, prefix="chip_smoke_") as tmp:
            phase_large("41 large frames", write_hero(Path(tmp)), Path(tmp), smi)
        return 0
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
    # the sampler's 0: its loop runs inside the bounce kernel on the main path
    launches["k1"], launches["kb"], launches["kc"], launches["ks"] = (
        headline["counts"][k] for k in ("k1", "kb", "kc", "ks"))
    launches.update((k, headline["counts"][k]) for k in RAY_ORDER)
    if not all(launches[k] for k in RAY_ORDER):
        raise SystemExit(f"[4 render headline] FAIL: a ray-order kernel never launched: {launched(headline['counts'])}")
    renders = {"4": headline}  # by phase: what phase 33's bench runs are held against
    early = dict(render=headline, bench=bench_preset("4b bench config 0", *BENCH_PRESETS[0], renders, smi))
    phase_parity("5 parity headline", headline_scene, Camera(), "flat")

    config4 = high_poly(100_000, "cuda")
    big = high_poly(200_000, "cuda")
    numbers["k2"] = phase_kernel("6 kernel 2", "k2", config4, cfg, cam4, smi, plain_reps=2)
    numbers["k3"] = phase_kernel("7 kernel 3", "k3", big, cfg, cam4, smi, plain_reps=2)
    renders["8"] = phase_render("8 render config 4", config4, cfg, cam4, 1, smi)
    launches["k2"] = renders["8"]["counts"]["k2"]
    launches["k3"] = phase_render("9 render 200k", big, cfg, cam4, 1, smi)["counts"]["k3"]
    phase_parity("10 parity two-level", lambda dev: high_poly(13_000, dev), cam4, "hier")

    numbers["k4"] = phase_kernel("11 kernel 4", "k4", scene, cfg_nee, Camera(), smi, plain_reps=5, parent=parent)
    numbers["k5"] = phase_kernel("12 kernel 5", "k5", config4, cfg_nee, cam4, smi, plain_reps=2, parent=parent)
    numbers["k6"] = phase_kernel("13 kernel 6", "k6", big, cfg_nee, cam4, smi, plain_reps=2, parent=parent)
    renders["14"] = phase_render("14 render headline NEE", scene, cfg_nee, Camera(), 1, smi)
    renders["15"] = phase_render("15 render config 4 NEE", config4, cfg_nee, cam4, 1, smi)
    launches["k4"], launches["k5"] = renders["14"]["counts"]["k4"], renders["15"]["counts"]["k5"]
    launches["kn"] = renders["14"]["counts"]["kn"]
    launches["k6"] = phase_render("16 render 200k NEE", big, cfg_nee, cam4, 1, smi)["counts"]["k6"]
    phase_parity("17 parity headline NEE", headline_scene, Camera(), "flat", nee=True)
    del config4, big

    numbers["k7"] = phase_fused_kernel("18 kernel 7", {"headline": scene, "config 1": config1_scene("cuda")}, smi,
                                       parent)
    stream_steps = phase_stream_step("18b kernel 7 widened", scene, smi)
    numbers["kp"] = phase_path_step("18c path step", scene, smi, parent)
    launches["k7"] = phase_fused_render("19 render headline", scene, cfg, Camera(), smi)["counts"]["k7"]
    renders["20"] = phase_fused_render("20 render config 1", config1_scene("cuda"), RenderConfig(**CONFIG1), Camera(),
                                       smi)
    one_spp = cfg.replace(samples_per_launch=1, tile_pixels=345_600)
    tiles = phase_render("21 render 1 spp", scene, one_spp, Camera(), 1, smi, warm=False)
    if tiles["schedule"] != "rays":
        raise SystemExit("[21 render 1 spp] FAIL: the frame did not take render_rays")
    launches["kp"] = tiles["counts"]["kp"]
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
        bench_lines, brute_counts = phase_bench("33 bench", renders, smi)
        late = bench_lines[0]
        # the brute-force kernels' main path: the bench's config 0 and config 3
        # with NEE at their defaults
        launches["kbc"], launches["kba"] = brute_counts["config 0"]["kbc"], brute_counts["config 3 NEE"]["kba"]
        phase_bench_position("33b bench position", scene, cfg, early, late, smi)
        plain_counts = phase_graph_ab("34 eager vs graphed", scene, hero, root, smi)
        plain_arm = {"ks": plain_counts["random_in_unit_sphere"]}  # the sampler runs on the plain versions' path
        hero_scene, hero_camera, hero_cfg = load_scene_file(str(hero), device="cuda", cache_dir=str(root / "cache"))
        config4 = high_poly(100_000, "cuda")
        numbers["kb"] = phase_bounce_kernel("35 bounce kernel", bounce_lane_sets(scene, config1_scene("cuda")) + [
            ("hero", shade_inputs(hero_scene, hero_cfg, hero_camera, CAMERA_RAYS)),
            ("config 4 NEE", shade_inputs(config4, cfg_nee, cam4, CAMERA_RAYS)),
            ("headline NEE MIS defensive", shade_inputs(
                scene, cfg_nee.replace(nee_mis_spec=True, nee_defensive_mix=True), Camera(), CAMERA_RAYS)),
        ], smi)
        numbers["kn"] = phase_nee_kernel("36 NEE kernel", nee_cases(scene, config4), smi, parent)
        numbers["kc"] = phase_camera_kernel("37 camera kernel", camera_pools(scene), smi, parent)
        ray_order = phase_ray_order("38 ray order", ray_order_cases(scene, config4), smi)
        numbers.update(zip(RAY_ORDER, (ray_order[k] for k in ("sort", "restore", "order"))))
        del config4
        phase_nee_quality("39 NEE quality", root, smi)
        brute_numbers, brute_cli_counts = phase_brute("40 brute force", (scene, cfg_nee, Camera()), brute_config1(),
                                                      (hero_scene, hero_cfg, hero_camera), root, smi)
        numbers.update(brute_numbers)
        large = phase_large("41 large frames", hero, root, smi)
    print("[launches on the CLI renders] " + "; ".join(
        f"{name}: " + ", ".join(f"{KERNELS[kid][0]} {n}" for kid, n in counts.items() if n)
        for name, counts in cli_counts.items()))
    print(f"[done] {time.perf_counter() - t_start:.1f} s after the device phase began")

    # `launches` is the main path's count; the sampler, which launches only
    # on the plain versions' path since the bounce kernel runs its loop,
    # also gives phase 34's plain arm's count as `plain_arm_launches`;
    # kernel 7 also gives its launches in phase 14's NEE render and its
    # numbers off the fused stream's envelope (phase 18b) as `widened`.
    # the ray-order kernels also give their launches in phase 14's NEE render.
    # The brute-force kernels also give their launches on the bench's other
    # brute-force presets.  The sort, the packet order and the path step
    # also give their numbers at phase 41's sizes as `large` (the sort and
    # the packet order on the DCI-4K frame's and the unregenerated 17-spp
    # frame's first trace, the path step at 35,251,200 lanes), and their
    # launches in phase 41's DCI-4K render as `launches_dci_4k`.  Kernel 7
    # also gives its numbers on the 8K frame's pool of 2^25 lanes (two
    # status words a tile) as `large`, and its launches in phase 41's 8K
    # stream renders as `launches_8k`, `launches_8k_nee`.
    dci_counts = large["renders"]["DCI 4K"]["counts"]
    extra = {"ks": dict(plain_arm_launches=plain_arm["ks"]),
             "kbc": dict(launches_config3_nee=brute_counts["config 3 NEE"]["kbc"],
                         launches_config1=brute_counts["config 1"]["kbc"], launches_cli=brute_cli_counts["kbc"]),
             "k7": dict(launches_nee=renders["14"]["counts"]["k7"], widened=stream_steps),
             **{k: dict(launches_nee=renders["14"]["counts"][k], launches_dci_4k=dci_counts[k]) for k in RAY_ORDER}}
    extra["kx"]["large"] = {k: v for k, v in large.items() if k.startswith("sort_")}
    extra["ko"]["large"] = large["order"]
    extra["kp"] = dict(large=large["path_step"], launches_dci_4k=dci_counts["kp"])
    extra["k7"].update(large=large["stream_step"], launches_8k=large["renders"]["8K stream"]["counts"]["k7"],
                       launches_8k_nee=large["renders"]["8K stream NEE"]["counts"]["k7"])
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches[kid], **numbers[kid],
             **extra.get(kid, {}))
        for kid, (name, source, replaces, *_) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
