"""The port on an NVIDIA GPU: the packet-traversal CUDA kernels (flat,
two-level, streamed; closest hit and any hit; Baldwin-Weber and
Moller-Trumbore), the fused schedule step and the unit-ball sampler
against their plain PyTorch versions, small renders on the card, with and
without next-event estimation, against the same renders on the CPU, the
fused schedule's render against the unfused one, and every schedule's
iteration free of stream syncs but its own read; deferred shading against
the dense shade, sharded frames (NCCL in a group of one, gloo across two
processes on one card) against render_frame, renders against the numpy
oracle, and the shading kernels (the bounce, NEE and camera kernels) and
the ray ordering (the radix sort of the rays, the restore in the
traversal's store, the packet order) against their plain versions, bit for bit, alone and in renders under
ops.cuda_build.plain().  Every test needs a card and skips without one; this
file imports no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import contextlib
import functools
import gc
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import bounce as bounce_ops  # noqa: E402
from tpu_pathtracer_torch.ops import cuda_build  # noqa: E402
from tpu_pathtracer_torch.ops import fused_schedule as fs  # noqa: E402
from tpu_pathtracer_torch.ops import intersect_cluster as ic  # noqa: E402
from tpu_pathtracer_torch.ops import ray_sort  # noqa: E402
from tpu_pathtracer_torch.ops import unit_sphere  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.render.film import post_process  # noqa: E402
from tpu_pathtracer_torch.render import graph_loop, integrator  # noqa: E402
from tpu_pathtracer_torch.render.integrator import _fused_stream_ok, render_frame_stats  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402
from tpu_pathtracer_torch.utils import rng  # noqa: E402
from tpu_pathtracer_torch.utils.ssim import ssim  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_scenes as ts  # noqa: E402  (imports neither JAX nor PIL)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def rays(seed, n, parked):
    """Rays toward the three-spheres scene, a quarter in random
    directions, the last `parked` parked at (3e37, 0, 0) pointing +x."""
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * [5.0, 2.0, 5.0] + [0.0, 2.5, 0.0]).astype(np.float32)
    target = (rs.rand(n, 3) * [8.0, 2.0, 2.0] - [4.0, 0.0, 1.0]).astype(np.float32)
    d = target - o
    d[: n // 4] = rs.randn(n // 4, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o[n - parked :] = [3.0e37, 0.0, 0.0]
    d[n - parked :] = [1.0, 0.0, 0.0]
    return torch.as_tensor(o), torch.as_tensor(d)


@pytest.mark.parametrize("rays_per_tile", [1024, 256, 32])
def test_kernel_matches_plain(cuda, rays_per_tile):
    """Bit-equal t, prim and uv; one launch counted per call."""
    acc = build_accel(procedural.three_spheres_scene(12, 24, device=cuda)).accel
    o, d = (x.to(cuda) for x in rays(0, 70_000, parked=1000))
    args = (acc.tris16bw, acc.aabb8, acc.order, o, d, 0.01, 1e16, rays_per_tile)
    before = ic.intersect_clusters.launches
    tk, pk, uvk = ic.intersect_clusters(*args)
    tp, pp, uvp = ic.intersect_clusters_plain(*args)
    torch.cuda.synchronize()
    assert ic.intersect_clusters.launches == before + 1
    assert torch.equal(pk, pp) and torch.equal(tk, tp) and torch.equal(uvk, uvp)
    assert (pk != ic.MISS_PRIM).sum() > 10_000


def test_kernel_mt_matches_plain(cuda):
    """The flat kernel's Moller-Trumbore arm, bit-equal."""
    acc = build_accel(procedural.three_spheres_scene(12, 24, device=cuda)).accel
    o, d = (x.to(cuda) for x in rays(0, 70_000, parked=1000))
    args = (acc.tris16, acc.aabb8, acc.order, o, d, 0.01, 1e16, 1024, "mt")
    tk, pk, uvk = ic.intersect_clusters(*args)
    tp, pp, uvp = ic.intersect_clusters_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(tk, tp) and torch.equal(uvk, uvp)
    assert (pk != ic.MISS_PRIM).sum() > 10_000


@pytest.mark.parametrize("rays_per_tile", [512, 256, 32])
@pytest.mark.parametrize("tri_test", ["bw", "mt"])
@pytest.mark.parametrize("route", ["hier", "streamed"])
def test_two_level_kernel_matches_plain(cuda, route, tri_test, rays_per_tile):
    """Kernels 2 and 3 on three spheres in clusters of 8 (217 clusters):
    bit-equal t, prim and uv, parked rays included; one launch counted
    per call."""
    acc = build_accel(procedural.three_spheres_scene(12, 24, device=cuda), cluster_size=8).accel
    o, d = (x.to(cuda) for x in rays(1, 70_000, parked=1000))
    tris = acc.tris16bw if tri_test == "bw" else acc.tris16
    if route == "hier":
        wrapper, plain = ic.intersect_clusters_hier, ic.intersect_clusters_hier_plain
        args = (tris, acc.aabb8_child, acc.aabb8_super, acc.order_super, o, d, 0.01, 1e16,
                rays_per_tile, acc.super_branch, tri_test)
    else:
        wrapper, plain = ic.intersect_clusters_streamed, ic.intersect_clusters_streamed_plain
        args = (tris, *ic.streamed_pads(acc.aabb8), o, d, 0.01, 1e16, rays_per_tile, 16, tri_test)
    before = wrapper.launches
    tk, pk, uvk = wrapper(*args)
    tp, pp, uvp = plain(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(pk, pp) and torch.equal(tk, tp) and torch.equal(uvk, uvp)
    assert (pk != ic.MISS_PRIM).sum() > 10_000
    assert (pk[-1000:] == ic.MISS_PRIM).all()


# name: (cluster size, branch, rays per packet, rays, parked rays)
STREAMED_SHAPES = {
    "ragged_last_packet": (8, 16, 512, 5 * 512 + 77, 0),
    "one_ray": (8, 16, 512, 1, 0),
    "parked_packets": (8, 16, 512, 2048, 1024),       # two packets of parked rays only
    "gate_inside_super": (8, 16, 256, 20_000, 100),   # 217 clusters: the last super has 9 children
    "branch_2": (8, 2, 256, 20_000, 100),             # 109 supers: four batches of super votes
    "branch_40": (8, 40, 256, 20_000, 100),           # children voted on in two words
    "clusters_of_128": (128, 16, 512, 70_000, 1000),
    "clusters_of_768": (768, 16, 512, 20_000, 100),   # 48 KB of rows a cluster, two buffers
    "more_packets_than_resident": (8, 16, 32, 300_000, 1000),
    "packets_of_96": (8, 16, 96, 20_000, 100),        # three warps: one block a packet
    "packets_of_992": (8, 16, 992, 20_000, 100),      # one thread a ray
    "packets_of_1024": (8, 16, 1024, 70_000, 1000),
}


@pytest.mark.parametrize("tri_test", ["bw", "mt"])
@pytest.mark.parametrize("shape", list(STREAMED_SHAPES))
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_streamed_kernels_take_every_shape(cuda, kind, shape, tri_test):
    """Kernels 3 and 6 at the edges of what they take: a ragged last
    packet, one ray, packets of parked rays only, a cluster count that is
    no multiple of the branch, branches of 2 and 40, clusters of 8, 128 and
    768 rows, more packets than the card holds at once, and packet sizes
    that give a packet one block or eight and a ray one thread or eight:
    all bit-equal to the plain version."""
    cluster_size, branch, rays_per_tile, n, parked = STREAMED_SHAPES[shape]
    acc = build_accel(procedural.three_spheres_scene(12, 24, device=cuda), cluster_size=cluster_size).accel
    o, d = (x.to(cuda) for x in rays(3, n, parked=parked))
    tris = acc.tris16bw if tri_test == "bw" else acc.tris16
    child, supers = ic.streamed_pads(acc.aabb8, branch=branch)
    args = (tris, child, supers, o, d, 0.01, 1e16, rays_per_tile, branch, tri_test)
    if kind == "closest":
        got, want = ic.intersect_clusters_streamed(*args), ic.intersect_clusters_streamed_plain(*args)
    else:
        got, want = (ic.occluded_clusters_streamed(*args),), (ic.occluded_clusters_streamed_plain(*args),)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hit = (got[1] != ic.MISS_PRIM) if kind == "closest" else got[0]
    if n > 1000:
        assert 0.1 * n < int(hit.sum()) < n - parked
    if parked:
        assert not hit[-parked:].any()


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_streamed_kernels_take_no_rays(cuda, kind):
    """n = 0: empty outputs, nothing launched and nothing counted."""
    acc = build_accel(procedural.three_spheres_scene(12, 24, device=cuda), cluster_size=8).accel
    o = torch.zeros((0, 3), device=cuda)
    args = (acc.tris16bw, *ic.streamed_pads(acc.aabb8), o, o.clone(), 0.01, 1e16, 512, 16, "bw")
    wrapper = ic.intersect_clusters_streamed if kind == "closest" else ic.occluded_clusters_streamed
    before = wrapper.launches
    if kind == "closest":
        t, prim, uv = wrapper(*args)
        assert t.shape == (0,) and prim.shape == (0,) and uv.shape == (0, 2)
    else:
        assert wrapper(*args).shape == (0,)
    assert wrapper.launches == before


def test_streamed_launch_shape(cuda):
    """The launch-shape query: 131,072 rays in packets of 512 over clusters
    of 128 rows are 256 packets, each a cluster of blocks that together
    hold 512 rays with whole warps, within the card's limits."""
    for any_hit in (False, True):
        sh = ic.streamed_launch_shape(131_072, 512, 128, "bw", any_hit)
        assert sh["packets"] == 256
        assert sh["blocks"] * sh["threads"] == 512 * sh["threads_per_ray"]
        assert sh["threads"] % 32 == 0 and sh["threads"] <= 1024 and 1 <= sh["blocks"] <= 8
        assert 0 < sh["registers"] <= 255 and sh["resident_blocks"] >= 1 and sh["resident_clusters"] >= 1


# name: (cluster size, super branch, rays per packet, rays, parked rays)
HIER_SHAPES = {
    "ragged_last_packet": (8, 8, 512, 5 * 512 + 77, 0),
    "one_ray": (8, 8, 512, 1, 0),
    "parked_packets": (8, 8, 512, 2048, 1024),        # two packets of parked rays only
    "branch_2": (8, 2, 256, 20_000, 100),             # 109 supers: four batches of super votes
    "branch_40": (8, 40, 256, 20_000, 100),           # children in two words, 23 padding children
    "clusters_of_128": (128, 8, 512, 70_000, 1000),
    "clusters_of_768": (768, 8, 512, 20_000, 100),    # one super of 3 clusters and 5 padding children
    "more_packets_than_resident": (8, 8, 32, 300_000, 1000),
    "packets_of_96": (8, 8, 96, 20_000, 100),         # three warps: one block a packet
    "packets_of_512": (8, 8, 512, 70_000, 1000),
    "packets_of_992": (8, 8, 992, 20_000, 100),       # one thread a ray
    "packets_of_1024": (8, 8, 1024, 70_000, 1000),
}


@pytest.mark.parametrize("tri_test", ["bw", "mt"])
@pytest.mark.parametrize("shape", list(HIER_SHAPES))
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_hier_kernels_take_every_shape(cuda, kind, shape, tri_test):
    """Kernels 2 and 5 at the edges of what they take: a ragged last
    packet, one ray, packets of parked rays only, super branches of 2 and
    40 (built by build_cluster_accel, padding children whose rows clamp to
    the last cluster), clusters of 8, 128 and 768 rows, more packets than
    the card holds at once, and packets of 32 to 1024 rays, each packet
    in its own first ray's octant order: all bit-equal to the plain
    version."""
    cluster_size, branch, rays_per_tile, n, parked = HIER_SHAPES[shape]
    acc = build_accel(procedural.three_spheres_scene(12, 24, device=cuda), cluster_size=cluster_size,
                      super_branch=branch).accel
    o, d = (x.to(cuda) for x in rays(3, n, parked=parked))
    tris = acc.tris16bw if tri_test == "bw" else acc.tris16
    args = (tris, acc.aabb8_child, acc.aabb8_super, acc.order_super, o, d, 0.01, 1e16, rays_per_tile, branch,
            tri_test)
    if kind == "closest":
        got, want = ic.intersect_clusters_hier(*args), ic.intersect_clusters_hier_plain(*args)
    else:
        got, want = (ic.occluded_clusters_hier(*args),), (ic.occluded_clusters_hier_plain(*args),)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hit = (got[1] != ic.MISS_PRIM) if kind == "closest" else got[0]
    if n > 1000:
        assert 0.1 * n < int(hit.sum()) < n - parked
    if parked:
        assert not hit[-parked:].any()


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_hier_kernels_take_no_rays(cuda, kind):
    """n = 0: empty outputs, nothing launched and nothing counted."""
    acc = build_accel(procedural.three_spheres_scene(12, 24, device=cuda), cluster_size=8).accel
    o = torch.zeros((0, 3), device=cuda)
    args = (acc.tris16bw, acc.aabb8_child, acc.aabb8_super, acc.order_super, o, o.clone(), 0.01, 1e16, 512,
            acc.super_branch, "bw")
    wrapper = ic.intersect_clusters_hier if kind == "closest" else ic.occluded_clusters_hier
    before = wrapper.launches
    if kind == "closest":
        t, prim, uv = wrapper(*args)
        assert t.shape == (0,) and prim.shape == (0,) and uv.shape == (0, 2)
    else:
        assert wrapper(*args).shape == (0,)
    assert wrapper.launches == before


def test_hier_launch_shape(cuda):
    """The launch-shape query on the hier route: 131,072 rays in packets of
    512 over clusters of 128 rows are 256 packets laid out as on the
    streamed route, within the card's limits."""
    for any_hit in (False, True):
        sh = ic.streamed_launch_shape(131_072, 512, 128, "bw", any_hit, route="hier")
        assert sh["packets"] == 256
        assert sh["blocks"] * sh["threads"] == 512 * sh["threads_per_ray"]
        assert sh["threads"] % 32 == 0 and sh["threads"] <= 1024 and 1 <= sh["blocks"] <= 8
        assert 0 < sh["registers"] <= 255 and sh["resident_blocks"] >= 1 and sh["resident_clusters"] >= 1
        streamed = ic.streamed_launch_shape(131_072, 512, 128, "bw", any_hit)
        assert (sh["blocks"], sh["threads"], sh["threads_per_ray"]) == (
            streamed["blocks"], streamed["threads"], streamed["threads_per_ray"])


# name: (cluster size, rays per packet, rays, parked rays)
FLAT_SHAPES = {
    "ragged_last_packet": (128, 1024, 5 * 1024 + 77, 0),
    "one_ray": (128, 1024, 1, 0),
    "parked_packets": (128, 1024, 4096, 2048),          # two packets of parked rays only
    "config1_pool": (128, 1024, 16_384, 100),           # 16 packets: 8 blocks of 1,024 threads
    "one_packet_an_sm": (128, 1024, 131_072, 1000),     # the rules part by kind
    "rule_2x2": (128, 1024, 600_000, 1000),             # 586 packets: 2 blocks of 1,024 threads
    "rule_2x1": (128, 256, 500_000, 1000),              # 1,954 packets
    "clusters_of_8": (8, 1024, 20_000, 100),            # 217 clusters: eight batches of votes
    "clusters_of_768": (768, 1024, 20_000, 100),        # 48 KB of rows a cluster, two buffers
    "more_packets_than_resident": (128, 32, 300_000, 1000),
    "packets_of_96": (128, 96, 20_000, 100),            # three warps: one block a packet
    "packets_of_512": (128, 512, 70_000, 1000),
    "packets_of_992": (128, 992, 20_000, 100),          # one thread a ray
}


@pytest.mark.parametrize("tri_test", ["bw", "mt"])
@pytest.mark.parametrize("shape", list(FLAT_SHAPES))
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_flat_kernels_take_every_shape(cuda, kind, shape, tri_test):
    """Kernels 1 and 4 at the edges of what they take: a ragged last
    packet, one ray, packets of parked rays only, launches under each row
    of kShapeRules' flat rules (BASELINE config 1's pool of 16 packets
    among them), clusters of 8 (more than one batch of 31 visit positions),
    128 and 768 rows, more packets than the card holds at once, and packets
    of 32 to 992 rays, each packet in its own first ray's octant order: all
    bit-equal to the plain version."""
    cluster_size, rays_per_tile, n, parked = FLAT_SHAPES[shape]
    acc = build_accel(procedural.three_spheres_scene(12, 24, device=cuda), cluster_size=cluster_size).accel
    o, d = (x.to(cuda) for x in rays(3, n, parked=parked))
    tris = acc.tris16bw if tri_test == "bw" else acc.tris16
    args = (tris, acc.aabb8, acc.order, o, d, 0.01, 1e16, rays_per_tile, tri_test)
    if kind == "closest":
        got, want = ic.intersect_clusters(*args), ic.intersect_clusters_plain(*args)
    else:
        got, want = (ic.occluded_clusters(*args),), (ic.occluded_clusters_plain(*args),)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hit = (got[1] != ic.MISS_PRIM) if kind == "closest" else got[0]
    if n > 1000:
        assert 0.1 * n < int(hit.sum()) < n - parked
    if parked:
        assert not hit[-parked:].any()


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_flat_kernels_take_no_rays(cuda, kind):
    """n = 0: empty outputs, nothing launched and nothing counted."""
    acc = build_accel(procedural.three_spheres_scene(12, 24, device=cuda)).accel
    o = torch.zeros((0, 3), device=cuda)
    args = (acc.tris16bw, acc.aabb8, acc.order, o, o.clone(), 0.01, 1e16, 1024, "bw")
    wrapper = ic.intersect_clusters if kind == "closest" else ic.occluded_clusters
    before = wrapper.launches
    if kind == "closest":
        t, prim, uv = wrapper(*args)
        assert t.shape == (0,) and prim.shape == (0,) and uv.shape == (0, 2)
    else:
        assert wrapper(*args).shape == (0,)
    assert wrapper.launches == before


def test_flat_launch_shape(cuda):
    """The launch-shape query on the flat route: 131,072 rays in packets of
    1,024 over clusters of 128 rows are 128 packets, each a cluster of
    blocks that together hold 1,024 rays with whole warps; 16,384 rays (16
    packets) are spread at least as wide."""
    for any_hit in (False, True):
        sh = ic.streamed_launch_shape(131_072, 1024, 128, "bw", any_hit, route="flat")
        assert sh["packets"] == 128
        assert sh["blocks"] * sh["threads"] == 1024 * sh["threads_per_ray"]
        assert sh["threads"] % 32 == 0 and sh["threads"] <= 1024 and 1 <= sh["blocks"] <= 8
        assert 0 < sh["registers"] <= 255 and sh["resident_blocks"] >= 1 and sh["resident_clusters"] >= 1
        few = ic.streamed_launch_shape(16_384, 1024, 128, "bw", any_hit, route="flat")
        assert few["packets"] == 16
        assert few["blocks"] * few["threads_per_ray"] >= sh["blocks"] * sh["threads_per_ray"]


def test_render_matches_cpu(cuda):
    """A 64x48 render through the kernel against the plain versions on
    the CPU: segment counts within 0.5%, SSIM above 0.995."""
    cfg = RenderConfig(width=64, height=48, samples_per_launch=4, max_depth=6, dof=False,
                       stream_lanes=512, intersector="cluster", env_mode="sunsky")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene = build_accel(procedural.three_spheres_scene(8, 16, device=dev))
        img, stats = render_frame_stats(scene, camera_arrays(Camera(), cfg, dev), cfg, 0)
        out[dev.type] = (post_process(img, cfg).cpu().numpy(), int(stats["segments"]))
    (gpu, seg_gpu), (cpu, seg_cpu) = out["cuda"], out["cpu"]
    assert abs(seg_gpu - seg_cpu) <= 0.005 * seg_cpu
    assert ssim(gpu, cpu) > 0.995


def test_render_hier_matches_cpu(cuda):
    """The same on the two-level route (97 clusters of 8)."""
    cfg = RenderConfig(width=64, height=48, samples_per_launch=4, max_depth=6, dof=False,
                       stream_lanes=512, intersector="cluster", env_mode="sunsky")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene = build_accel(procedural.three_spheres_scene(8, 16, device=dev), cluster_size=8)
        assert scene.accel.route(cfg) == "hier"
        img, stats = render_frame_stats(scene, camera_arrays(Camera(), cfg, dev), cfg, 0)
        out[dev.type] = (post_process(img, cfg).cpu().numpy(), int(stats["segments"]))
    (gpu, seg_gpu), (cpu, seg_cpu) = out["cuda"], out["cpu"]
    assert abs(seg_gpu - seg_cpu) <= 0.005 * seg_cpu
    assert ssim(gpu, cpu) > 0.995


@pytest.mark.parametrize("rays_per_tile", [1024, 256, 32])
@pytest.mark.parametrize("tri_test", ["bw", "mt"])
@pytest.mark.parametrize("route", ["flat", "hier", "streamed"])
def test_occluded_kernel_matches_plain(cuda, route, tri_test, rays_per_tile):
    """Kernels 4, 5 and 6 (any hit) against their plain versions: the same
    flags on every ray, parked rays never occluded; one launch counted per
    call.  Flat on three spheres in clusters of 128, the two-level routes
    in clusters of 8 (217 clusters)."""
    acc = build_accel(procedural.three_spheres_scene(12, 24, device=cuda),
                      cluster_size=128 if route == "flat" else 8).accel
    o, d = (x.to(cuda) for x in rays(2, 70_000, parked=1000))
    tris = acc.tris16bw if tri_test == "bw" else acc.tris16
    if route == "flat":
        wrapper, plain = ic.occluded_clusters, ic.occluded_clusters_plain
        args = (tris, acc.aabb8, acc.order, o, d, 0.01, 1e16, rays_per_tile, tri_test)
    elif route == "hier":
        wrapper, plain = ic.occluded_clusters_hier, ic.occluded_clusters_hier_plain
        args = (tris, acc.aabb8_child, acc.aabb8_super, acc.order_super, o, d, 0.01, 1e16,
                rays_per_tile, acc.super_branch, tri_test)
    else:
        wrapper, plain = ic.occluded_clusters_streamed, ic.occluded_clusters_streamed_plain
        args = (tris, *ic.streamed_pads(acc.aabb8), o, d, 0.01, 1e16, rays_per_tile, 16, tri_test)
    before = wrapper.launches
    occ_k = wrapper(*args)
    occ_p = plain(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(occ_k, occ_p)
    assert 10_000 < int(occ_k.sum()) < 69_000
    assert not occ_k[-1000:].any()


@pytest.mark.parametrize("cluster_size", [128, 8], ids=["flat", "hier"])
def test_render_nee_matches_cpu(cuda, cluster_size):
    """An NEE render (alias-table light draws, shadow rays through the
    any-hit kernel) on the card against the plain versions on the CPU:
    segments and shadow segments within 0.5%, SSIM above 0.995."""
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils.image import procedural_hdr

    cfg = RenderConfig(width=64, height=48, samples_per_launch=4, max_depth=6, dof=False,
                       stream_lanes=512, intersector="cluster", env_mode="equirect",
                       rr_mode="standard", env_importance_sampling=True)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        env = with_importance_sampling(make_env(procedural_hdr(32, 64), dev))
        scene = build_accel(procedural.three_spheres_scene(8, 16, device=dev).replace(env=env),
                            cluster_size=cluster_size)
        img, stats = render_frame_stats(scene, camera_arrays(Camera(), cfg, dev), cfg, 0)
        out[dev.type] = (post_process(img, cfg).cpu().numpy(), int(stats["segments"]),
                         int(stats["shadow_segments"]))
    (gpu, seg_gpu, sh_gpu), (cpu, seg_cpu, sh_cpu) = out["cuda"], out["cpu"]
    assert abs(seg_gpu - seg_cpu) <= 0.005 * seg_cpu
    assert abs(sh_gpu - sh_cpu) <= 0.005 * sh_cpu and sh_cpu > 0
    assert ssim(gpu, cpu) > 0.995


def step_state(lanes, seed, dev):
    """A lane pool after a trace, from a numpy seed (as
    test_torch_fused_schedule.step_inputs): distinct live slots, a tenth
    retired, a head near n_pix, attenuations with zeros, values above 1
    and a few NaNs.  Returns (tb, st, n_pix, head, segments) as tensors."""
    rs = np.random.RandomState(seed)
    n_pix = 4 * lanes
    head = n_pix - lanes // 16
    slot = rs.permutation(head)[:lanes].astype(np.int32)
    dead = rs.rand(lanes) < 0.1
    slot[dead] = n_pix + rs.randint(0, 3, dead.sum())
    pix = np.where(dead, rs.randint(0, n_pix, lanes), slot).astype(np.int32)

    def vec3(lo, hi):
        return rs.uniform(lo, hi, (lanes, 3)).astype(np.float32)

    att = vec3(0.0, 1.3)
    att[rs.rand(lanes) < 0.05] = 0.0
    att[rs.rand(lanes) < 0.01, 1] = np.nan
    tb = dict(origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=att, radiance=vec3(0, 4),
              seeds=rs.randint(0, 2**32, lanes).astype(np.int64), done=rs.rand(lanes) < 0.3)
    st = dict(origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=vec3(0, 1), radiance=vec3(0, 2),
              seeds=rs.randint(0, 2**32, lanes).astype(np.int64), slot=slot, pix=pix,
              sample_i=rs.randint(0, 3, lanes).astype(np.int32),
              depth=rs.randint(0, 5, lanes).astype(np.int32), lane_accum=vec3(0, 6))
    as_t = {k: torch.as_tensor(v).to(dev) for k, v in tb.items()}, {k: torch.as_tensor(v).to(dev) for k, v in st.items()}
    return (*as_t, n_pix, torch.tensor(head, device=dev), torch.tensor(1000, device=dev))


def same_bits(a, b):
    """Equal bit for bit; NaN where the other has NaN (the card writes
    its own NaN bits)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32), torch.where(nan, 0.0, b).view(torch.int32))


@pytest.mark.parametrize("rr_mode", ["reference", "standard"])
def test_fused_step_matches_plain(cuda, rr_mode):
    """Kernel 7 at 131,072 lanes (512 blocks, so the queue's look-back
    crosses many blocks) against its plain version on the same tensors:
    the state, the image, the regen mask, head, segments and the live
    count bit for bit; one launch counted."""
    tb, st, n_pix, head, segments = step_state(131072, 5 + (rr_mode == "standard"), cuda)
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=rr_mode == "reference", inv_spp=1.0 / 3)
    st_k = {k: v.clone() for k, v in st.items()}
    st_p = {k: v.clone() for k, v in st.items()}
    out_k = torch.zeros((n_pix + 1, 3), device=cuda)
    out_p = torch.zeros_like(out_k)
    before = fs.fused_stream_step.launches
    got = fs.fused_stream_step(tb, st_k, out_k, head, segments, **kw)
    want = fs.fused_stream_step_plain(tb, st_p, out_p, head, segments, **kw)
    torch.cuda.synchronize()
    assert fs.fused_stream_step.launches == before + 1
    for key in st:
        assert same_bits(st_k[key], st_p[key]), key
    assert same_bits(out_k, out_p)
    assert torch.equal(got[0], want[0])
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]
    assert int(head) < n_pix < int(got[1]) and int(got[3]) < 131072


@pytest.mark.parametrize("rr_mode", ["reference", "standard"])
def test_fused_render_bitwise_on_card(cuda, rr_mode):
    """The fused schedule's render on the card (kernel 7 every iteration)
    equals the unfused render under ops.cuda_build.plain() (its plain step,
    no kernel 7 launch) bit for bit, with the same iterations and
    segments."""
    res = {}
    scene = build_accel(procedural.three_spheres_scene(8, 16, device=cuda))
    for mode in ("on", "off"):
        cfg = RenderConfig(width=64, height=48, samples_per_launch=3, max_depth=4, dof=False, stream_lanes=512,
                           intersector="cluster", env_mode="sunsky", rr_mode=rr_mode, fused_schedule=mode)
        assert _fused_stream_ok(cfg, None, 512, cuda) == (mode == "on")
        before = fs.fused_stream_step.launches
        with cuda_build.plain() if mode == "off" else contextlib.nullcontext():
            img, stats = render_frame_stats(scene, camera_arrays(Camera(), cfg, cuda), cfg, 0)
        launches = fs.fused_stream_step.launches - before
        assert launches == (stats["iters"] if mode == "on" else 0)
        res[mode] = (img, stats["iters"], int(stats["segments"]))
    (img_f, it_f, seg_f), (img_u, it_u, seg_u) = res["on"], res["off"]
    assert torch.equal(img_f, img_u) and it_f == it_u and seg_f == seg_u


@pytest.mark.parametrize("lanes", [128, 16384, 131072, 524288])
@pytest.mark.parametrize("rr_mode", ["reference", "standard"])
def test_fused_step_pool_sizes(cuda, rr_mode, lanes):
    """Kernel 7 at every pool size the issue's sweep covers, from one tile
    to many windows of look-back, each at its rule's shape: bit-equal to
    the plain version, with lanes retiring past n_pix."""
    tb, st, n_pix, head, segments = step_state(lanes, lanes + (rr_mode == "standard"), cuda)
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=rr_mode == "reference", inv_spp=1.0 / 3)
    st_k = {k: v.clone() for k, v in st.items()}
    st_p = {k: v.clone() for k, v in st.items()}
    out_k = torch.zeros((n_pix + 1, 3), device=cuda)
    out_p = torch.zeros_like(out_k)
    got = fs.fused_stream_step(tb, st_k, out_k, head, segments, **kw)
    want = fs.fused_stream_step_plain(tb, st_p, out_p, head, segments, **kw)
    torch.cuda.synchronize()
    for key in st:
        assert same_bits(st_k[key], st_p[key]), key
    assert same_bits(out_k, out_p) and torch.equal(got[0], want[0])
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]
    assert int(got[1]) > n_pix


def test_fused_step_32_steps_on_one_scratch(cuda):
    """32 consecutive steps on one lane pool, each step's state, head and
    segments fed to the next, with no zeroing of the kernel's scratch
    between them: kernel and plain version stay bit-equal at every step."""
    lanes = 131072
    _, st, n_pix, head, segments = step_state(lanes, 7, cuda)
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=True, inv_spp=1.0 / 3)
    st_k = {k: v.clone() for k, v in st.items()}
    st_p = {k: v.clone() for k, v in st.items()}
    out_k = torch.zeros((n_pix + 1, 3), device=cuda)
    out_p = torch.zeros_like(out_k)
    head_k = head_p = head
    seg_k = seg_p = segments
    before = fs.fused_stream_step.launches
    for step in range(32):
        tb = step_state(lanes, 100 + step, cuda)[0]
        regen_k, head_k, seg_k, live_k = fs.fused_stream_step_cuda(tb, st_k, out_k, head_k, seg_k, **kw)
        regen_p, head_p, seg_p, live_p = fs.fused_stream_step_plain(tb, st_p, out_p, head_p, seg_p, **kw)
        torch.cuda.synchronize()
        for key in st:
            assert same_bits(st_k[key], st_p[key]), (step, key)
        assert same_bits(out_k, out_p) and torch.equal(regen_k, regen_p), step
        assert (int(head_k), int(seg_k), int(live_k)) == (int(head_p), int(seg_p), int(live_p)), step
    assert fs.fused_stream_step.launches == before + 32


@pytest.mark.parametrize("lanes", [16384, 131072])
def test_fused_step_repeats_on_one_scratch(cuda, lanes):
    """One step launched 4,200 times on one never-cleared scratch (more
    than the 4,095 tags a status word cycles through), each from a fresh
    copy of the state: every launch's slots, regen mask, head', segments'
    and live count equal the plain version's, whatever order the tiles
    run in."""
    tb, st, n_pix, head, segments = step_state(lanes, 11, cuda)
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=True, inv_spp=1.0 / 3)
    st_p = dict(st)
    want = fs.fused_stream_step_plain(tb, st_p, torch.zeros((n_pix + 1, 3), device=cuda), head, segments, **kw)
    st_k = {k: v.clone() for k, v in st.items()}
    out_k = torch.zeros((n_pix + 1, 3), device=cuda)
    bad = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(4200):
        for k, v in st.items():
            st_k[k].copy_(v)
        regen, head_k, seg_k, live_k = fs.fused_stream_step_cuda(tb, st_k, out_k, head, segments, **kw)
        bad += (st_k["slot"] != st_p["slot"]).sum() + (regen != want[0]).sum()
        bad += (head_k != want[1]).long() + (seg_k != want[2]).long() + (live_k != want[3]).long()
    assert int(bad) == 0
    assert int(want[1]) > int(head)


# ---------------------------------------------------------------------------
# Kernel 7 widened (every pixel map, NEE) and the path step of render_rays
# and render_pixels_regen (csrc/fused_schedule.cu) against their plain
# versions, bit for bit
# ---------------------------------------------------------------------------

STEP_NEE = ("off", "on", "mis")  # NEE off; on, its env credit bool; under nee_mis_spec, float32
STEP_POOLS = (16384, 131072, 100003)


def nee_fields(tb, st, lanes, nee, seed, dev):
    """Under NEE: the payload's hit flags and env credits and the lanes'
    env credits (bool, or float32 weights in [0, 1] under MIS), from a
    numpy seed, added to tb and st."""
    if nee == "off":
        return None
    rs = np.random.RandomState(seed)
    if nee == "mis":
        spec = lambda: torch.as_tensor(rs.uniform(0, 1, lanes).astype(np.float32)).to(dev)  # noqa: E731
    else:
        spec = lambda: torch.as_tensor(rs.rand(lanes) < 0.5).to(dev)  # noqa: E731
    tb["hit"] = torch.as_tensor(rs.rand(lanes) < 0.7).to(dev)
    tb["spec_last"], st["spec_last"] = spec(), spec()
    return torch.tensor(77, device=dev)


def pixel_map(kind, n_pix, seed, dev):
    """A stream step's pixel map keywords: the identity, an affine range's
    0-d base, or an id table (a permutation of pixels)."""
    if kind == "range":
        return dict(base=torch.tensor(123457, device=dev))
    if kind == "ids":
        perm = np.random.RandomState(seed).permutation(2 * n_pix)[:n_pix].astype(np.int32)
        return dict(ids=torch.as_tensor(perm).to(dev))
    return {}


def stream_step_pair(tb, st, n_pix, head, segments, shadow, kw):
    """The kernel and the plain version on copies of the same state:
    (kernel state, plain state, kernel image, plain image, kernel result,
    plain result)."""
    st_k = {k: v.clone() for k, v in st.items()}
    st_p = {k: v.clone() for k, v in st.items()}
    out_k = torch.zeros((n_pix + 1, 3), device=head.device)
    out_p = torch.zeros_like(out_k)
    got = fs.fused_stream_step_cuda(tb, st_k, out_k, head, segments, shadow, **kw)
    want = fs.fused_stream_step_plain(tb, st_p, out_p, head, segments, shadow, **kw)
    torch.cuda.synchronize()
    return st_k, st_p, out_k, out_p, got, want


def assert_stream_step_equal(st_k, st_p, out_k, out_p, got, want, what=""):
    for key in st_p:
        assert same_bits(st_k[key], st_p[key]), (what, key)
    assert same_bits(out_k, out_p) and torch.equal(got[0], want[0]), what
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]], what


@pytest.mark.parametrize("lanes", STEP_POOLS)
@pytest.mark.parametrize("rr_mode", ["reference", "standard"])
@pytest.mark.parametrize("nee", STEP_NEE)
@pytest.mark.parametrize("pixels", ["identity", "range", "ids"])
def test_stream_step_every_map_matches_plain(cuda, pixels, nee, rr_mode, lanes):
    """Kernel 7 on every pixel map (the identity, an affine range whose
    base it reads on the device, an id table), NEE off and on (the shadow
    count and the env credit, bool or float32), both rr_modes, pools of
    16,384, 131,072 and 100,003 lanes (no multiple of 256): the state, the
    image, the regen mask, head, segments, the live count and the shadow
    count bit-equal to the plain version; one launch counted."""
    seed = lanes + 7 * STEP_NEE.index(nee) + (rr_mode == "standard")
    tb, st, n_pix, head, segments = step_state(lanes, seed, cuda)
    shadow = nee_fields(tb, st, lanes, nee, seed, cuda)
    st["lane_accum"][::97] = -0.0  # the plain version's + 0.0 makes them +0.0
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=rr_mode == "reference", inv_spp=1.0 / 3,
              **pixel_map(pixels, n_pix, seed, cuda))
    before = fs.fused_stream_step.launches
    got = fs.fused_stream_step(tb, {k: v.clone() for k, v in st.items()},
                               torch.zeros((n_pix + 1, 3), device=cuda), head, segments, shadow, **kw)
    assert fs.fused_stream_step.launches == before + 1 and len(got) == (4 if shadow is None else 5)
    result = stream_step_pair(tb, st, n_pix, head, segments, shadow, kw)
    assert_stream_step_equal(*result)
    assert int(result[4][1]) > n_pix  # lanes retire past the queue's end


def test_stream_step_nee_32_steps_on_one_scratch(cuda):
    """32 consecutive stream steps under NEE on an id-table map, each
    step's state, head, segments and shadow count fed to the next, with
    no zeroing of the scratch: the grid sum of the shadow count clears
    itself and kernel and plain version stay bit-equal at every step."""
    lanes = 131072
    _, st, n_pix, head, segments = step_state(lanes, 17, cuda)
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=False, inv_spp=1.0 / 3, **pixel_map("ids", n_pix, 3, cuda))
    tb0 = step_state(lanes, 99, cuda)[0]
    shadow = nee_fields(tb0, st, lanes, "on", 5, cuda)
    st_k = {k: v.clone() for k, v in st.items()}
    st_p = {k: v.clone() for k, v in st.items()}
    out_k = torch.zeros((n_pix + 1, 3), device=cuda)
    out_p = torch.zeros_like(out_k)
    res_k = res_p = (None, head, segments, None, shadow)
    for step in range(32):
        tb = step_state(lanes, 200 + step, cuda)[0]
        nee_fields(tb, {}, lanes, "on", 300 + step, cuda)
        res_k = fs.fused_stream_step_cuda(tb, st_k, out_k, res_k[1], res_k[2], res_k[4], **kw)
        res_p = fs.fused_stream_step_plain(tb, st_p, out_p, res_p[1], res_p[2], res_p[4], **kw)
        torch.cuda.synchronize()
        assert_stream_step_equal(st_k, st_p, out_k, out_p, res_k, res_p, step)
    assert int(res_k[4]) > int(shadow)


def path_state(lanes, seed, dev, schedule, nee, share=None):
    """render_rays' or render_pixels_regen's buffers and a trace payload,
    from a numpy seed, as path_step takes them: about a third of the lanes
    ended (exactly round(share * lanes) with `share`), payload
    attenuations with zeros, values above 1 and NaNs.  Reachable as the
    loop leaves them: a -0.0 in accum on live lanes only (an ended lane's
    accum is never -0.0: tests/test_torch_path_step_design.py), the regen
    mask's buffer zeroed as at a frame's start."""
    tb, st_s, _, _, _ = step_state(lanes, seed, dev)
    rs = np.random.RandomState(seed + 1)
    st = {k: st_s[k] for k in ("origin", "direction", "attenuation", "radiance", "seeds", "depth")}
    if share is None:
        ended = torch.as_tensor(rs.rand(lanes) < 0.3).to(dev)
    else:
        ended_np = np.zeros(lanes, dtype=bool)
        ended_np[rs.permutation(lanes)[: int(round(share * lanes))]] = True
        ended = torch.as_tensor(ended_np).to(dev)
    st.update(done=torch.tensor(False, device=dev), segments=torch.tensor(1000, device=dev),
              shadow=torch.tensor(50, device=dev), spec_last=torch.ones(lanes, dtype=torch.bool, device=dev))
    if schedule == "rays":
        st.update(terminated=ended, result=torch.as_tensor(rs.uniform(0, 3, (lanes, 3)).astype(np.float32)).to(dev))
    else:
        st.update(exhausted=ended, sample_i=torch.as_tensor(rs.randint(0, 3, lanes).astype(np.int32)).to(dev),
                  accum=torch.as_tensor(rs.uniform(0, 6, (lanes, 3)).astype(np.float32)).to(dev),
                  regen=torch.zeros(lanes, dtype=torch.bool, device=dev))
        minus = torch.zeros(lanes, dtype=torch.bool, device=dev)
        minus[::97] = True
        st["accum"][minus & ~ended] = -0.0  # the plain version's + 0.0 makes them +0.0
    if nee != "off":
        nee_fields(tb, st, lanes, nee, seed + 2, dev)
    return tb, st


def path_step_pair(tb, st, kw):
    st_k = {k: v.clone() for k, v in st.items()}
    st_p = {k: v.clone() for k, v in st.items()}
    regen_k = fs.path_step_cuda(tb, st_k, **kw)
    regen_p = fs.path_step_plain(tb, st_p, **kw)
    torch.cuda.synchronize()
    return st_k, st_p, regen_k, regen_p


def assert_path_step_equal(st_k, st_p, regen_k, regen_p, what=""):
    for key in st_p:
        assert same_bits(st_k[key], st_p[key]), (what, key)
    assert (regen_k is None and regen_p is None) or torch.equal(regen_k, regen_p), what


@pytest.mark.parametrize("lanes", STEP_POOLS)
@pytest.mark.parametrize("rr_mode", ["reference", "standard"])
@pytest.mark.parametrize("nee", STEP_NEE)
@pytest.mark.parametrize("schedule", ["rays", "regen"])
def test_path_step_matches_plain(cuda, schedule, nee, rr_mode, lanes):
    """The path step of render_rays and render_pixels_regen, NEE off and
    on (bool and float32 env credits), both rr_modes, pools of 16,384,
    131,072 and 100,003 lanes: every buffer (the merges, result or accum
    and sample_i, the ended flags, segments, shadow and the 0-d done flag)
    and the regen mask bit-equal to path_step_plain; one launch counted."""
    seed = lanes + 7 * STEP_NEE.index(nee) + (rr_mode == "standard") + 3 * (schedule == "regen")
    tb, st = path_state(lanes, seed, cuda, schedule, nee)
    kw = dict(schedule=schedule, spp=3, max_depth=4, rr_reference=rr_mode == "reference", nee=nee != "off")
    before = fs.path_step.launches
    fs.path_step(tb, {k: v.clone() for k, v in st.items()}, **kw)
    assert fs.path_step.launches == before + 1
    assert_path_step_equal(*path_step_pair(tb, st, kw))


@pytest.mark.parametrize("schedule", ["rays", "regen"])
def test_path_step_32_steps_on_one_scratch(cuda, schedule):
    """32 consecutive path steps under NEE on one pool, each step's buffers
    fed to the next, with no zeroing of the scratch: the self-clearing grid
    sums (segments, shadow, done) and every buffer stay bit-equal to the
    plain version at every step, until every lane has ended (the last
    steps' payloads end every path) and `done` turns true."""
    lanes = 131072
    tb, st = path_state(lanes, 21, cuda, schedule, "on")
    kw = dict(schedule=schedule, spp=3, max_depth=4, rr_reference=False, nee=True)
    st_k = {k: v.clone() for k, v in st.items()}
    st_p = {k: v.clone() for k, v in st.items()}
    for step in range(32):
        tb = path_state(lanes, 400 + step, cuda, schedule, "on")[0]
        if step >= 24:
            tb["done"].fill_(True)
        regen_k = fs.path_step_cuda(tb, st_k, **kw)
        regen_p = fs.path_step_plain(tb, st_p, **kw)
        torch.cuda.synchronize()
        assert_path_step_equal(st_k, st_p, regen_k, regen_p, step)
    assert bool(st_k["done"]) and int(st_k["segments"]) > 1000 + lanes


def test_path_step_refuses_other_devices(cuda):
    """The path step's kernel takes CUDA tensors only, and no schedule but
    rays and regen; on the card, path_step runs the kernel outside
    ops.cuda_build.plain() and the plain version under it."""
    tb, st = path_state(256, 3, "cpu", "rays", "off")
    kw = dict(schedule="rays", spp=1, max_depth=4, rr_reference=True, nee=False)
    with pytest.raises(ValueError, match="CUDA"):
        fs.path_step_cuda(tb, st, **kw)
    tb, st = path_state(256, 3, cuda, "rays", "off")
    with pytest.raises(ValueError, match="schedule"):
        fs.path_step_cuda(tb, st, **dict(kw, schedule="stream"))
    before = fs.path_step.launches
    with cuda_build.plain():
        fs.path_step(tb, st, **kw)
    assert fs.path_step.launches == before


PATH_LANES = (0, 1, 257, 100_003, 345_600, 2_073_600)  # none, one, past a tile, no multiple of 256, a tile, a frame
ENDED_SHARES = (0.0, 1 / 3, 0.97, 1.0)


@pytest.mark.parametrize("nee", STEP_NEE)
@pytest.mark.parametrize("schedule", ["rays", "regen"])
@pytest.mark.parametrize("share", ENDED_SHARES, ids=["none", "third", "97pct", "all"])
@pytest.mark.parametrize("lanes", PATH_LANES)
def test_path_step_every_ended_share_matches_plain(cuda, lanes, share, schedule, nee):
    """The path step with none, a third, 97% and all of its lanes ended at
    entry (which it skips), from 0 lanes to a 1080p frame's 2,073,600, in
    both schedules and every NEE mode (standard rr, where the attenuation
    divides): every buffer, the counters, `done` and the regen mask
    bit-equal to path_step_plain, the regen mask (the loop's buffer
    st["regen"], written in place) from a zeroed buffer and from one that
    holds a last step's mask, 0 on every ended lane; one launch counted,
    none at 0 lanes."""
    seed = lanes % 9973 + 11 * ENDED_SHARES.index(share) + 3 * STEP_NEE.index(nee)
    tb, st = path_state(lanes, seed, cuda, schedule, nee, share)
    kw = dict(schedule=schedule, spp=3, max_depth=4, rr_reference=False, nee=nee != "off")
    before = fs.path_step.launches
    assert_path_step_equal(*path_step_pair(tb, st, kw), share)
    assert fs.path_step.launches == before + (lanes > 0)
    if schedule == "regen":
        flag = st["exhausted"]
        st["regen"] = torch.as_tensor(np.random.RandomState(seed).rand(lanes) < 0.5).to(cuda) & ~flag
        st_k, st_p, regen_k, regen_p = path_step_pair(tb, st, kw)
        assert_path_step_equal(st_k, st_p, regen_k, regen_p, share)
        assert regen_k.data_ptr() == st_k["regen"].data_ptr() and not bool((regen_k & flag).any())


# The seeds whose lanes need the most rejection draws of all 2^32 u32
# seeds (each draw three PCG steps), with their draw counts: 28 is the
# longest chain any seed starts, and no seed needs 30
# (test_torch_host_syncs.longest_chains(0, 2**32, 27), the plain version's
# arithmetic in numpy).
LONG_SEEDS = {
    957305047: 28, 1521286973: 28, 1703472025: 28, 2947995425: 28, 3863275345: 28,
    144638799: 27, 1261707827: 27, 1368128318: 27, 2132517328: 27, 2280451936: 27, 2296031367: 27,
    3623656311: 27, 4223736066: 27,
}


def draw_counts(seed):
    """Draws each lane of `seed` takes in the plain version: one more than
    the PCG steps its seed advanced, over three."""
    s, _ = rng.random_in_unit_sphere_plain(seed)
    steps = torch.zeros_like(seed)
    x = seed.clone()
    for k in range(1, 200):
        x = rng.pcg_hash(x)
        steps = torch.where((x == s) & (steps == 0), k, steps)
        if bool((steps > 0).all()):
            break
    return steps // 3


def test_sampler_matches_plain(cuda):
    """The unit-ball kernel at 131,072 lanes of camera seeds: seeds and
    points bit-equal to the plain version; one launch counted."""
    pix = torch.arange(131072, dtype=torch.int32, device=cuda)
    seed = rng.make_seeds(pix, pix % 10, 3)
    before = unit_sphere.random_in_unit_sphere.launches
    s_k, p_k = unit_sphere.random_in_unit_sphere(seed)
    s_p, p_p = rng.random_in_unit_sphere_plain(seed)
    torch.cuda.synchronize()
    assert unit_sphere.random_in_unit_sphere.launches == before + 1
    assert torch.equal(s_k, s_p) and same_bits(p_k, p_p)
    assert p_k.shape == (131072, 3) and float((p_k * p_k).sum(-1).max()) < 1.0


def test_sampler_long_rejection_chains(cuda):
    """Seeds that need the most draws of any u32 seed (the plain version
    counts them again here): the kernel takes every draw, so seeds and
    points stay bit-equal."""
    seed = torch.tensor(sorted(LONG_SEEDS), dtype=torch.int64, device=cuda)
    draws = draw_counts(seed)
    assert draws.tolist() == [LONG_SEEDS[k] for k in sorted(LONG_SEEDS)]
    s_k, p_k = unit_sphere.random_in_unit_sphere(seed)
    s_p, p_p = rng.random_in_unit_sphere_plain(seed)
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_p) and same_bits(p_k, p_p)


def test_sampler_takes_no_lanes(cuda):
    s, p = unit_sphere.random_in_unit_sphere(torch.empty(0, dtype=torch.int64, device=cuda))
    assert s.shape == (0,) and p.shape == (0, 3)


# schedule: the 64x48 config that takes it
SYNC_SCHEDULES = {
    "stream_fused": dict(fused_schedule="on"),
    "stream": dict(fused_schedule="off"),
    "stream_nee": dict(env_mode="equirect", rr_mode="standard", env_importance_sampling=True),
    "stream_deferred": dict(fused_schedule="off", deferred_shade=True),
    "regen": dict(stream_lanes=4096),
    "rays": dict(samples_per_launch=1),
}


@pytest.mark.parametrize("which", list(SYNC_SCHEDULES))
def test_iteration_syncs_only_on_its_read(cuda, monkeypatch, which):
    """After a warm render, a render of each schedule whose iterations run
    under torch.cuda.set_sync_debug_mode("error") from the loop's first
    read on, every read (`integrator._read`) excepted: any other stream
    sync inside an iteration raises."""
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils.image import procedural_hdr

    cfg = RenderConfig(**{**dict(width=64, height=48, samples_per_launch=2, max_depth=4, dof=False,
                                 intersector="cluster", env_mode="sunsky", stream_lanes=512),
                          **SYNC_SCHEDULES[which]})
    scene = procedural.three_spheres_scene(8, 16, device=cuda)
    if cfg.env_importance_sampling:
        scene = scene.replace(env=with_importance_sampling(make_env(procedural_hdr(32, 64), cuda)))
    scene = build_accel(scene)
    cam = camera_arrays(Camera(), cfg, cuda)
    render_frame_stats(scene, cam, cfg, 0)
    read, reads = integrator._read, []

    def checked_read(x):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return read(x)
        finally:
            reads.append(1)
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(integrator, "_read", checked_read)
    try:
        _, stats = render_frame_stats(scene, cam, cfg, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert stats["schedule"] == which.removesuffix("_nee").removesuffix("_deferred")
    assert stats["iters"] > 3 and len(reads) >= stats["iters"]


def test_png_codec_on_a_rendered_frame(cuda, tmp_path):
    """A frame rendered on the card, post-processed and brought to the host
    (row 0 the top), through the port's PNG encoder and decoder."""
    from tpu_pathtracer_torch.render.film import to_uint8
    from tpu_pathtracer_torch.utils.image import decode_png, encode_png, load_png, save_png

    cfg = RenderConfig(width=96, height=64, samples_per_launch=2, max_depth=4, dof=False,
                       intersector="cluster", env_mode="sunsky")
    scene = build_accel(procedural.three_spheres_scene(8, 16, device=cuda))
    img, _ = render_frame_stats(scene, camera_arrays(Camera(), cfg, cuda), cfg, 0)
    u8 = to_uint8(post_process(img, cfg)).cpu().numpy()[::-1]
    assert u8.std() > 1.0
    assert np.array_equal(decode_png(encode_png(u8, level=1)), u8)
    save_png(str(tmp_path / "f.png"), u8)
    assert np.array_equal(load_png(str(tmp_path / "f.png")), u8)


def test_progressive_matches_cpu(cuda, tmp_path):
    """ProgressiveRenderer on the card against the CPU for two launches on
    the CPU tests' textured, glass and emissive scene (DOF on): SSIM after
    post_process above 0.995; the AOVs' hit and mat exact, normal, depth
    and albedo within rtol 1e-5 / atol 1e-5; a resume on the card bit for
    bit an uninterrupted run."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    import _torch_scenes as ts

    from tpu_pathtracer_torch.render.aov import render_aov
    from tpu_pathtracer_torch.runtime.progressive import ProgressiveRenderer
    from tpu_pathtracer_torch.scene.builder import load_scene
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils.image import procedural_hdr

    paths = [ts.write_mtl_scene(str(tmp_path), tex=16)]
    cfg = RenderConfig(width=64, height=48, samples_per_launch=2, max_depth=4, dof=True, dof_blurriness=0.05,
                       env_mode="equirect", intersector="cluster")
    cam = Camera(eye=(0.0, 2.0, 5.0), lookat=(0.0, 0.6, 0.0))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene = load_scene(paths, env=make_env(procedural_hdr(32, 64), dev), material_source="mtl",
                           accel="cluster", device=dev)
        r = ProgressiveRenderer(scene, cam, cfg)
        r.step()
        r.step()
        aov = render_aov(scene, r._cam_arrays, cfg)
        out[dev.type] = (post_process(r.accum, cfg).cpu().numpy(), {k: v.cpu().numpy() for k, v in aov.items()}, r)
    (gpu, g_aov, r_gpu), (cpu, c_aov, _) = out["cuda"], out["cpu"]
    assert ssim(gpu, cpu) > 0.995
    assert np.array_equal(g_aov["hit"], c_aov["hit"]) and np.array_equal(g_aov["mat"], c_aov["mat"])
    for k in ("normal", "depth", "albedo"):
        np.testing.assert_allclose(g_aov[k], c_aov[k], rtol=1e-5, atol=1e-5, err_msg=k)
    ck = str(tmp_path / "ck.npz")
    r_gpu.save_checkpoint(ck)
    r_gpu.step()
    resumed = ProgressiveRenderer(r_gpu.scene, cam, cfg)
    resumed.load_checkpoint(ck)
    resumed.step()
    assert resumed.accum.device.type == "cuda" and torch.equal(resumed.accum, r_gpu.accum)


def mtl_scene(tmp_path, device):
    """The CPU tests' textured, glass and emissive OBJ scene on `device`."""
    from tpu_pathtracer_torch.scene.builder import load_scene
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils.image import procedural_hdr

    path = ts.write_mtl_scene(str(tmp_path), tex=16)
    return load_scene([path], env=make_env(procedural_hdr(32, 64), device), material_source="mtl", accel="cluster",
                      device=device)


@pytest.mark.parametrize("div", [1, 4, 7])
@pytest.mark.parametrize("name", ["spheres", "textured"])
def test_deferred_equals_dense_on_card(cuda, tmp_path, name, div):
    """Deferred shading on the card, 3,000 lanes (not a multiple of
    1,024): the dense shade's image bit for bit, the same segments."""
    if name == "spheres":
        scene, kw = build_accel(procedural.three_spheres_scene(8, 16, device=cuda)), dict(env_mode="sunsky")
        camera = Camera(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0))
    else:
        scene, kw = mtl_scene(tmp_path, cuda), dict(env_mode="equirect", dof=True, dof_blurriness=0.05)
        camera = Camera(eye=(0.0, 2.0, 5.0), lookat=(0.0, 0.6, 0.0))
    cfg = RenderConfig(**{**dict(width=64, height=48, samples_per_launch=2, max_depth=4, dof=False,
                                 intersector="cluster", stream_lanes=3000, deferred_chunk_div=div), **kw})
    cam = camera_arrays(camera, cfg, cuda)
    dense, d_stats = render_frame_stats(scene, cam, cfg, 1)
    deferred, stats = render_frame_stats(scene, cam, cfg.replace(deferred_shade=True), 1)
    assert float(dense.max()) > 0 and same_bits(deferred, dense)
    assert int(stats["segments"]) == int(d_stats["segments"]) and stats["iters"] == d_stats["iters"]


SHARD_CFG = dict(width=64, height=48, samples_per_launch=4, max_depth=4, dof=False, intersector="cluster",
                 env_mode="sunsky")


def test_shard_one_rank_nccl(cuda):
    """A NCCL group of one rank on the card: pixel sharding equals
    render_frame bit for bit (the affine range through the unfused
    stream), sample sharding within rtol 2e-4 / atol 2e-5."""
    import torch.distributed as dist

    from tpu_pathtracer_torch.parallel.shard import free_port, initialize_distributed, make_mesh, render_frame_sharded
    from tpu_pathtracer_torch.render.integrator import render_frame

    scene = build_accel(procedural.three_spheres_scene(8, 16, device=cuda))
    cfg = RenderConfig(**SHARD_CFG, stream_lanes=1024)
    cam = camera_arrays(Camera(), cfg, cuda)
    initialize_distributed("cuda", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh()
        pixels = render_frame_sharded(scene, cam, cfg, 1, mesh, mode="pixels")
        samples = render_frame_sharded(scene, cam, cfg, 1, mesh, mode="samples")
    finally:
        dist.destroy_process_group()
    single = render_frame(scene, cam, cfg, 1)
    assert float(single.max()) > 0 and same_bits(pixels, single)
    assert torch.allclose(samples, single, rtol=2e-4, atol=2e-5)


def test_shard_two_ranks_gloo_on_card(cuda, tmp_path):
    """tests/_torch_dist_worker.py's cases in two processes on the one
    card, over gloo: pixels bit-equal to render_frame (the stream and NEE
    included), samples within rtol 2e-4 / atol 2e-5."""
    import _torch_dist_worker as worker

    out = tmp_path / "w2.npz"
    worker.wait_group(worker.start_group(2, out, device="cuda"))
    res = dict(np.load(out))
    for case in ("pixels", "pixels_stream", "pixels_nee"):
        np.testing.assert_array_equal(res[case], res[f"{case}_single"])
    for case in ("samples", "samples_nee"):
        np.testing.assert_allclose(res[case], res[f"{case}_single"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", ts.ORACLE_CASES)
def test_render_matches_oracle_on_card(cuda, case):
    """tests/test_oracle.py's cases (tests/_torch_scenes.py: oracle_case)
    rendered on the card through the cluster accel (kernel 1; kernel 4
    under NEE), held against the numpy oracle by that file's rule: at
    least 98% of pixels with relative difference below 1e-3."""
    from tpu_pathtracer_torch import oracle
    from tpu_pathtracer_torch.render.integrator import render_frame

    scene, kw, eye = ts.oracle_case(case, cuda)
    scene = build_accel(scene, kind="cluster")
    cfg = RenderConfig(**{**dict(width=16, height=12, samples_per_launch=2, max_depth=4, dof=False), **kw})
    cam = camera_arrays(Camera(**eye), cfg, cuda)
    before = ic.intersect_clusters.launches
    img = render_frame(scene, cam, cfg, 0).reshape(-1, 3).cpu().numpy()
    assert ic.intersect_clusters.launches > before
    want = oracle.render(scene, cam, cfg, range(cfg.width * cfg.height), 0)
    rel = np.abs(img - want).max(axis=1) / (1.0 + np.abs(img).max(axis=1))
    assert (rel < 1e-3).mean() >= 0.98 and img.max() > 0


# ---------------------------------------------------------------------------
# The graphed loop (render/graph_loop.py): every schedule and route,
# captured once and replayed, against the same loop run eagerly
# ---------------------------------------------------------------------------

GRAPH_BASE = dict(width=64, height=48, samples_per_launch=2, max_depth=4, dof=False, intersector="cluster",
                  env_mode="sunsky", stream_lanes=512)
GRAPH_NEE = dict(env_mode="equirect", rr_mode="standard", env_importance_sampling=True)
# name: (the config that takes the schedule on a 64x48 frame, render_pixels' pixel_ids)
GRAPH_SCHEDULES = {
    "stream_fused": (dict(fused_schedule="on"), None),
    "stream": (dict(fused_schedule="off"), None),
    "stream_range": ({}, "range"),
    "stream_ids": ({}, "ids"),
    "regen": (dict(stream_lanes=4096), None),
    "rays": (dict(samples_per_launch=1), None),
    "rays_ids": (dict(samples_per_launch=1), "ids"),  # a 1-spp tile: render_rays on an id list
}
# (subframe, camera, sample_offset) of the frames one plan renders
GRAPH_FRAMES = ((0, 0, 0), (1, 0, 0), (2, 1, 2))
GRAPH_CAMERAS = (Camera(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0)), Camera(eye=(1.0, 1.5, 7.0), lookat=(0.0, 1.0, 0.0)))


def graph_scene(route, nee, dev, monkeypatch):
    """Three spheres on `route`: flat in clusters of 128, two-level in
    clusters of 8 (97 clusters), streamed with the 6 MB line patched low."""
    from tpu_pathtracer_torch.accel import cluster as cluster_mod
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils.image import procedural_hdr

    scene = procedural.three_spheres_scene(8, 16, device=dev)
    if nee:
        scene = scene.replace(env=with_importance_sampling(make_env(procedural_hdr(32, 64), dev)))
    if route == "streamed":
        monkeypatch.setattr(cluster_mod, "_FLAT_MAX_BYTES", 1024)
    return build_accel(scene, cluster_size=128 if route == "flat" else 8)


def graph_frames(scene, cfg, pixels, frames):
    """Render `frames` through render_pixels: (image, stats, launch counts)
    of each."""
    n_pix = cfg.width * cfg.height
    out = []
    for subframe, camera, offset in frames:
        ids = {"range": (512, n_pix - 1024), "ids": torch.arange(n_pix - 1, -1, -3, dtype=torch.int32,
                                                                  device=scene.device)}.get(pixels)
        cam = camera_arrays(GRAPH_CAMERAS[camera], cfg, scene.device)
        before = {f.__name__: f.launches for f in graph_loop.COUNTED}
        img, stats = integrator.render_pixels(scene, cam, cfg, ids, subframe, sample_offset=offset, return_stats=True)
        torch.cuda.synchronize()
        out.append((img, stats, {f.__name__: f.launches - before[f.__name__] for f in graph_loop.COUNTED}))
    return out


@pytest.mark.parametrize("which", list(GRAPH_SCHEDULES))
@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
@pytest.mark.parametrize("route", ["flat", "hier", "streamed"])
def test_graphed_loop_equals_eager(cuda, monkeypatch, route, nee, which):
    """One plan serves three subframes, two cameras and two sample offsets
    with one capture; its images, segments, shadow segments, iterations
    and each kernel's launches equal those of the loop run eagerly
    (`graph_loop.eager()`) bit for bit, and its replays run under
    torch.cuda.set_sync_debug_mode("error")."""
    overrides, pixels = GRAPH_SCHEDULES[which]
    cfg = RenderConfig(**{**GRAPH_BASE, **(GRAPH_NEE if nee else {}), **overrides})
    scene = graph_scene(route, nee, cuda, monkeypatch)
    assert scene.accel.route(cfg) == route
    real_step, replays = graph_loop.Plan.step, []

    def checked_step(plan):
        replay = plan.graph is not None
        replays.append(replay)
        torch.cuda.set_sync_debug_mode("error" if replay else 0)
        try:
            real_step(plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(graph_loop.Plan, "step", checked_step)
    graph_loop.clear()
    captures = graph_loop.stats["captures"]
    graphed = graph_frames(scene, cfg, pixels, GRAPH_FRAMES)
    assert graph_loop.stats["captures"] == captures + 1 and sum(replays) > len(replays) // 2
    with graph_loop.eager():
        eager = graph_frames(scene, cfg, pixels, GRAPH_FRAMES)
    assert graph_loop.stats["captures"] == captures + 1
    for (img_g, st_g, n_g), (img_e, st_e, n_e) in zip(graphed, eager):
        assert st_g["graphed"] and not st_e["graphed"] and st_g["schedule"] == st_e["schedule"]
        assert same_bits(img_g, img_e)
        for k in ("iters", "segments", "shadow_segments"):
            assert int(st_g[k]) == int(st_e[k]), k
        assert n_g == n_e
        assert (int(st_g["shadow_segments"]) > 0) == nee
    assert not same_bits(graphed[0][0], graphed[1][0])  # the subframe reaches the replays
    assert not same_bits(graphed[1][0], graphed[2][0])


@pytest.mark.parametrize("spp", [1, 2], ids=["rays", "stream"])
def test_graphed_tiles_share_one_capture(cuda, spp):
    """The six tiles of a tiled frame (render_frame_stats) replay one
    capture and equal the eager tiles bit for bit."""
    cfg = RenderConfig(**{**GRAPH_BASE, "samples_per_launch": spp, "tile_pixels": 512, "stream_lanes": 256})
    scene = build_accel(procedural.three_spheres_scene(8, 16, device=cuda))
    cam = camera_arrays(GRAPH_CAMERAS[0], cfg, cuda)
    graph_loop.clear()
    captures = graph_loop.stats["captures"]
    img_g, st_g = render_frame_stats(scene, cam, cfg, 1)
    assert graph_loop.stats["captures"] == captures + 1 and st_g["graphed"]
    with graph_loop.eager():
        img_e, st_e = render_frame_stats(scene, cam, cfg, 1)
    assert same_bits(img_g, img_e) and st_g["iters"] == st_e["iters"]
    assert int(st_g["segments"]) == int(st_e["segments"])


def test_deferred_loop_stays_eager(cuda):
    """Deferred shading reads the device inside its step: its loop is not
    captured, and says so."""
    cfg = RenderConfig(**{**GRAPH_BASE, "deferred_shade": True})
    scene = build_accel(procedural.three_spheres_scene(8, 16, device=cuda))
    captures = graph_loop.stats["captures"]
    _, stats = render_frame_stats(scene, camera_arrays(Camera(), cfg, cuda), cfg, 0)
    assert not stats["graphed"] and graph_loop.stats["captures"] == captures


# ---------------------------------------------------------------------------
# The shading kernels (csrc/bounce.cu, csrc/nee.cu, csrc/camera.cu) against
# their plain versions (render/integrator.py, ops/camera.py), bit for bit
# ---------------------------------------------------------------------------

SHADE_NEE = dict(rr_mode="standard", env_importance_sampling=True)
SHADE_CONFIGS = {
    "equirect": {}, "sunsky": dict(env_mode="sunsky"), "constant": dict(env_mode="constant"),
    "quirk": dict(seed_advance_quirk=True), "nee": SHADE_NEE, "nee_mis": dict(SHADE_NEE, nee_mis_spec=True),
    "nee_defensive": dict(SHADE_NEE, nee_defensive_mix=True),
    "nee_mis_defensive": dict(SHADE_NEE, nee_mis_spec=True, nee_defensive_mix=True),
}
# MaterialTable layout flags the constructor does not choose: (the
# shade_scene layout they read, the flags)
BUNDLE_FLAGS = {
    "morton": ("bundled_square", dict(bundled_scrambled=False, bundled_morton=True, bundled_pow2_dims=False)),
    "pow2_rowmajor": ("bundled_scrambled", dict(bundled_scrambled=False, bundled_pow2_dims=True)),
}


def fields_equal(got: dict, want: dict) -> list:
    """The keys of `want` whose tensors differ in a bit from `got`'s."""
    return [k for k, w in want.items() if w is not None and not same_bits(got[k], w)]


def shade_batch(scene, cfg, n, seed, dev):
    """ts.shade_rays' rays at shade_scene, their closest hits, and a seeded
    lane state (depth 0 on a tenth of the lanes; NEE's env credit)."""
    o, d = ts.shade_rays(n, seed, dev)
    hit = scene.accel.intersect(scene.vertices, o, d, cfg.t_min, cfg.t_max, cfg)
    rs = np.random.RandomState(seed)
    att = torch.as_tensor((rs.rand(n, 3) + 0.2).astype(np.float32), device=dev)
    rad = torch.as_tensor((rs.rand(n, 3) * 0.5).astype(np.float32), device=dev)
    seeds = torch.as_tensor(rs.randint(1, 2**32, size=n, dtype=np.uint64).astype(np.int64), device=dev)
    depth = torch.as_tensor(np.where(rs.rand(n) < 0.1, 0, rs.randint(1, 8, size=n)).astype(np.int32), device=dev)
    spec = torch.as_tensor(rs.rand(n).astype(np.float32) if cfg.nee_mis_spec else rs.rand(n) < 0.5, device=dev)
    return hit, o, d, att, rad, seeds, depth, spec


@pytest.mark.parametrize("name", list(SHADE_CONFIGS))
@pytest.mark.parametrize("layout", list(ts.SHADE_LAYOUTS) + list(BUNDLE_FLAGS))
def test_bounce_kernels_match_plain(cuda, layout, name):
    """The bounce kernel (and under NEE the any-hit traversal and the NEE
    kernel) against `_bounce_plain` on 20,000 lanes that reach every
    branch (textures in each layout, glass from outside and inside with
    TIR, emissive, degenerate normals, depth 0, misses): every payload
    field bit-equal; one launch of each kernel a bounce."""
    import dataclasses

    scene = build_accel(ts.shade_scene(BUNDLE_FLAGS[layout][0] if layout in BUNDLE_FLAGS else layout, cuda))
    if layout in BUNDLE_FLAGS:
        scene = scene.replace(materials=dataclasses.replace(scene.materials, **BUNDLE_FLAGS[layout][1]))
    cfg = RenderConfig(intersector="cluster", max_depth=8, **SHADE_CONFIGS[name])
    hit, o, d, att, rad, seeds, depth, spec = shade_batch(scene, cfg, 20_000, 7, cuda)
    nee = cfg.env_importance_sampling
    args = (scene, cfg, hit, o, d, att, rad, seeds, depth, spec if nee else None)
    before = (bounce_ops.bounce.launches, bounce_ops.next_event.launches)
    got = integrator._bounce_kernels(*args)
    assert (bounce_ops.bounce.launches, bounce_ops.next_event.launches) == (before[0] + 1, before[1] + nee)
    want = integrator._bounce_plain(*args)
    torch.cuda.synchronize()
    assert fields_equal(got, want) == []
    m = hit.hit
    mats = scene.tri_attrs[hit.prim[m].long(), 24]
    assert set(mats.long().tolist()) == {0, 1, 2, 3, 4} and 0.3 < float(m.float().mean()) < 1.0


@pytest.mark.parametrize("name", ["nee", "nee_mis_defensive"])
def test_bounce_kernel_nee_record_matches_plain(cuda, name):
    """The shadow rays, their candidates and the record the NEE kernel
    reads equal `_shade`, `_light_sample` and `_shadow_candidates`."""
    scene = build_accel(ts.shade_scene("unbundled", cuda))
    cfg = RenderConfig(intersector="cluster", max_depth=8, **SHADE_CONFIGS[name])
    hit, o, d, att, rad, seeds, depth, spec = shade_batch(scene, cfg, 20_000, 8, cuda)
    b = bounce_ops.bounce(scene, cfg, hit, o, d, att, rad, seeds, depth, spec)
    sh = integrator._shade(scene, cfg, hit, o, d, seeds, depth)
    _, env_dir, pdf, u, v = integrator._light_sample(scene, cfg, sh, sh["seeds"])
    cand, cos_l = integrator._shadow_candidates(hit.hit, sh, env_dir)
    rec = b["record"].T
    got = dict(shadow_origin=b["shadow_origin"], shadow_dir=b["shadow_dir"], cand=b["cand"], normal=rec[:, 0:3],
               alpha=rec[:, 3], spec_prob=rec[:, 4], idotn=rec[:, 5], brdf_combined=rec[:, 6:9], f_vec=rec[:, 9:12],
               diffuse_albedo=rec[:, 12:15], spec_dir=rec[:, 15:18], spec_pdf=rec[:, 18], pdf=rec[:, 19],
               u=rec[:, 20], v=rec[:, 21], cos_l=rec[:, 22])
    want = dict(shadow_origin=sh["new_origin"], shadow_dir=env_dir, cand=cand, pdf=pdf, u=u, v=v, cos_l=cos_l,
                **{k: sh[k] for k in ("normal", "alpha", "spec_prob", "idotn", "brdf_combined", "f_vec",
                                      "diffuse_albedo", "spec_dir", "spec_pdf")})
    torch.cuda.synchronize()
    assert fields_equal({k: v.contiguous() for k, v in got.items()}, want) == []
    assert 0.1 < float(cand.float().mean()) < 0.9


def mid_render_lanes(scene, cfg):
    """The arguments of `_bounce_kernels` in the middle iteration of a
    frame of the eager loop (bit-equal to the graphed one): the lanes as a
    stream hands them to the bounce kernel, misses and warps that mix hits
    and misses common."""
    from tpu_pathtracer_torch.ops.intersect import Hit

    cam = camera_arrays(GRAPH_CAMERAS[0], cfg, scene.device)
    calls, pool = [], {}
    real = integrator._bounce_kernels

    def spy(*args):
        calls.append(1)
        pool[len(calls)] = tuple(x.clone() if isinstance(x, torch.Tensor) else
                                 Hit(*(y.clone() for y in (x.t, x.prim, x.bary, x.hit))) if isinstance(x, Hit) else x
                                 for x in args)
        return real(*args)

    integrator._bounce_kernels = spy
    try:
        with graph_loop.eager():
            render_frame_stats(scene, cam, cfg, 1)
    finally:
        integrator._bounce_kernels = real
    return pool[max(1, len(calls) // 2)]


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_bounce_kernel_matches_plain_mid_render(cuda, monkeypatch, nee):
    """The bounce kernel (under NEE with the NEE kernel) against
    `_bounce_plain` on a stream's pool in the middle of a frame, where
    warps mix hits and misses: every payload field bit-equal."""
    scene = graph_scene("flat", nee, cuda, monkeypatch)
    cfg = RenderConfig(**{**GRAPH_BASE, **(GRAPH_NEE if nee else {}), "width": 160, "height": 120,
                          "stream_lanes": 4096, "fused_schedule": "off"})
    args = mid_render_lanes(scene, cfg)
    hit = args[2].hit
    warps = hit.reshape(-1, 32).sum(dim=1)
    assert 0.2 < float(hit.float().mean()) < 0.9 and int(((warps > 0) & (warps < 32)).sum()) > 4
    got = integrator._bounce_kernels(*args)
    want = integrator._bounce_plain(*args)
    torch.cuda.synchronize()
    assert fields_equal(got, want) == []


@pytest.mark.parametrize("layout", list(ts.SHADE_LAYOUTS))
def test_deferred_entry_matches_plain(cuda, layout):
    """`_shade_deferred` through the bounce kernel's second entry point
    (one launch a chunk) against its plain version: every field bit-equal."""
    scene = build_accel(ts.shade_scene(layout, cuda))
    cfg = RenderConfig(intersector="cluster", max_depth=8, deferred_chunk_div=3)
    hit, o, d, _, _, seeds, depth, _ = shade_batch(scene, cfg, 5_000, 9, cuda)
    before = bounce_ops.bounce.launches
    got = integrator._shade_deferred(scene, cfg, hit, o, d, seeds, depth)
    chunks = bounce_ops.bounce.launches - before
    with cuda_build.plain():
        want = integrator._shade_deferred(scene, cfg, hit, o, d, seeds, depth)
    torch.cuda.synchronize()
    assert bounce_ops.bounce.launches == before + chunks and chunks == -(-int(hit.hit.sum()) // 2048)
    assert fields_equal(got, want) == []


def test_math_functions_match_aten(cuda):
    """The math functions the shading kernels call, built with their flags
    (the bounce kernel's library), against ATen's on 2M inputs each: sin,
    cos, atan2, asin, pow(x, 5), rsqrt, sqrt and division bit-equal."""
    lib = cuda_build.library("bounce.cu")
    rs = np.random.RandomState(0)
    n = 2_000_000
    cases = [(0, torch.sin, rs.uniform(-40, 40, n), None), (1, torch.cos, rs.uniform(-40, 40, n), None),
             (2, torch.atan2, rs.randn(n), rs.randn(n)), (3, torch.asin, rs.uniform(-1, 1, n), None),
             (4, lambda a: torch.pow(a, 5.0), rs.uniform(0, 1, n), None),
             (5, torch.rsqrt, np.exp(rs.uniform(-46, 20, n)), None), (6, torch.sqrt, rs.uniform(0, 4, n), None),
             (7, torch.div, rs.randn(n), rs.randn(n))]
    for fn, ref, a, b in cases:
        a = torch.as_tensor(a.astype(np.float32), device=cuda)
        b2 = torch.as_tensor((np.ones(n) if b is None else b).astype(np.float32), device=cuda)
        out = torch.empty_like(a)
        assert lib.shade_math_probe(a.data_ptr(), b2.data_ptr(), out.data_ptr(), n, fn, 5.0,
                                    torch.cuda.current_stream().cuda_stream) == 0
        want = ref(a) if b is None else ref(a, b2)
        torch.cuda.synchronize()
        assert same_bits(out, want), fn


@pytest.mark.parametrize("lanes", ["identity", "range", "ids", "respawn"])
@pytest.mark.parametrize("dof", [False, True], ids=["pinhole", "dof"])
def test_camera_kernel_matches_plain(cuda, dof, lanes):
    """The camera kernel against camera_paths_plain at 1080p on 65,536
    lanes, each slot -> pixel map, with a mask into buffers it leaves
    alone elsewhere: origins, directions and seeds bit-equal, and
    camera_paths launching the kernel only outside plain()."""
    from tpu_pathtracer_torch.ops import camera as camera_ops

    cfg = RenderConfig(width=1920, height=1080, dof=dof, dof_blurriness=0.2, focus_distance=3.0)
    cam = camera_arrays(Camera(), cfg, cuda)
    n, rs = 65_536, np.random.RandomState(4)
    ids = lambda k: torch.as_tensor(rs.randint(0, 1920 * 1080, size=k).astype(np.int32), device=cuda)  # noqa: E731
    kw, mask = dict(identity=dict(per=10), range=dict(per=10, base=torch.tensor(777, device=cuda)),
                    ids=dict(per=3, pix=ids(n // 3 + 1)), respawn={})[lanes], None
    if lanes == "respawn":
        kw = dict(pix=ids(n), sample=torch.as_tensor(rs.randint(0, 12, n).astype(np.int32), device=cuda),
                  sample_max=9)
        mask = torch.as_tensor(rs.rand(n) < 0.4, device=cuda)
    outs, launched = [], []
    for arm in ("kernel", "plain"):
        out = (torch.full((n, 3), 5.0, device=cuda), torch.full((n, 3), 6.0, device=cuda),
               torch.full((n,), 7, dtype=torch.int64, device=cuda))
        before = camera_ops.camera_paths.launches
        with cuda_build.plain() if arm == "plain" else contextlib.nullcontext():
            camera_ops.camera_paths(cam, cfg, torch.tensor(4, device=cuda), torch.tensor(20, device=cuda), n,
                                    mask=mask, out=out, **kw)
        outs.append(out)
        launched.append(camera_ops.camera_paths.launches - before)
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(*outs))
    assert launched == [1, 0]  # a CUDA camera launches the kernel, but under plain()


@pytest.mark.parametrize("which", list(GRAPH_SCHEDULES))
@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_renders_equal_under_plain(cuda, monkeypatch, nee, which):
    """Every schedule (the affine range and the id list included), graphed
    and eager, with the kernels and under ops.cuda_build.plain(): images,
    iterations, segments and shadow segments bit-equal.  Launches: the
    bounce kernel once an iteration, the NEE kernel once under NEE, the
    camera kernel once an iteration of the stream and regen schedules and
    once a frame's set-up, kernel 7 once an iteration of every stream and
    the path step once an iteration of rays and regen, the ray-order
    kernels once a trace; none of them under plain() but the fused
    stream's kernel 7; replays run under
    torch.cuda.set_sync_debug_mode("error")."""
    from tpu_pathtracer_torch.ops import camera as camera_ops

    overrides, pixels = GRAPH_SCHEDULES[which]
    cfg = RenderConfig(**{**GRAPH_BASE, **(GRAPH_NEE if nee else {}), **overrides})
    scene = graph_scene("flat", nee, cuda, monkeypatch)
    real_step = graph_loop.Plan.step

    def checked_step(plan):
        torch.cuda.set_sync_debug_mode("error" if plan.graph is not None else 0)
        try:
            real_step(plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(graph_loop.Plan, "step", checked_step)
    graph_loop.clear()
    frames = GRAPH_FRAMES[:2]
    runs = {}
    for arm in ("kernels", "plain"):
        ctx = cuda_build.plain() if arm == "plain" else contextlib.nullcontext()
        with ctx:
            runs[arm, "graphed"] = graph_frames(scene, cfg, pixels, frames)
            with graph_loop.eager():
                runs[arm, "eager"] = graph_frames(scene, cfg, pixels, frames)
    ref = runs["plain", "eager"]
    for key, run in runs.items():
        for (img, st, counts), (img_r, st_r, _) in zip(run, ref):
            assert same_bits(img, img_r), key
            for k in ("iters", "segments", "shadow_segments"):
                assert int(st[k]) == int(st_r[k]), (key, k)
            shading = (counts["bounce"], counts["next_event"], counts["camera_paths"])
            iters, stream = st["iters"], st["schedule"].startswith("stream")
            # kernel 7 (the fused stream keeps it under plain()) and the path step
            steps = (counts["fused_stream_step"], counts["path_step"])
            # the ray ordering: a sorted trace an iteration, two under NEE,
            # each sort one launch (pools of at most 4,096 rays); at most 4
            # packets a trace, which the card holds at once, so no packet
            # order
            order = tuple(counts[f] for f in ("sort_rays", "caller_order_stores", "packet_order"))
            if key[0] == "plain":
                assert shading == (0, 0, 0), key
                assert steps == (iters if st["schedule"] == "stream_fused" else 0, 0), key
                assert order == (0, 0, 0), key
                continue
            traces = iters * (2 if nee else 1)
            assert order == (traces, traces, 0), key
            respawns = iters if st["schedule"] in ("stream", "stream_fused", "regen") else 0
            assert shading == (iters, iters if nee else 0, respawns + 1), key
            assert steps == ((iters, 0) if stream else (0, iters)), key
            assert counts["random_in_unit_sphere"] == 0, key


# ---------------------------------------------------------------------------
# The ray ordering (csrc/ray_sort.cu) against its plain versions
# (ops/ray_sort.py), bit for bit
# ---------------------------------------------------------------------------

RAY_COUNTS = [0, 1, 1000, 131_072]
def launch_delta(fn, *args, **kw):
    """(fn's result, the launches it added to each ray-ordering count: the
    sort, the restore in the traversal's store, the packet order)."""
    wrappers = (ray_sort.sort_rays, ic.caller_order_stores, ray_sort.packet_order)
    before = [w.launches for w in wrappers]
    out = fn(*args, **kw)
    return out, tuple(w.launches - b for w, b in zip(wrappers, before))


# The radix sort's sizes: empty, one ray, around a warp's keys and a
# tile's (2,048), around config 1's pool (the largest one-launch sort),
# the headline's pool, a 1-spp tile and the one-lane-a-pixel pool
SORT_COUNTS = [0, 1, 255, 256, 257, 2049, 16_383, 16_384, 16_385, 131_072, 345_600, 2_073_600]
# every (spatial bits, direction bits) the config allows (0-9, 0-4)
ALL_KEY_BITS = [(s, d) for s in range(10) for d in range(5)]


@pytest.fixture(scope="module")
def sort_inputs():
    """{n: (origins, directions, box)} on the card, made once: rays() with
    the first tenth sharing one origin and direction (ties in every key
    setting), and the three-spheres box."""
    if not torch.cuda.is_available():  # a module fixture is set up before the function's `cuda`
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    box = build_accel(procedural.three_spheres_scene(8, 16, device=dev)).accel
    out = {}
    for n in SORT_COUNTS:
        o, d = rays(13, n, parked=0)
        if n:
            o[: n // 10], d[: n // 10] = o[0], d[0]
        out[n] = o.to(dev), d.to(dev), (box.scene_lo, box.scene_hi)
    return out


def sort_mask(kind, n, dev):
    """No mask, two thirds of the lanes parked (the NEE shadow rays' share:
    every parked lane has one key), or every lane parked."""
    if kind == "none":
        return None
    if kind == "all":
        return torch.zeros(n, dtype=torch.bool, device=dev)
    return torch.as_tensor(np.random.RandomState(n).rand(n) < 0.34, device=dev)


@pytest.mark.parametrize("mask", ["none", "some", "all"])
@pytest.mark.parametrize("n", SORT_COUNTS)
def test_sort_rays_matches_plain(cuda, sort_inputs, n, mask):
    """The radix sort (key, parking, stable sort and gather) at every
    allowed (spatial bits, direction bits): perm equal to
    torch.sort(key, stable=True).indices of the plain key, and the sorted
    rays bit-equal to sort_rays_plain's; one launch up to 16,384 rays,
    else one for the keys and one a digit pass (at most 5)."""
    o, d, box = sort_inputs[n]
    active = sort_mask(mask, n, cuda)
    for bits in ALL_KEY_BITS:
        (o_s, d_s, perm), launched = launch_delta(ray_sort.sort_rays, o, d, *box, *bits, active=active)
        key = ray_sort.sort_key_plain(o, d, *box, *bits, active)
        o_p, d_p, perm_p = ray_sort.sort_rays_plain(o, d, *box, *bits, active)
        torch.cuda.synchronize()
        want = ray_sort.sort_launches(n, *bits)
        assert launched == (want, 0, 0), bits
        assert want <= (1 if n <= ray_sort.SMALL_MAX else 5)
        assert perm.dtype == torch.int64 and o_s.shape == (n, 3), bits
        assert torch.equal(perm, torch.sort(key, stable=True).indices) and torch.equal(perm, perm_p), bits
        assert same_bits(o_s, o_p) and same_bits(d_s, d_p), bits


@pytest.mark.parametrize("n", [131_072, 345_600, 2_073_600])
def test_sort_rays_replayed_past_the_tag_wrap(cuda, sort_inputs, n):
    """Two sorts on one scratch (closest hit without a mask, shadow rays
    with two thirds or one third parked, as an iteration under NEE makes
    them), captured in one CUDA graph and replayed 1,100 times (8 digit
    pass launches a replay, so the 127 tags of the status words wrap
    every 16 replays, 69 times in all), at each tile the wrapper picks
    over tiles (ray_sort.tile_items), the inputs changed between replays:
    every checked replay bit-equal to the plain version, under
    set_sync_debug_mode("error")."""
    o, d, box = sort_inputs[n]
    bits = (9, 4)  # 30-bit keys: 4 digit passes
    masks = [sort_mask("some", n, cuda), ~sort_mask("some", n, cuda)]
    src = [(o, d), (torch.flip(o, (0,)), torch.flip(d, (0,)))]
    o_in, d_in, act_in = o.clone(), d.clone(), masks[0].clone()
    ray_sort.sort_rays(o_in, d_in, *box, *bits)  # builds the library and the scratch outside the capture
    ray_sort.sort_rays(o_in, d_in, *box, *bits, active=act_in)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):  # as render/graph_loop.py captures
        closest = ray_sort.sort_rays(o_in, d_in, *box, *bits)
        shadow = ray_sort.sort_rays(o_in, d_in, *box, *bits, active=act_in)
    checked = 0
    for r in range(1100):
        k = r % 2
        o_in.copy_(src[k][0])
        d_in.copy_(src[k][1])
        act_in.copy_(masks[k])
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if r < 32 or r % 97 == 0 or r >= 1090:
            want_c = ray_sort.sort_rays_plain(*src[k], *box, *bits)
            want_s = ray_sort.sort_rays_plain(*src[k], *box, *bits, masks[k])
            torch.cuda.synchronize()
            for got, want in ((closest, want_c), (shadow, want_s)):
                assert all(same_bits(g, w) for g, w in zip(got, want)), r
            checked += 1
    assert checked > 40


@pytest.mark.parametrize("items", ray_sort.TILE_ITEMS)
@pytest.mark.parametrize("n", [16_385, 131_072, 345_600, 2_073_600])
def test_sort_rays_every_tile_matches_plain(cuda, sort_inputs, n, items):
    """The sort over each tile the kernel instantiates (256 threads x 4, 8
    or 16 keys), whichever tile_items picks: 1 + 4 launches, perm and
    rays bit-equal to sort_rays_plain's, with and without a mask."""
    o, d, box = sort_inputs[n]
    bits = (9, 4)  # 30-bit keys: 4 digit passes
    for active in (None, sort_mask("some", n, cuda)):
        before = ray_sort.sort_rays.launches
        got = ray_sort.sort_rays_cuda(o, d, *box, *bits, active, items=items)
        want = ray_sort.sort_rays_plain(o, d, *box, *bits, active)
        torch.cuda.synchronize()
        assert ray_sort.sort_rays.launches - before == 5
        assert all(same_bits(g, w) for g, w in zip(got, want)), active is None


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_headline_graphed_without_torch_sort(cuda, monkeypatch, nee):
    """A graphed headline render (1920x1080, 10 spp, depth 8, the
    three-spheres scene under the procedural sky), and its NEE variant,
    with torch.sort and torch.argsort patched to raise: they finish, and
    image, iterations, segments and shadow segments are bit-equal to the
    same render under ops.cuda_build.plain() (where the plain sort runs
    torch.sort)."""
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils.image import procedural_hdr

    sky = with_importance_sampling(make_env(procedural_hdr(256, 512), cuda))
    scene = build_accel(procedural.three_spheres_scene(device=cuda).replace(env=sky), kind="cluster")
    cfg = RenderConfig(width=1920, height=1080, samples_per_launch=10, max_depth=8, dof=False, env_mode="equirect",
                       rr_mode="standard" if nee else "reference", env_importance_sampling=nee,
                       intersector="cluster")
    cam = camera_arrays(Camera(), cfg, cuda)
    graph_loop.clear()
    with cuda_build.plain():
        render_frame_stats(scene, cam, cfg, 0)  # captures
        img_p, st_p = render_frame_stats(scene, cam, cfg, 1)

    def refuse(*args, **kw):
        raise AssertionError("torch.sort or torch.argsort ran on the card's main path")

    monkeypatch.setattr(torch, "sort", refuse)
    monkeypatch.setattr(torch, "argsort", refuse)
    before = ray_sort.sort_rays.launches
    render_frame_stats(scene, cam, cfg, 0)  # captures
    img, st = render_frame_stats(scene, cam, cfg, 1)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert st["graphed"] and st_p["graphed"]
    assert ray_sort.sort_rays.launches > before
    assert same_bits(img, img_p)
    for k in ("iters", "segments", "shadow_segments"):
        assert int(st[k]) == int(st_p[k]), k
    assert (int(st["shadow_segments"]) > 0) == nee


RESTORE_WRAPPERS = {("flat", False): ic.intersect_clusters, ("hier", False): ic.intersect_clusters_hier,
                    ("streamed", False): ic.intersect_clusters_streamed, ("flat", True): ic.occluded_clusters,
                    ("hier", True): ic.occluded_clusters_hier, ("streamed", True): ic.occluded_clusters_streamed}


@pytest.mark.parametrize("order", ["identity", "perm", "masked"])
@pytest.mark.parametrize("tri_test", ["bw", "mt"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("route", ["flat", "hier", "streamed"])
@pytest.mark.parametrize("n", RAY_COUNTS)
def test_restore_hits_matches_plain(cuda, monkeypatch, n, route, any_hit, tri_test, order):
    """The restore, done by each of the six traversal kernels in its store
    (restore=True: row i of the sorted rays written to row perm[i]),
    against the kernel's raw outputs through restore_hits_plain (closest
    hit: t, prim -1 on a miss, bary 0 on a miss, hit; any hit: the flags),
    in bw and mt, with no perm (closest hit: the Hit in place), the sort's
    perm and the sort's perm with a mask; 0 to 131,072 rays, the last
    packet ragged.  The count of caller-order stores: one a launch, but an
    any hit without a perm (its raw flags are in caller order)."""
    scene = graph_scene(route, False, cuda, monkeypatch)
    acc = scene.accel
    cfg = RenderConfig(**{**GRAPH_BASE, "tri_test": tri_test})
    assert acc.route(cfg) == route
    o, d = (x.to(cuda) for x in rays(5, n, parked=n // 20))
    perm = None
    if order != "identity":
        active = torch.as_tensor(np.random.RandomState(6).rand(n) < 0.6, device=cuda) if order == "masked" else None
        o, d, perm = acc.sort(o, d, cfg.replace(sort_rays="auto"), active)
    _, args = acc.traversal(o, d, 0.01, 1e16, cfg)
    wrapper = RESTORE_WRAPPERS[route, any_hit]
    raw = wrapper(*args)
    before = (wrapper.launches, ic.caller_order_stores.launches)
    got = wrapper(*args, restore=True, perm=perm)
    launched = (wrapper.launches - before[0], ic.caller_order_stores.launches - before[1])
    want = ray_sort.restore_hits_plain(raw, perm)
    torch.cuda.synchronize()
    assert launched == ((1, 0 if any_hit and perm is None else 1) if n else (0, 0))
    if any_hit:
        assert torch.equal(got, want)
    else:
        for f in ("t", "prim", "bary", "hit"):
            assert same_bits(getattr(got, f), getattr(want, f)), f
        if n >= 1000:
            assert 0 < int(got.hit.sum()) < n


@pytest.mark.parametrize("ties", ["few", "many"])
@pytest.mark.parametrize("packets", [1, 2, 33, 128, 1000, 4096, 5000])
def test_packet_order_matches_plain(cuda, packets, ties):
    """The packet order (ranks counted over the weights in shared memory)
    against the stable descending argsort, at 1 to 4,096 packets and past
    one chunk of shared memory."""
    rs = np.random.RandomState(packets)
    w = rs.randint(0, 4 if ties == "many" else 1 << 20, packets).astype(np.int32)
    weights = torch.as_tensor(w, device=cuda)
    got, launched = launch_delta(ray_sort.packet_order, weights)
    torch.cuda.synchronize()
    assert launched == (0, 0, 1)
    assert torch.equal(got, ray_sort.packet_order_plain(weights))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
@pytest.mark.parametrize("sort_rays", ["auto", "octant", "off"])
@pytest.mark.parametrize("route", ["flat", "hier", "streamed"])
def test_cluster_accel_ray_order_on_card(cuda, monkeypatch, route, sort_rays, masked):
    """ClusterAccel.intersect and occluded with the ray-order kernels
    against the same calls under ops.cuda_build.plain() (the plain versions;
    the traversal kernels in both): Hit and flags bit-equal on every
    route, sort on and off, with and without an active mask, at 131,072
    rays (128 packets or more: the packet order runs).  The kernels'
    launches: the sort's (1 + its digit passes at this size) a sorted
    call, the restore in the traversal's store once a call (an unsorted any
    hit needs none), the packet order once a call."""
    scene = graph_scene(route, False, cuda, monkeypatch)
    acc = scene.accel
    cfg = RenderConfig(**{**GRAPH_BASE, "sort_rays": sort_rays})
    assert acc.route(cfg) == route
    o, d = (x.to(cuda) for x in rays(3, 131_072, parked=0))
    active = torch.as_tensor(np.random.RandomState(3).rand(131_072) < 0.6, device=cuda) if masked else None
    sorted_ = sort_rays != "off"
    hit, n_hit = launch_delta(acc.intersect, scene.vertices, o, d, 0.01, 1e16, cfg)
    occ, n_occ = launch_delta(acc.occluded, scene.vertices, o, d, 0.01, 1e16, cfg, active)
    with cuda_build.plain():
        hit_p, n_hit_p = launch_delta(acc.intersect, scene.vertices, o, d, 0.01, 1e16, cfg)
        occ_p, n_occ_p = launch_delta(acc.occluded, scene.vertices, o, d, 0.01, 1e16, cfg, active)
    torch.cuda.synchronize()
    for f in ("t", "prim", "bary", "hit"):
        assert same_bits(getattr(hit, f), getattr(hit_p, f)), f
    assert torch.equal(occ, occ_p)
    assert int(hit.hit.sum()) > 10_000
    sorts = ray_sort.sort_launches(131_072, acc._spatial_bits(cfg) if sort_rays == "auto" else 0,
                                   acc._dir_bits(cfg)) if sorted_ else 0
    assert sorts in ((0,) if not sorted_ else (3, 5))  # octant keys: 9 bits, 2 passes; spatial: 30, 4
    assert n_hit == (sorts, 1, 1)
    assert n_occ == (sorts, int(sorted_), 1)
    assert n_hit_p == n_occ_p == (0, 0, 0)


# ---------------------------------------------------------------------------
# The NEE and camera kernels as programmatic dependents of the launch before
# them (csrc/launch_order.cuh): the any-hit traversal, kernel 7
# ---------------------------------------------------------------------------

REPLAYS = 1000


@functools.lru_cache(maxsize=None)
def bounce_lanes(device, nee):
    """65,536 camera rays of 1080p and their closest hits, with seeded
    attenuations, radiances and env credits: under NEE on config 4's scene
    (high_poly_scene at 100,000 triangles: the two-level route, ~2 ms an
    any-hit launch), else on the headline's three spheres (flat).
    Returns (scene, cfg, the bounce's arguments after scene and cfg)."""
    from tpu_pathtracer_torch.ops import camera as camera_ops
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils.image import procedural_hdr

    dev = torch.device(device)
    if nee:
        env = with_importance_sampling(make_env(procedural_hdr(64, 128), dev))
        scene = build_accel(procedural.high_poly_scene(total_tris=100_000, device=dev).replace(env=env),
                            kind="cluster")
        cfg = RenderConfig(width=1920, height=1080, max_depth=8, intersector="cluster", env_mode="equirect",
                           rr_mode="standard", env_importance_sampling=True)
        assert scene.accel.route(cfg) == "hier"
        camera = Camera(eye=(0, 3, 10), lookat=(0, 1, 0))
    else:
        scene = build_accel(procedural.three_spheres_scene(device=dev), kind="cluster")
        cfg = RenderConfig(width=1920, height=1080, max_depth=8, intersector="cluster", env_mode="sunsky")
        camera = Camera()
    n = 65_536
    pix = torch.arange(n, dtype=torch.int32, device=dev) * (1920 * 1080 // n)
    o, d, seeds = camera_ops.camera_paths(camera_arrays(camera, cfg, dev), cfg, 0, 0, n, pix=pix)
    hit = scene.accel.intersect(scene.vertices, o, d, cfg.t_min, cfg.t_max, cfg)
    rs = np.random.RandomState(31)
    att = torch.as_tensor((rs.rand(n, 3) + 0.2).astype(np.float32), device=dev)
    rad = torch.as_tensor((rs.rand(n, 3) * 0.5).astype(np.float32), device=dev)
    depth = torch.full((n,), 8, dtype=torch.int32, device=dev)
    spec = torch.as_tensor(rs.rand(n) < 0.5, device=dev)
    return scene, cfg, (hit, o, d, att, rad, seeds, depth, spec)


@functools.lru_cache(maxsize=None)
def nee_pair(device):
    """The any-hit traversal of config 4's shadow rays (bounce_lanes) and
    the NEE kernel as its programmatic dependent, as _bounce_kernels
    launches them: (pair() -> spec_next, writing `radiance` in place from
    the bounce kernel's; radiance; the plain version's radiance and
    spec_next; the NEE launch's (blocks, threads))."""
    scene, cfg, lanes = bounce_lanes(device, True)
    hit, o, d, att, rad, seeds, depth, spec = lanes
    n = o.shape[0]
    args = (scene, cfg, *lanes)
    b = bounce_ops.bounce(*args)

    def traverse():
        return scene.accel.occluded(scene.vertices, b["shadow_origin"], b["shadow_dir"], cfg.t_min, cfg.t_max, cfg,
                                    active=b["cand"])

    occ = traverse()
    real = integrator.occluded_scene
    integrator.occluded_scene = lambda *a, **k: occ
    try:
        want = integrator._bounce_plain(*args)
    finally:
        integrator.occluded_scene = real
    pre = b["radiance"].clone()
    radiance = pre.clone()
    x = dict(b, radiance=radiance)

    def pair():
        radiance.copy_(pre)
        return bounce_ops.next_event(scene, cfg, x, traverse(), d, att, dependent=True)

    blocked = occ[b["cand"]]
    assert int(b["cand"].sum()) > 1000 and 0 < int(blocked.sum()) < blocked.shape[0]
    return pair, radiance, want["radiance"], want["spec_last"], (-(-n // 128), 128)


@functools.lru_cache(maxsize=None)
def step_chain(device, nee, schedule):
    """The loop body's launches after the closest-hit traversal, as
    render_rays or render_pixels_regen runs them on the card: the bounce
    kernel, under NEE the any-hit traversal and the NEE kernel
    (integrator._bounce_kernels), then the path step as a programmatic
    dependent of the last of them, on bounce_lanes' lanes as the loop's
    buffers (a third ended; regen: the loop's regen buffer, 0 on them),
    reset each call: (chain() -> regen mask, the buffers, the plain
    version's buffers after the same payload, the path step's (blocks,
    threads))."""
    scene, cfg, lanes = bounce_lanes(device, nee)
    hit, o, d, att, rad, seeds, depth, spec = lanes
    dev, n = o.device, o.shape[0]
    rs = np.random.RandomState(7)
    ended = torch.as_tensor(rs.rand(n) < 1 / 3, device=dev)
    start = dict(origin=o, direction=d, attenuation=att, radiance=rad, seeds=seeds, depth=depth, spec_last=spec,
                 done=torch.zeros((), dtype=torch.bool, device=dev), segments=torch.tensor(10, device=dev),
                 shadow=torch.tensor(3, device=dev))
    if schedule == "rays":
        start.update(terminated=ended, result=torch.zeros_like(o))
    else:
        start.update(exhausted=ended, sample_i=torch.as_tensor(rs.randint(0, 2, n).astype(np.int32), device=dev),
                     accum=torch.as_tensor(rs.uniform(0, 2, (n, 3)).astype(np.float32), device=dev),
                     regen=torch.zeros(n, dtype=torch.bool, device=dev))
    kw = dict(schedule=schedule, spp=2, max_depth=cfg.max_depth, rr_reference=cfg.rr_mode == "reference", nee=nee)
    st = {k: v.clone() for k, v in start.items()}

    def trace(buf):
        return integrator._bounce_kernels(scene, cfg, hit, buf["origin"], buf["direction"], buf["attenuation"],
                                          buf["radiance"], buf["seeds"], buf["depth"], buf["spec_last"])

    want = {k: v.clone() for k, v in start.items()}
    fs.path_step_plain(trace(want), want, **kw)

    def chain():
        for k, v in start.items():
            st[k].copy_(v)
        return fs.path_step_cuda(trace(st), st, dependent=True, **kw)

    return chain, st, want, (-(-n // 256), 256)


@pytest.mark.parametrize("schedule", ["rays", "regen"])
@pytest.mark.parametrize("nee", [False, True], ids=["bounce", "nee"])
def test_path_step_dependent_bit_equal_through_replays(cuda, nee, schedule):
    """The path step as a programmatic dependent of the bounce kernel, and
    of the NEE kernel behind config 4's two-level any-hit traversal,
    captured as the graphed loop captures them and replayed 1,000 times:
    every buffer after every replay bit-equal to path_step_plain's."""
    chain, st, want, _ = step_chain(str(cuda), nee, schedule)
    chain()
    torch.cuda.synchronize()
    assert all(same_bits(st[k], want[k]) for k in want)
    assert replays_differ(chain, lambda _: [(st[k], want[k]) for k in want]) == 0


@pytest.mark.parametrize("schedule", ["rays", "regen"])
@pytest.mark.parametrize("nee", [False, True], ids=["bounce", "nee"])
def test_path_step_dependent_captured_edge_is_programmatic(cuda, nee, schedule):
    """A stream capture of the chain records the edge into the path step
    (the graph's last node) as programmatic, and under NEE the one into
    the NEE kernel too: nothing else."""
    from chip_smoke import captured_edges

    chain, *_, shape = step_chain(str(cuda), nee, schedule)
    edges = captured_edges(chain)
    into = [e for e in edges if e["sink"]]
    assert len(into) == 1 and into[0]["to"] == shape and into[0]["programmatic"]
    assert sum(e["programmatic"] for e in edges) == (2 if nee else 1)


@pytest.mark.parametrize("schedule", ["rays", "regen"])
@pytest.mark.parametrize("nee", [False, True], ids=["bounce", "nee"])
def test_path_step_dependent_32_steps_on_one_scratch(cuda, nee, schedule):
    """32 iterations of the loop's body on bounce_lanes' scene, one scratch
    never cleared: the trace (the closest-hit traversal, the bounce
    kernels), the path step as the dependent of its last launch and, on
    regen, the camera kernel as the path step's dependent; beside it the
    same with path_step_plain and an ordinary camera launch: every buffer
    bit-equal after every iteration."""
    from tpu_pathtracer_torch.ops import camera as camera_ops

    scene, cfg, (_, o, d, att, rad, seeds, depth, spec) = bounce_lanes(str(cuda), nee)
    n = o.shape[0]
    cam = camera_arrays(Camera(eye=(0, 3, 10), lookat=(0, 1, 0)) if nee else Camera(), cfg, cuda)
    ids = torch.arange(n, dtype=torch.int32, device=cuda) * (1920 * 1080 // n)
    counters = torch.tensor(0, device=cuda), torch.tensor(0, device=cuda)
    start = dict(origin=o, direction=d, attenuation=att, radiance=rad, seeds=seeds, depth=depth, spec_last=spec,
                 done=torch.zeros((), dtype=torch.bool, device=cuda), segments=torch.tensor(0, device=cuda),
                 shadow=torch.tensor(0, device=cuda))
    ended = torch.zeros(n, dtype=torch.bool, device=cuda)
    if schedule == "rays":
        start.update(terminated=ended, result=torch.zeros_like(o))
    else:
        start.update(exhausted=ended, sample_i=torch.zeros(n, dtype=torch.int32, device=cuda),
                     accum=torch.zeros_like(o), regen=ended.clone())
    kw = dict(schedule=schedule, spp=2, max_depth=cfg.max_depth, rr_reference=cfg.rr_mode == "reference", nee=nee)
    runs = {arm: {k: v.clone() for k, v in start.items()} for arm in ("kernel", "plain")}
    for it in range(32):
        for arm, st in runs.items():
            tb = integrator._trace_bounce(scene, cfg, st["origin"], st["direction"], st["attenuation"],
                                          st["radiance"], st["seeds"], st["depth"], st["spec_last"])
            if arm == "kernel":
                regen = fs.path_step_cuda(tb, st, dependent=True, **kw)
            else:
                regen = fs.path_step_plain(tb, st, **kw)
            if regen is not None:
                camera_ops.camera_paths(cam, cfg, *counters, n, pix=ids, sample=st["sample_i"], sample_max=1,
                                        mask=regen, out=(st["origin"], st["direction"], st["seeds"]),
                                        dependent=arm == "kernel")
        torch.cuda.synchronize()
        assert all(same_bits(runs["kernel"][k], runs["plain"][k]) for k in start), it
    flag = runs["kernel"]["terminated" if schedule == "rays" else "exhausted"]
    assert 0.5 < float(flag.float().mean()) and int(runs["kernel"]["segments"]) > n


@functools.lru_cache(maxsize=None)
def camera_pair(device):
    """Kernel 7 on 131,072 lanes of a seeded state and the camera kernel
    as its programmatic dependent on the step's regen mask (DOF), as the
    stream's respawn launches them, the state reset each call: (pair(),
    the state, the plain version's origins, directions and seeds (kernel
    7 then camera_paths_plain), the camera launch's (blocks, threads))."""
    from tpu_pathtracer_torch.ops import camera as camera_ops

    dev = torch.device(device)
    lanes = 131_072
    tb, st, n_pix, head, segments = step_state(lanes, 9, dev)
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=True, inv_spp=1.0 / 3)
    cfg = RenderConfig(width=1024, height=n_pix // 1024, dof=True, dof_blurriness=0.1, focus_distance=3.0)
    cam = camera_arrays(Camera(), cfg, dev)
    counters = torch.tensor(2, device=dev), torch.tensor(5, device=dev)
    image = torch.zeros((n_pix + 1, 3), device=dev)

    def respawn(s, regen, spawn, **extra):
        spawn(cam, cfg, *counters, lanes, pix=s["pix"], sample=s["sample_i"], sample_max=2, mask=regen,
              out=(s["origin"], s["direction"], s["seeds"]), **extra)

    s_p = {k: v.clone() for k, v in st.items()}
    regen = fs.fused_stream_step_cuda(tb, s_p, image, head, segments, **kw)[0]
    respawn(s_p, regen, camera_ops.camera_paths_plain)
    s = {k: v.clone() for k, v in st.items()}

    def pair():
        for k, v in st.items():
            s[k].copy_(v)
        respawn(s, fs.fused_stream_step_cuda(tb, s, image, head, segments, **kw)[0], camera_ops.camera_paths,
                dependent=True)

    assert 0.05 < float(regen.float().mean()) < 0.95
    return pair, s, {k: s_p[k] for k in ("origin", "direction", "seeds")}, (lanes // 256, 256)


def replays_differ(pair, check) -> int:
    """pair() captured into a CUDA graph and replayed REPLAYS times; the
    count, kept on the card, of the values that check() -> [(got, want)]
    finds differing in a bit after each replay."""
    pair()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pair()
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(REPLAYS):
        graph.replay()
        for got, want in check(out):
            if got.is_floating_point():
                got, want = got.view(torch.int32), want.view(torch.int32)
            bad += (got != want).sum()
    torch.cuda.synchronize()
    return int(bad)


@pytest.mark.parametrize("which", ["nee", "camera", "nee_brute"])
def test_dependent_kernel_bit_equal_through_replays(cuda, which):
    """Each dependent kernel behind the launch it depends on, captured as
    the graphed loop captures them and replayed 1,000 times: every replay
    bit-equal to the plain version.  Behind config 4's two-level any-hit
    traversal the NEE kernel's blocks wait ~2 ms, so a read of the flags
    before its wait would show; "nee_brute": behind the brute-force any
    hit on a scene without an accel."""
    if which in ("nee", "nee_brute"):
        pair, radiance, want_rad, want_spec, _ = (nee_pair if which == "nee" else brute_nee_pair)(str(cuda))
        spec = pair()
        torch.cuda.synchronize()
        assert same_bits(radiance, want_rad) and torch.equal(spec, want_spec)
        assert replays_differ(pair, lambda out: [(radiance, want_rad), (out, want_spec)]) == 0
    else:
        pair, s, want, _ = camera_pair(str(cuda))
        pair()
        torch.cuda.synchronize()
        assert all(same_bits(s[k], want[k]) for k in want)
        assert replays_differ(pair, lambda _: [(s[k], want[k]) for k in want]) == 0


@pytest.mark.parametrize("which", ["nee", "camera", "nee_brute"])
def test_dependent_kernel_captured_edge_is_programmatic(cuda, which):
    """A stream capture of each pair records the edge into the dependent
    kernel (the graph's last node, of its launch's shape) as a
    programmatic dependency, read through the driver API."""
    from chip_smoke import captured_edges

    pair, *_, shape = {"nee": nee_pair, "camera": camera_pair, "nee_brute": brute_nee_pair}[which](str(cuda))
    into = [e for e in captured_edges(pair) if e["sink"]]
    assert len(into) == 1 and into[0]["to"] == shape and into[0]["programmatic"]
    assert sum(e["programmatic"] for e in captured_edges(pair)) == 1


# ---------------------------------------------------------------------------
# Brute force (csrc/brute.cu) against its plain versions (ops/intersect.py),
# bit for bit
# ---------------------------------------------------------------------------

BRUTE_COUNTS = (0, 1, 19_200, 131_072, 345_600)  # chip_smoke.py phase 40's


@pytest.fixture(scope="module")
def brute_scenes(tmp_path_factory):
    """Phase 40's scenes on the card, each (scene with its accel, which
    makes the rays; cfg; camera): the headline (3,074 triangles, its sky
    with the alias table, NEE), config 1's sphere (4,098) and the hero
    stand-in (2,214, written as chip_smoke.py writes it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke as cs
    from tpu_pathtracer_torch.scene.scenefile import load_scene_file

    root = tmp_path_factory.mktemp("brute")
    hero, hero_camera, hero_cfg = load_scene_file(str(cs.write_hero(root)), device="cuda",
                                                  cache_dir=str(root / "cache"))
    return {"headline": (cs.headline_scene("cuda"), RenderConfig(**{**cs.HEADLINE, **cs.NEE}), Camera()),
            "config1": cs.brute_config1(), "hero": (hero, hero_cfg, hero_camera)}


@pytest.mark.parametrize("n", BRUTE_COUNTS)
@pytest.mark.parametrize("name", ["headline", "config1", "hero"])
def test_brute_kernels_match_plain(cuda, brute_scenes, name, n):
    """The closest hit's Hit bit for bit (its finalize included); the any
    hit's flags equal on the active lanes and False off them; one launch
    counted a call (none at 0 rays)."""
    import chip_smoke as cs
    from tpu_pathtracer_torch.ops import intersect as isect

    scene, cfg, camera = brute_scenes[name]
    v = scene.vertices
    o, d = cs.brute_rays(scene, cfg, camera, n)
    before = isect.intersect_brute.launches, isect.occluded_brute.launches
    got = isect.intersect_brute(v, o, d, cfg.t_min, cfg.t_max, cfg.intersect_block)
    want = isect.intersect_brute_plain(v, o, d, cfg.t_min, cfg.t_max, cfg.intersect_block)
    so, sd, active = cs.brute_shadow_rays(scene, cfg, camera, n)
    occ = isect.occluded_brute(v, so, sd, cfg.t_min, cfg.t_max, cfg.intersect_block, active=active)
    occ_p = isect.occluded_brute_plain(v, so, sd, cfg.t_min, cfg.t_max, cfg.intersect_block)
    torch.cuda.synchronize()
    assert cs.hit_bits_equal(got, want)
    assert torch.equal(occ[active], occ_p[active]) and not bool(occ[~active].any())
    launched = int(n > 0)
    assert (isect.intersect_brute.launches, isect.occluded_brute.launches) == (before[0] + launched,
                                                                              before[1] + launched)
    if n >= 19_200:
        assert 0.2 < float(got.hit.float().mean()) and 0 < int(occ.sum()) < int(active.sum())


@pytest.mark.parametrize("name", ["headline", "config1"])
def test_brute_grazing_match_plain(cuda, brute_scenes, name):
    """Rays and segments aimed at the triangles' vertices and edges, from
    around the scene and from points on triangles, the segments ending on
    the edge (chip_smoke.py's brute_grazing): both kernels bit-equal to
    their plain versions, where a wrong margin of the gate would drop a
    hit."""
    import chip_smoke as cs

    scene, cfg, camera = brute_scenes[name]
    assert "segments" in cs.brute_grazing("test", [(name, scene, cfg, camera)], n=65_536)


def test_brute_ties_match_plain(cuda, brute_scenes):
    """Every headline triangle twice, in one tile and in two: each kernel
    bit-equal to its plain version, every hit on the lower copy
    (chip_smoke.py's brute_ties)."""
    import chip_smoke as cs

    scene, cfg, camera = brute_scenes["headline"]
    assert "lower copy" in cs.brute_ties("test", scene, cfg, camera)


def test_brute_wrappers_never_run_plain_on_card(cuda, brute_scenes):
    """On the card outside plain() the dispatch launches the kernels and
    never calls a plain version; under plain() it calls them and launches
    nothing."""
    import chip_smoke as cs
    from tpu_pathtracer_torch.ops import intersect as isect

    scene, cfg, camera = brute_scenes["headline"]
    o, d = cs.brute_rays(scene, cfg, camera, 1000)
    bare, brute_cfg = scene.replace(accel=None), cfg.replace(intersector="auto")
    for arm in ("kernels", "plain"):
        before = isect.intersect_brute.launches, isect.occluded_brute.launches
        with cs.counting_plain_brute() as calls, (cuda_build.plain() if arm == "plain" else contextlib.nullcontext()):
            isect.intersect_scene(bare, o, d, cfg.t_min, cfg.t_max, brute_cfg)
            isect.occluded_scene(bare, o, d, cfg.t_min, cfg.t_max, brute_cfg,
                                 active=torch.ones(o.shape[0], dtype=torch.bool, device=o.device))
        added = (isect.intersect_brute.launches - before[0], isect.occluded_brute.launches - before[1])
        if arm == "kernels":
            assert added == (1, 1) and not calls
        else:
            assert added == (0, 0) and calls == {"intersect_brute_plain": 1, "occluded_brute_plain": 1}


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
@pytest.mark.parametrize("which", ["stream_fused", "stream", "regen", "rays"])
def test_brute_render_graphed_equals_eager_and_plain(cuda, monkeypatch, which, nee):
    """Three spheres without an accel (brute force) on each schedule,
    graphed (its replays under torch.cuda.set_sync_debug_mode("error")),
    eager, and graphed under ops.cuda_build.plain(): images, iterations,
    segments and shadow segments bit-equal; with the kernels one
    closest-hit launch an iteration (and one any-hit launch under NEE) and
    no plain brute-force call, under plain() no launch."""
    import chip_smoke as cs

    overrides, pixels = GRAPH_SCHEDULES[which]
    cfg = RenderConfig(**{**GRAPH_BASE, **(GRAPH_NEE if nee else {}), **overrides, "intersector": "auto"})
    scene = graph_scene("flat", nee, cuda, monkeypatch).replace(accel=None)
    real_step = graph_loop.Plan.step

    def checked_step(plan):
        torch.cuda.set_sync_debug_mode("error" if plan.graph is not None else 0)
        try:
            real_step(plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(graph_loop.Plan, "step", checked_step)
    graph_loop.clear()
    runs = {}
    for arm in ("graphed", "eager", "plain"):
        with cs.counting_plain_brute() as calls, (cuda_build.plain() if arm == "plain" else contextlib.nullcontext()), \
                (graph_loop.eager() if arm == "eager" else contextlib.nullcontext()):
            runs[arm] = graph_frames(scene, cfg, pixels, GRAPH_FRAMES[:2]), dict(calls)
    graph_loop.clear()
    for arm, (frames, calls) in runs.items():
        for (img, st, counts), (img_r, st_r, _) in zip(frames, runs["plain"][0]):
            assert same_bits(img, img_r), arm
            for k in ("iters", "segments", "shadow_segments"):
                assert int(st[k]) == int(st_r[k]), (arm, k)
            iters = int(st["iters"])
            brute = (counts["intersect_brute"], counts["occluded_brute"])
            if arm == "plain":
                assert brute == (0, 0) and calls, arm
            else:
                assert st["graphed"] == (arm == "graphed")
                assert brute == (iters, iters if nee else 0) and not calls, arm
        assert float(frames[0][0].max()) > 0


@functools.lru_cache(maxsize=None)
def brute_nee_pair(device):
    """nee_pair on a scene without an accel: the brute-force any hit of
    the headline's shadow rays (65,536 camera rays of 1080p and their
    closest hits by brute force) and the NEE kernel as its programmatic
    dependent, as _bounce_kernels launches them; returns as nee_pair."""
    from tpu_pathtracer_torch.ops import camera as camera_ops
    from tpu_pathtracer_torch.ops import intersect as isect
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils.image import procedural_hdr

    dev = torch.device(device)
    env = with_importance_sampling(make_env(procedural_hdr(64, 128), dev))
    scene = procedural.three_spheres_scene(device=dev).replace(env=env)
    cfg = RenderConfig(width=1920, height=1080, max_depth=8, intersector="auto", env_mode="equirect",
                       rr_mode="standard", env_importance_sampling=True)
    n = 65_536
    pix = torch.arange(n, dtype=torch.int32, device=dev) * (1920 * 1080 // n)
    o, d, seeds = camera_ops.camera_paths(camera_arrays(Camera(), cfg, dev), cfg, 0, 0, n, pix=pix)
    hit = isect.intersect_scene(scene, o, d, cfg.t_min, cfg.t_max, cfg)
    rs = np.random.RandomState(37)
    att = torch.as_tensor((rs.rand(n, 3) + 0.2).astype(np.float32), device=dev)
    rad = torch.as_tensor((rs.rand(n, 3) * 0.5).astype(np.float32), device=dev)
    depth = torch.full((n,), 8, dtype=torch.int32, device=dev)
    spec = torch.as_tensor(rs.rand(n) < 0.5, device=dev)
    lanes = (hit, o, d, att, rad, seeds, depth, spec)
    args = (scene, cfg, *lanes)
    b = bounce_ops.bounce(*args)

    def traverse():
        return isect.occluded_scene(scene, b["shadow_origin"], b["shadow_dir"], cfg.t_min, cfg.t_max, cfg,
                                    active=b["cand"])

    occ = traverse()
    real = integrator.occluded_scene
    integrator.occluded_scene = lambda *a, **k: occ
    try:
        want = integrator._bounce_plain(*args)
    finally:
        integrator.occluded_scene = real
    pre = b["radiance"].clone()
    radiance = pre.clone()
    x = dict(b, radiance=radiance)

    def pair():
        radiance.copy_(pre)
        return bounce_ops.next_event(scene, cfg, x, traverse(), d, att, dependent=True)

    blocked = occ[b["cand"]]
    assert int(b["cand"].sum()) > 1000 and 0 < int(blocked.sum()) < blocked.shape[0]
    return pair, radiance, want["radiance"], want["spec_last"], (-(-n // 128), 128)


# ---------------------------------------------------------------------------
# Batches past the old 32-bit counters: the sort's 64-bit status words
# above 2^23 - 1 rays, the path step's wide count layout from 2^25 lanes,
# the traversal's 64-bit row offsets past 715,827,882 rays
# ---------------------------------------------------------------------------

# around the narrow status word's last count, and 1080p at 17 spp without
# regeneration (35,251,200 rays in one render_rays batch)
WIDE_SORT_COUNTS = [2**23 - 1, 2**23, 35_251_200]
# the main path's key (7 spatial and 2 direction bits: 4 passes), the widest
WIDE_SORT_BITS = [(7, 2), (9, 4)]


def device_rays(seed, n, dev):
    """n rays made on the card from `seed` (a host pass at these sizes
    takes seconds): origins around the three-spheres scene, directions at
    random, the first tenth one ray (ties in every key setting)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    o = torch.randn((n, 3), generator=g, device=dev) * torch.tensor([5.0, 2.0, 5.0], device=dev)
    o += torch.tensor([0.0, 2.5, 0.0], device=dev)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device=dev), dim=1)
    o[: n // 10], d[: n // 10] = o[0].clone(), d[0].clone()
    return o, d


@pytest.fixture(scope="module")
def wide_sort_inputs():
    """{n: (origins, directions, box)} for WIDE_SORT_COUNTS, on the card."""
    if not torch.cuda.is_available():  # a module fixture is set up before the function's `cuda`
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    box = build_accel(procedural.three_spheres_scene(8, 16, device=dev)).accel
    return {n: (*device_rays(n % 9973, n, dev), (box.scene_lo, box.scene_hi)) for n in WIDE_SORT_COUNTS}


@pytest.mark.parametrize("mask", ["none", "some"])
@pytest.mark.parametrize("n", WIDE_SORT_COUNTS)
def test_sort_rays_past_the_narrow_status_word(cuda, wide_sort_inputs, n, mask):
    """The radix sort one below and at the narrow status word's limit and
    at 35,251,200 rays (64-bit status words from 2^23 on), with and
    without a mask: perm equal to torch.sort(key, stable=True).indices
    over all n, the sorted rays bit-equal to the gather
    (sort_rays_plain), 1 + 4 launches."""
    o, d, box = wide_sort_inputs[n]
    active = sort_mask(mask, n, cuda)
    assert ray_sort.wide_status(n) == (n > 2**23 - 1)
    for bits in WIDE_SORT_BITS:
        (o_s, d_s, perm), launched = launch_delta(ray_sort.sort_rays, o, d, *box, *bits, active=active)
        key = ray_sort.sort_key_plain(o, d, *box, *bits, active)
        want = torch.sort(key, stable=True).indices
        o_p, d_p = ray_sort.gather_rays_plain(o, d, want, active, *box)
        torch.cuda.synchronize()
        assert launched == (1 + ray_sort.digit_passes(*bits), 0, 0) == (5, 0, 0), bits
        assert torch.equal(perm, want), bits
        assert same_bits(o_s, o_p) and same_bits(d_s, d_p), bits
        del o_s, d_s, perm, key, want, o_p, d_p


def test_sort_rays_wide_replayed_1000_times(cuda, wide_sort_inputs):
    """At 8,388,608 rays (64-bit status words): a closest-hit sort and a
    masked shadow sort on one scratch, captured in one CUDA graph and
    replayed 1,000 times (8 pass launches a replay: the 127 tags wrap
    every 16 replays), the inputs changed between replays: every checked
    replay bit-equal to the plain version, under
    set_sync_debug_mode("error")."""
    n = 2**23
    o, d, box = wide_sort_inputs[n]
    bits = (7, 2)
    masks = [sort_mask("some", n, cuda), ~sort_mask("some", n, cuda)]
    src = [(o, d), (torch.flip(o, (0,)), torch.flip(d, (0,)))]
    o_in, d_in, act_in = o.clone(), d.clone(), masks[0].clone()
    ray_sort.sort_rays(o_in, d_in, *box, *bits)  # the library and the scratch, outside the capture
    ray_sort.sort_rays(o_in, d_in, *box, *bits, active=act_in)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        closest = ray_sort.sort_rays(o_in, d_in, *box, *bits)
        shadow = ray_sort.sort_rays(o_in, d_in, *box, *bits, active=act_in)
    checked = 0
    for r in range(1000):
        k = r % 2
        o_in.copy_(src[k][0])
        d_in.copy_(src[k][1])
        act_in.copy_(masks[k])
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if r < 6 or r % 97 == 0 or r >= 996:
            want_c = ray_sort.sort_rays_plain(*src[k], *box, *bits)
            want_s = ray_sort.sort_rays_plain(*src[k], *box, *bits, masks[k])
            torch.cuda.synchronize()
            for got, want in ((closest, want_c), (shadow, want_s)):
                assert all(same_bits(g, w) for g, w in zip(got, want)), r
            checked += 1
    assert checked >= 20


def wide_path_state(lanes, seed, dev, schedule, share, nee):
    """path_state's buffers and payload at `lanes`, made on the card from
    `seed`: exactly round(share * lanes) lanes ended, payload attenuations
    with zeros, values above 1 and NaNs; reachable as the loop leaves them
    (-0.0 in accum on live lanes only, which a step makes +0.0: a payload
    radiance of -0.0 would keep it -0.0 on a lane that ends, which no loop
    reaches; the regen buffer zeroed); under NEE ("mis"), float32 env
    credits."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def vec3(lo, hi):
        return torch.rand((lanes, 3), generator=g, device=dev) * (hi - lo) + lo

    def coin(p):
        return torch.rand(lanes, generator=g, device=dev) < p

    def u32():
        return torch.randint(0, 2**32, (lanes,), generator=g, device=dev, dtype=torch.int64)

    att = vec3(0.0, 1.3)
    att[coin(0.05)] = 0.0
    att[coin(0.01), 1] = float("nan")
    tb = dict(origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=att, radiance=vec3(0.0, 4.0), seeds=u32(),
              done=coin(0.3))
    ended = torch.zeros(lanes, dtype=torch.bool, device=dev)
    ended[torch.randperm(lanes, generator=g, device=dev)[: int(round(share * lanes))]] = True
    st = dict(origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=vec3(0, 1), radiance=vec3(0, 2), seeds=u32(),
              depth=torch.randint(0, 5, (lanes,), generator=g, device=dev, dtype=torch.int32),
              done=torch.tensor(False, device=dev), segments=torch.tensor(1000, device=dev),
              shadow=torch.tensor(50, device=dev), spec_last=torch.ones(lanes, dtype=torch.bool, device=dev))
    if schedule == "rays":
        st.update(terminated=ended, result=vec3(0, 3))
    else:
        st.update(exhausted=ended, sample_i=torch.randint(0, 3, (lanes,), generator=g, device=dev,
                                                          dtype=torch.int32),
                  accum=vec3(0, 6), regen=torch.zeros(lanes, dtype=torch.bool, device=dev))
        minus = torch.zeros(lanes, dtype=torch.bool, device=dev)
        minus[::97] = True
        st["accum"][minus & ~ended] = -0.0
    if nee == "mis":
        tb["hit"] = coin(0.7)
        tb["spec_last"], st["spec_last"] = torch.rand(lanes, generator=g, device=dev), torch.rand(
            lanes, generator=g, device=dev)
    return tb, st


WIDE_PATH_LANES = (2**25 - 1, 2**25, 2**25 + 1)  # the narrow count word's last grid, the wide one's first two
# (lanes, share ended, schedule, NEE): every share without NEE; NEE with
# float32 credits at half ended
WIDE_PATH_CASES = [(n, share, schedule, "off") for n in WIDE_PATH_LANES for share in (0.0, 0.5, 1.0)
                   for schedule in ("rays", "regen")] + [
    (n, 0.5, schedule, "mis") for n in WIDE_PATH_LANES for schedule in ("rays", "regen")]


@pytest.mark.parametrize("lanes,share,schedule,nee", WIDE_PATH_CASES,
                         ids=[f"{n}-{s}-{c}-{e}" for n, s, c, e in WIDE_PATH_CASES])
def test_path_step_at_the_wide_count_word(cuda, lanes, share, schedule, nee):
    """The path step at 2^25 - 1 lanes (the one-word count's last grid)
    and at 2^25 and 2^25 + 1 (live lanes and arrivals in one word, the
    tiles not ended in another), with none, half and all of the lanes
    ended, on both schedules, and at half ended under NEE with float32
    credits (the hit sum beside the two words): every buffer, segments,
    shadow, done and the regen mask bit-equal to path_step_plain; then a
    second step on the same scratch (the words it left at 0) bit-equal
    too; one launch counted a step."""
    seed = lanes % 977 + int(10 * share) + 3 * (schedule == "regen") + 7 * (nee == "mis")
    tb, st = wide_path_state(lanes, seed, cuda, schedule, share, nee)
    kw = dict(schedule=schedule, spp=3, max_depth=4, rr_reference=False, nee=nee != "off")
    st_k = {k: v.clone() for k, v in st.items()}
    st_p = {k: v.clone() for k, v in st.items()}
    del st
    for step in range(2):
        before = fs.path_step.launches
        regen_k = fs.path_step(tb, st_k, **kw)
        regen_p = fs.path_step_plain(tb, st_p, **kw)
        torch.cuda.synchronize()
        assert fs.path_step.launches == before + 1
        assert_path_step_equal(st_k, st_p, regen_k, regen_p, (share, step))
        tb = wide_path_state(lanes, seed + 100, cuda, schedule, 0.0, nee)[0]


WIDE_STEP_LANES = (2**25 - 1, 2**25, 2**25 + 1)  # kernel 7's narrow status words' last pool, the wide ones' first two
STEP_RETIRING = ("none", "some", "every")  # lanes whose pixel the step retires


def wide_step_state(lanes, seed, dev, retiring, nee):
    """step_state's lane pool and payload at `lanes`, made on the card from
    `seed`: distinct live slots below a head near n_pix = 4 lanes, a tenth
    of the lanes retired before (but with `retiring` "every", where every
    lane is live, its path ends and its pixel is done: 2^25 lanes retire
    at once); "none": no pixel is done (every sample count 0 of 3);
    "some": sample counts at random; under NEE the payload's hit flags and
    env credits, bool, and the lanes' credits.  Returns (tb, st, n_pix,
    head, segments, shadow or None)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def vec3(lo, hi):
        return torch.rand((lanes, 3), generator=g, device=dev) * (hi - lo) + lo

    def coin(p):
        return torch.rand(lanes, generator=g, device=dev) < p

    def ints(lo, hi, dtype=torch.int32):
        return torch.randint(lo, hi, (lanes,), generator=g, device=dev, dtype=dtype)

    n_pix = 4 * lanes
    head = n_pix - lanes // 16
    slot = torch.randperm(head, generator=g, device=dev)[:lanes].to(torch.int32)
    dead = coin(0.1) if retiring != "every" else torch.zeros(lanes, dtype=torch.bool, device=dev)
    slot[dead] = n_pix + ints(0, 3)[dead]
    pix = torch.where(dead, ints(0, n_pix), slot)
    att = vec3(0.0, 1.3)
    att[coin(0.05)] = 0.0
    att[coin(0.01), 1] = float("nan")
    tb = dict(origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=att, radiance=vec3(0, 4),
              seeds=ints(0, 2**32, torch.int64), done=coin(0.3) | (retiring == "every"))
    sample_i = {"none": torch.zeros(lanes, dtype=torch.int32, device=dev), "some": ints(0, 3),
                "every": torch.full((lanes,), 2, dtype=torch.int32, device=dev)}[retiring]
    st = dict(origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=vec3(0, 1), radiance=vec3(0, 2),
              seeds=ints(0, 2**32, torch.int64), slot=slot, pix=pix, sample_i=sample_i, depth=ints(0, 5),
              lane_accum=vec3(0, 6))
    st["lane_accum"][::97] = -0.0  # the plain version's + 0.0 makes them +0.0
    shadow = None
    if nee == "on":
        tb["hit"], tb["spec_last"], st["spec_last"] = coin(0.7), coin(0.5), coin(0.5)
        shadow = torch.tensor(77, device=dev)
    return tb, st, n_pix, torch.tensor(head, device=dev), torch.tensor(1000, device=dev), shadow


def wide_pixel_map(kind, n_pix, seed, dev):
    """pixel_map's keywords made on the card: the identity, an affine
    range's 0-d base, or an id table (a permutation of the pixels)."""
    if kind != "ids":
        return pixel_map(kind, n_pix, seed, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return dict(ids=torch.randperm(n_pix, generator=g, device=dev).to(torch.int32))


WIDE_STEP_CASES = [(n, pixels, nee, retiring) for n in WIDE_STEP_LANES for pixels in ("identity", "range", "ids")
                   for nee in ("off", "on") for retiring in STEP_RETIRING]


@pytest.mark.parametrize("lanes,pixels,nee,retiring", WIDE_STEP_CASES,
                         ids=[f"{n}-{p}-{e}-{r}" for n, p, e, r in WIDE_STEP_CASES])
def test_stream_step_wide_matches_plain(cuda, lanes, pixels, nee, retiring):
    """Kernel 7 at 2^25 - 1 lanes (the narrow status words' last pool) and
    at 2^25 and 2^25 + 1 (two words a tile), on every pixel map, NEE off
    and on, with no lane, some and every lane retiring its pixel: the
    state, the image, the regen mask, head, segments, the live count and
    the shadow count bit-equal to the plain version; then a second step
    from each one's result on the same scratch, with a new payload,
    bit-equal too; one launch counted a step."""
    case = WIDE_STEP_CASES.index((lanes, pixels, nee, retiring))
    tb, st, n_pix, head, segments, shadow = wide_step_state(lanes, case, cuda, retiring, nee)
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=case % 2 == 0, inv_spp=1.0 / 3,
              **wide_pixel_map(pixels, n_pix, case, cuda))
    st_k = {k: v.clone() for k, v in st.items()}
    st_p = st
    out_k = torch.zeros((n_pix + 1, 3), device=cuda)
    out_p = torch.zeros_like(out_k)
    res_k = res_p = (None, head, segments, None, shadow)
    for step in range(2):
        before = fs.fused_stream_step.launches
        res_k = fs.fused_stream_step(tb, st_k, out_k, res_k[1], res_k[2], res_k[4] if nee == "on" else None, **kw)
        res_p = fs.fused_stream_step_plain(tb, st_p, out_p, res_p[1], res_p[2], res_p[4] if nee == "on" else None,
                                           **kw)
        torch.cuda.synchronize()
        assert fs.fused_stream_step.launches == before + 1
        assert_stream_step_equal(st_k, st_p, out_k, out_p, res_k, res_p, step)
        if step == 0:
            retired = int(res_k[1]) - int(head)
            assert retired == {"none": 0, "every": lanes}.get(retiring, retired) and (retiring != "some" or retired)
        tb = wide_step_state(lanes, case + 1000, cuda, "some", nee)[0]
    del st_k, st_p, out_k, out_p, tb
    torch.cuda.empty_cache()


def test_stream_step_wide_repeated_past_the_tag_wrap(cuda):
    """One step at 2^25 lanes launched 4,100 times on one never-cleared
    scratch (more than the 4,095 tags a status word cycles through), each
    from a fresh copy of the state: every launch's slots, regen mask,
    head', segments', live and shadow counts equal the plain version's,
    and the last three launches equal it in every field and the image."""
    lanes = 2**25
    tb, st, n_pix, head, segments, shadow = wide_step_state(lanes, 4100, cuda, "some", "on")
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=False, inv_spp=1.0 / 3,
              **wide_pixel_map("ids", n_pix, 5, cuda))
    st_p = {k: v.clone() for k, v in st.items()}
    out_p = torch.zeros((n_pix + 1, 3), device=cuda)
    want = fs.fused_stream_step_plain(tb, st_p, out_p, head, segments, shadow, **kw)
    st_k = {k: v.clone() for k, v in st.items()}
    out_k = torch.zeros_like(out_p)
    bad = torch.zeros((), dtype=torch.int64, device=cuda)
    launches = 4100
    for r in range(launches):
        for k, v in st.items():
            st_k[k].copy_(v)
        if r >= launches - 3:
            out_k.zero_()
        got = fs.fused_stream_step_cuda(tb, st_k, out_k, head, segments, shadow, **kw)
        bad += (st_k["slot"] != st_p["slot"]).sum() + (got[0] != want[0]).sum()
        bad += sum((a != b).long() for a, b in zip(got[1:], want[1:]))
        if r >= launches - 3:
            torch.cuda.synchronize()
            assert_stream_step_equal(st_k, st_p, out_k, out_p, got, want, r)
    assert int(bad) == 0 and int(want[1]) > int(head)
    del st_k, st_p, out_k, out_p
    torch.cuda.empty_cache()


def test_stream_step_narrow_and_wide_alternated(cuda):
    """2^25 - 1 and 2^25 lanes take the same 131,072 tiles in the two
    layouts: the wrapper gives each its own scratch (fs._scratch, of
    3 + 131,072 and 3 + 262,144 words), and six steps alternated between
    the two, each from its own state's last result, stay bit-equal to the
    plain version."""
    dev = cuda
    pools = {}
    for lanes in (2**25 - 1, 2**25):
        tb, st, n_pix, head, segments, _ = wide_step_state(lanes, lanes % 101, dev, "some", "off")
        pools[lanes] = dict(tb=tb, st_k={k: v.clone() for k, v in st.items()}, st_p=st, head_k=head, head_p=head,
                            seg_k=segments, seg_p=segments, n_pix=n_pix,
                            out_k=torch.zeros((n_pix + 1, 3), device=dev), out_p=torch.zeros((n_pix + 1, 3), device=dev))
    narrow, wide = fs._scratch(dev, 0, 2**25 - 1), fs._scratch(dev, 0, 2**25)
    assert narrow is not wide and (narrow.shape[0], wide.shape[0]) == (3 + 131_072, 3 + 2 * 131_072)
    for step in range(6):
        lanes = (2**25 - 1, 2**25)[step % 2]
        p = pools[lanes]
        kw = dict(spp=3, n_pix=p["n_pix"], max_depth=4, rr_reference=True, inv_spp=1.0 / 3)
        got = fs.fused_stream_step_cuda(p["tb"], p["st_k"], p["out_k"], p["head_k"], p["seg_k"], **kw)
        want = fs.fused_stream_step_plain(p["tb"], p["st_p"], p["out_p"], p["head_p"], p["seg_p"], **kw)
        torch.cuda.synchronize()
        assert_stream_step_equal(p["st_k"], p["st_p"], p["out_k"], p["out_p"], got, want, step)
        p.update(head_k=got[1], seg_k=got[2], head_p=want[1], seg_p=want[2])
    del pools
    torch.cuda.empty_cache()


def far_rays(n, tail, dev):
    """n rays whose last `tail` are rays() toward the three-spheres scene
    and the rest parked at (3e37, 0, 0) pointing +x (they meet no box)."""
    o = torch.empty((n, 3), device=dev)
    d = torch.empty((n, 3), device=dev)
    o[: n - tail] = torch.tensor([3.0e37, 0.0, 0.0], device=dev)
    d[: n - tail] = torch.tensor([1.0, 0.0, 0.0], device=dev)
    o_t, d_t = (x.to(dev) for x in rays(31, tail, parked=0))
    o[n - tail:], d[n - tail:] = o_t, d_t
    return o, d, o_t, d_t


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_traversal_past_a_32_bit_row_offset(cuda, any_hit):
    """The flat traversal kernels (1 and 4) on 716,800,000 rays, where 3 i
    (a ray's first float) passes 2^31 from ray 715,827,883 on: the last
    131,072 rays' Hit (closest hit, restored in the kernel's store) and
    occluded flags bit-equal to the same kernel on those rays alone (the
    same packets of 1,024); the rest, parked, miss."""
    gc.collect()  # ~30 GB: nothing of earlier tests may hold the card
    torch.cuda.empty_cache()
    n, tail = 700_000 * 1024, 131_072
    assert 3 * (n - tail) > 2**31
    acc = build_accel(procedural.three_spheres_scene(8, 16, device=cuda)).accel
    o, d, o_t, d_t = far_rays(n, tail, cuda)
    fn = ic.occluded_clusters_cuda if any_hit else ic.intersect_clusters_cuda
    args = (acc.tris16bw, acc.aabb8, acc.order)
    got = fn(*args, o, d, 0.01, 1e16, 1024, restore=True)
    want = fn(*args, o_t, d_t, 0.01, 1e16, 1024, restore=True)
    torch.cuda.synchronize()
    if any_hit:
        assert torch.equal(got[n - tail:], want) and not bool(got[: n - tail].any())
        assert int(want.sum()) > 1000
    else:
        for f in ("t", "prim", "bary", "hit"):
            assert same_bits(getattr(got, f)[n - tail:], getattr(want, f)), f
        assert not bool(got.hit[: n - tail].any()) and int(want.hit.sum()) > 1000
    del got, want, o, d
    torch.cuda.empty_cache()
