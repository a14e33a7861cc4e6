"""The port on an NVIDIA GPU: the packet-traversal CUDA kernels (flat,
two-level, streamed; closest hit and any hit; Baldwin-Weber and
Moller-Trumbore), the fused schedule step and the unit-ball sampler
against their plain PyTorch versions, small renders on the card, with and
without next-event estimation, against the same renders on the CPU, the
fused schedule's render against the unfused one, and every schedule's
iteration free of stream syncs but its own read; deferred shading against
the dense shade, sharded frames (NCCL in a group of one, gloo across two
processes on one card) against render_frame, and renders against the
numpy oracle.  Every test needs a card and skips without one; this
file imports no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import fused_schedule as fs  # noqa: E402
from tpu_pathtracer_torch.ops import intersect_cluster as ic  # noqa: E402
from tpu_pathtracer_torch.ops import unit_sphere  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.render.film import post_process  # noqa: E402
from tpu_pathtracer_torch.render import integrator  # noqa: E402
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
    equals the unfused render on the card bit for bit, with the same
    iterations and segments."""
    res = {}
    scene = build_accel(procedural.three_spheres_scene(8, 16, device=cuda))
    for mode in ("on", "off"):
        cfg = RenderConfig(width=64, height=48, samples_per_launch=3, max_depth=4, dof=False, stream_lanes=512,
                           intersector="cluster", env_mode="sunsky", rr_mode=rr_mode, fused_schedule=mode)
        assert _fused_stream_ok(cfg, None, 512, cuda) == (mode == "on")
        before = fs.fused_stream_step.launches
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
