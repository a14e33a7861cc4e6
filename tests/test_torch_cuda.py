"""The port on an NVIDIA GPU: the packet-traversal CUDA kernels (flat,
two-level, streamed; closest hit and any hit; Baldwin-Weber and
Moller-Trumbore) against their plain PyTorch versions, and small renders
on the card, with and without next-event estimation, against the same
renders on the CPU.  Every test needs a card and skips without one; this
file imports no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import intersect_cluster as ic  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.render.film import post_process  # noqa: E402
from tpu_pathtracer_torch.render.integrator import render_frame_stats  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402
from tpu_pathtracer_torch.utils.ssim import ssim  # noqa: E402

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
