"""The graphed loop's plans (render/graph_loop.py) on the CPU, where a
plan calls its step directly: one cached plan serves every frame of its
(scene, config, schedule, shape), its per-frame inputs (subframe, sample
offset, camera, pixel ids, an affine range's base) read from its buffers,
so that its images, segments, shadow segments and iterations equal a
fresh eager render's bit for bit on every schedule, fused and unfused,
with NEE and on an affine range; the six tiles of a frame share one
plan; a replay adds the launch counts recorded over the captured
iteration; the cache's bound evicts; deferred shading is never captured;
and a reused plan's frame agrees with the JAX package's render_frame."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several worker processes: one intra-op thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.accel.build import build_accel as j_build_accel  # noqa: E402
from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.render import integrator as j_integ  # noqa: E402
from tpu_pathtracer.render.camera import Camera as JCamera  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402

from tpu_pathtracer_torch.accel import cluster as cluster_mod  # noqa: E402
from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import intersect_cluster as ic  # noqa: E402
from tpu_pathtracer_torch.ops import unit_sphere  # noqa: E402
from tpu_pathtracer_torch.render import graph_loop, integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.render.envmap import with_importance_sampling  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402
from tpu_pathtracer_torch.scene.scene import make_env  # noqa: E402
from tpu_pathtracer_torch.utils.image import procedural_hdr  # noqa: E402

BASE = dict(width=64, height=48, samples_per_launch=2, max_depth=4, dof=False, intersector="cluster",
            env_mode="sunsky", stream_lanes=512)
NEE = dict(env_mode="equirect", rr_mode="standard", env_importance_sampling=True)
CAMERAS = (Camera(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0)), Camera(eye=(1.0, 1.5, 7.0), lookat=(0.0, 1.0, 0.0)))
# (subframe, camera, sample_offset) of the frames one plan renders
FRAMES = ((0, 0, 0), (1, 0, 0), (2, 1, 2))
# name: (config overrides, render_pixels' pixel_ids, the schedule it takes)
CASES = {
    "rays": (dict(samples_per_launch=1), None, "rays"),
    "rays_nee": (dict(NEE, samples_per_launch=1), None, "rays"),
    "regen": (dict(stream_lanes=4096), None, "regen"),
    "regen_range": (dict(stream_lanes=4096), "range", "regen"),
    "stream": (dict(fused_schedule="off"), None, "stream"),
    "stream_fused": (dict(fused_schedule="on"), None, "stream_fused"),
    "stream_nee": (NEE, None, "stream"),
    "stream_range": ({}, "range", "stream"),
    "stream_ids": ({}, "ids", "stream"),
}


def scene_for(cfg):
    scene = procedural.three_spheres_scene(8, 16, device="cpu")
    if cfg.env_importance_sampling:
        scene = scene.replace(env=with_importance_sampling(make_env(procedural_hdr(16, 32), "cpu")))
    return build_accel(scene)


def pixels(kind, n_pix):
    """render_pixels' pixel_ids of `kind`: an affine range, a reversed
    id list with a stride, or the whole frame."""
    if kind == "range":
        return (512, n_pix - 1024)
    if kind == "ids":
        return torch.arange(n_pix - 1, -1, -3, dtype=torch.int32)
    return None


def frames(scene, cfg, kind):
    """[(image, stats)] of FRAMES through render_pixels."""
    out = []
    for subframe, camera, offset in FRAMES:
        cam = camera_arrays(CAMERAS[camera], cfg, "cpu")
        out.append(integrator.render_pixels(scene, cam, cfg, pixels(kind, cfg.width * cfg.height), subframe,
                                            sample_offset=offset, return_stats=True))
    return out


def same(a, b):
    """Images bit-equal; iterations, segments and shadow segments equal."""
    (img_a, st_a), (img_b, st_b) = a, b
    assert torch.equal(img_a, img_b)
    for k in ("iters", "segments", "shadow_segments"):
        assert int(st_a[k]) == int(st_b[k]), k


@pytest.mark.parametrize("which", list(CASES))
def test_one_plan_serves_every_frame(which):
    """One cached plan renders subframes 0, 1 and 2 with two sample
    offsets and two cameras; each frame equals a fresh eager render of it
    (a Python number baked into the step would repeat the first frame's)."""
    overrides, kind, sched = CASES[which]
    cfg = RenderConfig(**{**BASE, **overrides})
    scene = scene_for(cfg)
    graph_loop.clear()
    reused = frames(scene, cfg, kind)
    assert len(graph_loop._plans) == 1
    with graph_loop.eager():
        fresh = frames(scene, cfg, kind)
    assert len(graph_loop._plans) == 1
    for a, b in zip(reused, fresh):
        assert a[1]["schedule"] == b[1]["schedule"] == sched
        assert not a[1]["graphed"] and not b[1]["graphed"]  # the CPU runs the step directly
        same(a, b)
    assert (int(reused[0][1]["shadow_segments"]) > 0) == cfg.env_importance_sampling
    assert not torch.equal(reused[0][0], reused[1][0])  # the subframe reaches the step
    assert not torch.equal(reused[1][0], reused[2][0])  # and the camera and sample offset


@pytest.mark.parametrize("spp", [1, 2], ids=["rays", "stream"])
def test_tiles_share_one_plan(spp):
    """The six tiles of a tiled frame, and the tiles of the next frame,
    render through one plan; each frame equals a fresh eager one."""
    cfg = RenderConfig(**{**BASE, "samples_per_launch": spp, "tile_pixels": 512, "stream_lanes": 256})
    scene = scene_for(cfg)
    cam = camera_arrays(CAMERAS[0], cfg, "cpu")
    graph_loop.clear()
    reused = [integrator.render_frame_stats(scene, cam, cfg, k) for k in (1, 2)]
    assert len(graph_loop._plans) == 1
    assert reused[0][1]["schedule"] == ("rays" if spp == 1 else "stream")
    with graph_loop.eager():
        for k, a in zip((1, 2), reused):
            same(a, integrator.render_frame_stats(scene, cam, cfg, k))


class FakeGraph:
    """Stands in for a captured CUDA graph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_add_the_captured_increments(monkeypatch):
    """The launches recorded over one call of a step (with the wrappers
    counting on the CPU as they count on the card) are set back after the
    call, and N replays of the plan add N times them."""
    def counting(real, counter):
        def call(*args, **kwargs):
            counter.launches += 1
            return real(*args, **kwargs)
        return call

    monkeypatch.setattr(integrator, "random_in_unit_sphere",
                        counting(integrator.random_in_unit_sphere, unit_sphere.random_in_unit_sphere))
    monkeypatch.setattr(cluster_mod, "intersect_clusters", counting(ic.intersect_clusters, ic.intersect_clusters))
    cfg = RenderConfig(**{**BASE, "fused_schedule": "off"})
    scene = scene_for(cfg)
    graph_loop.clear()
    integrator.render_frame_stats(scene, camera_arrays(CAMERAS[0], cfg, "cpu"), cfg, 0)
    plan = next(iter(graph_loop._plans.values()))
    before = graph_loop.launch_counts()
    increments = graph_loop.record_launches(plan._step)
    assert graph_loop.launch_counts() == before
    named = dict(zip((f.__name__ for f in graph_loop.COUNTED), increments))
    assert named == {**dict.fromkeys(named, 0), "intersect_clusters": 1, "random_in_unit_sphere": 1}
    plan.graphed, plan.graph, plan.increments = True, FakeGraph(), increments
    iterations = graph_loop.stats["iterations"]
    for _ in range(5):
        plan.step()
    assert plan.graph.replays == 5 and graph_loop.stats["iterations"] == iterations + 5
    assert graph_loop.launch_counts() == tuple(b + 5 * n for b, n in zip(before, increments))
    graph_loop.clear()


def test_cache_bound_evicts(monkeypatch):
    """Past MAX_PLANS the least recently used plan goes; rendering its
    config again builds a new one."""
    monkeypatch.setattr(graph_loop, "MAX_PLANS", 2)
    scene = scene_for(RenderConfig(**BASE))
    cfgs = [RenderConfig(**{**BASE, "width": 16, "height": 12, "samples_per_launch": 1, "max_depth": d})
            for d in (1, 2, 3)]
    cam = camera_arrays(CAMERAS[0], cfgs[0], "cpu")
    graph_loop.clear()
    made = []
    for cfg in cfgs[:2]:
        integrator.render_frame(scene, cam, cfg, 0)
        made.append(next(reversed(graph_loop._plans.values())))
    integrator.render_frame(scene, cam, cfgs[0], 1)  # the first is now the most recent
    integrator.render_frame(scene, cam, cfgs[2], 0)
    plans = list(graph_loop._plans.values())
    assert len(plans) == 2 and plans[0] is made[0] and made[1] not in plans
    integrator.render_frame(scene, cam, cfgs[1], 0)
    assert next(reversed(graph_loop._plans.values())) is not made[1]
    graph_loop.clear()


@pytest.mark.parametrize("nee", [False, True], ids=["dense", "nee"])
def test_deferred_shading_is_not_captured(monkeypatch, nee):
    """Deferred shading reads the device inside its step, so its plan is
    never capturable and its stats say it was not graphed; under NEE it
    keeps the dense shade, whose loop is capturable."""
    asked = []
    real = graph_loop.plan

    def spy(key, scene, build, capturable=True, **kw):
        asked.append(capturable)
        return real(key, scene, build, capturable, **kw)

    monkeypatch.setattr(graph_loop, "plan", spy)
    cfg = RenderConfig(**{**BASE, **(NEE if nee else {}), "deferred_shade": True})
    _, stats = integrator.render_frame_stats(scene_for(cfg), camera_arrays(CAMERAS[0], cfg, "cpu"), cfg, 0)
    assert asked == [nee] and stats["graphed"] is False
    graph_loop.clear()


def test_reused_plan_matches_jax():
    """The third frame of one plan (subframe 2, after subframes 0 and 1)
    against the JAX package's render_frame at subframe 2 (Pallas kernels
    in interpret mode), with test_torch_render's tolerance: at least 99%
    of values within rtol 1e-3, atol 1e-4, each channel's mean within 1%."""
    cfg = RenderConfig(**{**BASE, "stream_lanes": 256})
    scene = scene_for(cfg)
    cam = camera_arrays(CAMERAS[0], cfg, "cpu")
    graph_loop.clear()
    for k in (0, 1):
        integrator.render_frame(scene, cam, cfg, k)
    timg = integrator.render_frame(scene, cam, cfg, 2).numpy()
    assert len(graph_loop._plans) == 1
    graph_loop.clear()
    j = j_build_accel(j_proc.three_spheres_scene(8, 16), kind="cluster")
    jcfg = JConfig(**{**BASE, "stream_lanes": 256})
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    try:
        jax.clear_caches()
        cam_j = JCamera(eye=CAMERAS[0].eye, lookat=CAMERAS[0].lookat)
        jimg = np.asarray(j_integ.render_frame(j, j_integ.camera_arrays(cam_j, jcfg), jcfg, jnp.int32(2)))
    finally:
        mp.undo()
        jax.clear_caches()
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, f"only {close.mean():.4%} of values agree"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=1e-2)
