"""The PyTorch port's render paths against the JAX package's render_frame
(Pallas kernels in interpret mode), with and without next-event
estimation (NEE): the stream, one lane per pixel, one lane per sample (1
spp) and tile_pixels; the film chain, the goldens, and the branches that
are not ported yet."""

import os

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
from tpu_pathtracer.render import envmap as j_envmap  # noqa: E402
from tpu_pathtracer.render import film as j_film  # noqa: E402
from tpu_pathtracer.render import integrator as j_integ  # noqa: E402
from tpu_pathtracer.render.camera import Camera as JCamera  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402
from tpu_pathtracer.scene import scene as j_scene  # noqa: E402
from tpu_pathtracer.utils.image import procedural_hdr  # noqa: E402

from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.render import envmap, film, integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.scene import procedural, scene  # noqa: E402
from tpu_pathtracer_torch.utils.ssim import ssim  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

# 64x48 at 2 spp with a 256-lane pool takes the streaming schedule (at
# auto lanes a 3072-pixel frame would take render_pixels_regen).
CFG = dict(
    width=64, height=48, samples_per_launch=2, max_depth=4, dof=False,
    stream_lanes=256, intersector="cluster", env_mode="equirect",
)
EYE = dict(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0))


@pytest.fixture(scope="module")
def renders():
    """(port image, port stats, JAX image, JAX stats) for subframe 3."""
    hdr = procedural_hdr(32, 64)
    j = j_build_accel(j_proc.three_spheres_scene(8, 16).replace(env=j_scene.make_env(hdr)), kind="cluster")
    t = build_accel(procedural.three_spheres_scene(8, 16, device="cpu").replace(env=scene.make_env(hdr, "cpu")))
    jcfg, tcfg = JConfig(**CFG), RenderConfig(**CFG)
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    try:
        # render_frame is jitted on the static cfg and reads the variable
        # while tracing: start from an empty cache.
        jax.clear_caches()
        jimg, jstats = j_integ.render_frame_stats(
            j, j_integ.camera_arrays(JCamera(**EYE), jcfg), jcfg, jnp.int32(3)
        )
        jimg = np.asarray(jimg)
        jstats = {k: int(v) for k, v in jstats.items()}
    finally:
        mp.undo()
        jax.clear_caches()
    timg, tstats = integrator.render_frame_stats(t, camera_arrays(Camera(**EYE), tcfg, "cpu"), tcfg, 3)
    return timg.numpy(), tstats, jimg, jstats


def test_render_frame_matches_jax(renders):
    """At least 99% of values within rtol 1e-3, atol 1e-4 (measured 99.97%:
    the rest are paths that one rounding sent another way) and each
    channel's mean within 1%."""
    timg, _, jimg, _ = renders
    assert timg.shape == jimg.shape == (48, 64, 3)
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, f"only {close.mean():.4%} of values agree"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)
    assert np.isfinite(timg).all() and timg.max() > 0


def test_render_segments_match_jax(renders):
    _, tstats, _, jstats = renders
    seg_t, seg_j = int(tstats["segments"]), jstats["segments"]
    assert abs(seg_t - seg_j) <= 0.005 * seg_j
    assert int(tstats["shadow_segments"]) == jstats["shadow_segments"] == 0
    assert tstats["iters"] > 1  # the pool of 256 lanes streamed the frame


def test_post_process_matches_jax(renders):
    timg, _, jimg, _ = renders
    for cfg in (dict(), dict(srgb_output=False, exposure=0.3, contrast=1.0)):
        got = film.post_process(torch.tensor(jimg), RenderConfig(**cfg)).numpy()
        want = np.asarray(j_film.post_process(jnp.asarray(jimg), JConfig(**cfg)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_to_uint8_and_accumulate_match_jax(renders):
    timg, _, jimg, _ = renders
    rgb = np.asarray(j_film.post_process(jnp.asarray(jimg), JConfig()))
    got = film.to_uint8(torch.tensor(rgb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_film.to_uint8(jnp.asarray(rgb))))
    for k in (0, 1, 5):
        got = film.accumulate(torch.tensor(jimg), torch.tensor(timg), k).numpy()
        want = np.asarray(j_film.accumulate(jnp.asarray(jimg), jnp.asarray(timg), jnp.int32(k)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def hier_renders():
    """The `renders` frame on the two-level route: three spheres (8, 16)
    in clusters of 8 give 97 clusters, at or above hier_min_clusters.
    (port image, port stats, JAX image, JAX stats) for subframe 1."""
    hdr = procedural_hdr(32, 64)
    j = j_build_accel(j_proc.three_spheres_scene(8, 16).replace(env=j_scene.make_env(hdr)),
                      kind="cluster", cluster_size=8)
    t = build_accel(procedural.three_spheres_scene(8, 16, device="cpu").replace(env=scene.make_env(hdr, "cpu")),
                    cluster_size=8)
    jcfg, tcfg = JConfig(**CFG), RenderConfig(**CFG)
    assert t.accel.num_clusters == 97 and t.accel.route(tcfg) == "hier"
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    try:
        jax.clear_caches()
        jimg, jstats = j_integ.render_frame_stats(
            j, j_integ.camera_arrays(JCamera(**EYE), jcfg), jcfg, jnp.int32(1)
        )
        jimg = np.asarray(jimg)
        jstats = {k: int(v) for k, v in jstats.items()}
    finally:
        mp.undo()
        jax.clear_caches()
    timg, tstats = integrator.render_frame_stats(t, camera_arrays(Camera(**EYE), tcfg, "cpu"), tcfg, 1)
    return timg.numpy(), tstats, jimg, jstats


def test_render_frame_hier_matches_jax(hier_renders):
    """The render_frame_matches_jax rule on the two-level route."""
    timg, _, jimg, _ = hier_renders
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, f"only {close.mean():.4%} of values agree"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)
    assert np.isfinite(timg).all() and timg.max() > 0


def test_render_segments_hier_match_jax(hier_renders):
    _, tstats, _, jstats = hier_renders
    seg_t, seg_j = int(tstats["segments"]), jstats["segments"]
    assert abs(seg_t - seg_j) <= 0.005 * seg_j
    assert tstats["iters"] > 1


def test_render_dof_standard_rr_matches_jax(monkeypatch):
    """Thin-lens camera (its discarded local chain and double sqrt),
    textbook Russian roulette and the sun+sky environment, at 32x24."""
    kw = dict(CFG, width=32, height=24, stream_lanes=128, dof=True, rr_mode="standard", env_mode="sunsky")
    j = j_build_accel(j_proc.three_spheres_scene(6, 12), kind="cluster")
    t = build_accel(procedural.three_spheres_scene(6, 12, device="cpu"))
    jcfg, tcfg = JConfig(**kw), RenderConfig(**kw)
    monkeypatch.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    try:
        jimg = np.asarray(j_integ.render_frame(j, j_integ.camera_arrays(JCamera(**EYE), jcfg), jcfg, jnp.int32(1)))
    finally:
        jax.clear_caches()
    timg = integrator.render_frame(t, camera_arrays(Camera(**EYE), tcfg, "cpu"), tcfg, 1).numpy()
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, f"only {close.mean():.4%} of values agree"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)


NEE_MODES = {
    "nee": {},
    "defensive": dict(nee_defensive_mix=True),
    "mis_spec": dict(nee_mis_spec=True),
    "defensive_mis_spec": dict(nee_defensive_mix=True, nee_mis_spec=True),
}
NEE_CASES = [("flat", mode) for mode in NEE_MODES] + [("hier", mode) for mode in NEE_MODES]


@pytest.fixture(scope="module", params=NEE_CASES, ids=[f"{r}-{m}" for r, m in NEE_CASES])
def nee_renders(request):
    """(port image, port stats, JAX image, JAX stats) of an NEE render with
    textbook RR and the alias-table environment: 64x48 on the flat route
    (14 clusters of 128), 32x24 on the two-level route (97 clusters of 8)."""
    route, mode = request.param
    hdr = procedural_hdr(32, 64)
    cluster_size = 128 if route == "flat" else 8
    j = j_build_accel(
        j_proc.three_spheres_scene(8, 16).replace(env=j_envmap.with_importance_sampling(j_scene.make_env(hdr))),
        kind="cluster", cluster_size=cluster_size,
    )
    t = build_accel(
        procedural.three_spheres_scene(8, 16, device="cpu").replace(
            env=envmap.with_importance_sampling(scene.make_env(hdr, "cpu"))),
        cluster_size=cluster_size,
    )
    kw = dict(CFG, rr_mode="standard", env_importance_sampling=True, **NEE_MODES[mode])
    if route == "hier":
        kw.update(width=32, height=24, stream_lanes=128)
    jcfg, tcfg = JConfig(**kw), RenderConfig(**kw)
    assert t.accel.route(tcfg) == route
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    try:
        jax.clear_caches()
        jimg, jstats = j_integ.render_frame_stats(
            j, j_integ.camera_arrays(JCamera(**EYE), jcfg), jcfg, jnp.int32(2)
        )
        jimg = np.asarray(jimg)
        jstats = {k: int(v) for k, v in jstats.items()}
    finally:
        mp.undo()
        jax.clear_caches()
    timg, tstats = integrator.render_frame_stats(t, camera_arrays(Camera(**EYE), tcfg, "cpu"), tcfg, 2)
    return timg.numpy(), tstats, jimg, jstats


def test_render_nee_matches_jax(nee_renders):
    """The render_frame_matches_jax rule (99% of values within rtol 1e-3,
    atol 1e-4; channel means within 1%) with NEE shadow rays through the
    any-hit traversal of each route, in each NEE mode."""
    timg, _, jimg, _ = nee_renders
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, f"only {close.mean():.4%} of values agree"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)
    assert np.isfinite(timg).all() and timg.max() > 0


def test_render_nee_segments_match_jax(nee_renders):
    """Segments and shadow segments (every live lane that hit) within 0.5%."""
    _, tstats, _, jstats = nee_renders
    for key in ("segments", "shadow_segments"):
        got, want = int(tstats[key]), jstats[key]
        assert abs(got - want) <= 0.005 * want, (key, got, want)
    assert 0 < jstats["shadow_segments"] < jstats["segments"]


def test_nee_mean_matches_bsdf_sampling():
    """As tests/test_envmap.py's mean-convergence check, on the port: NEE
    and plain BSDF sampling estimate the same image.  A diffuse sphere
    under a sun-heavy sky, 16x12 at 64 spp in 8 launches, brute force:
    the image means agree within 3% and the median pixel within 8%."""
    env = envmap.with_importance_sampling(scene.make_env(procedural_hdr(16, 32, seed=7, sun_intensity=40.0), "cpu"))
    t = procedural.single_sphere_scene(stacks=8, slices=16, device="cpu").replace(env=env)
    base = dict(width=16, height=12, samples_per_launch=8, max_depth=4, dof=False, env_mode="equirect",
                intersector="brute", rr_mode="standard", stream_lanes=96)
    means = []
    for nee in (False, True):
        cfg = RenderConfig(**base, env_importance_sampling=nee)
        cam = camera_arrays(Camera(), cfg, "cpu")
        acc = torch.zeros((cfg.height, cfg.width, 3))
        for k in range(8):
            acc = film.accumulate(acc, integrator.render_frame(t, cam, cfg, k), k)
        assert bool(torch.isfinite(acc).all())
        means.append(acc.numpy())
    img_b, img_n = means
    assert abs(img_b.mean() - img_n.mean()) / img_b.mean() < 0.03, (img_b.mean(), img_n.mean())
    assert np.median(np.abs(img_b - img_n) / (img_b + 0.05)) < 0.08


def test_nee_requires_alias_table():
    t = procedural.single_sphere_scene(stacks=4, slices=8, device="cpu")
    cfg = RenderConfig(**dict(CFG, intersector="brute", rr_mode="standard", env_importance_sampling=True))
    with pytest.raises(ValueError, match="alias table"):
        integrator.render_frame(t, camera_arrays(Camera(**EYE), cfg, "cpu"), cfg, 0)


def nee_golden_scene():
    env = envmap.with_importance_sampling(scene.make_env(procedural_hdr(32, 64), "cpu"))
    return procedural.three_spheres_scene(stacks=8, slices=16, device="cpu").replace(env=env)


GOLDENS = {
    # name: (scene, camera, config) of tests/test_golden.py
    "sphere_constant": (
        lambda: procedural.single_sphere_scene(stacks=10, slices=20, device="cpu"), {},
        dict(samples_per_launch=4, max_depth=6, env_mode="constant"),
    ),
    "spheres_sunsky_dof": (
        lambda: procedural.three_spheres_scene(stacks=8, slices=16, device="cpu"), dict(eye=(0, 2, 8)),
        dict(samples_per_launch=2, max_depth=4, dof=True, env_mode="sunsky"),
    ),
}
NEE_GOLDEN = (
    nee_golden_scene, dict(eye=(0, 2, 8)),
    dict(samples_per_launch=2, max_depth=4, env_mode="equirect", env_importance_sampling=True,
         rr_mode="standard"),
)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_images(name):
    """The committed goldens under tests/test_golden.py's rule (exact, else
    SSIM > 0.995 and atol 5e-3).  They were rendered by the one-lane-per-
    pixel schedule; a 256-lane pool takes the stream instead, which gives
    each pixel the same samples in the same order."""
    img, golden = render_golden(name, *GOLDENS[name])
    if not np.array_equal(img, golden):
        assert ssim(img, golden) > 0.995
        np.testing.assert_allclose(img, golden, atol=5e-3)


def render_golden(name, make, eye, kw, stream_lanes=256):
    """(the port's image, the committed golden) for tests/test_golden.py's
    `name`: two subframes averaged, then post_process."""
    cfg = RenderConfig(**{**dict(width=64, height=48, dof=False, intersector="brute", stream_lanes=stream_lanes),
                          **kw})
    scene_ = make()
    cam = camera_arrays(Camera(**eye), cfg, "cpu")
    acc = (integrator.render_frame(scene_, cam, cfg, 0) + integrator.render_frame(scene_, cam, cfg, 1)) / 2.0
    return film.post_process(acc, cfg).numpy(), np.load(f"{GOLDEN_DIR}/{name}.npz")["img"]


def test_golden_nee_image():
    """The spheres_nee golden (alias-table NEE, textbook RR, brute force)
    under tests/test_golden.py's rule, SSIM above 0.995 and atol 5e-3, on
    every pixel but those whose path took another turn on a rounding: at
    most 0.1% of the 3,072 pixels.  Measured: one pixel, (27, 37), is off
    by 0.53 after post_process, while brute-force hits and shadow flags
    agree with the JAX package on every ray of the render and the JAX
    stream schedule gives the golden to 3e-7; XLA:CPU's fused
    multiply-adds in the shading round differently (see
    test_torch_intersect.assert_close_fma)."""
    img, golden = render_golden("spheres_nee", *NEE_GOLDEN)
    assert ssim(img, golden) > 0.995
    close = np.isclose(img, golden, rtol=0.0, atol=5e-3).all(axis=-1)
    assert close.mean() >= 0.999, f"{(~close).sum()} pixels off"


def test_stream_image_independent_of_pool_size():
    """Seeds key off (pixel, sample, subframe), so the lane pool changes
    only the order pixels are taken in, never a pixel's value."""
    t = build_accel(procedural.three_spheres_scene(6, 12, device="cpu"))
    kw = dict(CFG, width=32, height=24, env_mode="sunsky")
    imgs = []
    for lanes in (64, 256):
        cfg = RenderConfig(**dict(kw, stream_lanes=lanes))
        imgs.append(integrator.render_frame(t, camera_arrays(Camera(**EYE), cfg, "cpu"), cfg, 0).numpy())
    np.testing.assert_array_equal(imgs[0], imgs[1])


@pytest.mark.parametrize("n_pix", [64 * 48, 512 * 512, 1920 * 1080, 4096 * 4096])
def test_resolve_stream_lanes_matches_jax(n_pix):
    for lanes in (0, 1024):
        assert integrator.resolve_stream_lanes(RenderConfig(stream_lanes=lanes), n_pix) == \
            j_integ.resolve_stream_lanes(JConfig(stream_lanes=lanes), n_pix)


SCHEDULE_BRANCHES = {
    # name: (config, the schedule function the frame must go through, the
    # schedule the frame's stats report)
    "regen": (dict(stream_lanes=0), "render_pixels_regen", "regen"),
    "render_rays": (dict(samples_per_launch=1), "render_rays", "rays"),
    "tile_pixels": (dict(tile_pixels=512), "render_pixels_stream", "stream"),
}


@pytest.mark.parametrize("branch", sorted(SCHEDULE_BRANCHES))
def test_schedule_branches_render(monkeypatch, branch):
    """The branches that once raised NotImplementedError render: one lane
    per pixel (a frame no larger than the lane pool), one lane per sample
    (1 spp) and tile_pixels (six tiles, each streamed from a pixel-id
    array); each goes through its schedule, reports it, and gives a
    finite, lit frame."""
    kw, schedule, reported = SCHEDULE_BRANCHES[branch]
    calls = []
    real = getattr(integrator, schedule)

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(integrator, schedule, spy)
    t = procedural.single_sphere_scene(stacks=4, slices=8, device="cpu")
    c = RenderConfig(**dict(CFG, intersector="brute", **kw))
    img, stats = integrator.render_frame_stats(t, camera_arrays(Camera(**EYE), c, "cpu"), c, 0)
    assert len(calls) == (6 if branch == "tile_pixels" else 1)
    assert stats["schedule"] == reported
    assert img.shape == (48, 64, 3) and bool(torch.isfinite(img).all()) and float(img.max()) > 0


@pytest.mark.parametrize("branch", ["deferred", "affine"])
def test_unported_branches_raise(branch):
    """Deferred shading and the affine (base, count) pixel ranges of
    sharded renders are not ported yet."""
    t = procedural.single_sphere_scene(stacks=4, slices=8, device="cpu")
    c = RenderConfig(**dict(CFG, intersector="brute", deferred_shade=branch == "deferred"))
    cam = camera_arrays(Camera(**EYE), c, "cpu")
    with pytest.raises(NotImplementedError, match=branch):
        if branch == "deferred":
            integrator.render_frame(t, cam, c, 0)
        else:
            integrator.render_pixels(t, cam, c, (0, 64 * 48), 0)


# Port against JAX through each schedule, brute force at 64x48: 1 spp
# (render_rays), frames no larger than the lane pool (render_pixels_regen)
# and tile_pixels, whose pixel-id arrays go to the stream (tiles above the
# lane pool), to render_pixels_regen (below it) and to render_rays (1 spp).
SCHEDULES = {
    "rays": dict(samples_per_launch=1),
    "rays_nee": dict(samples_per_launch=1, rr_mode="standard", env_importance_sampling=True),
    "regen": dict(stream_lanes=0),
    "regen_nee": dict(stream_lanes=0, rr_mode="standard", env_importance_sampling=True),
    "tile_rays": dict(samples_per_launch=1, tile_pixels=1024),
    "tile_stream": dict(tile_pixels=1024),
    "tile_regen": dict(tile_pixels=128),
}


@pytest.fixture(scope="module", params=sorted(SCHEDULES))
def schedule_renders(request):
    """(case, port image, port stats, JAX image, JAX stats) of subframe 1
    of the spheres_nee golden's scene, textbook RR under NEE."""
    hdr = procedural_hdr(32, 64)
    j = j_proc.three_spheres_scene(8, 16).replace(env=j_envmap.with_importance_sampling(j_scene.make_env(hdr)))
    t = nee_golden_scene()
    kw = dict(CFG, intersector="brute", **SCHEDULES[request.param])
    jcfg, tcfg = JConfig(**kw), RenderConfig(**kw)
    jax.clear_caches()
    try:
        jimg, jstats = j_integ.render_frame_stats(j, j_integ.camera_arrays(JCamera(**EYE), jcfg), jcfg, jnp.int32(1))
        jimg = np.asarray(jimg)
        jstats = {k: int(v) for k, v in jstats.items()}
    finally:
        jax.clear_caches()
    timg, tstats = integrator.render_frame_stats(t, camera_arrays(Camera(**EYE), tcfg, "cpu"), tcfg, 1)
    return request.param, timg.numpy(), tstats, jimg, jstats


def test_schedule_matches_jax(schedule_renders):
    """The render_frame_matches_jax rule (99% of values within rtol 1e-3,
    atol 1e-4; channel means within 1%)."""
    _, timg, _, jimg, _ = schedule_renders
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, f"only {close.mean():.4%} of values agree"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)
    assert np.isfinite(timg).all() and timg.max() > 0


def test_schedule_segments_match_jax(schedule_renders):
    """Segments equal JAX's, summed over tiles; shadow segments within
    0.5% (measured: one fewer of 2,825 and 5,674, from the path of this
    scene that one rounding sends another way; see test_golden_nee_image)."""
    case, _, tstats, _, jstats = schedule_renders
    assert int(tstats["segments"]) == jstats["segments"]
    got, want = int(tstats["shadow_segments"]), jstats["shadow_segments"]
    assert abs(got - want) <= 0.005 * want
    assert (want > 0) == case.endswith("_nee")


def test_tiles_equal_whole_frame():
    """A pixel's samples do not depend on the tile it is rendered in: the
    tiled stream equals the whole-frame stream bit for bit, and the tiled
    1-spp frame the whole 1-spp frame."""
    t = procedural.three_spheres_scene(6, 12, device="cpu")
    for kw in (dict(), dict(samples_per_launch=1)):
        imgs, segs = [], []
        for tile in (0, 768):
            c = RenderConfig(**dict(CFG, intersector="brute", tile_pixels=tile, **kw))
            img, stats = integrator.render_frame_stats(t, camera_arrays(Camera(**EYE), c, "cpu"), c, 2)
            imgs.append(img)
            segs.append(int(stats["segments"]))
        assert torch.equal(imgs[0], imgs[1]) and segs[0] == segs[1]


def test_tile_pixels_must_divide_frame():
    t = procedural.single_sphere_scene(stacks=4, slices=8, device="cpu")
    c = RenderConfig(**dict(CFG, intersector="brute", tile_pixels=1000))
    with pytest.raises(ValueError, match="tile_pixels must divide"):
        integrator.render_frame(t, camera_arrays(Camera(**EYE), c, "cpu"), c, 0)


@pytest.mark.parametrize("nee", [False, True], ids=["bsdf", "nee"])
def test_count_segments_matches_jax(nee):
    """Segments plus shadow segments of one 1-spp launch, as JAX counts
    them."""
    hdr = procedural_hdr(32, 64)
    j = j_proc.three_spheres_scene(8, 16).replace(env=j_envmap.with_importance_sampling(j_scene.make_env(hdr)))
    kw = dict(CFG, intersector="brute", samples_per_launch=1, width=32, height=24)
    if nee:
        kw.update(rr_mode="standard", env_importance_sampling=True)
    jcfg, tcfg = JConfig(**kw), RenderConfig(**kw)
    want = int(j_integ.count_segments(j, j_integ.camera_arrays(JCamera(**EYE), jcfg), jcfg, jnp.int32(0)))
    got = integrator.count_segments(nee_golden_scene(), camera_arrays(Camera(**EYE), tcfg, "cpu"), tcfg, 0)
    assert int(got) == want
    stats = integrator.render_frame_stats(nee_golden_scene(), camera_arrays(Camera(**EYE), tcfg, "cpu"), tcfg, 0)[1]
    assert int(got) == int(stats["segments"]) + int(stats["shadow_segments"])
    assert (int(stats["shadow_segments"]) > 0) == nee


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_images_regen(name):
    """The committed goldens through the schedule that rendered them, one
    lane per pixel (auto lanes: a 16,384-lane pool exceeds the 3,072
    pixels), under tests/test_golden.py's rule."""
    img, golden = render_golden(name, *GOLDENS[name], stream_lanes=0)
    if not np.array_equal(img, golden):
        assert ssim(img, golden) > 0.995
        np.testing.assert_allclose(img, golden, atol=5e-3)


def test_golden_nee_image_regen():
    """The spheres_nee golden through render_pixels_regen, under
    test_golden_nee_image's rule."""
    img, golden = render_golden("spheres_nee", *NEE_GOLDEN, stream_lanes=0)
    assert ssim(img, golden) > 0.995
    close = np.isclose(img, golden, rtol=0.0, atol=5e-3).all(axis=-1)
    assert close.mean() >= 0.999, f"{(~close).sum()} pixels off"
