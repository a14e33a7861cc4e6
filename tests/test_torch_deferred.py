"""Deferred (hit-compacted) shading in the port (`cfg.deferred_shade`,
`integrator._shade_deferred`): the same image as the dense shade, bit for
bit, on the three-spheres scene and on the CPU tests' textured, glass and
emissive OBJ scene, at chunk divisors 1, 4 and 7 and lane pools that are
and are not a multiple of 1,024; close to the JAX package's deferred
render; NEE keeps the dense shade."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.render import integrator as j_integ  # noqa: E402
from tpu_pathtracer.render.camera import Camera as JCamera  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402

from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.render import integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.render.envmap import with_importance_sampling  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402
from tpu_pathtracer_torch.scene.builder import load_scene  # noqa: E402
from tpu_pathtracer_torch.scene.scene import make_env  # noqa: E402
from tpu_pathtracer_torch.utils.image import procedural_hdr  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_scenes as ts  # noqa: E402

# 64x48 = 3,072 pixels at 2 spp: 3,000 and 2,048 lanes stream the frame.
CFG = dict(width=64, height=48, samples_per_launch=2, max_depth=4, dof=False, intersector="cluster")
EYE = dict(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0))
TEXTURED_EYE = dict(eye=(0.0, 2.0, 5.0), lookat=(0.0, 0.6, 0.0))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name: (scene, config overrides, camera) on the CPU."""
    spheres = build_accel(procedural.three_spheres_scene(8, 16, device="cpu"))
    path = ts.write_mtl_scene(str(tmp_path_factory.mktemp("deferred")), tex=16)
    textured = load_scene([path], env=make_env(procedural_hdr(32, 64), "cpu"), material_source="mtl",
                          accel="cluster", device="cpu")
    return {
        "spheres": (spheres, dict(env_mode="sunsky"), Camera(**EYE)),
        "textured": (textured, dict(env_mode="equirect", dof=True, dof_blurriness=0.05), Camera(**TEXTURED_EYE)),
    }


@pytest.fixture(scope="module")
def dense(scenes):
    """(scene name, lanes): the dense shade's image and stats."""
    cache = {}

    def render(name, lanes):
        if (name, lanes) not in cache:
            scene, kw, camera = scenes[name]
            cfg = RenderConfig(**{**CFG, **kw, "stream_lanes": lanes})
            cache[name, lanes] = integrator.render_frame_stats(scene, camera_arrays(camera, cfg, "cpu"), cfg, 1)
        return cache[name, lanes]

    return render


@pytest.mark.parametrize("lanes", [3000, 2048])
@pytest.mark.parametrize("div", [1, 4, 7])
@pytest.mark.parametrize("name", ["spheres", "textured"])
def test_deferred_equals_dense(scenes, dense, name, div, lanes):
    """Every lane's shading arithmetic and RNG chain are the dense shade's,
    in chunks of C = min(lanes, max(1024, lanes / div rounded up to
    1024)) lanes: the images are equal bit for bit, and so are the
    iterations and segments."""
    scene, kw, camera = scenes[name]
    cfg = RenderConfig(**{**CFG, **kw, "stream_lanes": lanes, "deferred_shade": True, "deferred_chunk_div": div})
    img, stats = integrator.render_frame_stats(scene, camera_arrays(camera, cfg, "cpu"), cfg, 1)
    want, want_stats = dense(name, lanes)
    assert stats["schedule"] == want_stats["schedule"] == "stream"
    assert stats["iters"] == want_stats["iters"] and int(stats["segments"]) == int(want_stats["segments"])
    assert float(want.max()) > 0
    assert torch.equal(img, want)


def test_deferred_chunks(monkeypatch, scenes):
    """The shade runs on ceil(n_hit / C) chunks of C lanes, and only the
    chunks' lanes: at 3,000 lanes and div 4, C is 1,024."""
    scene, kw, camera = scenes["spheres"]
    cfg = RenderConfig(**{**CFG, **kw, "stream_lanes": 3000, "deferred_shade": True})
    calls, hits = [], []
    shade, deferred = integrator._shade, integrator._shade_deferred

    def counted_shade(scene_, cfg_, hit, *args):
        calls.append(hit.t.shape[0])
        return shade(scene_, cfg_, hit, *args)

    def counted_deferred(scene_, cfg_, hit, *args):
        hits.append(int(hit.hit.sum()))
        return deferred(scene_, cfg_, hit, *args)

    monkeypatch.setattr(integrator, "_shade", counted_shade)
    monkeypatch.setattr(integrator, "_shade_deferred", counted_deferred)
    integrator.render_frame_stats(scene, camera_arrays(camera, cfg, "cpu"), cfg, 1)
    assert set(calls) == {1024}
    assert len(calls) == sum(-(-h // 1024) for h in hits) < 3 * len(hits)


def test_deferred_matches_jax():
    """The port's deferred render against the JAX package's, at the port's
    render tolerance (99% of values within rtol 1e-3 / atol 1e-4, channel
    means within 1%); brute force, so the JAX package needs no Pallas."""
    kw = dict(CFG, intersector="brute", env_mode="sunsky", stream_lanes=1000, deferred_shade=True)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jimg = np.asarray(j_integ.render_frame(j_proc.three_spheres_scene(8, 16),
                                           j_integ.camera_arrays(JCamera(**EYE), jcfg), jcfg, jnp.int32(1)))
    jax.clear_caches()
    timg = integrator.render_frame(procedural.three_spheres_scene(8, 16, device="cpu"),
                                   camera_arrays(Camera(**EYE), cfg, "cpu"), cfg, 1).numpy()
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, f"only {close.mean():.4%} of values agree"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)


def test_nee_keeps_the_dense_shade(monkeypatch):
    """NEE reads shade fields the deferred shade does not return: with
    deferred_shade on, an NEE render never takes it and equals the render
    with it off."""
    scene = build_accel(procedural.three_spheres_scene(8, 16, device="cpu").replace(
        env=with_importance_sampling(make_env(procedural_hdr(16, 32), "cpu"))))
    kw = dict(CFG, env_mode="equirect", rr_mode="standard", env_importance_sampling=True, stream_lanes=2048)
    taken = []
    deferred = integrator._shade_deferred
    monkeypatch.setattr(integrator, "_shade_deferred", lambda *a: taken.append(1) or deferred(*a))
    imgs = []
    for on in (True, False):
        cfg = RenderConfig(**kw, deferred_shade=on)
        imgs.append(integrator.render_frame(scene, camera_arrays(Camera(**EYE), cfg, "cpu"), cfg, 1))
    assert taken == []
    assert torch.equal(imgs[0], imgs[1])


def test_deferred_chunk_div_validated():
    with pytest.raises(ValueError, match="deferred_chunk_div"):
        RenderConfig(deferred_chunk_div=0)
