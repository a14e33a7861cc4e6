"""The port's numpy oracle (`tpu_pathtracer_torch/oracle.py`): the same
numbers as the JAX package's oracle on the same scenes, and the port's
renders held against it by `tests/test_oracle.py`'s rule (at least 98% of
pixels with relative difference < 1e-3) on that file's cases, NEE with
the defensive mixture and with spec-lobe MIS included."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_pathtracer import oracle as j_oracle  # noqa: E402
from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.render import envmap as j_envmap  # noqa: E402
from tpu_pathtracer.render import integrator as j_integ  # noqa: E402
from tpu_pathtracer.render.camera import Camera as JCamera  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402
from tpu_pathtracer.scene import scene as j_scene  # noqa: E402
from tpu_pathtracer.utils.image import procedural_hdr as j_procedural_hdr  # noqa: E402

from tpu_pathtracer_torch import oracle  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.render.integrator import render_frame  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402
from tpu_pathtracer_torch.scene.scene import make_env  # noqa: E402
from tpu_pathtracer_torch.utils.image import procedural_hdr  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_scenes as ts  # noqa: E402
from test_oracle import REF  # noqa: E402  (the reference OBJs' directory)


def cfg_(**kw):
    """tests/test_oracle.py's configuration."""
    base = dict(width=16, height=12, samples_per_launch=2, max_depth=4, dof=False, env_mode="sunsky",
                intersector="brute", regenerate=False)
    base.update(kw)
    return base


def compare(scene, cfg, camera, min_match=0.98):
    """tests/test_oracle.py's rule, for the port's render on the CPU."""
    cam = camera_arrays(camera, cfg, "cpu")
    n = cfg.width * cfg.height
    img = render_frame(scene, cam, cfg, 0).reshape(-1, 3).numpy()
    img_orc = oracle.render(scene, cam, cfg, range(n), 0)
    diff = np.abs(img - img_orc).max(axis=1)
    rel = diff / (1.0 + np.abs(img).max(axis=1))
    frac = float((rel < 1e-3).mean())
    assert frac >= min_match, f"only {frac * 100:.1f}% pixels match"
    return frac


def test_oracle_sunsky_spheres():
    frac = compare(procedural.three_spheres_scene(stacks=6, slices=12, device="cpu"), RenderConfig(**cfg_()),
                   Camera())
    assert frac == 1.0  # exact on this scene, as the JAX package's


def test_oracle_dof_and_constant_env():
    compare(procedural.single_sphere_scene(stacks=6, slices=12, device="cpu"),
            RenderConfig(**cfg_(dof=True, env_mode="constant")), Camera())


def test_oracle_regeneration_schedules_match():
    compare(procedural.single_sphere_scene(stacks=6, slices=12, device="cpu"),
            RenderConfig(**cfg_(regenerate=True, env_mode="constant")), Camera())


def test_oracle_standard_rr():
    compare(procedural.single_sphere_scene(stacks=6, slices=12, device="cpu"),
            RenderConfig(**cfg_(rr_mode="standard", env_mode="constant")), Camera())


def test_oracle_glass():
    scene, kw, eye = ts.oracle_case("glass", "cpu")
    compare(scene, RenderConfig(**cfg_(**kw, max_depth=6)), Camera(**eye))


@pytest.mark.skipif(not os.path.exists(REF), reason="reference assets absent")
def test_oracle_textured_monkey_equirect():
    from tpu_pathtracer_torch.scene.builder import load_scene

    scene = load_scene([f"{REF}/monkey.obj"], env=make_env(procedural_hdr(16, 32), "cpu"), rng_seed=0,
                       device="cpu")
    compare(scene, RenderConfig(**cfg_(env_mode="equirect", samples_per_launch=1, max_depth=3)),
            Camera(eye=(0, 1, 4), lookat=(0, 0.6, 0)))


@pytest.mark.parametrize("mode", ["nee", "nee_defensive_mix", "nee_mis_spec"])
def test_oracle_nee(mode):
    """NEE: alias-table draws, the shadow query and the lobe-partitioned
    weight; with the defensive mixture (branch choice, cosine draw,
    mixture pdf, the discarded pair-parity draw) and with spec-lobe MIS
    (the carried balance weight, the light-arm spec term)."""
    scene, kw, _ = ts.oracle_case(mode, "cpu")
    compare(scene, RenderConfig(**cfg_(**kw)), Camera())


@pytest.mark.slow
def test_oracle_ssim_hero_crop():
    """tests/test_oracle.py's whole-image SSIM gate on a hero-scene crop."""
    from tpu_pathtracer_torch.render.film import post_process
    from tpu_pathtracer_torch.scene.builder import load_scene
    from tpu_pathtracer_torch.utils.ssim import ssim

    if not os.path.exists(f"{REF}/suitcase.obj"):
        pytest.skip("reference assets unavailable")
    scene = load_scene([f"{REF}/suitcase.obj", f"{REF}/test.obj"], scale=0.05,
                       env=make_env(procedural_hdr(32, 64), "cpu"), rng_seed=0, device="cpu")
    cfg = RenderConfig(width=32, height=18, samples_per_launch=8, max_depth=6, dof=False, env_mode="equirect",
                       intersector="brute", regenerate=False, rr_mode="reference")
    cam = camera_arrays(Camera(eye=(0, 2, 6), lookat=(0, 0.5, 0)).with_aspect(32, 18), cfg, "cpu")
    img = render_frame(scene, cam, cfg, 0)
    img_orc = torch.as_tensor(oracle.render(scene, cam, cfg, range(32 * 18), 0).reshape(18, 32, 3))
    s = float(ssim(post_process(img, cfg).numpy(), post_process(img_orc, cfg).numpy()))
    assert s >= 0.99, s


# case: (the port's oracle case, the JAX package's scene, config overrides)
SAME_SCENES = {
    "spheres": ("sunsky", lambda: j_proc.three_spheres_scene(6, 12), {}),
    "glass_dof": ("glass", lambda: j_scene.make_scene(
        *j_proc.sphere_mesh((0.0, 0.0, 0.0), 1.0, 10, 20), None, np.zeros(400, np.int32),
        j_scene.make_material_table([dict(color=(1, 1, 1), roughness=0.1, transparent=True)])),
        dict(max_depth=6, dof=True)),
    "nee_defensive_mis": ("nee", lambda: j_proc.three_spheres_scene(6, 12).replace(
        env=j_envmap.with_importance_sampling(j_scene.make_env(j_procedural_hdr(16, 32, seed=5)))),
        dict(nee_defensive_mix=True, nee_mis_spec=True)),
}


@pytest.mark.parametrize("case", list(SAME_SCENES))
def test_oracle_matches_jax_oracle(case):
    """Both oracles on the scene each package builds from the same
    generator, every third pixel of the 16x12 frame: the same numbers,
    bit for bit."""
    name, j_make, overrides = SAME_SCENES[case]
    scene, kw, eye = ts.oracle_case(name, "cpu")
    kw = cfg_(**{**kw, **overrides})
    cfg, jcfg = RenderConfig(**kw), JConfig(**kw)
    pixels = range(0, cfg.width * cfg.height, 3)
    got = oracle.render(scene, camera_arrays(Camera(**eye), cfg, "cpu"), cfg, pixels, 2)
    want = j_oracle.render(j_make(), j_integ.camera_arrays(JCamera(**eye), jcfg), jcfg, pixels, 2)
    assert got.shape == (len(pixels), 3) and got.max() > 0
    np.testing.assert_array_equal(got, want)
