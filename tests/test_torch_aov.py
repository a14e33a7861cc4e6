"""The port's AOV pass and A-Trous denoiser against the JAX package's
(`render/aov.py`), on the textured, glass and emissive test scene (a
bundled pool) and on a scene with an unbundled pool, through the cluster
accel (the JAX package's kernels in Pallas interpret mode)."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.render import aov as j_aov  # noqa: E402
from tpu_pathtracer.render.camera import Camera as JCamera  # noqa: E402
from tpu_pathtracer.render.integrator import camera_arrays as j_camera_arrays  # noqa: E402
from tpu_pathtracer.scene import builder as j_builder  # noqa: E402
from tpu_pathtracer.scene.scene import make_env as j_make_env  # noqa: E402
from tpu_pathtracer.utils.image import procedural_hdr  # noqa: E402

from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.render import aov  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.scene import builder  # noqa: E402
from tpu_pathtracer_torch.scene.scene import make_env  # noqa: E402
from tpu_pathtracer_torch.utils import math as vm  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_scenes as ts  # noqa: E402

CFG = dict(width=64, height=48, dof=True, dof_blurriness=0.05, env_mode="equirect", intersector="cluster")
EYE = dict(eye=(0.0, 2.0, 5.0), lookat=(0.0, 0.6, 0.0))
KEYS = ("normal", "depth", "albedo", "mat", "hit")


@pytest.fixture(scope="module")
def aovs(tmp_path_factory):
    """name -> (port AOV, JAX AOV, port cfg, JAX cfg)."""
    d = tmp_path_factory.mktemp("aov")
    mixed = d / "mixed"
    mixed.mkdir()
    scenes = {
        "mtl": ([ts.write_mtl_scene(str(d), tex=16)], dict(material_source="mtl")),
        "unbundled": (ts.write_convention_scene(str(mixed), sizes={
            "albedo": (16, 24), "roughness": (8, 8), "normal": (12, 10)}), {}),
    }
    hdr = procedural_hdr(32, 64)
    tcfg, jcfg = RenderConfig(**CFG), JConfig(**CFG)
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    try:
        jax.clear_caches()
        for name, (paths, kw) in scenes.items():
            t = builder.load_scene(paths, env=make_env(hdr, "cpu"), accel="cluster", device="cpu", **kw)
            j = j_builder.load_scene(paths, env=j_make_env(hdr), accel="cluster", **kw)
            ja = j_aov.render_aov(j, j_camera_arrays(JCamera(**EYE), jcfg), jcfg)
            ta = aov.render_aov(t, camera_arrays(Camera(**EYE), tcfg, "cpu"), tcfg)
            out[name] = (ta, {k: np.asarray(v) for k, v in ja.items()}, tcfg, jcfg)
    finally:
        mp.undo()
        jax.clear_caches()
    return out


@pytest.mark.parametrize("name", ["mtl", "unbundled"])
def test_render_aov_matches_jax(aovs, name):
    """hit and mat exact; normal, depth and albedo within rtol 1e-5 /
    atol 1e-5: hit distances and barycentric blends contracted by
    XLA:CPU against the port's uncontracted products differ in the last
    bits."""
    ta, ja, _, _ = aovs[name]
    for k in KEYS:
        assert ta[k].shape == ja[k].shape, k
    assert np.array_equal(ta["hit"].numpy(), ja["hit"])
    assert np.array_equal(ta["mat"].numpy(), ja["mat"]) and ta["mat"].dtype == torch.int32
    for k in ("normal", "depth", "albedo"):
        np.testing.assert_allclose(ta[k].numpy(), ja[k], rtol=1e-5, atol=1e-5, err_msg=k)
    hit = ja["hit"]
    assert 0.2 < hit.mean() < 1.0  # the floor, the objects and some sky
    if name == "mtl":
        assert set(np.unique(ja["mat"])) == {-1, 0, 1, 2, 3}  # box, glass, light, floor


def test_defocus_mask_matches_jax(aovs):
    ta, ja, tcfg, jcfg = aovs["mtl"]
    got = aov.defocus_mask({k: torch.as_tensor(np.array(v)) for k, v in ja.items()}, tcfg)
    want = np.asarray(j_aov.defocus_mask({k: jnp.asarray(v) for k, v in ja.items()}, jcfg))
    assert np.array_equal(got.numpy(), want)
    assert 0.0 < float(got.max()) <= 1.0
    assert aov.defocus_mask(ta, tcfg.replace(dof=False)) is None


@pytest.mark.parametrize("dy,dx", [(0, 0), (1, -2), (-3, 4), (7, 0)])
def test_shift2d_matches_jax(dy, dx):
    x = np.random.RandomState(0).rand(6, 9, 3).astype(np.float32)
    assert np.array_equal(aov._shift2d(torch.as_tensor(x), dy, dx).numpy(),
                          np.asarray(j_aov._shift2d(jnp.asarray(x), dy, dx)))


@pytest.mark.parametrize("defocus", [False, True])
def test_atrous_denoise_matches_jax(aovs, defocus):
    """The same G-buffer and noisy radiance through both denoisers: within
    rtol 1e-4 / atol 1e-5 (exp, pow and the luminance product are
    rounded by different libraries)."""
    _, ja, tcfg, jcfg = aovs["mtl"]
    rs = np.random.RandomState(1)
    radiance = (rs.rand(48, 64, 3) * rs.rand(48, 64, 1) * 2.0).astype(np.float32)
    radiance[10, 20] = 80.0  # a firefly
    t_in = {k: torch.as_tensor(np.array(v)) for k, v in ja.items()}
    j_in = {k: jnp.asarray(v) for k, v in ja.items()}
    t_def = aov.defocus_mask(t_in, tcfg) if defocus else None
    j_def = j_aov.defocus_mask(j_in, jcfg) if defocus else None
    got = aov.atrous_denoise(torch.as_tensor(radiance), t_in, defocus=t_def).numpy()
    want = np.asarray(j_aov.atrous_denoise(jnp.asarray(radiance), j_in, defocus=j_def))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    miss = ~ja["hit"]
    assert np.array_equal(got[miss], radiance[miss])  # the environment stays untouched
    assert got[10, 20].max() < 10.0  # the firefly is gone
    assert float(np.abs(got - radiance)[~miss].mean()) > 0.01


def test_luminance():
    rgb = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.2, 0.4, 0.6]])
    got = vm.luminance(rgb).numpy()
    np.testing.assert_allclose(got, [0.2126, 0.7152, 0.2 * 0.2126 + 0.4 * 0.7152 + 0.6 * 0.0722], rtol=1e-6)
