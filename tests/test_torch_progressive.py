"""The port's progressive renderer against the JAX package's
`ProgressiveRenderer` on the textured, glass and emissive test scene
(DOF on, cluster accel; the JAX package's kernels in Pallas interpret
mode): the accumulation after two launches and a fixed-scale preview
under the golden rule; checkpoint and resume bit for bit; the refusals;
the converge ramp; the non-finite check."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.render import film as j_film  # noqa: E402
from tpu_pathtracer.render.camera import Camera as JCamera  # noqa: E402
from tpu_pathtracer.runtime.progressive import ProgressiveRenderer as JRenderer  # noqa: E402
from tpu_pathtracer.scene import builder as j_builder  # noqa: E402
from tpu_pathtracer.scene.scene import make_env as j_make_env  # noqa: E402
from tpu_pathtracer.utils.image import procedural_hdr  # noqa: E402

from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.render import film  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera  # noqa: E402
from tpu_pathtracer_torch.runtime import progressive  # noqa: E402
from tpu_pathtracer_torch.runtime.progressive import ProgressiveRenderer  # noqa: E402
from tpu_pathtracer_torch.scene import builder  # noqa: E402
from tpu_pathtracer_torch.scene.scene import make_env  # noqa: E402
from tpu_pathtracer_torch.utils.ssim import ssim  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_scenes as ts  # noqa: E402

CFG = dict(width=64, height=48, samples_per_launch=2, max_depth=4, dof=True, dof_blurriness=0.05,
           env_mode="equirect", intersector="cluster")
EYE = dict(eye=(0.0, 2.0, 5.0), lookat=(0.0, 0.6, 0.0))


def golden_rule(a, b):
    """tests/test_golden.py's rule: exact, else SSIM > 0.995 and atol 5e-3."""
    if not np.array_equal(a, b):
        assert ssim(a, b) > 0.995
        np.testing.assert_allclose(a, b, atol=5e-3)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("prog")
    paths = [ts.write_mtl_scene(str(d), tex=16)]
    hdr = procedural_hdr(32, 64)
    t = builder.load_scene(paths, env=make_env(hdr, "cpu"), material_source="mtl", accel="cluster", device="cpu")
    j = j_builder.load_scene(paths, env=j_make_env(hdr), material_source="mtl", accel="cluster")
    return t, j


@pytest.fixture(scope="module")
def renders(scenes):
    """(port renderer, JAX renderer) after two launches, and their
    previews at a fixed scale 2."""
    t, j = scenes
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    try:
        jax.clear_caches()
        jr = JRenderer(j, JCamera(**EYE), JConfig(**CFG))
        jp = JRenderer(j, JCamera(**EYE), JConfig(**CFG), preview_scale=2)
        jr.step()
        jr.step()
        jp.step_preview()
        jp_img = jp.image_u8()
    finally:
        mp.undo()
        jax.clear_caches()
    tr = ProgressiveRenderer(t, Camera(**EYE), RenderConfig(**CFG))
    tp = ProgressiveRenderer(t, Camera(**EYE), RenderConfig(**CFG), preview_scale=2)
    tr.step()
    tr.step()
    tp.step_preview()
    return tr, jr, tp.image_u8(), jp_img


def test_accum_after_two_launches_matches_jax(renders):
    tr, jr, _, _ = renders
    assert (tr.subframe, tr.spp) == (jr.subframe, jr.spp) == (2, 4)
    t_img = film.post_process(tr.accum, tr.cfg).numpy()
    j_img = np.asarray(j_film.post_process(jr.accum, jr.cfg))
    golden_rule(t_img, j_img)
    assert np.isfinite(tr.accum.numpy()).all() and float(tr.accum.max()) > 1.0  # the light is HDR


def test_display_images_match_jax(renders):
    """image_u8 (row 0 the top) and image_hdr as the JAX renderer's."""
    tr, jr, _, _ = renders
    golden_rule(tr.image_u8() / 255.0, jr.image_u8() / 255.0)
    assert tr.image_u8().dtype == np.uint8 and tr.image_u8().shape == (48, 64, 3)
    assert np.array_equal(tr.image_hdr(), tr.accum.numpy()[::-1])
    golden_rule(film.post_process(torch.as_tensor(tr.image_hdr().copy()), tr.cfg).numpy(),
                np.asarray(j_film.post_process(jr.image_hdr(), jr.cfg)))


def test_preview_at_fixed_scale_matches_jax(renders):
    """A 32x24, 1-spp preview nearest-upscaled to 64x48."""
    _, _, t_pv, j_pv = renders
    assert t_pv.shape == j_pv.shape == (48, 64, 3)
    assert np.array_equal(t_pv[0::2], t_pv[1::2]) and np.array_equal(t_pv[:, 0::2], t_pv[:, 1::2])
    golden_rule(t_pv / 255.0, j_pv / 255.0)


def test_stats(renders):
    tr, _, _, _ = renders
    st = tr.stats()
    assert st["subframe"] == 2 and st["spp"] == 4 and st["ms_per_frame"] > 0
    assert st["paths_per_sec"] > 0


def _small(scene, **kw):
    cfg = RenderConfig(**{**CFG, "width": 32, "height": 24, "max_depth": 3, **kw})
    return ProgressiveRenderer(scene, Camera(**EYE), cfg)


def test_checkpoint_resume_bitwise(scenes, tmp_path):
    """Two launches, a checkpoint, a fresh renderer that resumes and takes
    two more: the accumulation equals four uninterrupted launches bit for
    bit."""
    t, _ = scenes
    full = _small(t)
    for _ in range(4):
        full.step()
    first = _small(t)
    first.step()
    first.step()
    path = str(tmp_path / "ck.npz")
    first.save_checkpoint(path)
    resumed = _small(t)
    resumed.load_checkpoint(path)
    assert (resumed.subframe, resumed.spp) == (2, 4)
    resumed.step()
    resumed.step()
    assert torch.equal(resumed.accum, full.accum)
    data = np.load(path)
    import json

    meta = json.loads(str(data["meta"]))
    assert meta["version"] == 3 and meta["accum_spp"] == 4 and len(meta["scene"]) == 40


def test_checkpoint_refusals(scenes, tmp_path):
    t, _ = scenes
    r = _small(t)
    r.step()
    path = str(tmp_path / "ck.npz")
    r.save_checkpoint(path)
    with pytest.raises(ValueError, match="config mismatch"):
        _small(t, max_depth=2).load_checkpoint(path)
    other = t.replace(vertices=t.vertices + 1.0)
    with pytest.raises(ValueError, match="scene mismatch"):
        _small(other).load_checkpoint(path)
    with pytest.raises(FileNotFoundError):
        _small(t).load_checkpoint(str(tmp_path / "none.npz"))


def test_camera_change_and_reset(scenes):
    t, _ = scenes
    r = _small(t)
    r.step()
    r.set_camera(r.camera.orbit(10.0, 0.0))
    assert r.subframe == 0 and r.spp == 0 and float(r.accum.abs().max()) == 0.0
    assert r.camera.aspect == 32 / 24


def test_converge_ramp(scenes, monkeypatch):
    """Launches of 1, 1, 2, 4, then the configured 10 after a reset; the
    accumulation is their sample-weighted mean."""
    t, _ = scenes
    r = _small(t, samples_per_launch=10)
    seen, frames = [], []
    real = progressive.render_frame

    def spy(scene, cam, cfg, subframe):
        seen.append(cfg.samples_per_launch)
        frames.append(real(scene, cam, cfg, subframe))
        return frames[-1]

    monkeypatch.setattr(progressive, "render_frame", spy)
    for _ in range(6):
        r.step_converge()
    assert seen == [1, 1, 2, 4, 10, 10] and r.spp == 28
    want = sum(f * n for f, n in zip(frames, seen)) / 28.0
    np.testing.assert_allclose(r.accum.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_check_finite(scenes, monkeypatch):
    t, _ = scenes
    r = ProgressiveRenderer(t, Camera(**EYE), RenderConfig(**{**CFG, "width": 16, "height": 8}), check_finite=True)

    def bad(scene, cam, cfg, subframe):
        img = torch.zeros((cfg.height, cfg.width, 3))
        img[3, 5, 1] = float("nan")
        return img

    monkeypatch.setattr(progressive, "render_frame", bad)
    with pytest.raises(FloatingPointError, match="1 pixels"):
        r.step()
    r.check_finite = False
    r.step()  # off: no check
    assert r.subframe == 1


def test_denoise_is_display_only(scenes):
    t, _ = scenes
    raw = _small(t)
    den = ProgressiveRenderer(t, Camera(**EYE), raw.cfg, denoise=True)
    raw.step()
    den.step()
    assert torch.equal(raw.accum, den.accum)
    assert np.array_equal(raw.image_hdr(), den.image_hdr())
    assert not np.array_equal(raw.image_u8(), den.image_u8())
    den.set_camera(den.camera.zoom(0.9))
    assert den._aov is None
