"""The port's CLI end to end against the JAX package's CLI on the same
64x48 textured, glass and emissive OBJ scene (two launches, DOF on, the
JAX package's kernels in Pallas interpret mode): the decoded PNGs under
the golden rule, the AOV files, the raw linear EXR; the scene file,
checkpoint and resume, the refusals; and the viewer's endpoints."""

import json
import os
import sys
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from tpu_pathtracer import cli as j_cli  # noqa: E402
from tpu_pathtracer.render.film import post_process as j_post_process  # noqa: E402
from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402

from tpu_pathtracer_torch import cli  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera  # noqa: E402
from tpu_pathtracer_torch.render.film import post_process  # noqa: E402
from tpu_pathtracer_torch.runtime.progressive import ProgressiveRenderer  # noqa: E402
from tpu_pathtracer_torch.scene import builder  # noqa: E402
from tpu_pathtracer_torch.utils.image import decode_png, load_exr, load_png  # noqa: E402
from tpu_pathtracer_torch.utils.ssim import ssim  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_scenes as ts  # noqa: E402

DIM = dict(width=64, height=48)


def golden_rule(a, b):
    """tests/test_golden.py's rule: exact, else SSIM > 0.995 and atol 5e-3."""
    if not np.array_equal(a, b):
        assert ssim(a, b) > 0.995
        np.testing.assert_allclose(a, b, atol=5e-3)


def args(obj, out, *extra):
    return ["--dim", "64x48", "-s", "2", "--spp", "4", "--max-depth", "4", "--materials", "mtl",
            "--scene", obj, "--eye", "0,2,5", "--lookat", "0,0.6,0", "--no-scene-cache", "--file", out, *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Output directory, OBJ path; the JAX CLI's and the port's renders
    (PNG denoised with AOVs, and EXR) in it as j.* and t.*."""
    d = tmp_path_factory.mktemp("cli")
    obj = ts.write_mtl_scene(str(d), tex=16)
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_PT_PALLAS_INTERPRET", "1")
    try:
        jax.clear_caches()
        assert j_cli.main(args(obj, str(d / "j.png"), "--denoise", "--aov-prefix", str(d / "j"))) == 0
        assert j_cli.main(args(obj, str(d / "j.exr"), "--denoise")) == 0
    finally:
        mp.undo()
        jax.clear_caches()
    assert cli.main(args(obj, str(d / "t.png"), "--denoise", "--aov-prefix", str(d / "t"), "--device", "cpu")) == 0
    assert cli.main(args(obj, str(d / "t.exr"), "--denoise", "--device", "cpu")) == 0
    assert cli.main(args(obj, str(d / "raw.exr"), "--device", "cpu")) == 0
    return d, obj


def test_cli_png_matches_jax(runs):
    d, _ = runs
    t, j = load_png(str(d / "t.png")), load_png(str(d / "j.png"))
    assert t.shape == j.shape == (48, 64, 3)
    golden_rule(t / 255.0, j / 255.0)
    assert t.max() > 0 and t.std() > 5  # textured, lit, not flat


@pytest.mark.parametrize("kind", ["normal", "depth", "albedo"])
def test_cli_aovs_match_jax(runs, kind):
    d, _ = runs
    t, j = load_png(str(d / f"t_{kind}.png")), load_png(str(d / f"j_{kind}.png"))
    assert t.shape == (48, 64, 3)
    golden_rule(t / 255.0, j / 255.0)
    if kind == "depth":
        assert t[0].max() == 0 and t[-1].min() > 0  # sky at the top (row 0), floor at the bottom


def test_cli_exr_is_linear_hdr_and_not_denoised(runs):
    """The EXR holds the raw accumulation, row 0 the top: the same with
    and without --denoise, above 1 where the light is, and the JAX CLI's
    under the golden rule after the film chain."""
    d, _ = runs
    t, raw, j = (load_exr(str(d / n)) for n in ("t.exr", "raw.exr", "j.exr"))
    assert np.array_equal(t, raw)
    assert t.shape == (48, 64, 3) and t.max() > 1.0 and t.min() >= 0.0
    cfg, jcfg = RenderConfig(**DIM), JConfig(**DIM)
    golden_rule(post_process(torch.as_tensor(t), cfg).numpy(), np.asarray(j_post_process(j, jcfg)))


def test_cli_scene_file_checkpoint_and_resume(runs, tmp_path):
    """--scene-file with flag overrides; two launches, a checkpoint, a
    resume for a third: the PNG equals an uninterrupted three-launch run
    bit for bit."""
    d, obj = runs
    toml = tmp_path / "s.toml"
    toml.write_text(
        f'[scene]\nobjects = ["{obj}"]\nmaterial_source = "mtl"\n'
        '[environment]\nmode = "equirect"\nprocedural = { height = 16, width = 32 }\n'
        '[camera]\neye = [0.0, 2.0, 5.0]\nlookat = [0.0, 0.6, 0.0]\n'
        '[render]\nwidth = 48\nheight = 32\nsamples_per_launch = 4\nmax_depth = 5\n'
    )
    base = ["--scene-file", str(toml), "-s", "1", "--max-depth", "3", "--device", "cpu", "--no-scene-cache"]
    ck = str(tmp_path / "ck.npz")
    assert cli.main(base + ["--spp", "2", "--checkpoint", ck, "--file", str(tmp_path / "a.png")]) == 0
    assert cli.main(base + ["--spp", "3", "--checkpoint", ck, "--resume", "--file", str(tmp_path / "b.png")]) == 0
    assert cli.main(base + ["--spp", "3", "--file", str(tmp_path / "c.png")]) == 0
    b, c = load_png(str(tmp_path / "b.png")), load_png(str(tmp_path / "c.png"))
    assert b.shape == (32, 48, 3) and np.array_equal(b, c)
    meta = json.loads(str(np.load(ck)["meta"]))
    assert meta["subframe"] == 3 and meta["config"]["max_depth"] == 3 and meta["config"]["dof"] is True


@pytest.mark.parametrize("argv,match", [
    (["--dim", "64by48"], "invalid --dim"),
    (["--texture-lod", "mip"], "mip ladder"),
    (["--texture-lod", "split"], "mip ladder"),
    (["--nee", "--env", "constant"], "equirect"),
])
def test_cli_refusals(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["--dim", "16x8", "--device", "cpu", "--file", str(tmp_path / "x.png"), *argv])


def test_cli_needs_a_card_unless_told(tmp_path):
    """The default device is the card; without one it is refused, never
    quietly replaced by the CPU."""
    assert cli.build_arg_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dim", "16x8", "--file", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_cli_procedural_debug_nans_profile_ppm(tmp_path):
    """The procedural scene (no --scene), --texture-lod off, --debug-nans,
    --profile and a PPM output."""
    out = tmp_path / "p.ppm"
    rc = cli.main(["--dim", "24x16", "-s", "1", "--spp", "2", "--max-depth", "2", "--no-dof", "--env", "sunsky",
                   "--texture-lod", "off", "--debug-nans", "--profile", str(tmp_path / "prof"), "--device", "cpu",
                   "--file", str(out)])
    assert rc == 0
    data = out.read_bytes()
    assert data.startswith(b"P6\n24 16\n255\n") and len(data) == 13 + 24 * 16 * 3
    assert any(n.endswith(".json") for n in os.listdir(tmp_path / "prof"))
    assert any(n.startswith("spans-") for n in os.listdir(tmp_path / "prof"))


def test_cli_defaults_match_jax():
    assert cli.CLI_DEFAULTS == j_cli.CLI_DEFAULTS
    t, j = cli.build_arg_parser().parse_args([]), j_cli.build_arg_parser().parse_args([])
    assert {k: v for k, v in vars(t).items() if k != "device"} == vars(j)
    assert cli.parse_vec3("1,2.5,-3") == j_cli.parse_vec3("1,2.5,-3")
    assert cli.parse_dim("640X480") == (640, 480)


# ---------------------------------------------------------------------------
# the viewer


def test_viewer_endpoints(runs):
    """Every endpoint on a free localhost port answers 200; /frame.png
    decodes with the port's codec; /resize changes the frame's size."""
    from tpu_pathtracer_torch.viewer import serve

    _, obj = runs
    scene = builder.load_scene([obj], material_source="mtl", accel="cluster", device="cpu")
    cfg = RenderConfig(width=32, height=24, samples_per_launch=2, max_depth=3, dof=False, env_mode="sunsky")
    renderer = ProgressiveRenderer(scene, Camera(eye=(0.0, 2.0, 5.0), lookat=(0.0, 0.6, 0.0)), cfg,
                                   preview_scale=2)
    httpd, stop = serve(renderer, port=0, block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            assert r.status == 200, path
            return r.read()

    try:
        assert b"tpu_pathtracer_torch" in get("/")
        assert decode_png(get("/frame.png")).shape == (24, 32, 3)
        st = json.loads(get("/stats"))
        assert {"dof", "denoise", "spp"} <= set(st)
        for path in ("/orbit?dyaw=5&dpitch=2", "/zoom?f=0.9", "/pan?dx=0.1&dy=0.1", "/toggle_dof",
                     "/toggle_denoise", "/reset"):
            assert get(path) == b"ok"
        assert get("/resize?w=40&h=16") == b"ok"
        assert decode_png(get("/frame.png")).shape == (16, 40, 3)
        assert renderer.accum.shape == (16, 40, 3) and renderer.accum.device == scene.device
        with pytest.raises(urllib.error.HTTPError):
            get("/nothing")
    finally:
        stop.set()
        httpd.shutdown()
        httpd.server_close()
