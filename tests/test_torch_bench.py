"""The port's benchmark entry point (`python -m tpu_pathtracer_torch.bench`)
against the repository's `bench.py` on the same arguments at 16x12, 2 spp,
depth 3: the traced-ray accounting (path segments exact, shadow segments
within 0.5%), the scene and the metric's shape; the presets as bench.py
builds them (without a render); the refused options and devices, each
before any render; and the black-render guard."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_pathtracer.scene.builder import load_scene as j_load_scene  # noqa: E402

from tpu_pathtracer_torch import bench  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_scenes as ts  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--width", "16", "--height", "12", "--spp", "2", "--depth", "3", "--frames", "1"]
CASES = {
    "brute": ["--accel", "auto"],  # the three-spheres fallback has no accel: brute force on both sides
    "cluster": ["--accel", "cluster"],
    "nee": ["--config", "3", "--nee", "--accel", "cluster"],
}


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def port_main(argv):
    """(exit code, stdout) of the port's bench.main(argv)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX bench.py's line, the port's line)}: bench.py runs in
    subprocesses on the CPU (no backend probe, JAX's compile cache in a
    scratch directory), all at once, while the port runs in process."""
    cache = tmp_path_factory.mktemp("jax_cache")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(cache))
    procs = {
        case: subprocess.Popen([sys.executable, "bench.py", "--probe-minutes", "0", *SMALL, *extra], cwd=REPO,
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for case, extra in CASES.items()
    }
    ours = {}
    for case, extra in CASES.items():
        rc, out = port_main([*SMALL, *extra, "--device", "cpu"])
        assert rc == 0, out
        assert len(out.strip().splitlines()) == 1  # one JSON line
        ours[case] = last_json(out)
    theirs = {}
    for case, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        theirs[case] = last_json(out)
    return {case: (theirs[case], ours[case]) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_segments_match_bench_py(runs, case):
    """Path segments exact; shadow segments within 0.5%
    (test_schedule_segments_match_jax's rule)."""
    j, t = (r["detail"] for r in runs[case])
    assert t["path_segments"] == j["path_segments"] > 0
    got, want = t["shadow_segments"], j["shadow_segments"]
    assert abs(got - want) <= 0.005 * want
    assert (want > 0) == (case == "nee")


@pytest.mark.parametrize("case", list(CASES))
def test_detail_matches_bench_py(runs, case):
    j, t = (r["detail"] for r in runs[case])
    for key in ("triangles", "frames", "nee"):
        assert t[key] == j[key], key
    assert t["rays_per_launch"] == t["path_segments"] + t["shadow_segments"]
    assert set(j) - {"vs_baseline"} <= set(t)
    assert t["device"] == "cpu" and t["power_limit_w"] is None
    assert t["schedule"] == "regen" and t["iterations"] > 0  # 192 pixels fit the smallest pool
    # The CPU runs the loop's step directly: nothing is captured.
    assert t["graphed"] is False and t["captures"] == 0 and t["capture_seconds"] == 0.0
    for key in ("spp_per_sec", "sec_per_launch"):
        assert t[key] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_metric_matches_bench_py(runs, case):
    """The metric's shape, dims, depth and accel are bench.py's; its scene
    is the one rendered (bench.py calls the fallback "suitcase PBR")."""
    j, t = runs[case]
    assert (t["unit"], j["unit"]) == ("Mrays/s", "Mrays/s")
    assert t["value"] > 0 and "vs_baseline" not in t
    j_parts, t_parts = j["metric"].split(", "), t["metric"].split(", ")
    assert t_parts[0] == j_parts[0] == "Mrays/sec/chip"
    assert j_parts[1] == "suitcase PBR scene" and t_parts[1] == "three spheres scene"
    assert t_parts[2:4] == j_parts[2:4] == ["16x12", "depth 3"]
    accel = CASES[case][CASES[case].index("--accel") + 1]
    assert t_parts[4] == j_parts[4] == f"{accel} accel (cpu)"


def preset(*argv):
    args = bench.build_arg_parser().parse_args([*argv, "--device", "cpu"])
    scene, camera, cfg = bench.build_preset(args, torch.device("cpu"))
    return args, scene, camera, cfg


@pytest.mark.parametrize("extra", [[], ["--spp", "16"], ["--accel", "cluster"]])
def test_config1_preset(extra):
    """BASELINE config 1: the analytic sphere, 512x512, 64 spp (or
    --spp), depth 8, constant sky, the default camera; an accel only under
    --accel cluster (auto renders it by brute force, as bench.py does)."""
    args, scene, camera, cfg = preset("--config", "1", "--width", "64", "--depth", "3", *extra)
    assert scene.num_triangles == 4098
    assert (cfg.width, cfg.height, cfg.max_depth) == (512, 512, 8)
    assert cfg.samples_per_launch == (16 if "--spp" in extra else 64)
    assert cfg.env_mode == "constant" and cfg.rr_mode == "reference" and cfg.tile_pixels == 0
    assert camera == Camera()
    assert cfg.intersector == ("cluster" if "--accel" in extra else "auto")
    assert (scene.accel is not None) == ("--accel" in extra)
    if scene.accel is not None:
        assert scene.accel.num_clusters == 33
    assert args.scene_name == "sphere/constant-sky"


@pytest.mark.parametrize("nee", [False, True])
def test_config4_preset(nee):
    """BASELINE config 4's stand-in: 98,002 triangles in 766 clusters (the
    accel built under auto), eye (0,3,10) looking at (0,1,0)."""
    args, scene, camera, cfg = preset("--config", "4", *(["--nee"] if nee else []))
    assert scene.num_triangles == 98_002
    assert scene.accel is not None and scene.accel.num_clusters == 766
    assert (camera.eye, camera.lookat) == ((0, 3, 10), (0, 1, 0))
    assert (cfg.width, cfg.height, cfg.samples_per_launch, cfg.max_depth) == (1920, 1080, 10, 8)
    assert cfg.env_mode == "equirect" and cfg.intersector == "auto"
    assert cfg.env_importance_sampling == nee and cfg.rr_mode == ("standard" if nee else "reference")
    assert (scene.env.alias_table is not None) == nee
    assert args.scene_name == "high-poly 100k"


def test_config4_brute_builds_no_accel():
    _, scene, _, cfg = preset("--config", "4", "--accel", "brute")
    assert scene.accel is None and cfg.intersector == "brute"


@pytest.mark.parametrize("argv, tile", [
    (["--spp", "1"], 345_600),  # 6 tiles of 345,600 pixels at 1080p
    (["--spp", "2"], 0),
    ([], 0),
    (["--spp", "1", "--tiles", "4"], 518_400),
    (["--spp", "1", "--width", "512", "--height", "384"], 0),
])
def test_tiling(argv, tile):
    _, _, _, cfg = preset(*argv)
    assert cfg.tile_pixels == tile
    assert cfg.samples_per_launch == (int(argv[1]) if argv else 10)


def test_small_and_lanes():
    args, _, _, cfg = preset("--small", "--lanes", "4096", "--tri-test", "mt", "--fused", "off")
    assert (cfg.width, cfg.height, args.frames) == (256, 192, 4)
    assert (cfg.stream_lanes, cfg.tri_test, cfg.fused_schedule) == (4096, "mt", "off")


@pytest.mark.parametrize("config, files, scale, depth, eye, name", [
    (0, ["suitcase.obj", "test.obj"], 0.05, 8, (0.0, 2.0, 6.0), "suitcase PBR"),
    (3, ["suitcase.obj", "test.obj"], 0.05, 8, (0.0, 2.0, 6.0), "suitcase PBR"),
    (2, ["monkey.obj"], 1.0, 4, (0, 1, 4), "monkey+env"),
    (5, ["tower.obj", "fish.obj", "test.obj"], 1.0, 8, (0, 1.5, 5), "tower+fish+test"),
])
def test_obj_presets(tmp_path, config, files, scale, depth, eye, name):
    """The OBJ presets load the reference's files from --reference as
    bench.py loads them (the same triangles as the JAX package's
    load_scene, Morton-permuted under the cluster accel)."""
    (tmp_path / "src").mkdir()
    box, ball = ts.write_convention_scene(str(tmp_path / "src"))
    for i, f in enumerate(files):
        shutil.copy([box, ball][i % 2], tmp_path / f)
    _, scene, camera, cfg = preset("--config", str(config), "--reference", str(tmp_path))
    paths = [str(tmp_path / f) for f in files]
    want = j_load_scene(paths, scale=scale, rng_seed=0, accel="cluster")
    np.testing.assert_array_equal(scene.vertices.numpy(), np.asarray(want.vertices))
    assert scene.accel is not None and cfg.max_depth == depth
    assert camera.eye == eye
    assert name == preset("--config", str(config), "--reference", str(tmp_path))[0].scene_name


@pytest.mark.parametrize("config", ["2", "5"])
def test_obj_presets_need_reference(config):
    with pytest.raises(SystemExit) as e:
        preset("--config", config)
    assert "pass --reference DIR" in str(e.value.code)


@pytest.mark.parametrize("flag, value", [
    ("--pixel-order", "tiled"), ("--sort-rays", "entry"), ("--mq", "on"), ("--rpt", "64"),
])
def test_refused_options_exit_before_render(monkeypatch, flag, value):
    monkeypatch.setattr(bench, "build_preset", lambda *a: pytest.fail("built a scene"))
    with pytest.raises(SystemExit) as e:
        bench.main([*SMALL, "--device", "cpu", flag, value])
    assert e.value.code not in (0, None)
    assert str(e.value.code).startswith(f"{flag} {value}: not ported")


def test_refused_options_defaults_accepted():
    args = bench.build_arg_parser().parse_args(
        ["--pixel-order", "scanline", "--sort-rays", "octant", "--mq", "off", "--rpt", "0"])
    bench.check_refused(args)
    _, _, _, cfg = preset("--pixel-order", "scanline", "--sort-rays", "octant", "--mq", "off")
    assert cfg.sort_rays == "octant"


def test_cuda_refused_without_a_card(monkeypatch):
    """--device cuda (the default) on a machine without a card exits
    non-zero before any scene is built: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "build_preset", lambda *a: pytest.fail("built a scene"))
    for argv in (SMALL, [*SMALL, "--device", "cuda:0"]):
        with pytest.raises(SystemExit) as e:
            bench.main(argv)
        assert "no CUDA device is available" in str(e.value.code)


def test_module_entry_point():
    """`python -m tpu_pathtracer_torch.bench`: one JSON line with
    --device cpu; without it, on a machine without a card, a non-zero
    exit and no result line."""
    ok = subprocess.run([sys.executable, "-m", "tpu_pathtracer_torch.bench", *SMALL, "--device", "cpu"],
                        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr[-2000:]
    lines = ok.stdout.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["detail"]["path_segments"] == 640
    if not torch.cuda.is_available():
        refused = subprocess.run([sys.executable, "-m", "tpu_pathtracer_torch.bench", *SMALL], cwd=REPO,
                                 capture_output=True, text=True, timeout=300)
        assert refused.returncode != 0 and refused.stdout == ""
        assert "no CUDA device is available" in refused.stderr


def test_black_render_guard(monkeypatch):
    """A black warm frame: the error line and exit 1, before the
    accounting frame and the timed frames."""
    monkeypatch.setattr(bench, "render_frame", lambda scene, cam, cfg, subframe: torch.zeros(cfg.height, cfg.width, 3))
    monkeypatch.setattr(bench, "render_frame_stats", lambda *a: pytest.fail("rendered past the guard"))
    rc, out = port_main([*SMALL, "--device", "cpu"])
    assert rc == 1
    assert out.strip().splitlines() == [json.dumps({"error": "black render — refusing to benchmark"})]


def test_power_limit_by_uuid(monkeypatch):
    """The power limit is read from nvidia-smi's row of the card's UUID,
    whatever order nvidia-smi lists the cards in; None where no row or
    no nvidia-smi answers."""
    props = {0: "aaaa-0", 1: "bbbb-1"}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: type("Props", (), {"uuid": props[d.index or 0]})())
    rows = "GPU-bbbb-1, 350.00\nGPU-aaaa-0, 700.00\n"
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(a, 0, stdout=rows))
    assert bench.power_limit_watts(torch.device("cuda")) == 700.0
    assert bench.power_limit_watts(torch.device("cuda:1")) == 350.0
    props[1] = "cccc-2"
    assert bench.power_limit_watts(torch.device("cuda:1")) is None

    def no_smi(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(bench.subprocess, "run", no_smi)
    assert bench.power_limit_watts(torch.device("cuda:0")) is None
