"""The port's NEE quality study (`python -m
tpu_pathtracer_torch.tools.exp_nee_quality`) against the repository's
`tools/exp_nee_quality.py`: (a) the report on the same frames, both
tools' `run_arm` patched to return one seeded set, field by field (the
numpy arithmetic equal, SSIM within 1e-4, the denoised sweep, on each
package's own G-buffer, within 1e-3); (b) both tools end to end on the
CPU at 16x12, their frames by the port-against-JAX rule of
tests/test_golden.py and their variances within rtol 1e-4; (c) what the
port's tool refuses before any render."""

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_pathtracer.utils.logging as j_logging  # noqa: E402

from tpu_pathtracer_torch.tools import exp_nee_quality as t_tool  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SIZE = ["--size", "16x12"]
SSIM_TOL = {"equal_time_ssim": 1e-4, "equal_time_ssim_sweep": 1e-4, "equal_time_ssim_denoised": 1e-3}
TIMES = {False: 0.021, True: 0.0337}  # the patched arms' seconds a frame under --timed


@pytest.fixture(scope="module")
def j_tool():
    spec = importlib.util.spec_from_file_location("j_exp_nee_quality", REPO / "tools" / "exp_nee_quality.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def no_compile_cache(monkeypatch):
    """The JAX tool turns on JAX's persistent compile cache: not here."""
    monkeypatch.setattr(j_logging, "enable_compile_cache", lambda *a, **k: None)


def run_j(j_tool, monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["exp_nee_quality.py", *argv])
    j_tool.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def run_t(monkeypatch, capsys, argv):
    t_tool.main([*argv, "--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def same_keys(a, b, path=""):
    """The same keys in the same order, nested dicts included."""
    assert list(a) == list(b), f"{path}: {list(a)} vs {list(b)}"
    for k in a:
        if isinstance(a[k], dict):
            same_keys(a[k], b[k], f"{path}.{k}")


def equal_number(a, b):
    return (isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b)) or a == b


def ssim_gap(t, j):
    """The largest |port - JAX| of a report's SSIM tables, by table."""
    gaps = {}
    for key in SSIM_TOL:
        if key not in j:
            continue
        pairs = [(t[key][k], j[key][k]) for k in j[key]]
        flat = [(x, y) for a, b in pairs for x, y in zip(np.atleast_1d(a), np.atleast_1d(b))]
        gaps[key] = max(abs(x - y) for x, y in flat)
    return gaps


# ---------------------------------------------------------------------------
# (a) the report on the same frames


def seeded_frames(seed):
    """Six 12x16 1-spp stand-ins: lognormal radiance with a few firefly
    pixels (rare bright environment hits)."""
    rs = np.random.RandomState(seed)
    f = rs.lognormal(mean=-1.0, sigma=0.6, size=(6, 12, 16, 3)).astype(np.float32)
    idx = rs.randint(0, 12 * 16, size=(6, 3))
    for k in range(6):
        f[k].reshape(-1, 3)[idx[k]] *= np.float32(60.0)
    return f


FRAMES = {False: seeded_frames(1), True: seeded_frames(2)}


def patch_arms(monkeypatch, tool, cfg):
    def run_arm(scene_name, nee, size, n_frames, timed, *rest):
        return FRAMES[bool(nee)], (TIMES[bool(nee)] if timed else float("nan")), cfg
    monkeypatch.setattr(tool, "run_arm", run_arm)


REPORT_CASES = {
    "defaults": [],
    "spp2_cost": ["--spp", "2", "--cost-ratio", "2.5"],
    "defensive_mis": ["--defensive", "--mis"],
    "timed": ["--timed"],
    "denoised": ["--denoised"],
}


@pytest.mark.parametrize("case", list(REPORT_CASES))
def test_report_on_the_same_frames(case, j_tool, monkeypatch, capsys):
    argv = SIZE + REPORT_CASES[case]
    patch_arms(monkeypatch, j_tool, j_tool.build("spheres", False, (16, 12))[2])
    patch_arms(monkeypatch, t_tool, t_tool.build("spheres", False, (16, 12), "cpu")[2])
    j = run_j(j_tool, monkeypatch, capsys, argv)
    t = run_t(monkeypatch, capsys, argv)
    same_keys(t, j)
    for key in j:
        if key in SSIM_TOL:
            continue
        if isinstance(j[key], dict):
            for k in j[key]:
                assert equal_number(t[key][k], j[key][k]), (key, k, t[key][k], j[key][k])
        else:
            assert type(t[key]) is type(j[key]) and equal_number(t[key], j[key]), (key, t[key], j[key])
    for key, gap in ssim_gap(t, j).items():
        assert gap <= SSIM_TOL[key], (key, gap)
    if case == "timed":
        assert t["cost_ratio"] == round(TIMES[True] / TIMES[False], 3)
    if case == "denoised":
        assert "equal_time_ssim_denoised" in t


# ---------------------------------------------------------------------------
# (b) end to end on the CPU


@pytest.mark.parametrize("opts", [[], ["--defensive", "--mis"]], ids=["nee", "defensive_mis"])
def test_end_to_end_against_jax(opts, j_tool, monkeypatch, capsys, tmp_path):
    argv = SIZE + ["--frames", "4", "--spp", "1", *opts]
    j = run_j(j_tool, monkeypatch, capsys, argv + ["--save-frames", str(tmp_path / "j.npz")])
    t = run_t(monkeypatch, capsys, argv + ["--save-frames", str(tmp_path / "t.npz")])
    same_keys(t, j)
    jf, tf = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    for arm in ("bsdf", "nee"):
        assert tf[arm].shape == jf[arm].shape == (4, 12, 16, 3)
        assert np.isfinite(tf[arm]).all() and tf[arm].max() > 0
        close = np.isclose(tf[arm], jf[arm], rtol=1e-3, atol=1e-4)
        assert close.mean() >= 0.99, (arm, close.mean())
    for key in ("var_bsdf_1spp", "var_nee_1spp"):
        np.testing.assert_allclose(t[key], j[key], rtol=1e-4)
    # variance_reduction is printed rounded to 3 places: its ratio within
    # rtol 1e-4, and each printed value that ratio rounded.
    r_t, r_j = t["var_bsdf_1spp"] / t["var_nee_1spp"], j["var_bsdf_1spp"] / j["var_nee_1spp"]
    np.testing.assert_allclose(r_t, r_j, rtol=1e-4)
    assert t["variance_reduction"] == round(r_t, 3) and j["variance_reduction"] == round(r_j, 3)
    assert t["cost_ratio"] == j["cost_ratio"] == 1.6
    assert list(t["equal_time_ssim"]) == list(j["equal_time_ssim"])
    assert list(t["equal_time_ssim_sweep"]) == list(j["equal_time_ssim_sweep"])
    assert all(math.isnan(v) for v in (*t["sec_per_frame"].values(), *j["sec_per_frame"].values()))
    assert (t["nee_defensive_mix"], t["nee_mis_spec"]) == (j["nee_defensive_mix"], j["nee_mis_spec"])


# ---------------------------------------------------------------------------
# (c) refusals, before any render


def no_render(*a, **k):
    raise AssertionError("rendered")


def test_cuda_refused_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(t_tool, "run_arm", no_render)
    monkeypatch.setattr(t_tool, "render_frame", no_render)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tool.main(SIZE + ["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tool.main(SIZE)  # the default device is the card


@pytest.mark.parametrize("scene,first", [("monkey", "monkey.obj"), ("suitcase", "suitcase.obj")])
@pytest.mark.parametrize("with_dir", [False, True], ids=["no_reference", "empty_reference"])
def test_obj_scene_refused_naming_the_file(scene, first, with_dir, monkeypatch, tmp_path):
    monkeypatch.setattr(t_tool, "render_frame", no_render)
    monkeypatch.setattr(t_tool, "make_env", no_render)  # refused before the arm's scene is built
    argv = ["--scene", scene, "--device", "cpu"] + (["--reference", str(tmp_path)] if with_dir else [])
    with pytest.raises(SystemExit) as e:
        t_tool.main(argv)
    msg = str(e.value.code)
    assert (str(tmp_path / first) if with_dir else first) in msg, msg
    if not with_dir:
        assert "--reference" in msg
