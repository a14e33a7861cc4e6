"""The port's image comparison gate
(`python -m tpu_pathtracer_torch.tools.compare_images`) against the
repository's `tools/compare_images.py` on PNG and PPM pairs written here:
the same JSON line (SSIM within 1e-6) and the same exit code."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from tpu_pathtracer_torch.tools import compare_images  # noqa: E402
from tpu_pathtracer_torch.utils.image import save_png, save_ppm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def j_tool():
    spec = importlib.util.spec_from_file_location("j_compare_images", REPO / "tools" / "compare_images.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A seeded 48x64 render stand-in, a close copy, a far one, its
    vertical flip and a 32x64 crop, each as PNG and as PPM."""
    d = tmp_path_factory.mktemp("images")
    rs = np.random.RandomState(0)
    y, x = np.mgrid[0:48, 0:64]
    base = 0.5 + 0.4 * np.sin(x / 7.0)[..., None] * np.cos(y / 5.0)[..., None] * rs.rand(1, 1, 3)
    a = np.clip(base + 0.05 * rs.rand(48, 64, 3), 0, 1)
    imgs = {
        "a": a,
        "near": np.clip(a + 0.003 * rs.randn(48, 64, 3), 0, 1),
        "far": np.clip(a + 0.3 * rs.randn(48, 64, 3), 0, 1),
        "flip": a[::-1],
        "crop": a[:32],
    }
    for name, img in imgs.items():
        u8 = (img * 255.0).astype(np.uint8)
        save_png(str(d / f"{name}.png"), u8)
        save_ppm(str(d / f"{name}.ppm"), u8)
    return d


CASES = {
    "same_png": ("a.png", "a.png"),
    "near_png": ("a.png", "near.png"),
    "far_png": ("a.png", "far.png"),
    "near_ppm": ("a.ppm", "near.ppm"),
    "far_ppm": ("a.ppm", "far.ppm"),
    "png_vs_ppm": ("a.png", "near.ppm"),
    "flip_b": ("a.png", "flip.ppm", "--flip-b"),
    "unflipped": ("a.png", "flip.png"),
    "ssim_min": ("a.png", "near.png", "--ssim-min", "0.9999"),
    "shape_mismatch": ("a.png", "crop.png"),
}
EXIT = {"same_png": 0, "near_png": 0, "near_ppm": 0, "png_vs_ppm": 0, "flip_b": 0, "far_png": 1, "far_ppm": 1,
        "unflipped": 1, "ssim_min": 1, "shape_mismatch": 2}


def run(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_tool(j_tool, images, monkeypatch, capsys, case):
    a, b, *flags = CASES[case]
    argv = [str(images / a), str(images / b), *flags]
    got_rc, got = run(compare_images.main, argv, capsys)
    monkeypatch.setattr(sys, "argv", ["compare_images.py", *argv])
    want_rc, want = run(lambda _: j_tool.main(), argv, capsys)
    assert got_rc == want_rc == EXIT[case]
    assert got.keys() == want.keys()
    if "ssim" in want:
        assert abs(got.pop("ssim") - want.pop("ssim")) <= 1e-6
    assert got == want


def test_module_entry_point(images):
    out = subprocess.run([sys.executable, "-m", "tpu_pathtracer_torch.tools.compare_images",
                          str(images / "a.png"), str(images / "far.ppm")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["pass"] is False and line["ssim_min"] == 0.99 and 0 < line["ssim"] < 0.99
