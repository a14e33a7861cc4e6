"""The check that decides `correct`: the plain reference against the
program on the CPU at a small size, the control (the reference in
bfloat16 in the program's place) refused, and whole runs with the timed
path broken underneath refused."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_h100 import check, run
from bench_h100.reference import render as ref

SMALL = {"render": {"width": 16, "height": 12}, "mix": {"check_pixels": 48}}
CELLS = [w["name"] for w in json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]


def small(cell: str) -> dict:
    return {k: dict(v) for k, v in SMALL.items()}


def run_cell(cell: str, seed: int, seconds: float = 0.2):
    code, res = run.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                        device="cpu", overrides=small(cell))
    assert code == 0
    return res


def test_compare_counts_non_finite_values_as_mismatches():
    r = np.ones((4, 3))
    p = r.copy()
    p[0, 0] = np.nan
    got = check.compare(p, r)
    assert got["mismatch_share"] == pytest.approx(1 / 12) and got["rel_l1"] == float("inf")
    assert not check.judge(got, {"mismatch_share": 1.0, "rel_l1": 1.0})
    assert check.compare(r, r) == {"mismatch_share": 0.0, "rel_l1": 0.0}
    assert not check.judge({"mismatch_share": 0.0}, {})


def test_nearest_rank_percentile():
    assert run.percentile(list(range(1, 101)), 95) == 95
    assert run.percentile([3.0], 95) == 3.0


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_program(cell):
    res = run_cell(cell, 2**31 + 17)
    assert res["correct"], res["check"]
    assert res["check"]["mismatch_share"]["value"] <= res["check"]["mismatch_share"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_refused(cell):
    """The reference computed in bfloat16, put in the program's place,
    fails the cell's limits on three seeds."""
    for seed in (101, 102, 103):
        c = run.Cell(cell, seed, overrides=small(cell))
        arrays, env = c.arrays()
        f32 = run.reference_values(c, arrays, env, 2, "cpu", torch.float32)
        bf16 = run.reference_values(c, arrays, env, 2, "cpu", torch.bfloat16)
        assert not check.judge(check.compare(bf16, f32), c.limits)


def _unchanged(monkeypatch, progressive):
    monkeypatch.setattr(progressive, "accumulate_weighted", lambda prev, new, prev_spp, new_spp: prev)


def _half(monkeypatch, progressive):
    render_frame = progressive.render_frame

    def half(scene, cam, cfg, subframe):
        if cfg.samples_per_launch > 1:   # half the samples, the mean over the rest
            return render_frame(scene, cam, cfg.replace(samples_per_launch=cfg.samples_per_launch // 2), subframe)
        img = render_frame(scene, cam, cfg, subframe).clone()
        img[:, 1::2] = img[:, 0::2][:, : img[:, 1::2].shape[1]]   # every other pixel left out, its neighbour's
        return img

    monkeypatch.setattr(progressive, "render_frame", half)


def _altered(monkeypatch, progressive):
    render_frame = progressive.render_frame

    def altered(scene, cam, cfg, subframe):
        img = render_frame(scene, cam, cfg, subframe).clone()
        img.view(-1, 3)[::4] *= 1.1   # a quarter of the pixels 10% off
        return img

    monkeypatch.setattr(progressive, "render_frame", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_refused(cell, fault, monkeypatch):
    from tpu_pathtracer_torch.runtime import progressive

    fault(monkeypatch, progressive)
    res = run_cell(cell, 2**31 + 29)
    assert res["correct"] is False, res["check"]


def test_reference_counters_and_camera():
    seed = ref.make_seeds(torch.tensor([0, 5]), torch.tensor([0, 3]), torch.tensor([0, 2**31 + 5]))
    assert seed.dtype == torch.int64 and bool((seed & 1).all()) and int(seed.max()) < 2**32
    eye, u, v, w = ref.camera_frame((0, 2, 6), (0, 0, 0), (0, 1, 0), 50.0, 16 / 9)
    assert np.allclose(w, [0, -2, -6]) and abs(float(u @ w)) < 1e-5 and abs(float(v @ w)) < 1e-5
    assert np.linalg.norm(u) / np.linalg.norm(v) == pytest.approx(16 / 9, rel=1e-6)
