"""BENCHMARK.json against the rules of its format, and every file it
names found by name; a cell made only of new files runs."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_h100 import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "bench_h100/run.py"] and BENCH["paths"] == ["bench_h100"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}[section]
    names = [e["name"] for e in BENCH[section]]
    assert len(set(names)) == len(names)
    for e in BENCH[section]:
        assert set(e) <= allowed, e
        assert spec.NAME.match(e["name"])
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if section == "workloads":
            assert e["chips"] in (1, 4) and spec.NAME.match(e["config"]) and spec.NAME.match(e["traffic"])
        if section == "configs":
            assert all(spec.NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16


def test_metrics_cover_the_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = spec.metrics_of(BENCH, cell, "end_to_end")
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert spec.metrics_of(BENCH, cell, "per_layer")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        # every cell a per-layer metric lists reports the metric it moves
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_every_cell_finds_its_files(entry):
    cfg = spec.load_json("configs", entry["config"])
    mix = spec.load_json("mixes", entry["traffic"])
    limits = spec.load_json("cells", entry["name"])["limits"]
    kind = spec.kind(mix["kind"])
    assert cfg["render"]["width"] > 0 and limits
    assert all(callable(getattr(kind, f)) for f in ("subframe", "eye", "expected", "Loop"))
    spec.generator(cfg["scene"]["generator"])
    spec.generator(cfg["env"]["generator"])
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert config["file"] == f"bench_h100/configs/{entry['config']}.json"
    assert config["reduced"] == cfg["reduced"] and config["source"] == cfg["source"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(metric):
    mod = spec.reader(metric["name"])
    variant = metric["name"].split(".", 1)[-1]
    assert mod.UNIT == metric["unit"] and mod.LAYER == metric["layer"] and callable(mod.read)
    assert mod.MOVES.get(variant, metric["moves"]) == metric["moves"]


def test_files_under_paths_are_named_from_names():
    for path in (ROOT / "bench_h100").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" in rel:
            continue
        assert all(spec.NAME.match(part) for part in rel.split("/")), rel


# A kind of traffic no file has yet: every launch restarts the still at the
# next subframe, and the check compares each launch's image.
REDRAW = """
import torch


def subframe(tr, k):
    return tr.start_subframe + k


def eye(tr, k):
    return tuple(tr.camera["eye"])


class Loop:
    def __init__(self, tr, r, program, device):
        self.tr, self.r, self.pix, self.got = tr, r, tr.pixels_on(device), []

    def launch(self, k, spans=None):
        self.r.reset()
        self.r.subframe = subframe(self.tr, k)
        return self.r.step()

    def keep(self, img):
        self.got.append(img.reshape(-1, 3)[self.pix])

    def values(self):
        return torch.stack(self.got).cpu().numpy()


def expected(per_launch, tr, ref):
    return per_launch
"""


def test_a_cell_of_new_files_runs(tmp_path):
    """A later change adds a configuration, a mix with a launch loop of a
    new kind, a per-layer metric and a cell as new files and entries, with
    no edit to a file already there."""
    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    b = tmp_path / "bench_h100"
    cfg = json.loads((b / "configs" / "spheres1080.json").read_text())
    cfg["scene"]["args"] = {"stacks": 8, "slices": 16}
    cfg["render"].update(width=24, height=16, max_depth=3)
    (b / "configs" / "spheres_tiny.json").write_text(json.dumps(cfg))
    (b / "mixes" / "few.json").write_text(json.dumps({"kind": "redraw", "samples_per_launch": 2,
                                                      "check_pixels": 12}))
    (b / "kinds" / "redraw.py").write_text(REDRAW)
    (b / "metrics" / "launch_count.py").write_text(
        'UNIT = "count"\nLAYER = "frame"\nMOVES = {}\nKERNELS = ()\n\n\ndef read(ctx):\n    return ctx.launches\n')
    (b / "cells" / "spheres_tiny.few.json").write_text(json.dumps({"limits": {"mismatch_share": 0.05,
                                                                              "rel_l1": 0.001}}))
    bench["configs"].append(dict(bench["configs"][0], name="spheres_tiny",
                                 file="bench_h100/configs/spheres_tiny.json"))
    bench["workloads"].append({"name": "spheres_tiny.few", "config": "spheres_tiny", "traffic": "few", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("spheres_tiny.few")
    bench["per_layer"].append({"name": "launch_count.few", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "frame", "moves": "msamples_per_s",
                               "workloads": ["spheres_tiny.few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; from bench_h100 import run, spec; "
            "c, res = run.run(['--workload', 'spheres_tiny.few', '--seed', '2147483659', '--seconds', '0.1', "
            "'--trace', '0'], device='cpu'); "
            "print(json.dumps(dict(code=c, correct=res['correct'], metrics=sorted(res['metrics']), "
            "reader=spec.reader('launch_count.few').UNIT, file=spec.__file__)))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(ROOT)], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["code"] == 0 and got["correct"] is True
    assert got["metrics"] == ["msamples_per_s", "setup_s"] and got["reader"] == "count"
    assert got["file"].startswith(str(tmp_path))
