"""On the card (marked cuda; skips without one): a short run of each
cell through the command the benchmark gives, its result line as the
format asks for it, and the control refused at the cell's own size."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    need_card()
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", cell, "--seed", "4294967311",
                          "--seconds", "3", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "check" and res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_refused_at_the_cells_size(cell):
    need_card()
    from bench_h100 import check, run

    c = run.Cell(cell, 12345)
    arrays, env = c.arrays()
    f32 = run.reference_values(c, arrays, env, 1, torch.device("cuda:0"), torch.float32)
    bf16 = run.reference_values(c, arrays, env, 1, torch.device("cuda:0"), torch.bfloat16)
    assert not check.judge(check.compare(bf16, f32), c.limits)


@pytest.mark.cuda
def test_a_traced_run_on_the_card():
    need_card()
    cell = "spheres1080.orbit"
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", cell, "--seed", "4294967321",
                          "--seconds", "4", "--trace", "1"], capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wanted = {m["name"] for m in bench["per_layer"] if cell in m["workloads"]}
    assert res["correct"] is True and set(res["metrics"]) <= wanted
    assert {"traversal_ms_per_iter.orbit", "device_idle_pct.orbit"} <= set(res["metrics"])
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"] and len(res["breakdown"]["idle_gaps"]) <= 10
    assert all(0 < res["metrics"][m]["value"] <= 100 for m in res["metrics"] if "roofline" in m or "mfu" in m)
