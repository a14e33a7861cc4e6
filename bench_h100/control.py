"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process: for each seed, a window at the cell's
load as a run makes it, then the numbers that the check compares for the
program against the float32 reference (sound runs: the lower reading)
and for the reference computed in bfloat16, put in the program's place,
against the float32 one (the control: the upper reading).

    python3 bench_h100/control.py --workload NAME --seconds S --seeds 1,2,3

Prints one JSON line a seed.  It is not part of a benchmark run."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100 import check, run  # noqa: E402


def readings(workload: str, seconds: float, seeds, device=None, overrides=None):
    import torch

    from bench_h100 import program

    device = torch.device(device or "cuda:0")
    cell = run.Cell(workload, seeds[0], overrides=overrides)
    arrays, env = cell.arrays()
    tr = cell.traffic
    scene, cfg = program.build(arrays, env, tr.render, cell.config.get("accel"), device)
    r = program.renderer(scene, program.camera(tr.camera, tr.eye(-1)), cfg)
    r.step()
    out = []
    for seed in seeds:
        cell = run.Cell(workload, seed, overrides=overrides)
        r.reset()
        r.subframe = cell.traffic.subframe(0)
        times, wall, values, _ = run.window(cell, r, program, device, seconds, False)
        t0 = time.perf_counter()
        f32 = run.reference_values(cell, arrays, env, len(times), device, torch.float32)
        t1 = time.perf_counter()
        bf16 = run.reference_values(cell, arrays, env, len(times), device, torch.bfloat16)
        row = dict(seed=seed, launches=len(times), program=check.compare(values, f32),
                   control=check.compare(bf16, f32), reference_s=t1 - t0)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_h100/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    readings(args.workload, args.seconds, [int(s) for s in args.seeds.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
