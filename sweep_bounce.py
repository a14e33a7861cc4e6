"""The bounce kernel (csrc/bounce.cu) by build and launch shape, on two
sets of lanes at 16,384 and 131,072 lanes:

  * "camera": chip_smoke.py's phase 35 lanes (`chip_smoke.shade_inputs`:
    camera rays and their first bounces on the headline scene, sorted as
    the accel sorts them; nearly all of the camera rays hit);
  * "render": the lane pool of the headline's fused stream (131,072
    lanes) as the bounce kernel gets it in the middle iteration of a
    frame, and its first 16,384 lanes; and BASELINE config 1's pool
    (16,384 lanes) in the middle iteration of its frame
    (`chip_smoke.bounce_lane_sets`).

Each build's kernel is held bit-equal to `_bounce_plain` on every set,
then timed with the L2 flushed before each launch
(`chip_smoke._time_cold`) and warm, back to back behind a spin
(`chip_smoke._time_over`), the builds in turns (each round forwards,
then backwards).  A build is "change" (csrc/ as it is), "parent"
(--parent DIR, an older csrc/ directory), or a variant NAME=V[,NAME=V]:
csrc/'s bounce.cu with those constants set: kThreads (threads a block)
and kMinBlocks (the least blocks an SM in the launch bounds; 0: none).
Each build's registers, stack and spills come from nvcc's -Xptxas -v
report.  One line a build and round, with the card's name and power
limit; the hit share of each set, and the share of its warps that mix
hits and misses.

    python3 sweep_bounce.py [NAME=V[,NAME=V] ...] [--parent DIR] [--rounds R]

Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys

import torch

import chip_smoke as cs
from tpu_pathtracer_torch.ops import bounce as bounce_ops
from tpu_pathtracer_torch.ops import cuda_build
from tpu_pathtracer_torch.render import integrator

ROOT = cuda_build.BUILD_DIR / "sweep_bounce"
KERNEL_NAMES = ("bounce_kernel", "shade_lanes_kernel")


def start_build(name, src_dir, sets=()):
    """nvcc on a copy of `src_dir`'s bounce.cu, with the constants of
    `sets` ((name, value) pairs) set."""
    d = ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    src = d / "bounce.cu"
    text = src.read_text()
    for key, value in sets:
        if key == "kMinBlocks" and value == "0":
            text, n = re.subn(r"__launch_bounds__\(kThreads, kMinBlocks\) bounce_kernel",
                              "__launch_bounds__(kThreads) bounce_kernel", text)
        else:
            text, n = re.subn(rf"\b{key} = [^;]+;", f"{key} = {value};", text)
        if n != 1:
            raise SystemExit(f"{key} not found in bounce.cu")
    src.write_text(text)
    out = d / "bounce.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(d / "bounce.cu")]
    return name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(job):
    """(the library's bounce_launch, its kernels' -Xptxas -v report), or
    None, with nvcc's errors printed, where the build failed."""
    name, out, proc = job
    log = proc.communicate()[0]
    if proc.returncode:
        print(f"[{name}] nvcc failed on bounce.cu:\n{log[-4000:]}", flush=True)
        return None
    fn = ctypes.CDLL(str(out.resolve())).bounce_launch
    fn.argtypes, fn.restype = cuda_build.LAUNCHERS["bounce.cu"][1], ctypes.c_int
    report = {k: v for mangled, v in cuda_build.ptxas_report(log).items() for k in KERNEL_NAMES if k in mangled}
    return fn, report


def launch(fn, args):
    params, out, keep = bounce_ops.bounce_args(*args)
    err = fn(ctypes.addressof(params), 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"bounce_launch failed: CUDA error {err}")
    return out, keep


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", help="NAME=V[,NAME=V]: bounce.cu's constants set")
    parser.add_argument("--parent", help="an older csrc/ directory to time as well")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    smi = cs.phase_device()
    jobs = ([start_build("parent", args.parent)] if args.parent else []) + [start_build("change", cuda_build.CSRC_DIR)]
    jobs += [start_build(v.replace(",", "_").replace("=", ""), cuda_build.CSRC_DIR,
                         [tuple(kv.split("=", 1)) for kv in v.split(",")]) for v in args.variants]
    built = [(job[0], finish_build(job)) for job in jobs]
    builds = [(name, *b) for name, b in built if b is not None]
    for name, _, report in builds:
        print(f"[{name}] " + "; ".join(f"{k}: {v}" for k, v in report.items()), flush=True)
    sets = cs.bounce_lane_sets(cs.headline_scene("cuda"), cs.config1_scene("cuda"))
    for set_name, set_args in sets:
        want = integrator._bounce_plain(*set_args)
        for name, fn, _ in builds:
            got, _ = launch(fn, set_args)
            torch.cuda.synchronize()
            bad = [k for k in got if not cs.same_bits(got[k], want[k])]
            if bad:
                raise SystemExit(f"sweep_bounce: {name} on {set_name} differs from _bounce_plain in {bad}")
        hits, mixed = cs.hit_shares(set_args)
        print(f"[{set_name}] hit share {hits:.4f}, warps mixing hits and misses {mixed:.4f}; every build bit-equal "
              f"to _bounce_plain", flush=True)
    for r in range(args.rounds):
        for name, fn, _ in builds + builds[::-1]:
            line = []
            for set_name, set_args in sets:
                cold = cs._time_cold(lambda _: launch(fn, set_args), [None] * 21)
                warm = cs._time_over(lambda _: launch(fn, set_args), [None] * 21, device_only=True)
                line.append(f"{set_name.split(' (')[0]} {cold:.4f} ({warm:.4f})")
            print(f"[round {r + 1}] {name}: " + ", ".join(line) + f" ms with the L2 flushed (warm) | {smi}",
                  flush=True)
    return 1 if len(builds) < len(built) else 0


if __name__ == "__main__":
    sys.exit(main())
