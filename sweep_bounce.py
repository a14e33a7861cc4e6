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
import sys

import torch

import chip_smoke as cs
import sweep_builds
from tpu_pathtracer_torch.ops import bounce as bounce_ops
from tpu_pathtracer_torch.ops import cuda_build
from tpu_pathtracer_torch.render import integrator

KERNEL_NAMES = ("bounce_kernel", "shade_lanes_kernel")


def set_constants(sets):
    """An edit of bounce.cu's text: the constants of `sets` ((name, value)
    pairs) set."""
    def edit(text):
        for key, value in sets:
            if key == "kMinBlocks" and value == "0":
                text, n = re.subn(r"__launch_bounds__\(kThreads, kMinBlocks\) bounce_kernel",
                                  "__launch_bounds__(kThreads) bounce_kernel", text)
            else:
                text, n = re.subn(rf"\b{key} = [^;]+;", f"{key} = {value};", text)
            if n != 1:
                raise SystemExit(f"{key} not found in bounce.cu")
        return text

    return edit


def launch(lib, args):
    params, out, keep = bounce_ops.bounce_args(*args)
    err = lib.bounce_launch(ctypes.addressof(params), 0, torch.cuda.current_stream().cuda_stream)
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
    start = lambda name, src_dir, edit=None: sweep_builds.start("bounce", name, src_dir, "bounce.cu", edit)  # noqa: E731
    jobs = ([start("parent", args.parent)] if args.parent else []) + [start("change", cuda_build.CSRC_DIR)]
    jobs += [start(v.replace(",", "_").replace("=", ""), cuda_build.CSRC_DIR,
                   set_constants([tuple(kv.split("=", 1)) for kv in v.split(",")])) for v in args.variants]
    builds = sweep_builds.finish(jobs, KERNEL_NAMES)
    sets = cs.bounce_lane_sets(cs.headline_scene("cuda"), cs.config1_scene("cuda"))
    for set_name, set_args in sets:
        want = integrator._bounce_plain(*set_args)
        for name, lib in builds:
            got, _ = launch(lib, set_args)
            torch.cuda.synchronize()
            bad = [k for k in got if not cs.same_bits(got[k], want[k])]
            if bad:
                raise SystemExit(f"sweep_bounce: {name} on {set_name} differs from _bounce_plain in {bad}")
        hits, mixed = cs.hit_shares(set_args)
        print(f"[{set_name}] hit share {hits:.4f}, warps mixing hits and misses {mixed:.4f}; every build bit-equal "
              f"to _bounce_plain", flush=True)

    def times(lib):
        line = []
        for set_name, set_args in sets:
            cold = cs._time_cold(lambda _: launch(lib, set_args), [None] * 21)
            warm = cs._time_over(lambda _: launch(lib, set_args), [None] * 21, device_only=True)
            line.append(f"{set_name.split(' (')[0]} {cold:.4f} ({warm:.4f})")
        return ", ".join(line)

    sweep_builds.in_turns(builds, args.rounds, times, smi)
    return 1 if len(builds) < len(jobs) else 0


if __name__ == "__main__":
    sys.exit(main())
