"""The path step (csrc/fused_schedule.cu, entry 1) by build, on the lane
states of chip_smoke.py's phase 18c (`chip_smoke.PATH_STEP_CASES`: a
1-spp tile of render_rays after 0, 2 and 6 iterations and after 2 under
NEE, render_pixels_regen at 131,072 lanes without and with NEE and at a
1080p frame's 2,073,600; the headline scene).

A build is "change" (csrc/ as it is), "parent" (--parent DIR, an older
csrc/ directory), any other csrc/ directory (--build NAME=DIR, as often
as wanted), "no_grid_sum": csrc/'s path step without its counts and
their sum (its tiles' words; segments, shadow and done are then not
written), to read the sum's share of the kernel, or "wide": csrc/'s path
step with its two-word count (the layout from 2^25 lanes) at every lane
count, to read what the wide layout would cost on the main path's pools.

Each build's path step is held bit-equal to path_step_plain on every
case (no_grid_sum: every buffer but segments, shadow and done), then
timed with the L2 flushed before each launch (`chip_smoke._time_cold`)
and warm, back to back behind a spin (`chip_smoke._time_over`), alone
(an ordinary launch, as phase 18c times it), the builds in turns
(sweep_builds.in_turns).  One line a build and round, with the card's
name and power limit.

    python3 sweep_path_step.py [no_grid_sum] [wide] [--parent DIR] [--build NAME=DIR ...] [--rounds R]

Needs a card.
"""

from __future__ import annotations

import argparse
import sys

import torch

import chip_smoke as cs
import sweep_builds
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.ops import cuda_build
from tpu_pathtracer_torch.ops import fused_schedule as fs
from tpu_pathtracer_torch.render.camera import Camera

SOURCE = "fused_schedule.cu"
NOT_SUMMED = ("segments", "shadow", "done")


def without_grid_sum(text):
    """fused_schedule.cu's text with the path step's counts and their sum
    cut: from the comment that opens them to the kernel's end."""
    kernel = text.index("path_step_kernel(const __grid_constant__")
    start = text.index("\n  // The counts: each warp's by ballot", kernel)
    end = text.index("\n}\n", start)
    if "*p.done =" not in text[start:end] or "__global__" in text[start:end]:
        raise SystemExit("the path step's counts and their sum were not found in fused_schedule.cu")
    return text[:start] + text[end:]


def cases(scene):
    """(name, buffers, payload, keywords) of each of PATH_STEP_CASES."""
    out = []
    for name, schedule, over, n, iters, _ in cs.PATH_STEP_CASES:
        st, tb, kw = cs.path_lane_state(scene, RenderConfig(**{**cs.HEADLINE, **over}), Camera(), schedule, n, iters)
        out.append((name, st, tb, kw))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", choices=["no_grid_sum", "wide"],
                        help="no_grid_sum: the path step's sum cut; wide: its two-word count at every lane count")
    parser.add_argument("--parent", help="an older csrc/ directory to time as well")
    parser.add_argument("--build", action="append", default=[], metavar="NAME=DIR",
                        help="another csrc/ directory to time as well, under NAME")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    smi = cs.phase_device()
    start = lambda name, src_dir, edit=None: sweep_builds.start("path_step", name, src_dir, SOURCE, edit)  # noqa: E731
    jobs = ([start("parent", args.parent)] if args.parent else []) + [start("change", cuda_build.CSRC_DIR)]
    jobs += [start(name, d) for name, d in (b.split("=", 1) for b in args.build)]
    edits = dict(no_grid_sum=without_grid_sum, wide=sweep_builds.always_wide)
    jobs += [start(name, cuda_build.CSRC_DIR, edits[name]) for name in sorted(set(args.variants))]
    cuda_build.build_libraries()
    builds = sweep_builds.finish(jobs, ("path_step_kernel",))
    sets = cases(cs.headline_scene("cuda"))
    for case, st, tb, kw in sets:
        want = {k: v.clone() for k, v in st.items()}
        fs.path_step_plain(tb, want, **kw)
        for name, lib in builds:
            got = {k: v.clone() for k, v in st.items()}
            with cs.using_libraries({SOURCE: lib}):
                fs.path_step_cuda(tb, got, **kw)
            torch.cuda.synchronize()
            skip = NOT_SUMMED if name == "no_grid_sum" else ()
            bad = [k for k in st if k not in skip and not cs.same_bits(got[k], want[k])]
            if bad:
                raise SystemExit(f"sweep_path_step: {name} on {case} differs from path_step_plain in {bad}")
        live = int((~st["terminated" if kw["schedule"] == "rays" else "exhausted"]).sum())
        print(f"[{case}] {st['seeds'].shape[0]} lanes, {live} live; every build bit-equal to path_step_plain"
              f"{' (no_grid_sum: but ' + ', '.join(NOT_SUMMED) + ')' if 'no_grid_sum' in args.variants else ''}",
              flush=True)

    def times(lib):
        line = []
        for case, st, tb, kw in sets:
            reps = 21 if st["seeds"].shape[0] < 1_000_000 else 11

            def fn(s_):
                fs.path_step_cuda(tb, s_, **kw)

            with cs.using_libraries({SOURCE: lib}):
                cold = cs._time_cold(fn, [{k: v.clone() for k, v in st.items()} for _ in range(reps)])
                warm = cs._time_over(fn, [{k: v.clone() for k, v in st.items()} for _ in range(reps)],
                                     device_only=True)
            line.append(f"{case} {cold:.4f} ({warm:.4f})")
        return "; ".join(line)

    sweep_builds.in_turns(builds, args.rounds, times, smi)
    return 1 if len(builds) < len(jobs) else 0


if __name__ == "__main__":
    sys.exit(main())
