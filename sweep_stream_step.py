"""Kernel 7, the stream step (csrc/fused_schedule.cu, entry 0), by build,
on the main path's lane states (`CASES`: BASELINE config 1's pool of
16,384 lanes, the headline's 131,072 and 524,288, and the headline's
131,072 under NEE, each after 16 iterations of the unfused stream and
then until a step retires pixels, as chip_smoke.py's phases 18 and 18b
make them).

A build is "change" (csrc/ as it is), "parent" (--parent DIR, an older
csrc/ directory), any other csrc/ directory (--build NAME=DIR, as often
as wanted), or "wide": csrc/'s stream step with its two status words a
tile (the layout from 2^25 lanes) at every lane count, to read what the
wide layout would cost on the main path's pools.

Each build's kernel 7 is held bit-equal to fused_stream_step_plain on
every case (state, image, regen mask, head, segments, live and shadow
counts), then timed with the L2 flushed before each launch
(`chip_smoke._time_cold`) and warm, back to back behind a spin
(`chip_smoke._time_over`), the builds in turns (sweep_builds.in_turns).
One line a build and round, with the card's name and power limit.

    python3 sweep_stream_step.py [wide] [--parent DIR] [--build NAME=DIR ...] [--rounds R]

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
# (name, the lanes' frame and config, pool size)
CASES = (("config 1", cs.CONFIG1, 16_384), ("headline", cs.HEADLINE, 131_072),
         ("headline", cs.HEADLINE, 524_288), ("headline NEE", {**cs.HEADLINE, **cs.NEE}, 131_072))


def cases(scenes):
    """(name, the state the step reads and writes, payload, head, shadow or
    None, keywords) of each of CASES."""
    out = []
    for name, frame, lanes in CASES:
        cfg = RenderConfig(**{**frame, "stream_lanes": lanes})
        st, tb, head, _, *shadow = cs.lane_state(scenes[name.split(" NEE")[0]], cfg, Camera(), 16, retiring=True)
        st = {k: st[k] for k in cs.state_keys(cfg)}
        out.append((f"{name} {lanes}", st, tb, head, shadow[0] if shadow else None, cs.step_kw(cfg)))
    return out


def run(tb, st, head, shadow, kw, plain=False):
    """One step on `st` (changed in place): (state, image, result)."""
    seg = torch.tensor(12345, dtype=torch.int64, device=head.device)
    out = torch.zeros((kw["n_pix"] + 1, 3), device=head.device)
    step = fs.fused_stream_step_plain if plain else fs.fused_stream_step_cuda
    return st, out, step(tb, st, out, head, seg, shadow, **kw)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", choices=["wide"],
                        help="wide: kernel 7's two status words a tile at every lane count")
    parser.add_argument("--parent", help="an older csrc/ directory to time as well")
    parser.add_argument("--build", action="append", default=[], metavar="NAME=DIR",
                        help="another csrc/ directory to time as well, under NAME")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    smi = cs.phase_device()
    start = lambda name, src_dir, edit=None: sweep_builds.start("stream_step", name, src_dir, SOURCE, edit)  # noqa: E731
    jobs = ([start("parent", args.parent)] if args.parent else []) + [start("change", cuda_build.CSRC_DIR)]
    jobs += [start(name, d) for name, d in (b.split("=", 1) for b in args.build)]
    jobs += [start(name, cuda_build.CSRC_DIR, sweep_builds.always_wide) for name in sorted(set(args.variants))]
    cuda_build.build_libraries()
    builds = sweep_builds.finish(jobs, ("fused_step_kernel",))
    sets = cases({"headline": cs.headline_scene("cuda"), "config 1": cs.config1_scene("cuda")})
    for case, st, tb, head, shadow, kw in sets:
        want = run(tb, {k: v.clone() for k, v in st.items()}, head, shadow, kw, plain=True)
        for name, lib in builds:
            with cs.using_libraries({SOURCE: lib}):
                got = run(tb, {k: v.clone() for k, v in st.items()}, head, shadow, kw)
            torch.cuda.synchronize()
            bad = [k for k in st if not cs.same_bits(got[0][k], want[0][k])]
            bad += ["out"] * (not cs.same_bits(got[1], want[1])) + ["regen"] * (not torch.equal(got[2][0], want[2][0]))
            bad += [w for w, a, b in zip(("head", "segments", "live", "shadow"), got[2][1:], want[2][1:])
                    if int(a) != int(b)]
            if bad:
                raise SystemExit(f"sweep_stream_step: {name} on {case} differs from fused_stream_step_plain in {bad}")
        retired = int(want[2][1]) - int(head)
        print(f"[{case}] {st['slot'].shape[0]} lanes, {retired} pixels retired; every build bit-equal to "
              f"fused_stream_step_plain", flush=True)

    def times(lib):
        line = []
        for case, st, tb, head, shadow, kw in sets:
            seg = torch.tensor(12345, dtype=torch.int64, device=head.device)
            out = torch.zeros((kw["n_pix"] + 1, 3), device=head.device)

            def fn(s_):
                fs.fused_stream_step_cuda(tb, s_, out, head, seg, shadow, **kw)

            with cs.using_libraries({SOURCE: lib}):
                cold = cs._time_cold(fn, [{k: v.clone() for k, v in st.items()} for _ in range(21)])
                warm = cs._time_over(fn, [{k: v.clone() for k, v in st.items()} for _ in range(21)],
                                     device_only=True)
            line.append(f"{case} {cold:.4f} ({warm:.4f})")
        return "; ".join(line)

    sweep_builds.in_turns(builds, args.rounds, times, smi)
    return 1 if len(builds) < len(jobs) else 0


if __name__ == "__main__":
    sys.exit(main())
