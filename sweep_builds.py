"""What the sweeps of one kernel by build share (sweep_bounce.py,
sweep_path_step.py, sweep_stream_step.py): builds of one csrc/ source,
each from a copy of a csrc/ directory with the source's text edited or
not (always_wide: fused_schedule.cu's wide layouts at every lane count),
compiled all at once; each library loaded as chip_smoke.py loads a parent's
(`chip_smoke.load_library`), with its kernels' registers, stack and
spills from nvcc's -Xptxas -v report; and the builds timed in turns,
each round forwards, then backwards, one line a build and round.

Needs nvcc, and a card to time.
"""

from __future__ import annotations

import shutil

import chip_smoke as cs
from tpu_pathtracer_torch.ops import cuda_build

ROOT = cuda_build.BUILD_DIR / "sweeps"


def always_wide(text):
    """fused_schedule.cu's text with the wide layouts at every lane count
    (kNarrowLanes 0): the path step's two-word count and kernel 7's two
    status words a tile."""
    old = "constexpr int kNarrowLanes = 1 << 25;"
    if old not in text:
        raise SystemExit("kNarrowLanes was not found in fused_schedule.cu")
    return text.replace(old, "constexpr int kNarrowLanes = 0;")


def start(sweep, name, src_dir, source, edit=None):
    """nvcc on `source` in a copy of the csrc/ directory `src_dir`, its
    text passed through `edit` where given: the job."""
    d = ROOT / sweep / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    if edit is not None:
        (d / source).write_text(edit((d / source).read_text()))
    return name, cs.start_builds({source: d / source}, d)[0]


def finish(jobs, kernels):
    """[(name, library)] of the jobs whose build compiled, with a line of
    each one's report for the kernels whose mangled names hold one of
    `kernels`; nvcc's errors printed for each that did not compile."""
    built = []
    for name, (source, _, out, proc) in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"[{name}] nvcc failed on {source}:\n{log[-4000:]}", flush=True)
            continue
        report = {k: v for mangled, v in cuda_build.ptxas_report(log).items() for k in kernels if k in mangled}
        print(f"[{name}] built; " + "; ".join(f"{k}: {v}" for k, v in report.items()), flush=True)
        built.append((name, cs.load_library(source, out)))
    return built


def in_turns(builds, rounds, time_build, smi):
    """`rounds` rounds over the builds ([(name, library)]), each forwards,
    then backwards: a line a build and round, `time_build(library)` its
    times, with the card's name and power limit (`smi`)."""
    for r in range(rounds):
        for name, lib in builds + builds[::-1]:
            print(f"[round {r + 1}] {name}: {time_build(lib)} ms with the L2 flushed (warm) | {smi}", flush=True)
