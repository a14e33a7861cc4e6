"""The brute-force kernels (csrc/brute.cu) by build, on chip_smoke.py's
phase 40 cases (`chip_smoke.brute_timed_cases`: the closest hit at the
headline's 131,072 rays, the NEE study's 19,200, config 1's 16,384 x
4,098 and a 1-spp tile's 345,600; the any hit on the headline's and the
study's NEE shadow rays with their candidate mask).

A build is "change" (csrc/ as it is), "parent" (--parent DIR, an older
csrc/ directory), any other csrc/ directory (--build NAME=DIR), an
ablation of csrc/'s brute.cu with one of its switches set:

    no_gate     BRUTE_GATE 0: every pair tested in full, no vote
    runtime_p   BRUTE_STATIC_P 0: the closest hit's threads a ray a runtime value
    no_compact  BRUTE_COMPACT 0: the any hit lists every ray of its slice once
    rays1       BRUTE_RAYS_PER_THREAD 1: one ray a thread in the closest hit
    rays4       BRUTE_RAYS_PER_THREAD 4

or NAME=V[,NAME=V]: csrc/'s brute.cu with those constants set (e.g.
kAnyWaves=8, kWaves=8).

Each build is held to the plain versions on every case (the Hit bit for
bit; the flags on the active lanes, False off them), then timed with the
L2 flushed before each launch (`chip_smoke._time_cold`) and warm, back to
back behind a spin (`chip_smoke._time_over`), the builds in turns
(sweep_builds.in_turns).  One line a build and round, with the card's name
and power limit; each build's registers and spills from nvcc's report and
its launch shape at each size.

--sass DIR writes `cuobjdump -sass` of each build's library to DIR and
prints count_sass's lines; `--count DIR` only counts the .sass files
already in DIR (no card needed).

    python3 sweep_brute.py [VARIANT ...] [--parent DIR] [--build NAME=DIR ...] [--rounds R] [--sass DIR]
    python3 sweep_brute.py --count DIR

Needs a card but for --count.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

SOURCE = "brute.cu"
VARIANTS = {"no_gate": "BRUTE_GATE 0", "runtime_p": "BRUTE_STATIC_P 0", "no_compact": "BRUTE_COMPACT 0",
            "rays1": "BRUTE_RAYS_PER_THREAD 1", "rays4": "BRUTE_RAYS_PER_THREAD 4"}

# SASS opcodes by what they do in a test (the division's Newton steps are
# the only FFMA of a -fmad=false build)
CATEGORIES = (("float", ("FMUL", "FADD")),
              ("shared loads", ("LDS",)),
              ("division", ("MUFU", "FCHK", "FFMA", "CALL")),
              ("compare/select", ("FSETP", "FSEL", "SEL", "PLOP3", "VOTE", "P2R", "R2P")),
              ("loop control", ("BRA", "ISETP", "IADD3", "IMAD", "LEA", "BSSY", "BSYNC", "WARPSYNC")))
INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def variant_edit(variant):
    """The edit of brute.cu's text that makes a variant: a switch of
    VARIANTS defined ahead of the source, or constants NAME=V set."""
    if variant in VARIANTS:
        return lambda text: f"#define {VARIANTS[variant]}\n" + text

    def edit(text):
        for key, value in (kv.split("=", 1) for kv in variant.split(",")):
            text, n = re.subn(rf"\bconstexpr (int|float|bool) {key} = [^;]+;", rf"constexpr \g<1> {key} = {value};",
                              text)
            if n != 1:
                raise SystemExit(f"{key} not found in brute.cu")
        return text

    return edit


def category(opcode):
    base = opcode.split(".")[0]
    return next((name for name, ops in CATEGORIES if base in ops), "other")


def functions(sass):
    """{function name: [(address, predicate, opcode, operands)]} of a
    cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = INSTRUCTION.search(line)
        if m and name:
            out[name].append((int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3), m.group(4).strip()))
    return out


def branch_target(operands):
    m = re.match(r"`?\(?\s*0x([0-9a-f]+)", operands)
    return int(m.group(1), 16) if m else None


def test_loop(code):
    """The loop of a kernel that holds its tests: of the loops (a
    predicated backward branch and its target; the unpredicated ones jump
    back from a vote's out-of-line divergence path), the innermost ones
    holding a shared load, the one with the most FMUL.  Returns (start,
    end) addresses or None."""
    loops = [(branch_target(ops), addr) for addr, pred, op, ops in code
             if pred and op.startswith("BRA") and branch_target(ops) is not None and branch_target(ops) <= addr]
    inner = [(a, b) for a, b in loops if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]

    def fmuls(lo, hi):
        return sum(1 for addr, _, op, _ in code if lo <= addr <= hi and op.startswith("FMUL"))

    held = [(a, b) for a, b in inner if any(a <= addr <= b and op.startswith("LDS") for addr, _, op, _ in code)]
    return max(held, key=lambda ab: fmuls(*ab), default=None)


def count_loop(code, loop):
    """The test loop's instructions: its body, the tests an iteration
    (one VOTE a test where the gate votes, else one MUFU.RCP, the
    division's), and the tails: what a forward branch right after a vote
    skips.  Returns (body, tests, {category: count a test on the gate's
    path}, instructions a test in the tails)."""
    lo, hi = loop
    body = [x for x in code if lo <= x[0] <= hi]
    votes = [i for i, x in enumerate(body) if x[2].startswith("VOTE")]
    tests = len(votes) or sum(1 for x in body if x[2].startswith("MUFU.RCP"))
    skipped = set()
    for i in votes:
        for addr, pred, op, ops in body[i + 1:i + 4]:
            target = branch_target(ops) if op.startswith("BRA") else None
            if pred and target is not None and target > addr:
                skipped.update(a for a, *_ in body if addr < a < target)
                break
    hot = [x for x in body if x[0] not in skipped]
    counts = {}
    for _, _, op, _ in hot:
        counts[category(op)] = counts.get(category(op), 0) + 1
    return len(body), max(tests, 1), counts, len(skipped)


def count_sass(name, sass):
    """A line per brute_kernel instantiation of a build's SASS: the test
    loop's length, tests an iteration, and the instructions a test on the
    gate's path by category, the tail's aside."""
    lines = []
    for fn, code in functions(sass).items():
        if "brute_kernel" not in fn:
            continue
        loop = test_loop(code)
        if loop is None:
            lines.append(f"[sass] {name} {fn}: no test loop found")
            continue
        body, tests, counts, tail = count_loop(code, loop)
        per = ", ".join(f"{k} {v / tests:.2f}" for k, v in sorted(counts.items()))
        lines.append(f"[sass] {name} {fn}: loop {loop[0]:#x}-{loop[1]:#x}, {body} instructions, {tests} tests an "
                     f"iteration; a test on the gate's path {sum(counts.values()) / tests:.2f} ({per}); the tails "
                     f"{tail / tests:.2f} a test more where a vote takes them")
    return lines


def dump_sass(name, library_path, out_dir):
    """cuobjdump -sass of a library into out_dir/NAME.sass; its text."""
    from tpu_pathtracer_torch.ops import cuda_build

    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(library_path)], check=True, capture_output=True, text=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.sass").write_text(text)
    return text


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*",
                        help=f"ablations of csrc/'s brute.cu ({', '.join(VARIANTS)}) or NAME=V[,NAME=V]")
    parser.add_argument("--parent", help="an older csrc/ directory to time as well")
    parser.add_argument("--build", action="append", default=[], metavar="NAME=DIR",
                        help="another csrc/ directory to time as well, under NAME")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--sass", help="write each build's SASS here and count its test loop")
    parser.add_argument("--count", help="count the test loops of the .sass files in this directory, and stop")
    args = parser.parse_args()
    if args.count:
        for path in sorted(Path(args.count).glob("*.sass")):
            print("\n".join(count_sass(path.stem, path.read_text())), flush=True)
        return 0

    import torch

    import chip_smoke as cs
    import sweep_builds
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.ops import cuda_build
    from tpu_pathtracer_torch.ops import intersect as brute_ops
    from tpu_pathtracer_torch.render.camera import Camera

    smi = cs.phase_device()
    start = lambda name, src_dir, edit=None: sweep_builds.start("brute", name, src_dir, SOURCE, edit)  # noqa: E731
    jobs = ([start("parent", args.parent)] if args.parent else []) + [start("change", cuda_build.CSRC_DIR)]
    jobs += [start(name, d) for name, d in (b.split("=", 1) for b in args.build)]
    jobs += [start(v, cuda_build.CSRC_DIR, variant_edit(v)) for v in dict.fromkeys(args.variants)]
    builds = sweep_builds.finish(jobs, ("brute_kernel",))
    if args.sass:
        libraries = {name: out for name, (_, _, out, _) in jobs}
        for name, _ in builds:
            print("\n".join(count_sass(name, dump_sass(name, libraries[name], Path(args.sass)))), flush=True)

    cases = cs.brute_timed_cases((cs.headline_scene("cuda"), RenderConfig(**{**cs.HEADLINE, **cs.NEE}), Camera()),
                                 cs.brute_config1())
    sets = []
    for what, scene, cfg, camera, n, any_hit in cases:
        v = scene.vertices
        if any_hit:
            o, d, active = cs.brute_shadow_rays(scene, cfg, camera, n)
            want = brute_ops.occluded_brute_plain(v, o, d, cfg.t_min, cfg.t_max, cfg.intersect_block)
        else:
            (o, d), active = cs.brute_rays(scene, cfg, camera, n), None
            want = brute_ops.intersect_brute_plain(v, o, d, cfg.t_min, cfg.t_max, cfg.intersect_block)

        def kernel(_=None, v=v, o=o, d=d, cfg=cfg, active=active, any_hit=any_hit):
            if any_hit:
                return brute_ops.occluded_brute_cuda(v, o, d, cfg.t_min, cfg.t_max, active)
            return brute_ops.intersect_brute_cuda(v, o, d, cfg.t_min, cfg.t_max)

        shapes = []
        for name, lib in builds:
            with cs.using_libraries({SOURCE: lib}):
                got = kernel()
            torch.cuda.synchronize()
            ok = (torch.equal(got[active], want[active]) and not bool(got[~active].any()) if any_hit
                  else cs.hit_bits_equal(got, want))
            if not ok:
                raise SystemExit(f"sweep_brute: {name} on {what} differs from its plain version")
            try:
                sh = brute_ops.brute_launch_shape(n, any_hit, lib)
                shapes.append(f"{name} {sh['threads_per_ray']} a ray, {sh['rays_per_block']} rays a block, "
                              f"{sh['blocks']} blocks, {sh['registers']} registers, {sh['resident_blocks']} an SM")
            except (RuntimeError, OSError):
                shapes.append(f"{name} (no shape)")
        print(f"[{what}] {n} rays x {v.shape[0]} triangles"
              f"{f', {int(active.sum())} active' if any_hit else ''}; every build equal to its plain version; "
              + "; ".join(shapes), flush=True)
        sets.append((what, kernel))

    def times(lib):
        line = []
        with cs.using_libraries({SOURCE: lib}):
            for what, kernel in sets:
                cold = cs._time_cold(kernel, [None] * 11)
                warm = cs._time_over(kernel, [None] * 21, device_only=True)
                line.append(f"{what} {cold:.4f} ({warm:.4f})")
        return "; ".join(line)

    sweep_builds.in_turns(builds, args.rounds, times, smi)
    return 1 if len(builds) < len(jobs) else 0


if __name__ == "__main__":
    sys.exit(main())
