"""How the two-level kernels' launch shape was chosen: kernels 2 and 5 (the
hier route, csrc/cluster_hier.cu, csrc/cluster_occluded_hier.cu) and 3 and
6 (the streamed route, csrc/cluster_streamed.cu,
csrc/cluster_occluded_streamed.cu), all streamed_kernel of
csrc/cluster_streamed.cuh, rebuilt with one fixed shape each and timed on
chip_smoke.py's rays: phases 6 and 12 (BASELINE config 4's scene) for
kernels 2 and 5, phases 7 and 13 (the 200k-triangle scene) for kernels 3
and 6, 131,072 rays each, and the same rays tiled 2, 4, 8 and 16 times,
every result held bit-equal to the plain version's.

    python3 sweep_streamed.py [G,T ...] [--kernels k2,k5,k3,k6] [--parent DIR]
                              [--no-order | --visit-order] [--rounds N]

A shape G,T spreads a packet over a thread block cluster of G blocks and
gives a ray T threads (kShapeRules of csrc/cluster_streamed.cuh pinned to
that one shape for both visit orders); "rules" builds the sources as they
are.  --parent DIR also
times the kernels of an older csrc/ directory, first in every round: a
library there whose launch function has no `_weights` companion takes no
packet order, and an older hier launch (one block a packet, one thread a
ray) takes order_super and no packet order.  Packets go heaviest first by
the pre-pass's estimate, as the wrappers launch them; --no-order launches
them in index order, --visit-order heaviest first by the true per-packet
visit counts of the plain version.  One line per build and round, with
the card's name, power limit and SM clock; times in ms, Baldwin-Weber
unless marked mt.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.ops import cuda_build
from tpu_pathtracer_torch.ops import intersect_cluster as ic
from tpu_pathtracer_torch.render.camera import Camera

ROOT = cuda_build.BUILD_DIR / "sweep"
# kernel: (source, any hit, scene's triangles)
KERNELS = {
    "k2": ("cluster_hier.cu", False, 100_000),
    "k5": ("cluster_occluded_hier.cu", True, 100_000),
    "k3": ("cluster_streamed.cu", False, 200_000),
    "k6": ("cluster_occluded_streamed.cu", True, 200_000),
}
TILES = (2, 4, 8, 16)


def start_build(name, src_dir, sources, rule=None):
    """Start nvcc on each of `sources` in a copy of `src_dir`, with
    kShapeRules cut to `rule` = (G, T) if given.  Returns the jobs for
    `finish_build`."""
    d = ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    if rule:
        header = d / "cluster_streamed.cuh"
        text, count = re.subn(r"kShapeRules\[\] = \{.*?\};", "kShapeRules[] = {{kAscending, 1 << 30, %d, %d}, {kPerPacket, 1 << 30, %d, %d}};"
                              % (rule * 2), header.read_text(), flags=re.S)
        if count != 1:
            raise SystemExit("kShapeRules not found in cluster_streamed.cuh")
        header.write_text(text)
    jobs = []
    for f in sources:
        out = d / (Path(f).stem + ".so")
        jobs.append((name, f, out, subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(d / f)],
                                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return jobs


def finish_build(jobs):
    """{source: (launch, weights or None)} once the jobs' nvcc are done."""
    libs = {}
    for name, f, out, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {f} ({name}):\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out.resolve()))
        launcher, argtypes = cuda_build.LAUNCHERS[f]
        weights = getattr(lib, launcher.replace("_launch", "_weights"), None)
        if weights is None:  # no packet order: the pointer before n goes
            cut = argtypes.index(ctypes.c_int) - 1
            argtypes = argtypes[:cut] + argtypes[cut + 1:]
        else:
            weights.argtypes, weights.restype = cuda_build.HELPERS[f][launcher.replace("_launch", "_weights")], ctypes.c_int
        fn = getattr(lib, launcher)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[f] = (fn, weights)
    return libs


def launch(fns, any_hit, args, order_by):
    """One launch through a library's own functions, as the wrappers of
    ops/intersect_cluster.py make it.  `order_by`: "estimate" (the
    pre-pass), "index", or the per-packet visit counts to sort by."""
    fn, weights = fns
    tris, child, supers, *order_super, o, d, t_min, t_max, rpt, branch, tri_test = args
    n = o.shape[0]
    order = ()
    if weights is not None:
        if isinstance(order_by, torch.Tensor):
            by_weight = torch.argsort(order_by.repeat(n // rpt // order_by.shape[0]), descending=True,
                                      stable=True).to(torch.int32)
        elif order_by == "estimate":
            by_weight = ic._heaviest_first(weights, supers, o, d, t_min, t_max, rpt)
        else:
            by_weight = None
        order = (by_weight.data_ptr() if by_weight is not None else None,)
    common = (tris.data_ptr(), child.data_ptr(), supers.data_ptr(), *(x.data_ptr() for x in order_super),
              o.data_ptr(), d.data_ptr(), *order, n, supers.shape[0], branch, tris.shape[0], tris.shape[1],
              float(t_min), float(t_max), rpt, ic._TRI_TEST_IDS[tri_test])
    stream = torch.cuda.current_stream().cuda_stream
    if any_hit:
        out = (torch.empty(n, dtype=torch.bool, device=o.device),)
    else:
        out = ic._hit_outputs(o)
    err = fn(*common, *(x.data_ptr() for x in out), stream)
    if err:
        raise SystemExit(f"launch failed: CUDA error {err}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("shapes", nargs="*", default=["rules"], help='"G,T" or "rules"')
    parser.add_argument("--kernels", default=",".join(KERNELS), help="comma-separated, of " + ",".join(KERNELS))
    parser.add_argument("--parent", help="an older csrc/ directory to time as well")
    order = parser.add_mutually_exclusive_group()
    order.add_argument("--no-order", action="store_true", help="packets in index order")
    order.add_argument("--visit-order", action="store_true", help="packets heaviest first by true visit counts")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    args.kernels = args.kernels.split(",")
    if not set(args.kernels) <= set(KERNELS):
        parser.error(f"--kernels: not among {','.join(KERNELS)}: {args.kernels}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    cfg, cfg_nee = RenderConfig(**cs.HEADLINE), RenderConfig(**{**cs.HEADLINE, **cs.NEE})
    camera = Camera(**cs.CONFIG4_CAMERA)
    scenes = {}
    cases = {}  # kernel: (any hit, source, {tri_test: (args, the plain version's result)}, visits per packet)
    for kid in args.kernels:
        source, any_hit, total = KERNELS[kid]
        if total not in scenes:
            scenes[total] = cs.high_poly(total, "cuda")
        scene = scenes[total]
        c = cfg_nee if any_hit else cfg
        plain = cs.KERNELS[kid][7]
        o, d = cs.shadow_batch(scene, c, camera)[:2] if any_hit else cs.bounce_batch(scene, c, camera)
        want = {}
        for tri_test in ("bw", "mt"):
            _, call_args = scene.accel.traversal(o, d, c.t_min, c.t_max, c.replace(tri_test=tri_test))
            rpt = scene.accel._rpt(c)
            with cs.counting_visits(ic._Occlusion if any_hit else ic._Packets, -(-o.shape[0] // rpt), o.device) as v:
                result = plain(*call_args)
            want[tri_test] = (call_args, (result,) if any_hit else result)
            if tri_test == "bw":
                visits = v
        cases[kid] = (any_hit, source, want, visits)
    torch.cuda.synchronize()

    sources = sorted({KERNELS[kid][0] for kid in args.kernels})
    jobs = []  # every build's nvcc at once
    if args.parent:
        jobs.append(("parent", start_build("parent", Path(args.parent), sources)))
    for shape in args.shapes:
        rule = None if shape == "rules" else tuple(int(x) for x in shape.split(","))
        jobs.append((shape, start_build(shape.replace(",", "x"), cuda_build.CSRC_DIR, sources, rule)))
    builds = [(name, finish_build(j)) for name, j in jobs]

    def timed(fns, any_hit, call_args, want, visits, tiles, reps):
        if tiles > 1:
            call_args = list(call_args)
            i = 4 if len(call_args) == 11 else 3  # the origins (after order_super on the hier route)
            call_args[i], call_args[i + 1] = call_args[i].repeat(tiles, 1), call_args[i + 1].repeat(tiles, 1)
        order_by = visits if args.visit_order else "index" if args.no_order else "estimate"
        got = launch(fns, any_hit, call_args, order_by)
        torch.cuda.synchronize()
        bad = sum(int((a.reshape(tiles, *b.shape) != b[None]).sum()) for a, b in zip(got, want))
        ms = cs._time_ms(lambda: launch(fns, any_hit, call_args, order_by), reps)
        return f"{ms:.4f}" + (f" DIFFERS on {bad}" if bad else "")

    for _ in range(args.rounds):
        for name, libs in builds:
            line = [name]
            for kid, (any_hit, source, want, visits) in cases.items():
                line += [f"{kid} {timed(libs[source], any_hit, *want['bw'], visits, 1, 10)}",
                         f"mt {timed(libs[source], any_hit, *want['mt'], visits, 1, 10)}"]
                line += [f"x{tiles} {timed(libs[source], any_hit, *want['bw'], visits, tiles, 3)}" for tiles in TILES]
            print(" | ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
