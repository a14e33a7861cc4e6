"""How the streamed kernels' launch shape was chosen: kernels 3 and 6
(csrc/cluster_streamed.cu, csrc/cluster_occluded_streamed.cu) rebuilt with
one fixed shape each and timed on chip_smoke.py's phase 7 and phase 13 rays
(the 200k-triangle scene, 131,072 rays) and on the same rays tiled 2, 4, 8
and 16 times, every result held bit-equal to the plain version's.

    python3 sweep_streamed.py [G,T ...] [--parent DIR] [--no-order] [--rounds N]

A shape G,T spreads a packet over a thread block cluster of G blocks and
gives a ray T threads (kShapeRules of csrc/cluster_streamed.cuh pinned to
that one rule); "rules" builds the sources as they are.  --parent DIR also
times the kernels of an older csrc/ directory whose launch functions take
no packet order (one block per packet, one thread per ray), first in every
round.  --no-order launches the packets in index order instead of heaviest
first.  One line per build and round, with the card's name, power limit and
SM clock; times in ms, Baldwin-Weber unless marked mt.
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
SOURCES = ("cluster_streamed.cu", "cluster_occluded_streamed.cu")
TILES = (2, 4, 8, 16)


def build(name, src_dir, rule=None, takes_order=True):
    """Both libraries from a copy of `src_dir`, with kShapeRules cut to
    `rule` = (G, T) if given.  {source: (launch, weights or None)}."""
    d = ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    if rule:
        header = d / "cluster_streamed.cuh"
        text, count = re.subn(r"kShapeRules\[\] = .*;", "kShapeRules[] = {{1 << 30, %d, %d}};" % rule, header.read_text())
        if count != 1:
            raise SystemExit("kShapeRules not found in cluster_streamed.cuh")
        header.write_text(text)
    procs = [(f, d / (Path(f).stem + ".so")) for f in SOURCES]
    procs = [(f, out, subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(d / f)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for f, out in procs]
    libs = {}
    for f, out, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {f} ({name}):\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out.resolve()))
        launcher, argtypes = cuda_build.LAUNCHERS[f]
        fns = {launcher: argtypes if takes_order else argtypes[:5] + argtypes[6:]}
        if takes_order:
            fns.update({k: v for k, v in cuda_build.HELPERS[f].items() if k.endswith("_weights")})
        for fn_name, fn_argtypes in fns.items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = fn_argtypes, ctypes.c_int
        libs[f] = (getattr(lib, launcher), getattr(lib, launcher.replace("_launch", "_weights")) if takes_order else None)
    return libs


def launch(fns, any_hit, args, ordered):
    """One launch through a library's own functions, as the wrappers of
    ops/intersect_cluster.py make it."""
    fn, weights = fns
    tris, child, supers, o, d, t_min, t_max, rpt, branch, tri_test = args
    n = o.shape[0]
    order = ()
    if weights is not None:
        by_weight = ic._heaviest_first(weights, supers, o, d, t_min, t_max, rpt) if ordered else None
        order = (by_weight.data_ptr() if by_weight is not None else None,)
    common = (tris.data_ptr(), child.data_ptr(), supers.data_ptr(), o.data_ptr(), d.data_ptr(), *order, n,
              supers.shape[0], branch, tris.shape[0], tris.shape[1], float(t_min), float(t_max), rpt,
              ic._TRI_TEST_IDS[tri_test])
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
    parser.add_argument("--parent", help="an older csrc/ directory to time as well")
    parser.add_argument("--no-order", action="store_true", help="packets in index order")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    cfg, cfg_nee = RenderConfig(**cs.HEADLINE), RenderConfig(**{**cs.HEADLINE, **cs.NEE})
    camera = Camera(**cs.CONFIG4_CAMERA)
    scene = cs.high_poly(200_000, "cuda")
    cases = {}  # kernel: (any hit, source, {tri_test: (args, the plain version's result)})
    for kid, any_hit, c, plain, source in (("k3", False, cfg, ic.intersect_clusters_streamed_plain, SOURCES[0]),
                                           ("k6", True, cfg_nee, ic.occluded_clusters_streamed_plain, SOURCES[1])):
        o, d = cs.shadow_batch(scene, c, camera)[:2] if any_hit else cs.bounce_batch(scene, c, camera)
        want = {}
        for tri_test in ("bw", "mt"):
            _, call_args = scene.accel.traversal(o, d, c.t_min, c.t_max, c.replace(tri_test=tri_test))
            result = plain(*call_args)
            want[tri_test] = (call_args, (result,) if any_hit else result)
        cases[kid] = (any_hit, source, want)
    torch.cuda.synchronize()

    builds = []
    if args.parent:
        builds.append(("parent", build("parent", Path(args.parent), takes_order=False)))
    for shape in args.shapes:
        rule = None if shape == "rules" else tuple(int(x) for x in shape.split(","))
        builds.append((shape, build(shape.replace(",", "x"), cuda_build.CSRC_DIR, rule)))

    def timed(fns, any_hit, call_args, want, tiles, reps):
        if tiles > 1:
            call_args = list(call_args)
            call_args[3], call_args[4] = call_args[3].repeat(tiles, 1), call_args[4].repeat(tiles, 1)
        got = launch(fns, any_hit, call_args, not args.no_order)
        torch.cuda.synchronize()
        bad = sum(int((a.reshape(tiles, *b.shape) != b[None]).sum()) for a, b in zip(got, want))
        ms = cs._time_ms(lambda: launch(fns, any_hit, call_args, not args.no_order), reps)
        return f"{ms:.4f}" + (f" DIFFERS on {bad}" if bad else "")

    for _ in range(args.rounds):
        for name, libs in builds:
            line = [name]
            for kid, (any_hit, source, want) in cases.items():
                line += [f"{kid} {timed(libs[source], any_hit, *want['bw'], 1, 10)}",
                         f"mt {timed(libs[source], any_hit, *want['mt'], 1, 10)}"]
                line += [f"x{tiles} {timed(libs[source], any_hit, *want['bw'], tiles, 3)}" for tiles in TILES]
            print(" | ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
