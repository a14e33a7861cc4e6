"""How the traversal kernels' launch shape was chosen: kernels 1 and 4 (the
flat route, csrc/cluster_intersect.cu, csrc/cluster_occluded.cu), 2 and 5
(the hier route, csrc/cluster_hier.cu, csrc/cluster_occluded_hier.cu) and 3
and 6 (the streamed route, csrc/cluster_streamed.cu,
csrc/cluster_occluded_streamed.cu), all streamed_kernel of
csrc/cluster_streamed.cuh, rebuilt with one fixed shape each and timed on
chip_smoke.py's rays, every result held bit-equal to the plain version's:

  * kernels 1 and 4: phases 3 and 11 (the headline scene, 131,072 rays in
    128 packets of 1,024), the same rays tiled into 338 packets (one 1-spp
    tile of 345,600 pixels) and 2,048 packets (16 tiles), and 16 packets:
    for kernel 1 phase 3b's rays (BASELINE config 1's pool of 16,384 lanes),
    for kernel 4 every eighth packet of phase 11's;
  * kernels 2 and 5: phases 6 and 12 (BASELINE config 4's scene), kernels 3
    and 6: phases 7 and 13 (the 200k-triangle scene), 131,072 rays each in
    packets of 512, and the same rays tiled 2, 4, 8 and 16 times.

    python3 sweep_streamed.py [G,T ...] [--kernels k1,k4,k2,k5,k3,k6] [--parent DIR]
                              [--branch1] [--no-order | --visit-order] [--rounds N]

A shape G,T spreads a packet over a thread block cluster of G blocks and
gives a ray T threads (kShapeRules of csrc/cluster_streamed.cuh pinned to
that one shape for every visit order and kind; T still halves while a
block would exceed 1,024 threads); "rules" builds the sources as they
are.  --parent DIR also times the kernels of an older csrc/ directory,
first in every round: a library there whose launch function has no
`_weights` companion takes no packet order.
--branch1 also times kernels 1 and 4's work as the two-level kernels of the
"rules" build do it (cluster_hier.cu, cluster_occluded_hier.cu with
branch 1, every cluster its own super: aabb_child = aabb_super = aabb8,
order_super = order), which costs one more vote a cluster tested and never
prefetches.  Packets go heaviest first by the pre-pass's estimate, as the
wrappers launch them; --no-order launches them in index order,
--visit-order heaviest first by the true per-packet visit counts of the
plain version.  One line per build and round, with the card's name, power
limit and SM clock; times in ms, Baldwin-Weber unless marked mt.
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
# kernel: (source, route, any hit, scene: "headline" or high_poly's triangles)
KERNELS = {
    "k1": ("cluster_intersect.cu", "flat", False, "headline"),
    "k4": ("cluster_occluded.cu", "flat", True, "headline"),
    "k2": ("cluster_hier.cu", "hier", False, 100_000),
    "k5": ("cluster_occluded_hier.cu", "hier", True, 100_000),
    "k3": ("cluster_streamed.cu", "streamed", False, 200_000),
    "k6": ("cluster_occluded_streamed.cu", "streamed", True, 200_000),
}
# The two-level source that does a flat kernel's work with branch 1 (--branch1).
BRANCH1 = {"cluster_intersect.cu": "cluster_hier.cu", "cluster_occluded.cu": "cluster_occluded_hier.cu"}
TILES = (2, 4, 8, 16)
FLAT_PACKETS = 338  # one 1-spp tile of 345,600 pixels in packets of 1,024


def start_build(name, src_dir, sources, rule=None):
    """Start nvcc on each of `sources` in a copy of `src_dir`, with
    kShapeRules cut to `rule` = (G, T) if given.  Returns the jobs for
    `finish_build`."""
    d = ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    if rule:
        header = d / "cluster_streamed.cuh"
        text, count = re.subn(r"kShapeRules\[\] = \{.*?\};", "kShapeRules[] = {%s};" % ", ".join(
            "{%s, kBothKinds, 1 << 30, %d, %d}" % (visit, *rule) for visit in ("kAscending", "kPerPacket", "kFlat")),
            header.read_text(), flags=re.S)
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
    """{source: (launch, weights or None, route, whether the launch takes
    perm and the Hit's flags)} once the jobs' nvcc are done."""
    routes = {source: route for source, route, *_ in KERNELS.values()}
    libs = {}
    for name, f, out, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {f} ({name}):\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out.resolve()))
        launcher, argtypes = cuda_build.LAUNCHERS[f]
        # a tree before the restore went into the traversal's store: no perm
        # (nor, closest hit, the Hit's flags) before the stream
        takes_perm = "hit_out" in (out.parent / "cluster_streamed.cuh").read_text()
        if not takes_perm:
            cut = [-3] if "occluded" in f else [-6, -2]  # perm; and the Hit's flags
            argtypes = [a for k, a in enumerate(argtypes) if k - len(argtypes) not in cut]
        weights = getattr(lib, launcher.replace("_launch", "_weights"), None)
        if weights is None:  # no packet order: the pointer before n goes
            cut = argtypes.index(ctypes.c_int) - 1
            argtypes = argtypes[:cut] + argtypes[cut + 1:]
        else:
            weights.argtypes, weights.restype = cuda_build.HELPERS[f][launcher.replace("_launch", "_weights")], ctypes.c_int
        fn = getattr(lib, launcher)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[f] = (fn, weights, routes[f], takes_perm)
    return libs


def two_level_form(route, args):
    """A wrapper's arguments (ClusterAccel.traversal) in one form for every
    route: (tris, aabb_child, aabb_super, order_super or None, origins,
    directions, t_min, t_max, rays per packet, branch, tri_test).  The flat
    route's is its branch-1 two-level walk: every cluster its own super."""
    if route == "flat":
        tris, aabb8, order, *rest, tri_test = args
        return (tris, aabb8, aabb8, order, *rest, 1, tri_test)
    if route == "streamed":
        return (*args[:3], None, *args[3:])
    return tuple(args)


def launch(lib, any_hit, args, order_by):
    """One launch through a library's own functions, as the wrappers of
    ops/intersect_cluster.py make it; `args` in two_level_form.
    `order_by`: "estimate" (the pre-pass), "index", or the per-packet visit
    counts to sort by."""
    fn, weights, route, takes_perm = lib
    tris, child, supers, order_super, o, d, t_min, t_max, rpt, branch, tri_test = args
    n = o.shape[0]
    order = ()
    if weights is not None:
        if isinstance(order_by, torch.Tensor):
            by_weight = torch.argsort(order_by, descending=True, stable=True).to(torch.int32)
        elif order_by == "estimate":
            by_weight = ic._heaviest_first(weights, supers, o, d, t_min, t_max, rpt)
        else:
            by_weight = None
        order = (by_weight.data_ptr() if by_weight is not None else None,)
    if route == "flat":
        boxes, sizes = (supers, order_super), (supers.shape[0], tris.shape[1])
    else:
        boxes = (child, supers) + ((order_super,) if route == "hier" else ())
        sizes = (supers.shape[0], branch, tris.shape[0], tris.shape[1])
    stream = torch.cuda.current_stream().cuda_stream
    if any_hit:
        out = (torch.empty(n, dtype=torch.bool, device=o.device),)
    else:
        out = ic._hit_outputs(o)
    outs = [x.data_ptr() for x in out]
    if takes_perm:  # the raw outputs: no perm, no Hit
        outs = [None, *outs] + ([] if any_hit else [None])
    err = fn(tris.data_ptr(), *(b.data_ptr() for b in boxes), o.data_ptr(), d.data_ptr(), *order, n, *sizes,
             float(t_min), float(t_max), rpt, ic._TRI_TEST_IDS[tri_test], *outs, stream)
    if err:
        raise SystemExit(f"launch failed: CUDA error {err}")
    return out


def with_rays(args, o, d):
    return (*args[:4], o, d, *args[6:])


def tiled(point, tiles, packets=None):
    """A point's rays, wanted results and visit counts repeated `tiles`
    times and cut to `packets` whole packets if given."""
    args, want, visits = point
    rpt = args[8]
    n = (packets or visits.shape[0] * tiles) * rpt

    def rep(x):
        return x.repeat(tiles, *([1] * (x.dim() - 1)))[:n]

    return with_rays(args, rep(args[4]), rep(args[5])), tuple(rep(w) for w in want), rep(visits)[: n // rpt]


def strided(point, step):
    """Every step-th packet of a point."""
    args, want, visits = point
    rpt = args[8]

    def pick(x):
        return x.reshape(-1, rpt, *x.shape[1:])[::step].reshape(-1, *x.shape[1:])

    return with_rays(args, pick(args[4]), pick(args[5])), tuple(pick(w) for w in want), visits[::step]


def kernel_points(kid, scenes):
    """[(label, (args in two_level_form, wanted results, per-packet visit
    counts))] of one kernel: Baldwin-Weber at every size, Moller-Trumbore at
    131,072 rays."""
    source, route, any_hit, scene_key = KERNELS[kid]
    plain = cs.KERNELS[kid][7]

    def point(scene, cfg, camera, tri_test, n_cam=cs.CAMERA_RAYS):
        o, d = cs.shadow_batch(scene, cfg, camera)[:2] if any_hit else cs.bounce_batch(scene, cfg, camera, n_cam)
        _, args = scene.accel.traversal(o, d, cfg.t_min, cfg.t_max, cfg.replace(tri_test=tri_test))
        rpt = scene.accel._rpt(cfg)
        with cs.counting_visits(ic._Occlusion if any_hit else ic._Packets, -(-o.shape[0] // rpt), o.device) as v:
            want = plain(*args)
        return two_level_form(route, args), (want,) if any_hit else want, v

    if scene_key not in scenes:
        scenes[scene_key] = cs.headline_scene("cuda") if scene_key == "headline" else cs.high_poly(scene_key, "cuda")
    scene = scenes[scene_key]
    cfg = RenderConfig(**{**cs.HEADLINE, **(cs.NEE if any_hit else {})})
    camera = Camera() if route == "flat" else Camera(**cs.CONFIG4_CAMERA)
    base = point(scene, cfg, camera, "bw")
    mt = point(scene, cfg, camera, "mt")
    if route != "flat":
        return [("x1", base), ("mt", mt)] + [(f"x{t}", tiled(base, t)) for t in TILES]
    if any_hit:  # config 1 traces no shadow rays
        few = strided(base, 8)
    else:
        few = point(cs.config1_scene("cuda"), RenderConfig(**cs.CONFIG1), Camera(), "bw", cs.CONFIG1_CAMERA_RAYS)
    return [("p16", few), ("p128", base), ("mt", mt), (f"p{FLAT_PACKETS}", tiled(base, 3, FLAT_PACKETS)),
            ("p2048", tiled(base, 16))]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("shapes", nargs="*", default=["rules"], help='"G,T" or "rules"')
    parser.add_argument("--kernels", default=",".join(KERNELS), help="comma-separated, of " + ",".join(KERNELS))
    parser.add_argument("--parent", help="an older csrc/ directory to time as well")
    parser.add_argument("--branch1", action="store_true", help="also time kernels 1 and 4 as branch-1 hier walks")
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

    scenes = {}
    cases = {kid: kernel_points(kid, scenes) for kid in args.kernels}  # kernel: [(label, point)]
    torch.cuda.synchronize()

    sources = sorted({KERNELS[kid][0] for kid in args.kernels})
    branch1 = sorted({BRANCH1[f] for f in sources if f in BRANCH1}) if args.branch1 else []
    jobs = []  # every build's nvcc at once
    if args.parent:
        jobs.append(("parent", start_build("parent", Path(args.parent), sources)))
    for shape in args.shapes:
        rule = None if shape == "rules" else tuple(int(x) for x in shape.split(","))
        extra = branch1 if shape == "rules" else []
        jobs.append((shape, start_build(shape.replace(",", "x"), cuda_build.CSRC_DIR, sorted({*sources, *extra}),
                                        rule)))
    builds = [(name, finish_build(j)) for name, j in jobs]
    if branch1:
        rules = dict(builds)["rules"]
        builds.append(("branch1", {f: rules[BRANCH1[f]] for f in sources if f in BRANCH1}))

    def timed(lib, any_hit, point, reps):
        call_args, want, visits = point
        order_by = visits if args.visit_order else "index" if args.no_order else "estimate"
        got = launch(lib, any_hit, call_args, order_by)
        torch.cuda.synchronize()
        bad = sum(int((a != b).sum()) for a, b in zip(got, want))
        ms = cs._time_ms(lambda: launch(lib, any_hit, call_args, order_by), reps)
        return f"{ms:.4f}" + (f" DIFFERS on {bad}" if bad else "")

    for _ in range(args.rounds):
        for name, libs in builds:
            line = [name]
            for kid, points in cases.items():
                source, _, any_hit, _ = KERNELS[kid]
                if source not in libs:
                    continue
                for i, (label, point) in enumerate(points):
                    reps = 3 if point[0][4].shape[0] > 400_000 else 10
                    line.append(f"{kid if i == 0 else ''} {label} {timed(libs[source], any_hit, point, reps)}".strip())
            print(" | ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
