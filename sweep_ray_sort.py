"""The ray sort on the main path's rays, by tile and by build: each case of
chip_smoke.py's phase 38 that the sort takes over tiles (`chip_smoke.ray_order_cases`
above 16,384 rays: the headline's and config 4's 131,072 rays and their
NEE shadow rays with the mask, a 1-spp tile's 345,600, the
one-lane-a-pixel pool's 2,073,600 of the headline and of config 4),
sorted by `ray_sort.sort_rays_cuda`, every output held bit-equal to
`sort_rays_plain`'s.

Without --parent: over each tile that csrc/ray_sort.cu instantiates (256
threads x 4, 8 or 16 keys), in turns (4, 8, 16, 16, 8, 4, --rounds
times): ms with the L2 flushed (`chip_smoke._time_cold`), and warm device
ms and device kernels a call (`chip_smoke._profiled`); the tile
`ray_sort.tile_items` picks is marked.

With --parent DIR (an older csrc/ directory): builds of ray_sort.cu
compared at the tile `tile_items` picks, in turns (sweep_builds.in_turns):
"change" (csrc/ as it is), "parent", and with `wide` "wide" (csrc/ with
the 64-bit status words at every n: kNarrowMax 0), each build's launches
on a scratch of its own.  One line a case and tile, or a build and round,
with the card's name and power limit.

    python3 sweep_ray_sort.py [--rounds R]
    python3 sweep_ray_sort.py --parent DIR [wide] [--rounds R]

Needs a card.
"""

from __future__ import annotations

import argparse
import re
import sys

import chip_smoke as cs
import sweep_builds
from tpu_pathtracer_torch.ops import cuda_build
from tpu_pathtracer_torch.ops import ray_sort

SOURCE = "ray_sort.cu"


def always_wide(text):
    """ray_sort.cu's text with the 64-bit status words at every n."""
    out, count = re.subn(r"constexpr int kNarrowMax = [^;]+;", "constexpr int kNarrowMax = 0;", text)
    if count != 1:
        raise SystemExit("kNarrowMax was not found in ray_sort.cu")
    return out


def sort_cases():
    """(name, origins, directions, mask, box, bits, plain version's outputs)
    of each phase 38 case above SMALL_MAX rays."""
    out = []
    for name, scene, cfg, camera, n_cam, any_hit in cs.ray_order_cases(cs.headline_scene("cuda"),
                                                                        cs.high_poly(100_000, "cuda")):
        o, d, active, box, bits = cs.ray_order_inputs(scene, cfg, camera, n_cam, any_hit)
        if o.shape[0] > ray_sort.SMALL_MAX:
            out.append((name, o, d, active, box, bits, ray_sort.sort_rays_plain(o, d, *box, *bits, active)))
    return out


def by_build(args, smi):
    start = lambda name, src_dir, edit=None: sweep_builds.start("ray_sort", name, src_dir, SOURCE, edit)  # noqa: E731
    jobs = [start("parent", args.parent), start("change", cuda_build.CSRC_DIR)]
    jobs += [start("wide", cuda_build.CSRC_DIR, always_wide) for _ in set(args.variants)]
    cuda_build.build_libraries()
    builds = sweep_builds.finish(jobs, ("sort_pass_kernel",))
    cases = sort_cases()

    def times(lib):
        ray_sort._scratch.cache_clear()  # a build's launches on scratches of their own
        line = []
        with cs.using_libraries({SOURCE: lib}):
            for name, o, d, active, box, bits, want in cases:
                def sort(*_):
                    return ray_sort.sort_rays_cuda(o, d, *box, *bits, active)

                if not all(cs.same_bits(g, w) for g, w in zip(sort(), want)):
                    raise SystemExit(f"sweep_ray_sort: {name} differs from sort_rays_plain")
                line.append(f"{name} ({o.shape[0]}) {cs._time_cold(sort, [None] * 21):.4f}")
        return "; ".join(line)

    sweep_builds.in_turns(builds, args.rounds, times, smi)
    return 1 if len(builds) < len(jobs) else 0


def by_tile(args, smi):
    for name, o, d, active, box, bits, want in sort_cases():
        n = o.shape[0]
        runs = {items: [] for items in ray_sort.TILE_ITEMS}
        for _ in range(args.rounds):
            for items in ray_sort.TILE_ITEMS + ray_sort.TILE_ITEMS[::-1]:
                def sort(*_, items=items):
                    return ray_sort.sort_rays_cuda(o, d, *box, *bits, active, items=items)

                if not all(cs.same_bits(g, w) for g, w in zip(sort(), want)):
                    raise SystemExit(f"sweep_ray_sort: {name}, {items} keys a thread, differs from sort_rays_plain")
                runs[items].append((cs._time_cold(sort, [None] * 21), cs._profiled(sort)))
        for items, r in runs.items():
            warm = [p for _, p in r if p is not None]
            device = ("not measured (no complete trace)" if not warm else
                      f"{sum(p['ms'] for p in warm) / len(warm):.4f} ms in "
                      f"{sum(p['kernels'] for p in warm) / len(warm):.1f} device kernels")
            print(f"[{name}] {n} rays{f', {int(active.sum())} active' if active is not None else ''}, tiles of "
                  f"{ray_sort.TILE_THREADS * items} keys{' (tile_items)' if items == ray_sort.tile_items(n) else ''}: "
                  f"bit-equal; L2 flushed {' '.join(f'{c:.4f}' for c, _ in r)} ms; warm {device} | {smi}",
                  flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", choices=["wide"], help="with --parent: wide, the 64-bit words at "
                                                                       "every n")
    parser.add_argument("--parent", help="an older csrc/ directory: compare builds instead of tiles")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    if args.variants and not args.parent:
        parser.error("the variants are builds: they need --parent")
    smi = cs.phase_device()
    return by_build(args, smi) if args.parent else by_tile(args, smi)


if __name__ == "__main__":
    sys.exit(main())
