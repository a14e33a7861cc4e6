"""The ray sort's tile on the main path's rays: each case of chip_smoke.py's
phase 38 that the sort takes over tiles (`chip_smoke.ray_order_cases`
above 16,384 rays: the headline's and config 4's 131,072 rays and their
NEE shadow rays with the mask, a 1-spp tile's 345,600, the
one-lane-a-pixel pool's 2,073,600 of the headline and of config 4),
sorted by `ray_sort.sort_rays_cuda` over each tile that csrc/ray_sort.cu
instantiates (256 threads x 4, 8 or 16 keys), every output held
bit-equal to `sort_rays_plain`'s.  The tiles in turns (4, 8, 16, 16, 8,
4, --rounds times): ms with the L2 flushed (`chip_smoke._time_cold`),
and warm device ms and device kernels a call (`chip_smoke._profiled`).
One line a case and tile, with the card's name and power limit; the
tile `ray_sort.tile_items` picks is marked.

    python3 sweep_ray_sort.py [--rounds R]

Needs a card.
"""

from __future__ import annotations

import argparse
import sys

import chip_smoke as cs
from tpu_pathtracer_torch.ops import ray_sort


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    smi = cs.phase_device()
    cases = cs.ray_order_cases(cs.headline_scene("cuda"), cs.high_poly(100_000, "cuda"))
    for name, scene, cfg, camera, n_cam, any_hit in cases:
        o, d, active, box, bits = cs.ray_order_inputs(scene, cfg, camera, n_cam, any_hit)
        n = o.shape[0]
        if n <= ray_sort.SMALL_MAX:
            continue
        want = ray_sort.sort_rays_plain(o, d, *box, *bits, active)
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


if __name__ == "__main__":
    sys.exit(main())
