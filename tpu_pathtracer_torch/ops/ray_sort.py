"""The traversal's ray ordering: the coherence sort of the rays (the key,
the stable sort, the gather into key order), the restore of the
traversal's outputs into caller order (its plain version: on the card the
traversal kernels store in caller order themselves,
`ops.intersect_cluster`), and the order in which a traversal kernel takes
its packets.

Counterpart of `ray_sort_key` and `sort_by_key` (with `octant_sort`) in
`tpu_pathtracer/ops/intersect_pallas.py`, and of the parking and the
packed restore around the Pallas kernels in
`tpu_pathtracer/accel/cluster.py` (`ClusterAccel.intersect`,
`occluded`).  None of it is a TPU kernel: XLA fuses it inside the JAX
package's jitted loop, and leaves the sort to `lax.sort_key_val`.  On the
card it runs as the kernels of `csrc/ray_sort.cu`, each with its plain
version here:

* `sort_rays`: the rays in the stable ascending order of the int32 key of
  `ray_sort_key` (the lanes outside an `active` mask parked first,
  `park`), and the permutation: a hand-written LSD radix sort that
  computes the keys in its first launch and gathers the rays in its last
  pass (one launch up to `SMALL_MAX` rays, else 1 + `digit_passes`; its
  look-back's status words 64-bit above `NARROW_MAX` rays, so that one
  sort takes every batch up to `MAX_RAYS`);
* `packet_order`: the heaviest-first order of a traversal's packets.

The key's value needs at most 30 bits (3 octant bits, up to 9 spatial
bits a axis, direction bits clamped to what is left of 32), so the sort
takes ceil(width / 8) passes of 8-bit digits over the width the host
derives from the bit counts (`key_width`).

Each wrapper launches its kernel for tensors on a CUDA device outside
`ops.cuda_build.plain()` (the A/B switch) and runs its plain version on
the CPU and under `plain()`; a failed build or launch raises.  Each counts its kernel launches in `.launches`
(`render/graph_loop.COUNTED`).  None reads the device from the host.
"""

from __future__ import annotations

import functools

import torch

from tpu_pathtracer_torch.ops.cuda_build import MAX_LANES, check_lanes, kernel_arg, library, on_card
from tpu_pathtracer_torch.ops.intersect import Hit
from tpu_pathtracer_torch.utils.device import constant

# The traversal kernels' miss marker in `prim`; `Hit.prim` is -1 there.
MISS_PRIM = 0x7FFFFFFF
# The radix sort (csrc/ray_sort.cu): digits of RADIX_BITS bits; up to
# SMALL_MAX rays in one launch (a thread block cluster of tiles of 2,048
# keys), more over tiles of TILE_THREADS x `tile_items(n)` keys.
RADIX_BITS = 8
SMALL_MAX = 16_384
TILE_THREADS = 256
TILE_ITEMS = (4, 8, 16)  # the keys a thread that csrc/ray_sort.cu instantiates
RADIX = 1 << RADIX_BITS
# The sort's scratch before its status words (64-bit words): a ticket and
# an arrival counter, four passes' digit counts and digit starts.
STATUS_OFFSET = 2 + 2 * 4 * RADIX
# The look-back's status words are 32-bit up to NARROW_MAX keys (their
# count field's 23 bits: every pool of the main path), 64-bit above.
NARROW_MAX = (1 << 23) - 1
# The kernels index rays and rows with int32.
MAX_RAYS = MAX_LANES


# ---------------------------------------------------------------------------
# The key, the parking and the restore
# ---------------------------------------------------------------------------

def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of v so bit i lands at bit 3i (3-D Morton)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def key_dir_bits(spatial_bits: int, dir_bits: int) -> int:
    """`dir_bits` clamped so the key fits 32 bits."""
    return min(dir_bits, max(0, (32 - 3 - 3 * spatial_bits) // 3))


def key_width(spatial_bits: int, dir_bits: int) -> int:
    """Bits of the key's value: the octant, the spatial cell, the
    direction bits as clamped."""
    return 3 + 3 * spatial_bits + 3 * key_dir_bits(spatial_bits, dir_bits)


def digit_passes(spatial_bits: int, dir_bits: int) -> int:
    """Passes of the radix sort over a key of that width."""
    return -(-key_width(spatial_bits, dir_bits) // RADIX_BITS)


def tile_items(n: int) -> int:
    """Keys a thread of the sort over tiles of n > SMALL_MAX rays: tiles of
    1,024 keys up to 2^20 rays (the stream pools of 131,072 and a 1-spp
    tile's 345,600), of 4,096 above (the one-lane-a-pixel pool's
    2,073,600), the fastest on the main path's rays of each pool
    (`sweep_ray_sort.py`; PERF.md §6)."""
    return 4 if n <= 1 << 20 else 16


def wide_status(n: int) -> bool:
    """Whether a sort of n rays over tiles takes 64-bit status words."""
    return n > NARROW_MAX


def sort_launches(n: int, spatial_bits: int, dir_bits: int) -> int:
    """Kernel launches of one sort of n rays on the card."""
    if n == 0:
        return 0
    return 1 if n <= SMALL_MAX else 1 + digit_passes(spatial_bits, dir_bits)


def ray_sort_key(origins, directions, scene_lo=None, scene_hi=None, spatial_bits: int = 0,
                 dir_bits: int = 0) -> torch.Tensor:
    """[N] int32 key (JAX's u32 value): (origin Morton cell << 3) | octant,
    refined by `dir_bits` direction-magnitude bits per axis below the
    octant bits; clamped so the key fits 32 bits (it takes at most 30)."""
    dir_bits = key_dir_bits(spatial_bits, dir_bits)
    key = (
        (directions[:, 0] > 0).to(torch.int32)
        + 2 * (directions[:, 1] > 0).to(torch.int32)
        + 4 * (directions[:, 2] > 0).to(torch.int32)
    )
    if spatial_bits:
        span = torch.clamp_min(scene_hi - scene_lo, 1e-6)
        cells = float((1 << spatial_bits) - 1)
        q = torch.clamp((origins - scene_lo) / span, 0.0, 1.0) * cells
        qi = q.to(torch.int32)
        morton = _part1by2(qi[:, 0]) | (_part1by2(qi[:, 1]) << 1) | (_part1by2(qi[:, 2]) << 2)
        key = key | (morton << 3)
    if dir_bits:
        cells = float((1 << dir_bits) - 1)
        mag = (torch.clamp(torch.abs(directions), 0.0, 1.0) * cells).to(torch.int32)
        fine = (mag[:, 0] << (2 * dir_bits)) | (mag[:, 1] << dir_bits) | mag[:, 2]
        key = (key << (3 * dir_bits)) | fine
    return key


def park(origins, directions, active, scene_lo, scene_hi):
    """The lanes outside `active` moved outside the scene box to
    scene_hi + (scene_hi - scene_lo) + 1, pointing +x: they overlap no box
    and, sharing one sort key, fill packets of their own."""
    point = scene_hi + (scene_hi - scene_lo) + 1.0
    plus_x = constant((1.0, 0.0, 0.0), directions.dtype, directions.device)
    return (torch.where(active[:, None], origins, point[None, :]),
            torch.where(active[:, None], directions, plus_x))


def restore(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Inverse of the sort permutation along the first axis."""
    out = torch.empty_like(x)
    out[perm] = x
    return out


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------

def sort_key_plain(origins, directions, scene_lo, scene_hi, spatial_bits: int, dir_bits: int, active=None):
    if active is not None:
        origins, directions = park(origins, directions, active, scene_lo, scene_hi)
    return ray_sort_key(origins, directions, scene_lo, scene_hi, spatial_bits, dir_bits)


def gather_rays_plain(origins, directions, perm, active=None, scene_lo=None, scene_hi=None):
    if active is not None:
        origins, directions = park(origins, directions, active, scene_lo, scene_hi)
    return origins[perm], directions[perm]


def sort_rays_plain(origins, directions, scene_lo, scene_hi, spatial_bits: int, dir_bits: int, active=None):
    key = sort_key_plain(origins, directions, scene_lo, scene_hi, spatial_bits, dir_bits, active)
    perm = torch.sort(key, stable=True).indices
    return (*gather_rays_plain(origins, directions, perm, active, scene_lo, scene_hi), perm)


def restore_hits_plain(outputs, perm):
    """A traversal's outputs in the sorted order back in caller order:
    `outputs` = (t, prim, uv) of a closest-hit traversal gives a `Hit`
    (prim -1 and bary 0 where prim is MISS_PRIM), the any-hit flags give
    the flags.  `perm` None is the identity.  The traversal kernels do
    this in their store (`ops.intersect_cluster`, restore=True)."""
    if isinstance(outputs, torch.Tensor):
        return outputs if perm is None else restore(outputs, perm)
    t, prim, uv = outputs if perm is None else (restore(x, perm) for x in outputs)
    hit = prim != MISS_PRIM
    return Hit(t=t, prim=torch.where(hit, prim, -1), bary=torch.where(hit[:, None], uv, 0.0), hit=hit)


def packet_order_plain(weights):
    return torch.argsort(weights, descending=True, stable=True).to(torch.int32)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def _launch(fn: str, *args, dev) -> None:
    err = getattr(library("ray_sort.cu"), fn)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _box(scene_lo, scene_hi, dev):
    return (kernel_arg("scene_lo", scene_lo, torch.float32, (3,), dev),
            kernel_arg("scene_hi", scene_hi, torch.float32, (3,), dev))


@functools.lru_cache(maxsize=None)
def _scratch(device: torch.device, tiles: int, wide: bool) -> torch.Tensor:
    """The sort's scratch for launches over `tiles` tiles on `device` with
    32-bit status words, or 64-bit ones where `wide`: a ticket and an
    arrival counter, the digit counts and starts, then room for a 64-bit
    status word a tile a digit.  Zeroed once here and never again: a pass
    tags its status words with its own number, read off the ticket
    counter, and the key launch's last block sets the counts back to 0
    (csrc/ray_sort.cu).  Sorts that share one run one at a time, on one
    stream, and with one word width: n = 2^23 - 1 and 2^23 both take 2,048
    tiles, and a narrow launch would leave half of a wide launch's words
    unwritten, so that one of them could still hold this launch's tag."""
    return torch.zeros(STATUS_OFFSET + tiles * RADIX, dtype=torch.int64, device=device)


def sort_rays_cuda(origins, directions, scene_lo, scene_hi, spatial_bits: int, dir_bits: int, active=None,
                   items=None):
    """`items`: keys a thread over tiles (one of TILE_ITEMS), in place of
    `tile_items(n)`, to compare tile sizes."""
    dev, n = origins.device, check_lanes("rays", origins.shape[0])
    if not 0 <= spatial_bits <= 9 or dir_bits < 0:
        raise ValueError(f"no sort key of {spatial_bits} spatial and {dir_bits} direction bits")
    o = kernel_arg("origins", origins, torch.float32, (n, 3), dev)
    d = kernel_arg("directions", directions, torch.float32, (n, 3), dev)
    lo, hi = _box(scene_lo, scene_hi, dev) if spatial_bits or active is not None else (None, None)
    act = None if active is None else kernel_arg("active", active, torch.bool, (n,), dev)
    out = (torch.empty((n, 3), dtype=torch.float32, device=dev), torch.empty((n, 3), dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.int64, device=dev))
    if n:
        keys = idx = scratch = None
        tiles = 0
        if n > SMALL_MAX:
            items = items or tile_items(n)
            tiles = -(-n // (TILE_THREADS * items))
            keys, idx = torch.empty((2, 2 * n), dtype=torch.int32, device=dev)
            scratch = _scratch(dev, tiles, wide_status(n))
        db = key_dir_bits(spatial_bits, dir_bits)
        _launch("ray_sort_rays_launch", o.data_ptr(), d.data_ptr(), _ptr(lo), _ptr(hi), _ptr(act), n, spatial_bits,
                db, digit_passes(spatial_bits, dir_bits), _ptr(keys), _ptr(idx), _ptr(scratch), tiles,
                items if tiles else 0, *(x.data_ptr() for x in out), dev=dev)
        sort_rays.launches += sort_launches(n, spatial_bits, dir_bits)
    return out


def packet_order_cuda(weights):
    dev, p = weights.device, weights.shape[0]
    w = kernel_arg("weights", weights, torch.int32, (p,), dev)
    order = torch.empty(p, dtype=torch.int32, device=dev)
    if p:
        _launch("ray_sort_order_launch", w.data_ptr(), p, order.data_ptr(), dev=dev)
        packet_order.launches += 1
    return order


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def sort_rays(origins, directions, scene_lo, scene_hi, spatial_bits: int, dir_bits: int, active=None):
    """(origins_s, directions_s, perm): the rays in the stable ascending
    order of their int32 sort key (`ray_sort_key`), the lanes outside
    `active` parked first (`park`), as new [N,3] tensors, and perm the
    [N] int64 permutation (row i is ray perm[i]).  The scene box is [3]
    float32 device tensors, read on the device."""
    fn = sort_rays_cuda if on_card(origins.device) else sort_rays_plain
    return fn(origins, directions, scene_lo, scene_hi, spatial_bits, dir_bits, active)


def packet_order(weights):
    """[P] int32: the packets heaviest first by [P] int32 `weights`, ties in
    packet order (a stable descending argsort)."""
    return (packet_order_cuda if on_card(weights.device) else packet_order_plain)(weights)


# Kernel launches since each count was last set to 0.
sort_rays.launches = 0
packet_order.launches = 0
