"""Packet traversal over Morton triangle clusters: the coherence sort, the
CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of `tpu_pathtracer/ops/intersect_pallas.py`: `ray_sort_key`,
`octant_sort`/`sort_by_key` and `intersect_clusters_pallas` with its
Baldwin-Weber test.  The kernel is `csrc/cluster_intersect.cu`;
`intersect_clusters` launches it for CUDA tensors and runs
`intersect_clusters_plain` for CPU tensors.  Both take the packet size as
a parameter: a packet takes its cluster visit order from its first ray,
so the packet size can change which cluster wins an exact tie in t.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MISS_PRIM = 0x7FFFFFFF
_PAD_ORIGIN_X = 3.0e37
_BIG_INV = 3.4e38


# ---------------------------------------------------------------------------
# Coherence sort
# ---------------------------------------------------------------------------

def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of v so bit i lands at bit 3i (3-D Morton)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def ray_sort_key(origins, directions, scene_lo=None, scene_hi=None, spatial_bits: int = 0, dir_bits: int = 0) -> torch.Tensor:
    """[N] int64 key (a u32 value): (origin Morton cell << 3) | octant,
    refined by `dir_bits` direction-magnitude bits per axis below the
    octant bits; clamped so the key fits 32 bits."""
    dir_bits = min(dir_bits, max(0, (32 - 3 - 3 * spatial_bits) // 3))
    key = (
        (directions[:, 0] > 0).to(torch.int64)
        + 2 * (directions[:, 1] > 0).to(torch.int64)
        + 4 * (directions[:, 2] > 0).to(torch.int64)
    )
    if spatial_bits:
        span = torch.clamp_min(scene_hi - scene_lo, 1e-6)
        cells = float((1 << spatial_bits) - 1)
        q = torch.clamp((origins - scene_lo) / span, 0.0, 1.0) * cells
        qi = q.to(torch.int64)
        morton = _part1by2(qi[:, 0]) | (_part1by2(qi[:, 1]) << 1) | (_part1by2(qi[:, 2]) << 2)
        key = key | (morton << 3)
    if dir_bits:
        cells = float((1 << dir_bits) - 1)
        mag = (torch.clamp(torch.abs(directions), 0.0, 1.0) * cells).to(torch.int64)
        fine = (mag[:, 0] << (2 * dir_bits)) | (mag[:, 1] << dir_bits) | mag[:, 2]
        key = (key << (3 * dir_bits)) | fine
    return key


def sort_by_key(origins, directions, key):
    """Stable sort of the rays by `key`.  Returns (origins_s, directions_s,
    perm); `restore(x, perm)` puts per-ray results back in caller order."""
    perm = torch.sort(key, stable=True).indices
    return origins[perm], directions[perm], perm


def restore(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Inverse of the sort permutation along the first axis."""
    out = torch.empty_like(x)
    out[perm] = x
    return out


def octant_sort(origins, directions, scene_lo=None, scene_hi=None, spatial_bits: int = 0, dir_bits: int = 0):
    """Sort rays by `ray_sort_key`; returns (origins_s, directions_s, perm)."""
    key = ray_sort_key(origins, directions, scene_lo, scene_hi, spatial_bits, dir_bits)
    return sort_by_key(origins, directions, key)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _pad_rays(origins, directions, rays_per_tile):
    """Pad to whole packets with rays that start far out on +x and point
    away, so they overlap no box; returns [P,R] component views."""
    n = origins.shape[0]
    n_pad = -(-n // rays_per_tile) * rays_per_tile
    o = torch.zeros((n_pad, 3), dtype=torch.float32, device=origins.device)
    d = torch.zeros((n_pad, 3), dtype=torch.float32, device=origins.device)
    o[:n] = origins
    d[:n] = directions
    o[n:, 0] = _PAD_ORIGIN_X
    d[n:, 0] = 1.0
    p = n_pad // rays_per_tile
    return [o[:, a].reshape(p, rays_per_tile) for a in range(3)], [
        d[:, a].reshape(p, rays_per_tile) for a in range(3)
    ]


def _inv(d):
    return torch.where(torch.abs(d) > 1e-12, 1.0 / d, _BIG_INV)


def intersect_clusters_plain(tris, aabb8, order, origins, directions, t_min: float, t_max: float, rays_per_tile: int):
    """Closest hit with the kernel's packet semantics, in PyTorch.

    Rays are cut into [P,R] packets.  At each visit position every packet
    gathers its cluster, slab-tests it against each ray's running best t,
    and keeps the triangle results only where some ray of the packet
    overlaps; the [P,K,R] Baldwin-Weber test and its tie rules are those
    of the kernel.  Returns (t [N], prim [N] i32 with MISS_PRIM on a
    miss, uv [N,2])."""
    n = origins.shape[0]
    c_count, k, _ = tris.shape
    (ox, oy, oz), (dx, dy, dz) = _pad_rays(origins, directions, rays_per_tile)
    ix, iy, iz = _inv(dx), _inv(dy), _inv(dz)
    p = ox.shape[0]
    dev = origins.device

    octant = (dx[:, 0] > 0).long() + 2 * (dy[:, 0] > 0).long() + 4 * (dz[:, 0] > 0).long()
    best_t = torch.full((p, rays_per_tile), t_max, dtype=torch.float32, device=dev)
    best_p = torch.full((p, rays_per_tile), MISS_PRIM, dtype=torch.int32, device=dev)
    best_u = torch.zeros((p, rays_per_tile), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    lane = torch.arange(k, dtype=torch.int32, device=dev)
    # Triangle-test operands broadcast as [P,K,1] against rays [P,1,R].
    rox, roy, roz = ox[:, None], oy[:, None], oz[:, None]
    rdx, rdy, rdz = dx[:, None], dy[:, None], dz[:, None]

    for pos in range(c_count):
        c = order[octant, pos]                                  # [P]
        b = aabb8[c]                                            # [P,8]
        tx0 = (b[:, 0:1] - ox) * ix
        tx1 = (b[:, 3:4] - ox) * ix
        ty0 = (b[:, 1:2] - oy) * iy
        ty1 = (b[:, 4:5] - oy) * iy
        tz0 = (b[:, 2:3] - oz) * iz
        tz1 = (b[:, 5:6] - oz) * iz
        tnear = torch.maximum(
            torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
            torch.minimum(tz0, tz1),
        )
        tfar = torch.minimum(
            torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
            torch.maximum(tz0, tz1),
        )
        overlap = (tnear <= tfar) & (tfar >= t_min) & (tnear <= best_t)
        packet_on = overlap.any(dim=1, keepdim=True)           # [P,1]

        tri = tris[c]                                           # [P,K,16]
        col = [tri[:, :, j : j + 1] for j in range(12)]         # [P,K,1]
        nx, ny, nz, d0, p1x, p1y, p1z, c1, p2x, p2y, p2z, c2 = col
        den = nx * rdx + ny * rdy + nz * rdz
        num = d0 - (nx * rox + ny * roy + nz * roz)
        rcp = torch.where(torch.abs(den) > 1e-12, 1.0 / den, 0.0)
        t = num * rcp
        hx = rox + t * rdx
        hy = roy + t * rdy
        hz = roz + t * rdz
        u = p1x * hx + p1y * hy + p1z * hz + c1
        v = p2x * hx + p2y * hy + p2z * hz + c2
        bary_ok = torch.minimum(torch.minimum(u, v), 1.0 - (u + v)) >= 0.0
        ok = bary_ok & (t > t_min) & (t < t_max) & (rcp != 0.0)
        tc = torch.where(ok, t, torch.inf)                      # [P,K,R]

        t_blk = tc.amin(dim=1)                                  # [P,R]
        gid = (c[:, None] * k + lane[None, :]).to(torch.int32)[:, :, None]
        prim_blk = torch.where(tc == t_blk[:, None], gid, MISS_PRIM).amin(dim=1)
        win = gid == prim_blk[:, None]
        u_blk = torch.where(win, u, torch.inf).amin(dim=1)
        v_blk = torch.where(win, v, torch.inf).amin(dim=1)

        improved = packet_on & (t_blk < best_t)
        best_t = torch.where(improved, t_blk, best_t)
        best_p = torch.where(improved, prim_blk, best_p)
        best_u = torch.where(improved, u_blk, best_u)
        best_v = torch.where(improved, v_blk, best_v)

    uv = torch.stack([best_u.reshape(-1)[:n], best_v.reshape(-1)[:n]], dim=-1)
    return best_t.reshape(-1)[:n], best_p.reshape(-1)[:n], uv


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def library():
    """The kernel's library, compiled at first use; launch signatures set."""
    from tpu_pathtracer_torch.ops.cuda_build import build_library

    lib = build_library("cluster_intersect.cu")
    fn = lib.cluster_intersect_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32, f32, i32, ptr, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return lib


def _check(name, x, dtype, shape):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def intersect_clusters_cuda(tris, aabb8, order, origins, directions, t_min: float, t_max: float, rays_per_tile: int):
    """Launch the kernel on CUDA tensors; same contract as the plain version."""
    c_count, k, cols = tris.shape
    n = origins.shape[0]
    dev = origins.device
    if not origins.is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    for name, x in (("tris", tris), ("aabb8", aabb8), ("order", order), ("directions", directions)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, origins on {dev}")
    _check("tris", tris, torch.float32, (c_count, k, 16))
    _check("aabb8", aabb8, torch.float32, (c_count, 8))
    _check("order", order, torch.int32, (8, c_count))
    _check("origins", origins, torch.float32, (n, 3))
    _check("directions", directions, torch.float32, (n, 3))
    if not (32 <= rays_per_tile <= 1024 and rays_per_tile % 32 == 0):
        raise ValueError(f"rays_per_tile must be a multiple of 32 in [32, 1024]: {rays_per_tile}")
    if k * 16 * 4 > 48 * 1024:
        raise ValueError(f"cluster of {k} rows exceeds 48 KB of shared memory")
    if tris.data_ptr() % 16:
        raise ValueError("tris must be 16-byte aligned")

    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    err = library().cluster_intersect_launch(
        tris.data_ptr(), aabb8.data_ptr(), order.data_ptr(),
        origins.data_ptr(), directions.data_ptr(), n, c_count, k,
        float(t_min), float(t_max), rays_per_tile,
        t.data_ptr(), prim.data_ptr(), uv.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cluster_intersect_kernel launch failed: CUDA error {err}")
    intersect_clusters.launches += 1
    return t, prim, uv


def intersect_clusters(tris, aabb8, order, origins, directions, t_min: float, t_max: float, rays_per_tile: int):
    """Closest hit over the clusters: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (t, prim, uv) as above."""
    if origins.is_cuda:
        return intersect_clusters_cuda(tris, aabb8, order, origins, directions, t_min, t_max, rays_per_tile)
    if origins.device.type != "cpu":
        raise ValueError(f"no cluster-intersect kernel for device {origins.device}")
    return intersect_clusters_plain(tris, aabb8, order, origins, directions, t_min, t_max, rays_per_tile)


# Kernel launches since the count was last set to 0.
intersect_clusters.launches = 0
