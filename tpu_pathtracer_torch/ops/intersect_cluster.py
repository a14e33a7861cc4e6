"""Packet traversal over Morton triangle clusters: the CUDA kernels'
wrappers and their plain PyTorch versions (the coherence sort around them
is `ops/ray_sort.py`).

Counterpart of `tpu_pathtracer/ops/intersect_pallas.py`: `_streamed_pads`,
the closest-hit entries `intersect_clusters_pallas` (flat),
`intersect_clusters_pallas_hier` (two-level) and
`intersect_clusters_pallas_streamed` (scenes beyond 6 MB of rows), and
the any-hit entries of the same three routes
(`occluded_clusters_pallas`, `_hier`, `_streamed`), each with its
Baldwin-Weber ("bw") and Moller-Trumbore ("mt") triangle test.  The
kernels are `csrc/cluster_intersect.cu`, `cluster_hier.cu`,
`cluster_streamed.cu`, `cluster_occluded.cu`, `cluster_occluded_hier.cu`
and `cluster_occluded_streamed.cu`; each wrapper launches its kernel for
CUDA tensors and runs its plain version for CPU tensors.  All take the
packet size as a parameter: a packet takes its visit order from its
first ray and tests a cluster when any of its rays overlaps it, so the
packet size can change which cluster wins an exact tie in t, and which
ray a rounding miss of a box leaves untested.

Each wrapper returns the raw outputs in the rays' order, (t, prim with
MISS_PRIM on a miss, uv) or the any-hit flags, or with `restore=True` the
caller's: a `Hit` (prim -1 and bary 0 on a miss) or the flags, row i of
the rays written to row perm[i] (`perm` None: the identity), which is
`ops.ray_sort.restore_hits_plain` of the raw outputs.  On the card the
kernel does that restore in its store, so it needs no launch of its own;
`caller_order_stores.launches` counts those launches.  Under
`ops.cuda_build.plain()` the kernel stores raw outputs and the plain
restore follows.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_pathtracer_torch.ops.cuda_build import check_lanes, check_tensor, kernel_arg, library, on_card
from tpu_pathtracer_torch.ops.intersect import Hit
from tpu_pathtracer_torch.ops.ray_sort import MISS_PRIM, packet_order, restore_hits_plain

_PAD_ORIGIN_X = 3.0e37
_BIG_INV = 3.4e38
_TRI_TEST_IDS = {"bw": 0, "mt": 1}
# (route, any hit): the stem of the kernel's source in csrc/ and of its functions
_STEMS = {
    ("flat", False): "cluster_intersect", ("hier", False): "cluster_hier", ("streamed", False): "cluster_streamed",
    ("flat", True): "cluster_occluded", ("hier", True): "cluster_occluded_hier",
    ("streamed", True): "cluster_occluded_streamed",
}


# ---------------------------------------------------------------------------
# Plain versions
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


def _bw_tests(tri, ox, oy, oz, dx, dy, dz, t_min, t_max):
    """Baldwin-Weber rows [M,K,16] against rays [M,1,R]: (tc, u, v), each
    [M,K,R], tc = t where the test passes and +inf elsewhere."""
    nx, ny, nz, d0, p1x, p1y, p1z, c1, p2x, p2y, p2z, c2 = (tri[:, :, j : j + 1] for j in range(12))
    den = nx * dx + ny * dy + nz * dz
    num = d0 - (nx * ox + ny * oy + nz * oz)
    rcp = torch.where(torch.abs(den) > 1e-12, 1.0 / den, 0.0)
    t = num * rcp
    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz
    u = p1x * hx + p1y * hy + p1z * hz + c1
    v = p2x * hx + p2y * hy + p2z * hz + c2
    bary_ok = torch.minimum(torch.minimum(u, v), 1.0 - (u + v)) >= 0.0
    ok = bary_ok & (t > t_min) & (t < t_max) & (rcp != 0.0)
    return torch.where(ok, t, torch.inf), u, v


def _mt_tests(tri, ox, oy, oz, dx, dy, dz, t_min, t_max):
    """Moller-Trumbore rows (v0, e1, e2) [M,K,16] against rays [M,1,R], in
    the operation order of the JAX package's `_mt_tests`; returns as
    `_bw_tests`."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri[:, :, j : j + 1] for j in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return torch.where(ok, t, torch.inf), u, v


_TRI_TESTS = {"bw": _bw_tests, "mt": _mt_tests}


class _PacketRays:
    """The plain versions' rays: cut into [P,R] packets and padded as the
    kernels pad them, each packet with the visit octant of its first ray.
    The traversals work on a subset `idx` of the packets, so they compute
    only for the packets that a box gate lets through, as the kernels do.

    `stats`, when given a dict, counts what the kernel computes for these
    inputs: "visits", the (packet, cluster) pairs staged, and "tests",
    the ray-triangle tests made."""

    def __init__(self, tris, origins, directions, t_min, t_max, rays_per_tile, tri_test, stats):
        if tri_test not in _TRI_TESTS:
            raise ValueError(f"unknown tri_test {tri_test!r}")
        self.n = origins.shape[0]
        self.r = rays_per_tile
        self.o, self.d = _pad_rays(origins, directions, rays_per_tile)
        self.inv = [_inv(x) for x in self.d]
        p = self.o[0].shape[0]
        self.all = torch.arange(p, device=origins.device)
        dx, dy, dz = self.d
        self.octant = (dx[:, 0] > 0).long() + 2 * (dy[:, 0] > 0).long() + 4 * (dz[:, 0] > 0).long()
        self.tris = tris
        self.t_min, self.t_max = t_min, t_max
        self.test = _TRI_TESTS[tri_test]
        self.stats = stats
        if stats is not None:
            stats.setdefault("visits", 0)
            stats.setdefault("tests", 0)

    def slab(self, boxes, idx, t_limit):
        """[M,R] bool: does ray r of packet idx[m] overlap boxes[m] ([M,8],
        or [1,8] for one box) within [t_min, t_limit]?"""
        ox, oy, oz = (x[idx] for x in self.o)
        ix, iy, iz = (x[idx] for x in self.inv)
        tx0 = (boxes[:, 0:1] - ox) * ix
        tx1 = (boxes[:, 3:4] - ox) * ix
        ty0 = (boxes[:, 1:2] - oy) * iy
        ty1 = (boxes[:, 4:5] - oy) * iy
        tz0 = (boxes[:, 2:3] - oz) * iz
        tz1 = (boxes[:, 5:6] - oz) * iz
        tnear = torch.maximum(
            torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
            torch.minimum(tz0, tz1),
        )
        tfar = torch.minimum(
            torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
            torch.maximum(tz0, tz1),
        )
        return (tnear <= tfar) & (tfar >= self.t_min) & (tnear <= t_limit)

    def tests(self, idx, row):
        """Every ray of packet idx[m] against the K triangles of rows
        tris[row[m]]: (tc, u, v), each [M,K,R], tc = t where the test
        passes and +inf elsewhere."""
        rays = [x[idx][:, None] for x in (*self.o, *self.d)]             # [M,1,R]
        return self.test(self.tris[row], *rays, self.t_min, self.t_max)


class _Packets(_PacketRays):
    """Closest hit: each ray's running winner."""

    def __init__(self, tris, origins, directions, t_min, t_max, rays_per_tile, tri_test, stats=None):
        super().__init__(tris, origins, directions, t_min, t_max, rays_per_tile, tri_test, stats)
        p, dev = self.all.shape[0], origins.device
        self.best_t = torch.full((p, rays_per_tile), t_max, dtype=torch.float32, device=dev)
        self.best_p = torch.full((p, rays_per_tile), MISS_PRIM, dtype=torch.int32, device=dev)
        self.best_u = torch.zeros((p, rays_per_tile), dtype=torch.float32, device=dev)
        self.best_v = torch.zeros_like(self.best_u)
        self.lane = torch.arange(tris.shape[1], dtype=torch.int32, device=dev)

    def overlaps(self, boxes, idx):
        """[M] bool: does any ray of packet idx[m] overlap boxes[m] before
        its running best t?"""
        return self.slab(boxes, idx, self.best_t[idx]).any(dim=1)

    def visit(self, idx, c, row):
        """Every ray of packet idx[m] tests cluster c[m], whose rows are
        tris[row[m]]; a strictly closer winner replaces the ray's best.
        Within the cluster the smallest t wins, equal t the lowest id."""
        if idx.numel() == 0:
            return
        tc, u, v = self.tests(idx, row)                                   # [M,K,R]
        if self.stats is not None:
            self.stats["visits"] += idx.numel()
            self.stats["tests"] += tc.numel()
        t_blk = tc.amin(dim=1)
        gid = (c[:, None] * self.lane.shape[0] + self.lane[None, :]).to(torch.int32)[:, :, None]
        prim_blk = torch.where(tc == t_blk[:, None], gid, MISS_PRIM).amin(dim=1)
        win = gid == prim_blk[:, None]
        u_blk = torch.where(win, u, torch.inf).amin(dim=1)
        v_blk = torch.where(win, v, torch.inf).amin(dim=1)
        best = self.best_t[idx]
        improved = t_blk < best
        self.best_t[idx] = torch.where(improved, t_blk, best)
        self.best_p[idx] = torch.where(improved, prim_blk, self.best_p[idx])
        self.best_u[idx] = torch.where(improved, u_blk, self.best_u[idx])
        self.best_v[idx] = torch.where(improved, v_blk, self.best_v[idx])

    def result(self):
        n = self.n
        uv = torch.stack([self.best_u.reshape(-1)[:n], self.best_v.reshape(-1)[:n]], dim=-1)
        return self.best_t.reshape(-1)[:n], self.best_p.reshape(-1)[:n], uv


class _Occlusion(_PacketRays):
    """Any hit: each ray's occluded flag.  A box is voted on by the rays
    not yet occluded, against t_max; a visited cluster sets the flag of
    every ray of the packet that meets one of its triangles, including
    rays whose own slab test missed the box."""

    def __init__(self, tris, origins, directions, t_min, t_max, rays_per_tile, tri_test, stats=None):
        super().__init__(tris, origins, directions, t_min, t_max, rays_per_tile, tri_test, stats)
        self.occ = torch.zeros((self.all.shape[0], rays_per_tile), dtype=torch.bool, device=origins.device)

    def overlaps(self, boxes, idx):
        """[M] bool: does a ray of packet idx[m] that is not yet occluded
        overlap boxes[m] within [t_min, t_max]?"""
        return (self.slab(boxes, idx, self.t_max) & ~self.occ[idx]).any(dim=1)

    def visit(self, idx, row):
        if idx.numel() == 0:
            return
        ok = self.tests(idx, row)[0] < torch.inf                          # [M,K,R]
        hit = ok.any(dim=1)
        if self.stats is not None:
            # A ray not yet occluded tests up to its first valid triangle.
            k = ok.shape[1]
            first = torch.where(hit, ok.to(torch.int8).argmax(dim=1) + 1, k)
            self.stats["visits"] += idx.numel()
            self.stats["tests"] += int((first * ~self.occ[idx]).sum())
        self.occ[idx] |= hit

    def unfinished(self, idx):
        """The packets of idx that still hold a ray not occluded: a packet
        whose rays are all occluded leaves the traversal."""
        return idx[~self.occ[idx].all(dim=1)]

    def result(self):
        return self.occ.reshape(-1)[: self.n]


def intersect_clusters_plain(tris, aabb8, order, origins, directions, t_min: float, t_max: float,
                             rays_per_tile: int, tri_test: str = "bw", stats=None):
    """Flat closest hit with the kernel's packet semantics, in PyTorch.

    Rays are cut into [P,R] packets; each packet visits the clusters in
    its octant's front-to-back `order` and tests a cluster when some ray
    of the packet overlaps its box.  Returns (t [N], prim [N] i32 with
    MISS_PRIM on a miss, uv [N,2]).  `stats`: see _PacketRays."""
    pk = _Packets(tris, origins, directions, t_min, t_max, rays_per_tile, tri_test, stats)
    for pos in range(tris.shape[0]):
        c = order[pk.octant, pos]
        on = pk.overlaps(aabb8[c], pk.all)
        pk.visit(pk.all[on], c[on], c[on])
    return pk.result()


def intersect_clusters_hier_plain(tris, aabb_child, aabb_super, order_super, origins, directions,
                                  t_min: float, t_max: float, rays_per_tile: int, branch: int,
                                  tri_test: str = "bw", stats=None):
    """Two-level closest hit with the kernel's packet semantics: each
    packet visits the supers in its octant's front-to-back `order_super`,
    and for a super some ray overlaps, its `branch` children in index
    order, testing a child some ray overlaps.  Padding children are far
    point boxes; the row index is clamped to C-1 all the same.  Returns
    as `intersect_clusters_plain`."""
    pk = _Packets(tris, origins, directions, t_min, t_max, rays_per_tile, tri_test, stats)
    last = tris.shape[0] - 1
    for pos in range(aabb_super.shape[0]):
        s = order_super[pk.octant, pos]
        on = pk.overlaps(aabb_super[s], pk.all)
        live, s = pk.all[on], s[on]
        for j in range(branch):
            if live.numel() == 0:
                break
            c = s * branch + j
            on = pk.overlaps(aabb_child[c], live)
            pk.visit(live[on], c[on], torch.clamp(c[on], max=last))
    return pk.result()


def intersect_clusters_streamed_plain(tris, aabb_child, aabb_super, origins, directions,
                                      t_min: float, t_max: float, rays_per_tile: int, branch: int,
                                      tri_test: str = "bw", stats=None):
    """Streamed closest hit with the kernel's packet semantics: the supers
    of `streamed_pads` in ascending id, each super's `branch` children in
    index order, children at or past the cluster count never tested.
    Returns as `intersect_clusters_plain`."""
    pk = _Packets(tris, origins, directions, t_min, t_max, rays_per_tile, tri_test, stats)
    num_clusters = tris.shape[0]
    for s in range(aabb_super.shape[0]):
        live = pk.all[pk.overlaps(aabb_super[s : s + 1], pk.all)]
        for c in range(s * branch, min((s + 1) * branch, num_clusters)):
            if live.numel() == 0:
                break
            on = live[pk.overlaps(aabb_child[c : c + 1], live)]
            cc = torch.full_like(on, c, dtype=torch.int32)
            pk.visit(on, cc, cc)
    return pk.result()


def occluded_clusters_plain(tris, aabb8, order, origins, directions, t_min: float, t_max: float,
                            rays_per_tile: int, tri_test: str = "bw", stats=None):
    """Flat any hit with the kernel's packet semantics, in PyTorch: each
    packet visits the clusters in its octant's front-to-back `order` and
    tests a cluster when a ray of the packet that is not yet occluded
    overlaps its box within [t_min, t_max]; a packet stops once all its
    rays are occluded.  Returns occluded [N] bool."""
    pk = _Occlusion(tris, origins, directions, t_min, t_max, rays_per_tile, tri_test, stats)
    live = pk.all
    for pos in range(tris.shape[0]):
        if live.numel() == 0:
            break
        c = order[pk.octant[live], pos]
        on = pk.overlaps(aabb8[c], live)
        pk.visit(live[on], c[on])
        live = pk.unfinished(live)
    return pk.result()


def occluded_clusters_hier_plain(tris, aabb_child, aabb_super, order_super, origins, directions,
                                 t_min: float, t_max: float, rays_per_tile: int, branch: int,
                                 tri_test: str = "bw", stats=None):
    """Two-level any hit with the kernel's packet semantics: supers in the
    packet octant's front-to-back `order_super`, each passing super's
    children in index order (row index clamped to C-1), both voted on by
    the rays not yet occluded; a packet stops after a super once all its
    rays are occluded.  Returns occluded [N] bool."""
    pk = _Occlusion(tris, origins, directions, t_min, t_max, rays_per_tile, tri_test, stats)
    last = tris.shape[0] - 1
    live = pk.all
    for pos in range(aabb_super.shape[0]):
        if live.numel() == 0:
            break
        s = order_super[pk.octant[live], pos]
        on = pk.overlaps(aabb_super[s], live)
        sub, s = live[on], s[on]
        for j in range(branch):
            if sub.numel() == 0:
                break
            c = s * branch + j
            on = pk.overlaps(aabb_child[c], sub)
            pk.visit(sub[on], torch.clamp(c[on], max=last))
        live = pk.unfinished(live)
    return pk.result()


def occluded_clusters_streamed_plain(tris, aabb_child, aabb_super, origins, directions,
                                     t_min: float, t_max: float, rays_per_tile: int, branch: int,
                                     tri_test: str = "bw", stats=None):
    """Streamed any hit with the kernel's packet semantics: the supers of
    `streamed_pads` in ascending id, children in index order, children at
    or past the cluster count never tested; a packet stops after a super
    once all its rays are occluded.  Returns occluded [N] bool."""
    pk = _Occlusion(tris, origins, directions, t_min, t_max, rays_per_tile, tri_test, stats)
    num_clusters = tris.shape[0]
    live = pk.all
    for s in range(aabb_super.shape[0]):
        if live.numel() == 0:
            break
        sub = live[pk.overlaps(aabb_super[s : s + 1], live)]
        for c in range(s * branch, min((s + 1) * branch, num_clusters)):
            if sub.numel() == 0:
                break
            on = sub[pk.overlaps(aabb_child[c : c + 1], sub)]
            pk.visit(on, torch.full_like(on, c))
        live = pk.unfinished(live)
    return pk.result()


def streamed_pads(aabbs, block_clusters: int = 96, branch: int = 16):
    """The supers of the streamed route, as the JAX package's
    `_streamed_pads`: pad the cluster boxes to a multiple of the block size
    with far point boxes (3e37) and group them by `branch` over the padded
    range.  A boundary group that mixes real and padding children gets a
    huge box; its children are gated one by one.  The triangle rows need no
    padding: a child at or past the cluster count is never tested.
    Returns (aabb_child [Sp*branch,8], aabb_super [Sp,8])."""
    c = aabbs.shape[0]
    cb = min(block_clusters, max(branch, -(-c // branch) * branch))
    cb = max(cb, branch)
    if cb % branch:
        cb = -(-cb // branch) * branch
    c_pad = -(-c // cb) * cb
    child = torch.full((c_pad, 8), 3.0e37, dtype=aabbs.dtype, device=aabbs.device)
    child[:c] = aabbs
    groups = child.reshape(c_pad // branch, branch, 8)
    supers = torch.cat(
        [groups[:, :, 0:3].amin(dim=1), groups[:, :, 3:6].amax(dim=1),
         torch.zeros((groups.shape[0], 2), dtype=aabbs.dtype, device=aabbs.device)],
        dim=-1,
    )
    return child, supers


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check_launch(tris, origins, directions, rays_per_tile, tri_test, boxes):
    """Check what every kernel takes.  Boxes must be 16-byte aligned: the
    kernels read them as float4."""
    dev = origins.device
    if not origins.is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    c_count, k, _ = tris.shape
    n = check_lanes("rays", origins.shape[0])
    check_tensor("tris", tris, torch.float32, (c_count, k, 16), dev)
    check_tensor("origins", origins, torch.float32, (n, 3), dev)
    check_tensor("directions", directions, torch.float32, (n, 3), dev)
    for name, (x, dtype, shape) in boxes.items():
        check_tensor(name, x, dtype, shape, dev)
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if tri_test not in _TRI_TEST_IDS:
        raise ValueError(f"unknown tri_test {tri_test!r}")
    if not (32 <= rays_per_tile <= 1024 and rays_per_tile % 32 == 0):
        raise ValueError(f"rays_per_tile must be a multiple of 32 in [32, 1024]: {rays_per_tile}")
    if k * 16 * 4 > 48 * 1024:
        raise ValueError(f"cluster of {k} rows exceeds 48 KB of shared memory")
    if tris.data_ptr() % 16:
        raise ValueError("tris must be 16-byte aligned")


def _hit_outputs(origins, restore=False):
    """(t, prim, uv) for a closest-hit kernel to fill, and with `restore`
    the Hit's flags (the kernel writes bary into uv's place)."""
    n, dev = origins.shape[0], origins.device
    return (
        torch.empty(n, dtype=torch.float32, device=dev),
        torch.empty(n, dtype=torch.int32, device=dev),
        torch.empty((n, 2), dtype=torch.float32, device=dev),
    ) + ((torch.empty(n, dtype=torch.bool, device=dev),) if restore else ())


def _stream(origins):
    return torch.cuda.current_stream(origins.device).cuda_stream


def intersect_clusters_cuda(tris, aabb8, order, origins, directions, t_min: float, t_max: float,
                            rays_per_tile: int, tri_test: str = "bw", restore: bool = False, perm=None):
    """Launch the flat kernel on CUDA tensors; same contract as the plain
    version, and with `restore` the wrapper's."""
    return _traversal_cuda(intersect_clusters, "flat", tris, (aabb8, order), origins, directions, t_min, t_max,
                           rays_per_tile, 1, tri_test, restore, perm)


def intersect_clusters_hier_cuda(tris, aabb_child, aabb_super, order_super, origins, directions,
                                 t_min: float, t_max: float, rays_per_tile: int, branch: int,
                                 tri_test: str = "bw", restore: bool = False, perm=None):
    """Launch the two-level kernel on CUDA tensors; same contract as the
    plain version, and with `restore` the wrapper's."""
    return _traversal_cuda(intersect_clusters_hier, "hier", tris, (aabb_child, aabb_super, order_super), origins,
                           directions, t_min, t_max, rays_per_tile, branch, tri_test, restore, perm)


def packet_weights(weights_launch, aabb_super, origins, directions, t_min, t_max, rays_per_tile):
    """The traversal's pre-pass (`weights_launch`, a library's `_weights`
    function): [packets] int32, the supers (on the flat route the
    clusters) that some ray of each packet overlaps."""
    packets = -(-origins.shape[0] // rays_per_tile)
    weights = torch.empty(packets, dtype=torch.int32, device=origins.device)
    err = weights_launch(aabb_super.data_ptr(), origins.data_ptr(), directions.data_ptr(), origins.shape[0],
                         aabb_super.shape[0], float(t_min), float(t_max), rays_per_tile, weights.data_ptr(),
                         _stream(origins))
    if err:
        raise RuntimeError(f"packet_weight_kernel launch failed: CUDA error {err}")
    return weights


def _heaviest_first(weights_launch, aabb_super, origins, directions, t_min, t_max, rays_per_tile):
    """The order in which a traversal kernel takes its packets: heaviest
    first by the pre-pass's estimate (`packet_weights`), so that the few
    packets that test the most clusters start at once and not behind a
    queue of light ones.  [packets] int32 (`ops.ray_sort.packet_order`),
    or None where the card holds every packet at once anyway (a packet
    takes at most 8 blocks and an SM holds at least 2).  The order changes
    no result: packets are independent, and the estimate counts the same
    boxes whatever order a packet visits them in."""
    packets = -(-origins.shape[0] // rays_per_tile)
    if packets * 4 <= torch.cuda.get_device_properties(origins.device).multi_processor_count:
        return None
    return packet_order(packet_weights(weights_launch, aabb_super, origins, directions, t_min, t_max,
                                       rays_per_tile))


def _traversal_cuda(counter, route, tris, boxes, origins, directions, t_min, t_max, rays_per_tile, branch,
                    tri_test, restore=False, perm=None):
    """Check, allocate and launch streamed_kernel (csrc/cluster_streamed.cuh)
    on `route`, packets heaviest first.  `boxes` are the route's box and
    visit-order tensors in its launch's order: flat (aabb8 [C,8], order
    [8,C]), hier (aabb_child, aabb_super, order_super [8,S]) or streamed
    (aabb_child, aabb_super; ascending order).  Closest hit where `counter`
    is a closest-hit wrapper, else any hit; `counter.launches` counts the
    launch.  Returns (t, prim, uv), or occluded; with `restore` a Hit, or
    occluded, in caller order through `perm` (None: the identity), written
    by the kernel's store (counted in caller_order_stores.launches where
    it differs from the raw store: closest hit, or a perm)."""
    if perm is not None and not restore:
        raise ValueError("perm is for the outputs in caller order (restore=True)")
    any_hit = counter in (occluded_clusters, occluded_clusters_hier, occluded_clusters_streamed)
    c_count, k, _ = tris.shape
    if route == "flat":
        aabb_super = boxes[0]
        checks = {"aabb8": (boxes[0], torch.float32, (c_count, 8)), "order": (boxes[1], torch.int32, (8, c_count))}
        sizes = (c_count, k)
    else:
        aabb_super = boxes[1]
        s = aabb_super.shape[0]
        checks = {
            "aabb_child": (boxes[0], torch.float32, (s * branch, 8)),
            "aabb_super": (aabb_super, torch.float32, (s, 8)),
        }
        if route == "hier":
            checks["order_super"] = (boxes[2], torch.int32, (8, s))
        elif s * branch < c_count:
            raise ValueError(f"{s} supers of {branch} do not cover {c_count} clusters")
        sizes = (s, branch, c_count, k)
    _check_launch(tris, origins, directions, rays_per_tile, tri_test, checks)
    n, dev = origins.shape[0], origins.device
    rows = kernel_arg("perm", perm, torch.int64, (n,), dev) if perm is not None else None
    if any_hit:
        out = (torch.empty(n, dtype=torch.bool, device=dev),)
    else:
        out = _hit_outputs(origins, restore)
    result = out[0] if any_hit else Hit(t=out[0], prim=out[1], bary=out[2], hit=out[3]) if restore else out
    if n == 0:
        return result  # nothing to launch
    stem = _STEMS[route, any_hit]
    lib = library(f"{stem}.cu")
    order = _heaviest_first(getattr(lib, f"{stem}_weights"), aabb_super, origins, directions, t_min, t_max,
                            rays_per_tile)
    hit_out = () if any_hit else ((out[3].data_ptr() if restore else None),)
    err = getattr(lib, f"{stem}_launch")(
        tris.data_ptr(), *(x.data_ptr() for x in boxes), origins.data_ptr(), directions.data_ptr(),
        order.data_ptr() if order is not None else None, n, *sizes,
        float(t_min), float(t_max), rays_per_tile, _TRI_TEST_IDS[tri_test],
        rows.data_ptr() if rows is not None else None, *(x.data_ptr() for x in out[:3]), *hit_out, _stream(origins),
    )
    if err:
        raise RuntimeError(f"streamed_kernel ({route}, {'any' if any_hit else 'closest'} hit) launch failed: "
                           f"CUDA error {err}")
    counter.launches += 1
    if restore and (rows is not None or not any_hit):
        caller_order_stores.launches += 1
    return result


def intersect_clusters_streamed_cuda(tris, aabb_child, aabb_super, origins, directions,
                                     t_min: float, t_max: float, rays_per_tile: int, branch: int,
                                     tri_test: str = "bw", restore: bool = False, perm=None):
    """Launch the streamed kernel on CUDA tensors; same contract as the
    plain version, and with `restore` the wrapper's."""
    return _traversal_cuda(intersect_clusters_streamed, "streamed", tris, (aabb_child, aabb_super), origins,
                           directions, t_min, t_max, rays_per_tile, branch, tri_test, restore, perm)


def occluded_clusters_cuda(tris, aabb8, order, origins, directions, t_min: float, t_max: float,
                           rays_per_tile: int, tri_test: str = "bw", restore: bool = False, perm=None):
    """Launch the flat any-hit kernel on CUDA tensors; same contract as
    the plain version, and with `restore` the wrapper's."""
    return _traversal_cuda(occluded_clusters, "flat", tris, (aabb8, order), origins, directions, t_min, t_max,
                           rays_per_tile, 1, tri_test, restore, perm)


def occluded_clusters_hier_cuda(tris, aabb_child, aabb_super, order_super, origins, directions,
                                t_min: float, t_max: float, rays_per_tile: int, branch: int,
                                tri_test: str = "bw", restore: bool = False, perm=None):
    """Launch the two-level any-hit kernel on CUDA tensors; same contract
    as the plain version, and with `restore` the wrapper's."""
    return _traversal_cuda(occluded_clusters_hier, "hier", tris, (aabb_child, aabb_super, order_super), origins,
                           directions, t_min, t_max, rays_per_tile, branch, tri_test, restore, perm)


def occluded_clusters_streamed_cuda(tris, aabb_child, aabb_super, origins, directions,
                                    t_min: float, t_max: float, rays_per_tile: int, branch: int,
                                    tri_test: str = "bw", restore: bool = False, perm=None):
    """Launch the streamed any-hit kernel on CUDA tensors; same contract
    as the plain version, and with `restore` the wrapper's."""
    return _traversal_cuda(occluded_clusters_streamed, "streamed", tris, (aabb_child, aabb_super), origins,
                           directions, t_min, t_max, rays_per_tile, branch, tri_test, restore, perm)


def streamed_launch_shape(n: int, rays_per_tile: int, cluster_k: int, tri_test: str = "bw",
                          any_hit: bool = False, route: str = "streamed") -> dict:
    """How the traversal kernel of `route` ("flat", "hier" or "streamed";
    closest hit, or any hit) lays out a launch of n rays on the current CUDA
    device: "packets", "blocks" (of a packet's thread block cluster),
    "threads" (of a block), "threads_per_ray", "registers" (of a thread),
    "resident_blocks" (per SM) and "resident_clusters" (packets the card
    holds at once).  Builds the kernel if need be; launches nothing."""
    if tri_test not in _TRI_TEST_IDS:
        raise ValueError(f"unknown tri_test {tri_test!r}")
    if route not in ("flat", "hier", "streamed"):
        raise ValueError(f"no launch shape for route {route!r}")
    stem = _STEMS[route, any_hit]
    out = (ctypes.c_int * 6)()
    err = getattr(library(f"{stem}.cu"), f"{stem}_shape")(n, rays_per_tile, cluster_k, _TRI_TEST_IDS[tri_test], out)
    if err:
        raise RuntimeError(f"{route} kernel shape query failed: CUDA error {err}")
    keys = ("blocks", "threads", "threads_per_ray", "registers", "resident_blocks", "resident_clusters")
    return {"packets": -(-n // rays_per_tile), **dict(zip(keys, out))}


def _route(origins, kernel, plain, *args, restore=False, perm=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors; with
    `restore` the outputs in caller order: on the card outside
    ops.cuda_build.plain() by the kernel's store, else by the plain
    restore of the raw outputs."""
    if origins.is_cuda:
        if restore and on_card(origins.device):
            return kernel(*args, restore=True, perm=perm)
        out = kernel(*args)
    elif origins.device.type == "cpu":
        out = plain(*args)
    else:
        raise ValueError(f"no cluster-intersect kernel for device {origins.device}")
    return restore_hits_plain(out, perm) if restore else out


def intersect_clusters(tris, aabb8, order, origins, directions, t_min: float, t_max: float,
                       rays_per_tile: int, tri_test: str = "bw", *, restore: bool = False, perm=None):
    """Flat closest hit over the clusters (TPU kernel 1's contract).
    Returns (t, prim, uv) as `intersect_clusters_plain`, or with `restore`
    the Hit in caller order through `perm` (see the top of this module)."""
    return _route(origins, intersect_clusters_cuda, intersect_clusters_plain,
                  tris, aabb8, order, origins, directions, t_min, t_max, rays_per_tile, tri_test,
                  restore=restore, perm=perm)


def intersect_clusters_hier(tris, aabb_child, aabb_super, order_super, origins, directions,
                            t_min: float, t_max: float, rays_per_tile: int, branch: int,
                            tri_test: str = "bw", *, restore: bool = False, perm=None):
    """Two-level closest hit (TPU kernel 2's contract)."""
    return _route(origins, intersect_clusters_hier_cuda, intersect_clusters_hier_plain,
                  tris, aabb_child, aabb_super, order_super, origins, directions,
                  t_min, t_max, rays_per_tile, branch, tri_test, restore=restore, perm=perm)


def intersect_clusters_streamed(tris, aabb_child, aabb_super, origins, directions,
                                t_min: float, t_max: float, rays_per_tile: int, branch: int,
                                tri_test: str = "bw", *, restore: bool = False, perm=None):
    """Streamed closest hit (TPU kernel 3's contract) over the supers of
    `streamed_pads`."""
    return _route(origins, intersect_clusters_streamed_cuda, intersect_clusters_streamed_plain,
                  tris, aabb_child, aabb_super, origins, directions,
                  t_min, t_max, rays_per_tile, branch, tri_test, restore=restore, perm=perm)


def occluded_clusters(tris, aabb8, order, origins, directions, t_min: float, t_max: float,
                      rays_per_tile: int, tri_test: str = "bw", *, restore: bool = False, perm=None):
    """Flat any hit over the clusters (TPU kernel 4's contract).  Returns
    occluded [N] bool as `occluded_clusters_plain`, with `restore` in
    caller order through `perm`."""
    return _route(origins, occluded_clusters_cuda, occluded_clusters_plain,
                  tris, aabb8, order, origins, directions, t_min, t_max, rays_per_tile, tri_test,
                  restore=restore, perm=perm)


def occluded_clusters_hier(tris, aabb_child, aabb_super, order_super, origins, directions,
                           t_min: float, t_max: float, rays_per_tile: int, branch: int,
                           tri_test: str = "bw", *, restore: bool = False, perm=None):
    """Two-level any hit (TPU kernel 5's contract)."""
    return _route(origins, occluded_clusters_hier_cuda, occluded_clusters_hier_plain,
                  tris, aabb_child, aabb_super, order_super, origins, directions,
                  t_min, t_max, rays_per_tile, branch, tri_test, restore=restore, perm=perm)


def occluded_clusters_streamed(tris, aabb_child, aabb_super, origins, directions,
                               t_min: float, t_max: float, rays_per_tile: int, branch: int,
                               tri_test: str = "bw", *, restore: bool = False, perm=None):
    """Streamed any hit (TPU kernel 6's contract) over the supers of
    `streamed_pads`."""
    return _route(origins, occluded_clusters_streamed_cuda, occluded_clusters_streamed_plain,
                  tris, aabb_child, aabb_super, origins, directions,
                  t_min, t_max, rays_per_tile, branch, tri_test, restore=restore, perm=perm)


def caller_order_stores() -> int:
    """The traversal launches since the count was last set to 0 whose
    store was the restore into caller order (a wrapper's `restore` on the
    card: every closest hit, and an any hit through a perm), which the
    restore kernel launched once each before it was folded into the
    traversal's store.  The count is `.launches` (render/graph_loop.COUNTED);
    returns it."""
    return caller_order_stores.launches


# Kernel launches since each count was last set to 0.
caller_order_stores.launches = 0
intersect_clusters.launches = 0
intersect_clusters_hier.launches = 0
intersect_clusters_streamed.launches = 0
occluded_clusters.launches = 0
occluded_clusters_hier.launches = 0
occluded_clusters_streamed.launches = 0
