"""Cluster accel: Morton-ordered triangle clusters with per-octant visit
orders and a supercluster level, traversed by the packet kernels
(`ops.intersect_cluster`).

Counterpart of `tpu_pathtracer/accel/cluster.py` (the Pallas branches of
`ClusterAccel.intersect` and `ClusterAccel.occluded`,
`build_cluster_accel`) and of
`pack_cluster_tris`, `pack_cluster_tris_bw` and `octant_orders` in
`ops/intersect_pallas.py`.  The build runs in numpy and gives the JAX
package's arrays bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_pathtracer_torch.ops.intersect import Hit
from tpu_pathtracer_torch.utils.device import DEFAULT_DEVICE, resolve
from tpu_pathtracer_torch.ops.intersect_cluster import (
    intersect_clusters,
    intersect_clusters_hier,
    intersect_clusters_streamed,
    occluded_clusters,
    occluded_clusters_hier,
    occluded_clusters_streamed,
    streamed_pads,
)
from tpu_pathtracer_torch.ops.ray_sort import sort_rays

# Scenes with more rows than this take the streamed kernel; at or below
# it, the two-level kernel from cfg.hier_min_clusters clusters up and the
# flat kernel under that.
_FLAT_MAX_BYTES = 6 * 1024 * 1024


@dataclasses.dataclass
class ClusterAccel:
    tris16bw: torch.Tensor      # [C,K,16] f32 Baldwin-Weber rows
    aabb8: torch.Tensor         # [C,8] f32: min xyz, max xyz, pad, pad
    order: torch.Tensor         # [8,C] i32 front-to-back order per octant
    scene_lo: torch.Tensor      # [3] f32
    scene_hi: torch.Tensor      # [3] f32
    # Supercluster level: groups of `super_branch` Morton-consecutive
    # clusters with their own boxes and visit orders; child boxes padded to
    # S*branch rows with far point boxes.
    aabb8_child: torch.Tensor   # [S*B,8] f32
    aabb8_super: torch.Tensor   # [S,8] f32
    order_super: torch.Tensor   # [8,S] i32
    tris16: torch.Tensor        # [C,K,16] f32 Moller-Trumbore rows (v0, e1, e2)
    cluster_size: int = 128
    super_branch: int = 8
    # streamed_pads per branch, made at the first streamed call.
    _pads: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_clusters(self) -> int:
        return self.aabb8.shape[0]

    def _want_sort(self, cfg) -> str:
        """cfg.sort_rays resolved: "" (off), "octant" or "spatial"."""
        if cfg.sort_rays in ("octant", "spatial"):
            return cfg.sort_rays
        if cfg.sort_rays == "off" or self.num_clusters < 2:
            return ""
        return "spatial"

    def _dir_bits(self, cfg) -> int:
        if cfg.sort_dir_bits == 0:
            return 3 if self.num_clusters >= 256 else 2
        return max(cfg.sort_dir_bits, 0)

    def _spatial_bits(self, cfg) -> int:
        if cfg.sort_spatial_bits:
            return cfg.sort_spatial_bits
        return 7 if self.num_clusters < 256 else 5

    def _rpt(self, cfg) -> int:
        """Rays per packet: 512 from the two-level threshold up, else 1024."""
        return 512 if self.num_clusters >= cfg.hier_min_clusters else 1024

    def _tri(self, cfg):
        """cfg.tri_test resolved to (name, rows); "auto" is Baldwin-Weber."""
        mode = "bw" if cfg.tri_test == "auto" else cfg.tri_test
        return mode, (self.tris16bw if mode == "bw" else self.tris16)

    def route(self, cfg) -> str:
        """The kernel this scene takes: "flat", "hier" or "streamed"."""
        if self.tris16bw.numel() * 4 > _FLAT_MAX_BYTES:
            return "streamed"
        return "hier" if self.num_clusters >= cfg.hier_min_clusters else "flat"

    def streamed_pads(self, branch: int):
        if branch not in self._pads:
            self._pads[branch] = streamed_pads(self.aabb8, branch=branch)
        return self._pads[branch]

    def sort(self, origins, directions, cfg, active=None):
        """The coherence sort cfg.sort_rays asks for: (origins, directions,
        perm), with perm None when the rays stay in caller order.  With a
        mask, inactive lanes are parked only when the batch is sorted:
        moved outside the scene box to scene_hi + (scene_hi - scene_lo) +
        1, pointing +x, so they overlap no box and, sharing one sort key,
        fill packets of their own.  Unsorted, parked lanes would sit in
        every packet and block its all-occluded exit while compacting
        nothing.  On the card the key, the parking, the stable sort and
        the gather are one hand-written radix sort (ops.ray_sort.sort_rays)."""
        mode = self._want_sort(cfg)
        if not mode:
            return origins, directions, None
        return sort_rays(origins, directions, self.scene_lo, self.scene_hi,
                         spatial_bits=self._spatial_bits(cfg) if mode == "spatial" else 0,
                         dir_bits=self._dir_bits(cfg), active=active)

    def traversal(self, origins, directions, t_min, t_max, cfg):
        """(route, arguments of the route's wrapper in
        ops.intersect_cluster) for rays in the order given."""
        tri_test, tris = self._tri(cfg)
        rays = (origins, directions, float(t_min), float(t_max), self._rpt(cfg))
        route = self.route(cfg)
        if route == "flat":
            return route, (tris, self.aabb8, self.order, *rays, tri_test)
        if route == "hier":
            return route, (tris, self.aabb8_child, self.aabb8_super, self.order_super, *rays,
                           self.super_branch, tri_test)
        # The streamed supers are the kernel's own groups, twice as wide.
        branch = 2 * self.super_branch
        return route, (tris, *self.streamed_pads(branch), *rays, branch, tri_test)

    def intersect(self, vertices, origins, directions, t_min, t_max, cfg) -> Hit:
        """Closest hit over all clusters: sort the rays for coherence, run
        the route's packet kernel, which writes the results back in caller
        order."""
        origins, directions, perm = self.sort(origins, directions, cfg)
        route, args = self.traversal(origins, directions, t_min, t_max, cfg)
        wrapper = {
            "flat": intersect_clusters,
            "hier": intersect_clusters_hier,
            "streamed": intersect_clusters_streamed,
        }[route]
        return wrapper(*args, restore=True, perm=perm)

    def occluded(self, vertices, origins, directions, t_min, t_max, cfg, active=None) -> torch.Tensor:
        """Any hit over all clusters: [N] bool, True where the segment
        (t_min, t_max) is blocked.  The same sort and route as `intersect`,
        through the route's any-hit kernel, flags written in caller order.
        Lanes outside `active` are parked (see `sort`); their flags are
        unspecified and callers mask on `active`."""
        origins, directions, perm = self.sort(origins, directions, cfg, active)
        route, args = self.traversal(origins, directions, t_min, t_max, cfg)
        wrapper = {
            "flat": occluded_clusters,
            "hier": occluded_clusters_hier,
            "streamed": occluded_clusters_streamed,
        }[route]
        return wrapper(*args, restore=True, perm=perm)


def octant_orders(aabbs: np.ndarray) -> np.ndarray:
    """[8,C] front-to-back cluster order per direction octant: clusters
    sorted (stably) by their near corner projected on the octant's
    diagonal."""
    amin = np.asarray(aabbs)[:, 0:3]
    amax = np.asarray(aabbs)[:, 3:6]
    orders = []
    for oct_ in range(8):
        sign = np.array([1.0 if oct_ & (1 << a) else -1.0 for a in range(3)])
        near_corner = np.where(sign > 0, amin, amax)
        orders.append(np.argsort(near_corner @ sign, kind="stable"))
    return np.stack(orders).astype(np.int32)


def pack_cluster_tris(vertices: np.ndarray, cluster_size: int) -> np.ndarray:
    """[T,3,3] Morton-permuted vertices -> [C,K,16] Moller-Trumbore rows:
    v0 (0:3), e1 = v1 - v0 (3:6), e2 = v2 - v0 (6:9), rest zero; padding
    rows are all zero and fail the det test."""
    t = vertices.shape[0]
    k = cluster_size
    c = max(1, -(-t // k))
    out = np.zeros((c * k, 16), np.float32)
    v0 = vertices[:, 0, :]
    out[:t, 0:3] = v0
    out[:t, 3:6] = vertices[:, 1, :] - v0
    out[:t, 6:9] = vertices[:, 2, :] - v0
    return np.ascontiguousarray(out.reshape(c, k, 16))


def pack_cluster_tris_bw(vertices: np.ndarray, cluster_size: int) -> np.ndarray:
    """[T,3,3] Morton-permuted vertices -> [C,K,16] Baldwin-Weber rows:
    n (0:3), d0 = n.v0 (3), p1 (4:7), c1 = -p1.v0 (7), p2 (8:11),
    c2 = -p2.v0 (11), rest zero.  Degenerate triangles and padding get
    all-zero rows, which fail the den test.  Computed in float64."""
    t = vertices.shape[0]
    k = cluster_size
    c = max(1, -(-t // k))
    out = np.zeros((c * k, 16), np.float32)
    if t:
        v0 = vertices[:, 0, :].astype(np.float64)
        e1 = vertices[:, 1, :].astype(np.float64) - v0
        e2 = vertices[:, 2, :].astype(np.float64) - v0
        n = np.cross(e1, e2)
        nn = (n * n).sum(-1, keepdims=True)
        ok = nn > 1e-30
        safe = np.where(ok, nn, 1.0)
        p1 = np.where(ok, np.cross(e2, n) / safe, 0.0)
        p2 = np.where(ok, np.cross(n, e1) / safe, 0.0)
        n = np.where(ok, n, 0.0)
        out[:t, 0:3] = n
        out[:t, 3:4] = (n * v0).sum(-1, keepdims=True)
        out[:t, 4:7] = p1
        out[:t, 7:8] = -(p1 * v0).sum(-1, keepdims=True)
        out[:t, 8:11] = p2
        out[:t, 11:12] = -(p2 * v0).sum(-1, keepdims=True)
    return np.ascontiguousarray(out.reshape(c, k, 16))


def super_boxes(aabb8: np.ndarray, branch: int):
    """Supercluster level over [C,8] cluster boxes: (child [S*branch,8],
    super [S,8]).  Padding children are point boxes at 3e37, which no ray
    overlaps (a box with min > max would not fail the order-agnostic slab
    test); super bounds come from the real children only."""
    c = aabb8.shape[0]
    s = -(-c // branch)
    child = np.zeros((s * branch, 8), np.float32)
    child[:, 0:6] = 3.0e37
    child[:c] = aabb8
    super8 = np.zeros((s, 8), np.float32)
    for g in range(s):
        real = aabb8[g * branch : min((g + 1) * branch, c)]
        super8[g, 0:3] = real[:, 0:3].min(axis=0)
        super8[g, 3:6] = real[:, 3:6].max(axis=0)
    return child, super8


def build_cluster_accel(vertices: np.ndarray, cluster_size: int = 128, super_branch: int = 8,
                        device=DEFAULT_DEVICE) -> ClusterAccel:
    """Cluster boxes, visit orders, supers and rows over Morton-permuted
    [T,3,3] vertices, on the card unless given another device."""
    device = resolve(device)
    t_count = vertices.shape[0]
    c = max(1, -(-t_count // cluster_size))
    pad = c * cluster_size - t_count
    v = vertices
    if pad:
        # Padding triangles collapse to the last real vertex so they do not
        # grow the last cluster's box.
        fill = np.broadcast_to(v[-1, -1], (pad, 3, 3)) if t_count else np.zeros((pad, 3, 3), np.float32)
        v = np.concatenate([v, fill], axis=0)
    blocks = v.reshape(c, -1, 3)
    aabb8 = np.zeros((c, 8), np.float32)
    aabb8[:, 0:3] = blocks.min(axis=1)
    aabb8[:, 3:6] = blocks.max(axis=1)
    child, super8 = super_boxes(aabb8, super_branch)
    flat = vertices.reshape(-1, 3) if t_count else np.zeros((1, 3), np.float32)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return ClusterAccel(
        tris16bw=up(pack_cluster_tris_bw(vertices, cluster_size)),
        aabb8=up(aabb8),
        order=up(octant_orders(aabb8)),
        scene_lo=up(flat.min(axis=0).astype(np.float32)),
        scene_hi=up(flat.max(axis=0).astype(np.float32)),
        aabb8_child=up(child),
        aabb8_super=up(super8),
        order_super=up(octant_orders(super8)),
        tris16=up(pack_cluster_tris(vertices, cluster_size)),
        cluster_size=cluster_size,
        super_branch=super_branch,
    )
