"""Cluster accel: Morton-ordered triangle clusters with per-octant visit
orders, traversed by the packet kernel (`ops.intersect_cluster`).

Counterpart of `tpu_pathtracer/accel/cluster.py` (flat-kernel branch of
`ClusterAccel.intersect`, `build_cluster_accel`) and of
`pack_cluster_tris_bw` / `octant_orders` in `ops/intersect_pallas.py`.
The build runs in numpy and gives the JAX package's arrays bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_pathtracer_torch.ops.intersect import Hit
from tpu_pathtracer_torch.ops.intersect_cluster import (
    MISS_PRIM,
    intersect_clusters,
    octant_sort,
    restore,
)

# Cluster rows above this many bytes go to the streamed kernel, at or
# above cfg.hier_min_clusters to the two-level kernel (both not ported).
_FLAT_MAX_BYTES = 6 * 1024 * 1024
# Rays per packet: the JAX accel's choice for flat-kernel scenes.
RAYS_PER_PACKET = 1024


@dataclasses.dataclass
class ClusterAccel:
    tris16bw: torch.Tensor   # [C,K,16] f32 Baldwin-Weber rows
    aabb8: torch.Tensor      # [C,8] f32: min xyz, max xyz, pad, pad
    order: torch.Tensor      # [8,C] i32 front-to-back order per octant
    scene_lo: torch.Tensor   # [3] f32
    scene_hi: torch.Tensor   # [3] f32
    cluster_size: int = 128

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

    def intersect(self, vertices, origins, directions, t_min, t_max, cfg) -> Hit:
        """Closest hit over all clusters: sort the rays for coherence, run
        the packet kernel, put the results back in caller order."""
        if cfg.tri_test == "mt":
            raise NotImplementedError(
                "tri_test='mt' in the packet kernel is not ported (ROADMAP, "
                "modules to port: the Moller-Trumbore kernel arm)"
            )
        if self.tris16bw.numel() * 4 > _FLAT_MAX_BYTES:
            raise NotImplementedError(
                "scenes with more than 6 MB of cluster rows need the streamed "
                "kernel, not ported yet (ROADMAP, TPU kernels 3 and 6)"
            )
        if self.num_clusters >= cfg.hier_min_clusters:
            raise NotImplementedError(
                f"scenes with >= {cfg.hier_min_clusters} clusters need the "
                "two-level kernel, not ported yet (ROADMAP, TPU kernels 2 and 5)"
            )
        sort = self._want_sort(cfg)
        if sort:
            origins, directions, perm = octant_sort(
                origins, directions,
                scene_lo=self.scene_lo, scene_hi=self.scene_hi,
                spatial_bits=self._spatial_bits(cfg) if sort == "spatial" else 0,
                dir_bits=self._dir_bits(cfg),
            )
        t, prim, uv = intersect_clusters(
            self.tris16bw, self.aabb8, self.order, origins, directions,
            float(t_min), float(t_max), RAYS_PER_PACKET,
        )
        if sort:
            t, prim, uv = restore(t, perm), restore(prim, perm), restore(uv, perm)
        hit = prim != MISS_PRIM
        return Hit(
            t=t,
            prim=torch.where(hit, prim, -1),
            bary=torch.where(hit[:, None], uv, 0.0),
            hit=hit,
        )


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


def build_cluster_accel(vertices: np.ndarray, cluster_size: int = 128, device="cpu") -> ClusterAccel:
    """Cluster boxes, visit orders and rows over Morton-permuted [T,3,3]
    vertices."""
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
    flat = vertices.reshape(-1, 3) if t_count else np.zeros((1, 3), np.float32)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return ClusterAccel(
        tris16bw=up(pack_cluster_tris_bw(vertices, cluster_size)),
        aabb8=up(aabb8),
        order=up(octant_orders(aabb8)),
        scene_lo=up(flat.min(axis=0).astype(np.float32)),
        scene_hi=up(flat.max(axis=0).astype(np.float32)),
        cluster_size=cluster_size,
    )
