"""Ray-triangle intersection: the Hit record, blocked brute-force
Moller-Trumbore (the CPU oracle) for closest and any hit, and the
intersector dispatch for both.

Counterpart of `tpu_pathtracer/ops/intersect.py`.  Triangles are two-sided.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_pathtracer_torch.utils import math as vm

_DET_EPS = 1e-12
_MISS = 0x7FFFFFFF


@dataclasses.dataclass
class Hit:
    """Closest-hit record for a ray batch ([N] lanes)."""

    t: torch.Tensor      # [N] f32 hit distance (t_max on a miss)
    prim: torch.Tensor   # [N] i32 triangle index (-1 on a miss)
    bary: torch.Tensor   # [N,2] f32 (beta, gamma) barycentrics
    hit: torch.Tensor    # [N] bool


def _mt_block(origins, directions, tri_block, t_min, t_max):
    """Moller-Trumbore of [N] rays against [B] triangles ([B,3,3]).
    Returns t, u, v, valid, each [N,B]."""
    ox, oy, oz = origins[:, 0:1], origins[:, 1:2], origins[:, 2:3]
    dx, dy, dz = directions[:, 0:1], directions[:, 1:2], directions[:, 2:3]
    v0x, v0y, v0z = (tri_block[None, :, 0, a] for a in range(3))
    e1 = tri_block[:, 1, :] - tri_block[:, 0, :]
    e2 = tri_block[:, 2, :] - tri_block[:, 0, :]
    e1x, e1y, e1z = (e1[None, :, a] for a in range(3))
    e2x, e2y, e2z = (e2[None, :, a] for a in range(3))

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(torch.abs(det) > _DET_EPS, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (
        (torch.abs(det) > _DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return t, u, v, valid


def intersect_brute(vertices, origins, directions, t_min: float, t_max: float, block: int = 256) -> Hit:
    """Closest hit by exhaustive blocked search over [T,3,3] vertices."""
    t_count = vertices.shape[0]
    block = max(8, min(block, max(t_count, 8)))
    pad = (-t_count) % block
    if pad:
        # All-zero triangles never pass the det test.
        vertices = torch.cat([vertices, vertices.new_zeros((pad, 3, 3))])
    n = origins.shape[0]
    best_t = torch.full((n,), t_max, dtype=torch.float32, device=origins.device)
    best_prim = torch.full((n,), _MISS, dtype=torch.int32, device=origins.device)
    lane = torch.arange(block, dtype=torch.int32, device=origins.device)
    for base in range(0, vertices.shape[0], block):
        t, _, _, valid = _mt_block(origins, directions, vertices[base : base + block], t_min, t_max)
        t = torch.where(valid, t, torch.inf)
        t_blk = t.amin(dim=1)
        prim_blk = torch.where(t == t_blk[:, None], base + lane, _MISS).amin(dim=1)
        closer = t_blk < best_t
        best_t = torch.where(closer, t_blk, best_t)
        best_prim = torch.where(closer, prim_blk, best_prim)
    return finalize_hit(vertices, origins, directions, best_t, best_prim, t_min, t_max)


def finalize_hit(vertices, origins, directions, best_t, best_prim, t_min, t_max) -> Hit:
    """Recompute the winner's barycentrics and assemble the Hit."""
    hit = best_prim < _MISS
    prim = torch.where(hit, best_prim, 0)
    tris = vertices[prim]                                   # [N,3,3]
    v0 = tris[:, 0, :]
    e1 = tris[:, 1, :] - v0
    e2 = tris[:, 2, :] - v0
    _, u, v, _ = _mt_single(origins, directions, v0, e1, e2, t_min, t_max)
    bary = torch.where(hit[:, None], torch.stack([u, v], dim=-1), 0.0)
    return Hit(t=best_t, prim=torch.where(hit, best_prim, -1), bary=bary, hit=hit)


def _mt_single(origins, directions, v0, e1, e2, t_min, t_max):
    """Moller-Trumbore with one triangle per lane; each output [N]."""
    pvec = vm.cross(directions, e2)
    det = vm.dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > _DET_EPS, 1.0 / det, 0.0)
    tvec = origins - v0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    v = vm.dot(directions, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    valid = (torch.abs(det) > _DET_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return t, u, v, valid


def intersect_scene(scene, origins, directions, t_min, t_max, cfg) -> Hit:
    """Dispatch to the configured intersector.  "auto" takes the scene's
    accel when it has one and brute force otherwise."""
    mode = cfg.intersector
    if mode == "auto":
        mode = "brute" if scene.accel is None else "cluster"
    if mode == "brute":
        return intersect_brute(scene.vertices, origins, directions, t_min, t_max, cfg.intersect_block)
    if scene.accel is None:
        raise ValueError(f"intersector {mode!r} requested but scene has no accel")
    return scene.accel.intersect(scene.vertices, origins, directions, t_min, t_max, cfg)


def occluded_brute(vertices, origins, directions, t_min: float, t_max: float, block: int = 256) -> torch.Tensor:
    """Any hit by exhaustive blocked search: [N] bool, True where the
    segment (t_min, t_max) of the ray meets a triangle."""
    t_count = vertices.shape[0]
    block = max(8, min(block, max(t_count, 8)))
    pad = (-t_count) % block
    if pad:
        vertices = torch.cat([vertices, vertices.new_zeros((pad, 3, 3))])
    occ = torch.zeros(origins.shape[0], dtype=torch.bool, device=origins.device)
    for base in range(0, vertices.shape[0], block):
        _, _, _, valid = _mt_block(origins, directions, vertices[base : base + block], t_min, t_max)
        occ = occ | valid.any(dim=1)
    return occ


def occluded_scene(scene, origins, directions, t_min, t_max, cfg, active=None) -> torch.Tensor:
    """Any-hit dispatch for shadow rays, by the rule of intersect_scene.
    `active` ([N] bool) marks the rays whose answer is read; the others'
    answers are unspecified (the cluster accel parks them outside the
    scene, so they stop keeping packets alive)."""
    mode = cfg.intersector
    if mode == "auto":
        mode = "brute" if scene.accel is None else "cluster"
    if mode == "brute":
        return occluded_brute(scene.vertices, origins, directions, t_min, t_max, cfg.intersect_block)
    if scene.accel is None:
        raise ValueError(f"intersector {mode!r} requested but scene has no accel")
    return scene.accel.occluded(scene.vertices, origins, directions, t_min, t_max, cfg, active=active)
