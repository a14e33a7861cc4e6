"""Ray-triangle intersection: the Hit record, brute-force Moller-Trumbore
for closest and any hit, and the intersector dispatch for both.

Counterpart of `tpu_pathtracer/ops/intersect.py`.  Triangles are two-sided.

Brute force tests every ray against every triangle.  On the card it is two
kernels (`csrc/brute.cu`): the closest hit, which writes the Hit with its
finalize folded in, and the any hit, which writes the flags
(`intersect_brute_cuda`, `occluded_brute_cuda`).  Both put a
division-free gate in front of the test, which skips the division and
the rest wherever the test certainly fails; the any hit spends its
threads only on the rays of `active` that are not yet occluded.  Their plain versions
(`intersect_brute_plain`, `occluded_brute_plain`: blocked loops over the
triangles, the JAX package's `lax.scan` written out) run on the CPU, and
on the card under `ops.cuda_build.plain()`.  `intersect_brute` and
`occluded_brute` dispatch between them by `ops.cuda_build.on_card`; on a
CUDA device outside `plain()` they launch the kernel or raise.  Each
counts its kernel's launches in `.launches`
(`render/graph_loop.COUNTED`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpu_pathtracer_torch.ops.cuda_build import kernel_arg, library, on_card
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


def intersect_brute_plain(vertices, origins, directions, t_min: float, t_max: float, block: int = 256) -> Hit:
    """Closest hit by exhaustive blocked search over [T,3,3] vertices: the
    least t, equal t to the lowest triangle id.  `block` triangles a step;
    no result depends on it."""
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


def occluded_brute_plain(vertices, origins, directions, t_min: float, t_max: float, block: int = 256) -> torch.Tensor:
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


# ---------------------------------------------------------------------------
# The kernels (csrc/brute.cu)
# ---------------------------------------------------------------------------

def _brute_launch(any_hit, vertices, origins, directions, t_min, t_max, active, out):
    """Check the inputs and launch brute_kernel on the current stream into
    `out` ((t, prim, bary, hit) or (occluded,)), counted on its wrapper."""
    if not origins.is_cuda:
        raise ValueError(f"the brute-force kernel needs CUDA tensors, got {origins.device}")
    dev = origins.device
    n, t_count = origins.shape[0], vertices.shape[0]
    vertices = kernel_arg("vertices", vertices, torch.float32, (t_count, 3, 3), dev)
    origins = kernel_arg("origins", origins, torch.float32, (n, 3), dev)
    directions = kernel_arg("directions", directions, torch.float32, (n, 3), dev)
    if active is not None:
        active = kernel_arg("active", active, torch.bool, (n,), dev)
    if n == 0:
        return  # nothing to launch
    hit_out = out[-1]
    t_out, prim_out, bary_out = (x.data_ptr() for x in out[:3]) if not any_hit else (None, None, None)
    err = library("brute.cu").brute_launch(
        int(any_hit), vertices.data_ptr(), t_count, origins.data_ptr(), directions.data_ptr(),
        active.data_ptr() if active is not None else None, n, float(t_min), float(t_max),
        t_out, prim_out, bary_out, hit_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"brute_kernel ({'any' if any_hit else 'closest'} hit) launch failed: CUDA error {err}")
    (occluded_brute if any_hit else intersect_brute).launches += 1


def intersect_brute_cuda(vertices, origins, directions, t_min: float, t_max: float) -> Hit:
    """Launch the closest-hit kernel on CUDA tensors: one launch writes the
    Hit (`finalize_hit` included), bit-equal to `intersect_brute_plain`."""
    n, dev = origins.shape[0], origins.device
    hit = Hit(t=torch.empty(n, dtype=torch.float32, device=dev), prim=torch.empty(n, dtype=torch.int32, device=dev),
              bary=torch.empty((n, 2), dtype=torch.float32, device=dev),
              hit=torch.empty(n, dtype=torch.bool, device=dev))
    _brute_launch(False, vertices, origins, directions, t_min, t_max, None, (hit.t, hit.prim, hit.bary, hit.hit))
    return hit


def occluded_brute_cuda(vertices, origins, directions, t_min: float, t_max: float, active=None) -> torch.Tensor:
    """Launch the any-hit kernel on CUDA tensors: [N] bool, the plain
    version's flags on the rays of `active` ([N] bool, None: all) and
    False on the others, which test nothing."""
    occluded = torch.empty(origins.shape[0], dtype=torch.bool, device=origins.device)
    _brute_launch(True, vertices, origins, directions, t_min, t_max, active, (occluded,))
    return occluded


def brute_launch_shape(n: int, any_hit: bool = False, lib=None) -> dict:
    """How the brute-force kernel lays out a launch of n rays on the current
    CUDA device: "threads_per_ray" (the any hit: the block's, which each
    listed ray gets), "blocks", "threads" (of a block), "registers" (of a
    thread), "resident_blocks" (per SM) and "rays_per_block" (closest hit:
    256 / threads a ray x rays a thread; any hit: its slice).  Builds the
    kernel if need be (`lib`: another build's library); launches nothing."""
    out = (ctypes.c_int * 6)()
    err = (lib or library("brute.cu")).brute_shape(n, int(any_hit), out)
    if err:
        raise RuntimeError(f"brute_shape failed: CUDA error {err}")
    return dict(zip(("threads_per_ray", "blocks", "threads", "registers", "resident_blocks", "rays_per_block"), out))


def intersect_brute(vertices, origins, directions, t_min: float, t_max: float, block: int = 256) -> Hit:
    """Closest hit by exhaustive search over [T,3,3] vertices: the kernel
    on the card, the plain version on the CPU and under
    ops.cuda_build.plain() (`block` is the plain version's)."""
    if on_card(origins.device):
        return intersect_brute_cuda(vertices, origins, directions, t_min, t_max)
    return intersect_brute_plain(vertices, origins, directions, t_min, t_max, block)


def occluded_brute(vertices, origins, directions, t_min: float, t_max: float, block: int = 256, *,
                   active=None) -> torch.Tensor:
    """Any hit by exhaustive search: [N] bool, True where the segment
    (t_min, t_max) of the ray meets a triangle.  The answers outside
    `active` are unspecified: the kernel tests none of those rays and
    stores False, the plain version computes them."""
    if on_card(origins.device):
        return occluded_brute_cuda(vertices, origins, directions, t_min, t_max, active)
    return occluded_brute_plain(vertices, origins, directions, t_min, t_max, block)


# Kernel launches since each count was last set to 0.
intersect_brute.launches = 0
occluded_brute.launches = 0


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


def occluded_scene(scene, origins, directions, t_min, t_max, cfg, active=None) -> torch.Tensor:
    """Any-hit dispatch for shadow rays, by the rule of intersect_scene.
    `active` ([N] bool) marks the rays whose answer is read; the others'
    answers are unspecified (the cluster accel parks them outside the
    scene, so they stop keeping packets alive; the brute-force kernel
    skips them)."""
    mode = cfg.intersector
    if mode == "auto":
        mode = "brute" if scene.accel is None else "cluster"
    if mode == "brute":
        return occluded_brute(scene.vertices, origins, directions, t_min, t_max, cfg.intersect_block, active=active)
    if scene.accel is None:
        raise ValueError(f"intersector {mode!r} requested but scene has no accel")
    return scene.accel.occluded(scene.vertices, origins, directions, t_min, t_max, cfg, active=active)
