"""Accel construction on the host (numpy), as `tpu_pathtracer/accel/build.py`:
Morton-sort the triangles, permute the whole scene into that order, and
slice it into fixed-size clusters (`accel.cluster.build_cluster_accel`)."""

from __future__ import annotations

import numpy as np
import torch

from tpu_pathtracer_torch.utils.device import DEFAULT_DEVICE


def _expand_bits_10(x: np.ndarray) -> np.ndarray:
    """Spread 10 bits over 30 (Morton bit-interleave)."""
    x = x.astype(np.uint32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for [T,3] centroids normalised to their AABB."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    return (
        (_expand_bits_10(q[:, 0]) << 2)
        | (_expand_bits_10(q[:, 1]) << 1)
        | _expand_bits_10(q[:, 2])
    )


def morton_order(vertices: np.ndarray) -> np.ndarray:
    """Permutation sorting triangles by centroid Morton code (stable)."""
    return np.argsort(morton_codes(vertices.mean(axis=1)), kind="stable")


def build_accel_arrays(vertices: np.ndarray, kind: str = "cluster", device=DEFAULT_DEVICE, **kw):
    """Accel build over host [T,3,3] vertices: (perm, accel), the Morton
    permutation to apply to every per-triangle array and the cluster
    accel (on `device`; kw: cluster_size) of the permuted order."""
    from tpu_pathtracer_torch.accel.cluster import build_cluster_accel

    if kind != "cluster":
        raise ValueError(f"unknown accel kind: {kind!r}")
    perm = morton_order(vertices)
    return perm, build_cluster_accel(np.ascontiguousarray(vertices[perm]), device=device, **kw)


def build_accel(scene, kind: str = "cluster", **kw):
    """Permute `scene` into Morton order and attach a cluster accel (kw:
    cluster_size) on the scene's device.  Returns a new Scene."""
    if kind != "cluster":
        raise ValueError(f"unknown accel kind: {kind!r}")
    verts = scene.vertices.cpu().numpy()
    if verts.shape[0] == 0:
        return scene
    device = scene.device
    perm, accel = build_accel_arrays(verts, kind, device, **kw)
    idx = torch.as_tensor(perm, device=device)
    return scene.replace(
        vertices=scene.vertices[idx],
        normals=scene.normals[idx],
        uvs=scene.uvs[idx],
        mat_ids=scene.mat_ids[idx],
        tri_attrs=scene.tri_attrs[idx],
        accel=accel,
    )
