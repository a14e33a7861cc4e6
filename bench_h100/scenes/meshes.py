"""Triangle meshes the scene generators share: a lat-long UV sphere and a
ground quad, as plain numpy arrays.

Frozen copies of the port's procedural geometry (its scene/procedural.py
at the time this benchmark was written): the benchmark makes its inputs
itself and hands the same arrays to the program and to the reference, so
a later change to the program's generators cannot change what is
measured."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SceneArrays:
    """A scene as host arrays: vertices and vertex normals [T,3,3]
    float32, material ids [T] int32, and one dict a material (keys color,
    specular, emission, roughness, metallic, transparent, ior, and maps
    into `texture_quads`); `uvs` [T,3,2] where a scene has them."""

    vertices: np.ndarray
    normals: np.ndarray
    mat_ids: np.ndarray
    materials: list
    uvs: np.ndarray | None = None
    texture_quads: np.ndarray | None = None


def sphere_mesh(center, radius: float, stacks: int = 16, slices: int = 32):
    """Lat-long UV sphere as a triangle soup with radial vertex normals:
    (vertices [T,3,3], normals [T,3,3]) float32."""
    center = np.asarray(center, dtype=np.float64)
    phi = np.pi * np.arange(stacks + 1, dtype=np.float64) / stacks
    theta = 2.0 * np.pi * np.arange(slices + 1, dtype=np.float64) / slices
    y = radius * np.cos(phi)[:, None]
    r = radius * np.sin(phi)[:, None]
    x = r * np.cos(theta)
    z = r * np.sin(theta)
    pos = np.stack([x, np.broadcast_to(y, x.shape), np.broadcast_to(z, x.shape)], axis=-1)
    nrm = pos / np.maximum(np.linalg.norm(pos, axis=-1, keepdims=True), 1e-12)
    pos = pos + center
    # Quad (i,j) -> (i,j) (i+1,j) (i,j+1) and (i,j+1) (i+1,j) (i+1,j+1).
    v00, v10, v01, v11 = pos[:-1, :-1], pos[1:, :-1], pos[:-1, 1:], pos[1:, 1:]
    n00, n10, n01, n11 = nrm[:-1, :-1], nrm[1:, :-1], nrm[:-1, 1:], nrm[1:, 1:]
    verts = np.concatenate([np.stack([v00, v10, v01], axis=2).reshape(-1, 3, 3),
                            np.stack([v01, v10, v11], axis=2).reshape(-1, 3, 3)])
    norms = np.concatenate([np.stack([n00, n10, n01], axis=2).reshape(-1, 3, 3),
                            np.stack([n01, n10, n11], axis=2).reshape(-1, 3, 3)])
    return verts.astype(np.float32), norms.astype(np.float32)


def ground_plane(y: float, size: float):
    """Two-triangle ground quad at height y, normals +y."""
    v0, v1, v2, v3 = [-size, y, -size], [-size, y, size], [size, y, -size], [size, y, size]
    verts = np.asarray([[v0, v1, v2], [v2, v1, v3]], dtype=np.float32)
    norms = np.broadcast_to(np.asarray([0.0, 1.0, 0.0], np.float32), (2, 3, 3)).copy()
    return verts, norms
