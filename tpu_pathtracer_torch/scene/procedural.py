"""Procedural scenes (numpy geometry), as `tpu_pathtracer/scene/procedural.py`:
UV-sphere meshes, ground quads and the reference's fallback scene.  The
scenes are built on the card unless they are given another device."""

from __future__ import annotations

import numpy as np

from tpu_pathtracer_torch.scene.scene import Scene, make_material_table, make_scene
from tpu_pathtracer_torch.utils.device import DEFAULT_DEVICE


def sphere_mesh(center, radius: float, stacks: int = 16, slices: int = 32):
    """Lat-long UV sphere as a triangle soup with radial vertex normals.
    Returns (vertices [T,3,3], normals [T,3,3]) float32."""
    center = np.asarray(center, dtype=np.float64)
    i = np.arange(stacks + 1, dtype=np.float64)
    j = np.arange(slices + 1, dtype=np.float64)
    phi = np.pi * i / stacks
    theta = 2.0 * np.pi * j / slices

    y = radius * np.cos(phi)[:, None]
    r = radius * np.sin(phi)[:, None]
    x = r * np.cos(theta)
    z = r * np.sin(theta)
    pos = np.stack(
        [x, np.broadcast_to(y, x.shape), np.broadcast_to(z, x.shape)], axis=-1
    )
    nrm = pos / np.maximum(np.linalg.norm(pos, axis=-1, keepdims=True), 1e-12)
    pos = pos + center

    # Quad (i,j) -> (i,j) (i+1,j) (i,j+1) and (i,j+1) (i+1,j) (i+1,j+1).
    v00, v10, v01, v11 = pos[:-1, :-1], pos[1:, :-1], pos[:-1, 1:], pos[1:, 1:]
    n00, n10, n01, n11 = nrm[:-1, :-1], nrm[1:, :-1], nrm[:-1, 1:], nrm[1:, 1:]
    verts = np.concatenate(
        [
            np.stack([v00, v10, v01], axis=2).reshape(-1, 3, 3),
            np.stack([v01, v10, v11], axis=2).reshape(-1, 3, 3),
        ]
    )
    norms = np.concatenate(
        [
            np.stack([n00, n10, n01], axis=2).reshape(-1, 3, 3),
            np.stack([n01, n10, n11], axis=2).reshape(-1, 3, 3),
        ]
    )
    return verts.astype(np.float32), norms.astype(np.float32)


def ground_plane(y: float, size: float):
    """Two-triangle ground quad at height y."""
    v0 = [-size, y, -size]
    v1 = [-size, y, size]
    v2 = [size, y, -size]
    v3 = [size, y, size]
    verts = np.asarray([[v0, v1, v2], [v2, v1, v3]], dtype=np.float32)
    norms = np.broadcast_to(np.asarray([0.0, 1.0, 0.0], np.float32), (2, 3, 3)).copy()
    return verts, norms


def three_spheres_scene(stacks: int = 16, slices: int = 32, device=DEFAULT_DEVICE) -> Scene:
    """Ground quad (size 10, y=0) and red/green/blue unit spheres at
    x=-3,0,3, y=1.  Materials: 0 ground, 1 red, 2 green, 3 blue."""
    mats = [
        dict(color=(0.5, 0.5, 0.5), specular=(1.0, 1.0, 1.0), roughness=0.8),
        dict(color=(1.0, 0.0, 0.0), roughness=0.0),
        dict(color=(0.0, 1.0, 0.0), roughness=0.0),
        dict(color=(0.0, 0.0, 1.0), roughness=0.0),
    ]
    gv, gn = ground_plane(0.0, 10.0)
    verts, norms, mat_ids = [gv], [gn], [np.zeros(2, np.int32)]
    for i, c in enumerate([(-3.0, 1.0, 0.0), (0.0, 1.0, 0.0), (3.0, 1.0, 0.0)]):
        sv, sn = sphere_mesh(c, 1.0, stacks, slices)
        verts.append(sv)
        norms.append(sn)
        mat_ids.append(np.full(len(sv), i + 1, np.int32))
    return make_scene(
        np.concatenate(verts), np.concatenate(norms), None,
        np.concatenate(mat_ids), make_material_table(mats, device=device),
        device=device,
    )


def high_poly_scene(total_tris: int = 100_000, n_objects: int = 5, seed: int = 0, device=DEFAULT_DEVICE) -> Scene:
    """n_objects finely tessellated spheres with random materials on a
    ground plane, about total_tris triangles in all."""
    rs = np.random.RandomState(seed)
    per_obj = max(total_tris // max(n_objects, 1), 8)
    stacks = max(4, int(np.sqrt(per_obj / 4)))
    slices = 2 * stacks

    verts, norms, ids, mats = [], [], [], []
    for i in range(n_objects):
        c = rs.randn(3) * 2.0
        c[1] = abs(c[1]) + 1.0
        sv, sn = sphere_mesh(c, 0.8 + 0.4 * rs.rand(), stacks, slices)
        verts.append(sv)
        norms.append(sn)
        ids.append(np.full(len(sv), i, np.int32))
        mats.append(
            dict(
                color=tuple(rs.rand(3).tolist()),
                roughness=float(rs.rand()),
                metallic=bool(rs.rand() < 0.3),
            )
        )
    mats.append(dict(color=(0.4, 0.4, 0.4), roughness=0.6))
    gv, gn = ground_plane(0.0, 50.0)
    verts.append(gv)
    norms.append(gn)
    ids.append(np.full(2, n_objects, np.int32))
    return make_scene(
        np.concatenate(verts), np.concatenate(norms), None, np.concatenate(ids),
        make_material_table(mats, device=device), device=device,
    )


def single_sphere_scene(
    radius: float = 1.0,
    stacks: int = 16,
    slices: int = 32,
    albedo=(0.8, 0.8, 0.8),
    with_ground: bool = True,
    device=DEFAULT_DEVICE,
) -> Scene:
    """One diffuse sphere, with an optional ground plane."""
    mats = [dict(color=albedo, roughness=1.0)]
    sv, sn = sphere_mesh((0.0, radius, 0.0), radius, stacks, slices)
    verts, norms, ids = [sv], [sn], [np.zeros(len(sv), np.int32)]
    if with_ground:
        mats.append(dict(color=(0.5, 0.5, 0.5), roughness=1.0))
        gv, gn = ground_plane(0.0, 20.0)
        verts.append(gv)
        norms.append(gn)
        ids.append(np.ones(2, np.int32))
    return make_scene(
        np.concatenate(verts), np.concatenate(norms), None, np.concatenate(ids),
        make_material_table(mats, device=device), device=device,
    )
