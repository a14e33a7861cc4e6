"""Ground quad (size 10, y = 0) and red, green and blue unit spheres at
x = -3, 0, 3, y = 1: the reference renderer's fallback scene when its
suitcase OBJ is absent.  Materials: 0 ground, 1 red, 2 green, 3 blue."""

from __future__ import annotations

import numpy as np

from bench_h100.scenes.meshes import SceneArrays, ground_plane, sphere_mesh


def build(stacks: int = 16, slices: int = 32) -> SceneArrays:
    mats = [
        dict(color=(0.5, 0.5, 0.5), specular=(1.0, 1.0, 1.0), roughness=0.8),
        dict(color=(1.0, 0.0, 0.0), roughness=0.0),
        dict(color=(0.0, 1.0, 0.0), roughness=0.0),
        dict(color=(0.0, 0.0, 1.0), roughness=0.0),
    ]
    gv, gn = ground_plane(0.0, 10.0)
    verts, norms, ids = [gv], [gn], [np.zeros(2, np.int32)]
    for i, c in enumerate([(-3.0, 1.0, 0.0), (0.0, 1.0, 0.0), (3.0, 1.0, 0.0)]):
        sv, sn = sphere_mesh(c, 1.0, stacks, slices)
        verts.append(sv)
        norms.append(sn)
        ids.append(np.full(len(sv), i + 1, np.int32))
    return SceneArrays(np.concatenate(verts), np.concatenate(norms), np.concatenate(ids), mats)
