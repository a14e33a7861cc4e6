"""Carry a scene built by the JAX package across to the port.

The JAX package's `Scene` is a pytree of arrays.  Its caller flattens it
to a dict of numpy arrays named by field path ("vertices",
"materials.attrs", "env.quads", "accel.tris16bw", ...), with each static
field (the texture-layout flags, the accel's cluster size and super
branch) as a 0-d array, and hands that dict over: the port never sees a
JAX object.  Optional leaves (the accel, the environment's importance-
sampling tables) are carried when the dict holds them.  The layouts are the same on both sides, so every leaf is a
plain copy.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pathtracer_torch.accel.cluster import ClusterAccel
from tpu_pathtracer_torch.scene.scene import EnvironmentMap, MaterialTable, Scene

SCENE_KEYS = ("vertices", "normals", "uvs", "mat_ids", "tri_attrs")
MATERIAL_KEYS = ("attrs", "texture_quads", "texture_bundles")
MATERIAL_FLAGS = ("bundled", "bundled_morton", "bundled_scrambled", "bundled_pow2_dims")
ENV_KEYS = ("data", "quads")
ENV_TABLES = ("cdf_rows", "cdf_cols", "alias_table")
ACCEL_KEYS = ("tris16bw", "aabb8", "order", "scene_lo", "scene_hi",
              "aabb8_child", "aabb8_super", "order_super", "tris16")
ACCEL_STATICS = ("cluster_size", "super_branch")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype == np.uint32:
        a = a.astype(np.int64)  # PyTorch has no u32 arithmetic
    return torch.as_tensor(a, device=device)


def scene_from_numpy(leaves: dict, device) -> Scene:
    """Build the port's Scene (with its ClusterAccel, when the leaves hold
    one) and EnvironmentMap on `device` from the JAX scene's leaves."""
    def t(key):
        return _tensor(leaves[key], device)

    materials = MaterialTable(
        **{k: t(f"materials.{k}") for k in MATERIAL_KEYS},
        **{k: bool(leaves[f"materials.{k}"]) for k in MATERIAL_FLAGS},
    )
    env = EnvironmentMap(
        **{k: t(f"env.{k}") for k in ENV_KEYS},
        **{k: t(f"env.{k}") for k in ENV_TABLES if f"env.{k}" in leaves},
        quads_scrambled=bool(leaves["env.quads_scrambled"]),
    )
    accel = None
    if "accel.tris16bw" in leaves:
        accel = ClusterAccel(
            **{k: t(f"accel.{k}") for k in ACCEL_KEYS},
            **{k: int(leaves[f"accel.{k}"]) for k in ACCEL_STATICS},
        )
    return Scene(
        **{k: t(k) for k in SCENE_KEYS}, materials=materials, env=env, accel=accel
    )
