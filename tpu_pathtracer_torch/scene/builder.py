"""Scene assembly from OBJ files with the reference's conventions, as
`tpu_pathtracer/scene/builder.py`:

* one material per OBJ *file*;
* texture discovery by filename convention:
  `<stem>_albedo/_roughness/_normal/_metallic.png`;
* files with any map get the neutral textured material (gray 0.5,
  roughness 0.4); files without get a random material (random colour and
  roughness, 10% chance emissive x100, metallic when the decider falls in
  (0.5, 0.65)), drawn from `np.random.RandomState(rng_seed)` in the JAX
  package's order;
* an auto floor plane at the scene's min vertex height, size 200.

`material_source="mtl"` honours the parsed MTL constants and maps
instead.  The whole scene is packed on the host (numpy, then CPU tensors
that share its memory), permuted into Morton order with its cluster
accel when asked, and moved to the device in one step at the end, so
the arrays equal the JAX package's `load_scene` bit for bit.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

import numpy as np

from tpu_pathtracer_torch.assets.obj import ObjMaterial, parse_mtl, parse_obj, triangulate
from tpu_pathtracer_torch.scene.scene import (
    EnvironmentMap,
    Scene,
    make_material_table,
    make_scene,
    make_texture_quads,
)
from tpu_pathtracer_torch.utils.device import DEFAULT_DEVICE, to_device
from tpu_pathtracer_torch.utils.image import load_image

_KINDS = ("albedo", "roughness", "normal", "metallic")


class TexturePoolBuilder:
    """Accumulates texture images into one flat [P,4] quad-packed pool
    (see scene.make_texture_quads for the layout)."""

    def __init__(self):
        self.rows: List[np.ndarray] = []
        self.offset = 0
        self._cache = {}

    def add(self, path: str) -> Optional[tuple]:
        """Load `path` and append; returns (offset, w, h) or None."""
        if not os.path.exists(path):
            return None
        if path in self._cache:
            return self._cache[path]
        img = load_image(path)  # [H,W,3] f32
        h, w = img.shape[:2]
        quads = make_texture_quads(img)
        desc = (self.offset, w, h)
        self.rows.append(quads)
        self.offset += quads.shape[0]
        self._cache[path] = desc
        return desc

    def build(self) -> np.ndarray:
        if not self.rows:
            return np.zeros((1, 4), np.uint32)
        return np.concatenate(self.rows, axis=0)


def _load_file(path, scale, skip_non_triangles, use_native, mtl_basepath):
    """Per-file geometry load: the native C++ parser when it builds
    (bit-identical output), the pure-Python parser otherwise.

    Returns (vertices [T,3,3], normals, uvs, face_mat_ids [T],
    materials) where face ids index `materials` (ObjMaterial list)."""
    if use_native:
        from tpu_pathtracer_torch.assets.native import parse_obj_native

        out = parse_obj_native(path, scale, skip_non_triangles)
        if out is not None:
            tv, tn, tuv, tm, names, libs = out
            mdir = mtl_basepath or os.path.dirname(os.path.abspath(path))
            mtl_map = {}
            for libname in libs:
                mtl_map.update(parse_mtl(os.path.join(mdir, libname)))
            mats = [mtl_map.get(nm, ObjMaterial(name=nm)) for nm in names]
            return tv, tn, tuv, tm, mats
    model = parse_obj(path, mtl_basepath=mtl_basepath)
    tv, tn, tuv, tm = triangulate(model, scale=scale, skip_non_triangles=skip_non_triangles)
    return tv, tn, tuv, tm, model.materials


def discover_convention_maps(obj_path: str, pool: TexturePoolBuilder) -> dict:
    """Filename-convention texture discovery."""
    stem = os.path.splitext(obj_path)[0]
    maps = {}
    for kind in _KINDS:
        desc = pool.add(f"{stem}_{kind}.png")
        if desc is not None:
            maps[kind] = desc
    return maps


def _mtl_materials(obj_materials, mdir, pool) -> List[dict]:
    """Material dicts of an OBJ's MTL materials (material_source="mtl")."""
    materials = []
    for m in obj_materials:
        maps = {}
        for kind, texname in (
            ("albedo", m.diffuse_texname),
            ("roughness", m.roughness_texname),
            ("normal", m.normal_texname or m.bump_texname),
            ("metallic", m.metallic_texname),
        ):
            if texname:
                desc = pool.add(os.path.join(mdir, texname))
                if desc is not None:
                    maps[kind] = desc
        emission = float(np.max(m.emission))
        emissive = emission > 0.0
        if m.roughness is not None:
            roughness = m.roughness
        elif m.shininess > 0:  # Blinn-Phong shininess -> roughness
            roughness = float(np.sqrt(2.0 / (m.shininess + 2.0)))
        else:
            roughness = 0.5
        materials.append(dict(
            # An emissive MTL material glows in its Ke colour at unit scale.
            color=m.emission if emissive else m.diffuse,
            specular=m.specular,
            emission=1.0 if emissive else emission,
            roughness=roughness,
            metallic=(m.metallic or 0.0) > 0.5,
            transparent=m.dissolve < 0.99 or m.illum in (4, 6, 7, 9),
            # MTL `Ni` (> 1 = specified); 0 defers to cfg.ior.
            ior=m.ior if m.ior > 1.0 else 0.0,
            maps=maps,
        ))
    return materials


def load_scene(
    filenames: Sequence[str],
    scale: float = 1.0,
    env: Optional[EnvironmentMap] = None,
    material_source: str = "convention",
    add_floor: bool = True,
    floor_size: float = 200.0,
    skip_non_triangles: bool = False,
    rng_seed: Optional[int] = 0,
    mtl_basepath: Optional[str] = None,
    use_native: bool = True,
    accel: Optional[str] = None,
    accel_kw: Optional[dict] = None,
    device=DEFAULT_DEVICE,
    timings: Optional[dict] = None,
) -> Scene:
    """Load OBJ files into a Scene on `device`.

    material_source:
      "convention" — the reference's behaviour: one material per file,
        filename-convention maps, random fallback materials (rng_seed
        fixes them; None draws from entropy).
      "mtl" — one material per MTL material, honouring Kd/Ke/Pr/Pm/d/Ni
        and texture maps resolved relative to the MTL.
    accel="cluster" permutes the triangles into Morton order and attaches
    the cluster accel.  `timings`, when given, receives the seconds spent
    parsing ("parse"), decoding textures and packing every array on the
    host ("pack") and moving them to the device ("upload").
    """
    if material_source not in ("convention", "mtl"):
        raise ValueError(f"invalid material_source: {material_source!r}")

    t0 = time.perf_counter()
    parse_s = 0.0
    rs = np.random.RandomState(rng_seed)
    pool = TexturePoolBuilder()

    all_v, all_n, all_uv, all_mid = [], [], [], []
    materials: List[dict] = []
    min_height = 10.0  # the reference's initial value

    for path in filenames:
        tp = time.perf_counter()
        tv, tn, tuv, face_mats, obj_materials = _load_file(
            path, scale, skip_non_triangles, use_native, mtl_basepath
        )
        parse_s += time.perf_counter() - tp
        if len(tv):
            min_height = min(min_height, float(tv[:, :, 1].min()))

        if material_source == "convention":
            maps = discover_convention_maps(path, pool)
            if maps:
                mat = dict(
                    color=(0.5, 0.5, 0.5),
                    specular=(0.5, 0.5, 0.5),
                    emission=0.0,
                    roughness=0.4,
                    metallic=False,
                    transparent=False,
                    maps=maps,
                )
            else:
                color = tuple(rs.rand(3).astype(np.float32).tolist())
                decider = float(rs.rand())
                mat = dict(
                    color=color,
                    specular=color,
                    emission=100.0 if decider < 0.1 else 0.0,
                    roughness=float(rs.rand()),
                    metallic=0.5 < decider < 0.65,
                    transparent=False,
                )
            all_mid.append(np.full(len(tv), len(materials), np.int32))
            materials.append(mat)
        else:  # mtl
            base = len(materials)
            if obj_materials:
                mdir = mtl_basepath or os.path.dirname(os.path.abspath(path))
                materials.extend(_mtl_materials(obj_materials, mdir, pool))
                all_mid.append(np.where(face_mats >= 0, face_mats + base, 0).astype(np.int32))
            else:
                materials.append(dict(color=(0.7, 0.7, 0.7), roughness=0.5))
                all_mid.append(np.full(len(tv), base, np.int32))

        all_v.append(tv)
        all_n.append(tn)
        all_uv.append(tuv)

    if add_floor:
        from tpu_pathtracer_torch.scene.procedural import ground_plane

        # Floor material: gray 0.2, roughness 0.1.
        floor_idx = len(materials)
        materials.append(dict(color=(0.2, 0.2, 0.2), specular=(0.2, 0.2, 0.2), roughness=0.1))
        fv, fn = ground_plane(min_height, floor_size)
        all_v.append(fv)
        all_n.append(fn)
        all_uv.append(np.zeros((2, 3, 2), np.float32))
        all_mid.append(np.full(2, floor_idx, np.int32))

    def cat(parts, shape, dtype):
        return np.concatenate(parts, axis=0) if parts else np.zeros(shape, dtype)

    vertices = cat(all_v, (0, 3, 3), np.float32)
    normals = cat(all_n, (0, 3, 3), np.float32)
    uvs = cat(all_uv, (0, 3, 2), np.float32)
    mat_ids = cat(all_mid, (0,), np.int32)

    table = make_material_table(materials, pool.build(), device="cpu")

    accel_obj = None
    if accel is not None and len(vertices):
        from tpu_pathtracer_torch.accel.build import build_accel_arrays

        perm, accel_obj = build_accel_arrays(vertices, kind=accel, device="cpu", **(accel_kw or {}))
        vertices, normals, uvs, mat_ids = vertices[perm], normals[perm], uvs[perm], mat_ids[perm]

    scene = make_scene(vertices, normals, uvs, mat_ids, table, device="cpu")
    if accel_obj is not None:
        scene = scene.replace(accel=accel_obj)
    t1 = time.perf_counter()
    scene = to_device(scene, device)
    if env is not None:
        scene = scene.replace(env=env)
    if timings is not None:
        timings.update(parse=parse_s, pack=t1 - t0 - parse_s, upload=time.perf_counter() - t1)
    return scene
