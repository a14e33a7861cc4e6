"""Wavefront OBJ/MTL parser (pure Python front end).

Format-complete replacement for the reference's vendored tinyobjloader
(tiny_obj_loader.h: `LoadObj` 1395-1730, `LoadMtl` 965-1335): v/vn/vt,
faces with v, v/vt, v//vn, v/vt/vn forms, negative (relative) indices,
usemtl/mtllib/g/o/s, and MTL with the PBR extensions the reference's loader
understands (Pr/Pm/map_Pr/map_Pm/norm — tiny_obj_loader.h:1138-1200 era
extensions) plus the classic Kd/Ks/Ke/Ns/Ni/d/map_Kd/map_bump set.

The port's own copy of `tpu_pathtracer/assets/obj.py` (that package
imports JAX).  A faster C++ parser with the same output contract lives in
`tpu_pathtracer_torch.assets.native`; this module is the always-available
fallback and the correctness oracle for it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ObjMaterial:
    """Parsed MTL material (tinyobj material_t equivalent,
    tiny_obj_loader.h:169-230)."""

    name: str = ""
    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)        # Ka
    diffuse: Tuple[float, float, float] = (0.5, 0.5, 0.5)        # Kd
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)       # Ks
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)       # Ke
    shininess: float = 0.0                                       # Ns
    ior: float = 1.0                                             # Ni
    dissolve: float = 1.0                                        # d / 1-Tr
    illum: int = 2
    # PBR extension
    roughness: Optional[float] = None                            # Pr
    metallic: Optional[float] = None                             # Pm
    # texture maps (paths as written in the MTL)
    diffuse_texname: str = ""                                    # map_Kd
    specular_texname: str = ""                                   # map_Ks
    emissive_texname: str = ""                                   # map_Ke
    bump_texname: str = ""                                       # map_bump/bump
    normal_texname: str = ""                                     # norm
    roughness_texname: str = ""                                  # map_Pr
    metallic_texname: str = ""                                   # map_Pm
    alpha_texname: str = ""                                      # map_d


@dataclasses.dataclass
class ObjShape:
    """One `o`/`g` group: faces as index triples into the shared attrib
    arrays (tinyobj shape_t/mesh_t equivalent)."""

    name: str = ""
    # [F_total_verts, 3] int32: (vertex_idx, texcoord_idx, normal_idx),
    # -1 where absent.  Faces are variable arity:
    face_vertex_counts: List[int] = dataclasses.field(default_factory=list)
    indices: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)
    material_ids: List[int] = dataclasses.field(default_factory=list)  # per face


@dataclasses.dataclass
class ObjModel:
    """Full parse result (tinyobj attrib_t + shapes + materials)."""

    vertices: np.ndarray    # [V,3] f32
    normals: np.ndarray     # [VN,3] f32
    texcoords: np.ndarray   # [VT,2] f32
    shapes: List[ObjShape]
    materials: List[ObjMaterial]
    warnings: List[str]


def _parse_floats(parts: List[str], n: int, default: float = 0.0) -> List[float]:
    out = []
    for i in range(n):
        try:
            out.append(float(parts[i]))
        except (IndexError, ValueError):
            out.append(default)
    return out


def parse_mtl(path: str) -> Dict[str, ObjMaterial]:
    """Parse one .mtl file -> {name: ObjMaterial} (LoadMtl equivalent)."""
    materials: Dict[str, ObjMaterial] = {}
    cur: Optional[ObjMaterial] = None
    if not os.path.exists(path):
        return materials
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            args = parts[1:]
            kl = key.lower()
            if kl == "newmtl":
                cur = ObjMaterial(name=" ".join(args) if args else "")
                materials[cur.name] = cur
                continue
            if cur is None:
                continue
            if kl == "ka":
                cur.ambient = tuple(_parse_floats(args, 3))
            elif kl == "kd":
                cur.diffuse = tuple(_parse_floats(args, 3))
            elif kl == "ks":
                cur.specular = tuple(_parse_floats(args, 3))
            elif kl == "ke":
                cur.emission = tuple(_parse_floats(args, 3))
            elif kl == "ns":
                cur.shininess = _parse_floats(args, 1)[0]
            elif kl == "ni":
                cur.ior = _parse_floats(args, 1)[0]
            elif kl == "d":
                cur.dissolve = _parse_floats(args, 1, 1.0)[0]
            elif kl == "tr":
                cur.dissolve = 1.0 - _parse_floats(args, 1)[0]
            elif kl == "illum":
                try:
                    cur.illum = int(args[0])
                except (IndexError, ValueError):
                    pass
            elif kl == "pr":
                cur.roughness = _parse_floats(args, 1)[0]
            elif kl == "pm":
                cur.metallic = _parse_floats(args, 1)[0]
            elif kl == "map_kd":
                cur.diffuse_texname = args[-1] if args else ""
            elif kl == "map_ks":
                cur.specular_texname = args[-1] if args else ""
            elif kl == "map_ke":
                cur.emissive_texname = args[-1] if args else ""
            elif kl in ("map_bump", "bump"):
                cur.bump_texname = args[-1] if args else ""
            elif kl == "norm":
                cur.normal_texname = args[-1] if args else ""
            elif kl == "map_pr":
                cur.roughness_texname = args[-1] if args else ""
            elif kl == "map_pm":
                cur.metallic_texname = args[-1] if args else ""
            elif kl == "map_d":
                cur.alpha_texname = args[-1] if args else ""
    return materials


def _resolve_index(idx: int, count: int) -> int:
    """OBJ indices are 1-based; negative = relative to current end."""
    if idx > 0:
        return idx - 1
    if idx < 0:
        return count + idx
    return -1


def parse_obj(path: str, mtl_basepath: Optional[str] = None) -> ObjModel:
    """Parse an OBJ file (LoadObj equivalent, tiny_obj_loader.h:1395-1730)."""
    if mtl_basepath is None:
        mtl_basepath = os.path.dirname(os.path.abspath(path))

    vertices: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    materials: List[ObjMaterial] = []
    mat_index: Dict[str, int] = {}
    warnings: List[str] = []

    shapes: List[ObjShape] = []
    cur_shape = ObjShape(name="")
    cur_mat = -1

    def flush_shape(new_name: str):
        nonlocal cur_shape
        if cur_shape.face_vertex_counts:
            shapes.append(cur_shape)
        cur_shape = ObjShape(name=new_name)

    with open(path, "r", errors="replace") as f:
        for line in f:
            # line continuation
            while line.endswith("\\\n"):
                line = line[:-2] + next(f, "")
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            args = parts[1:]
            if key == "v":
                vals = _parse_floats(args, 3)
                vertices.append((vals[0], vals[1], vals[2]))
            elif key == "vn":
                vals = _parse_floats(args, 3)
                normals.append((vals[0], vals[1], vals[2]))
            elif key == "vt":
                vals = _parse_floats(args, 2)
                texcoords.append((vals[0], vals[1]))
            elif key == "f":
                cnt = 0
                for vert in args:
                    comps = vert.split("/")
                    vi = _resolve_index(int(comps[0]), len(vertices)) if comps[0] else -1
                    ti = (
                        _resolve_index(int(comps[1]), len(texcoords))
                        if len(comps) > 1 and comps[1]
                        else -1
                    )
                    ni = (
                        _resolve_index(int(comps[2]), len(normals))
                        if len(comps) > 2 and comps[2]
                        else -1
                    )
                    cur_shape.indices.append((vi, ti, ni))
                    cnt += 1
                cur_shape.face_vertex_counts.append(cnt)
                cur_shape.material_ids.append(cur_mat)
            elif key == "usemtl":
                name = " ".join(args)
                cur_mat = mat_index.get(name, -1)
                if cur_mat < 0:
                    warnings.append(f"usemtl of unknown material {name!r}")
            elif key == "mtllib":
                for mtl_name in args:
                    mtl_path = os.path.join(mtl_basepath, mtl_name)
                    parsed = parse_mtl(mtl_path)
                    if not parsed and not os.path.exists(mtl_path):
                        warnings.append(f"mtllib not found: {mtl_path}")
                    for name, mat in parsed.items():
                        if name not in mat_index:
                            mat_index[name] = len(materials)
                            materials.append(mat)
            elif key in ("o", "g"):
                flush_shape(" ".join(args))
            elif key == "s":
                pass  # smoothing groups: shading normals come from vn
            else:
                warnings.append(f"ignored OBJ directive: {key}")

    flush_shape("")

    return ObjModel(
        vertices=np.asarray(vertices, np.float32).reshape(-1, 3),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        texcoords=np.asarray(texcoords, np.float32).reshape(-1, 2),
        shapes=shapes,
        materials=materials,
        warnings=warnings,
    )


def triangulate(
    model: ObjModel,
    scale: float = 1.0,
    skip_non_triangles: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flatten an ObjModel into triangle-soup SoA arrays.

    Returns (vertices [T,3,3], normals [T,3,3], uvs [T,3,2],
    face_material_ids [T] into model.materials, -1 where none).

    skip_non_triangles=True reproduces the reference exactly — it *skips*
    quads/ngons (reference optixSphere.cpp:454-459); the default fan-
    triangulates them.  Missing normals fall back to (0,1,0) and missing
    UVs to (0,0) exactly like cpp:480-495.
    """
    vs, ns, ts, mats = [], [], [], []
    v_arr = model.vertices * np.float32(scale)
    n_arr = model.normals
    t_arr = model.texcoords

    for shape in model.shapes:
        off = 0
        for face_i, fv in enumerate(shape.face_vertex_counts):
            idxs = shape.indices[off : off + fv]
            off += fv
            if fv != 3 and skip_non_triangles:
                continue
            if fv < 3:
                continue
            # fan triangulation (v0, v_k, v_k+1)
            for k in range(1, fv - 1):
                tri = (idxs[0], idxs[k], idxs[k + 1])
                tv = np.zeros((3, 3), np.float32)
                tn = np.zeros((3, 3), np.float32)
                tt = np.zeros((3, 2), np.float32)
                for c, (vi, ti, ni) in enumerate(tri):
                    tv[c] = v_arr[vi]
                    if 0 <= ni < len(n_arr):
                        # normalise in double (bit-parity with the native
                        # parser, assets/native/objparser.cpp)
                        n = n_arr[ni].astype(np.float64)
                        l = np.linalg.norm(n)
                        tn[c] = n / l if l > 1e-12 else (0.0, 1.0, 0.0)
                    else:
                        tn[c] = (0.0, 1.0, 0.0)  # cpp:487 fallback
                    if 0 <= ti < len(t_arr):
                        tt[c] = t_arr[ti]
                vs.append(tv)
                ns.append(tn)
                ts.append(tt)
                mats.append(shape.material_ids[face_i])

    if not vs:
        return (
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 2), np.float32),
            np.zeros((0,), np.int32),
        )
    return (
        np.stack(vs),
        np.stack(ns),
        np.stack(ts),
        np.asarray(mats, np.int32),
    )
