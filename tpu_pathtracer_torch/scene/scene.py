"""Scene tensors: geometry, material table, texture pools, environment.

Counterpart of `tpu_pathtracer/scene/scene.py`.  Everything is built in numpy
on the host, in the JAX package's packed layouts, and then uploaded to the
requested device, so the arrays equal the JAX package's bit for bit and a
scene can be carried across leaf by leaf (`tpu_pathtracer_torch.bridge`).

Layouts:
* `Scene.tri_attrs` [T,32] f32: v0 v1 v2 (0:9), n0 n1 n2 (9:18),
  uv0 uv1 uv2 (18:24), material id as float (24).
* `MaterialTable.attrs` [M,40] f32: the column map below.
* `MaterialTable.texture_quads` [P,4] u32 (held as int64): per texel its
  2x2 repeat-wrap neighbourhood as RGBA8 words.
* `MaterialTable.texture_bundles` [Pb,8] u32 (held as int64): per texel
  corner, word A = albedo.rgb + roughness.r, word B = normal.rgb +
  metallic.r; row 0 is the no-map sink.
* `EnvironmentMap.quads` [H*W,12] f32: each texel's bilinear
  neighbourhood (x wraps, y clamps), at hash-scrambled rows when H*W is a
  power of two.
* `EnvironmentMap.alias_table` [H*W,4] f32 (accept probability, alias
  index, own mass, alias mass) and the CDF tables, attached by
  `render.envmap.with_importance_sampling` for NEE.

Every constructor builds on the card unless it is given another device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpu_pathtracer_torch.utils.device import DEFAULT_DEVICE, resolve

# Column layout of MaterialTable.attrs ([M,MAT_COLS]).
MAT_DIFFUSE = slice(0, 3)
MAT_SPECULAR = slice(3, 6)
MAT_EMISSION = slice(6, 9)
MAT_ROUGHNESS = 9
MAT_METALLIC = 10
MAT_TRANSPARENT = 11
MAT_HAS_MAP = slice(12, 16)     # albedo, roughness, normal, metallic
MAT_MAP_OFFSET = slice(16, 20)
MAT_MAP_WIDTH = slice(20, 24)
MAT_MAP_HEIGHT = slice(24, 28)
MAT_BUNDLE_OFFSET = 28
MAT_BUNDLE_WIDTH = 29
MAT_BUNDLE_HEIGHT = 30
MAT_IOR = 31
MAT_MIP_OFFSET = 32
MAT_MIP_WIDTH = 33
MAT_MIP_HEIGHT = 34
MAT_COLS = 40

# Column layout of Scene.tri_attrs ([T,32]).
TRI_V = slice(0, 9)
TRI_N = slice(9, 18)
TRI_UV = slice(18, 24)
TRI_MAT = 24

# Odd multiplier: i -> (i * MULT) mod 2^k is a bijection for pow2 moduli.
SCRAMBLE_MULT = 2654435761


def _u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """u32 numpy array -> int64 tensor (PyTorch has no u32 arithmetic)."""
    return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64), device=device)


@dataclasses.dataclass
class MaterialTable:
    """Per-material constants and texture pools."""

    attrs: torch.Tensor            # [M,40] f32
    texture_quads: torch.Tensor    # [P,4] int64 holding u32
    texture_bundles: torch.Tensor  # [Pb,8] int64 holding u32
    bundled: bool = False
    bundled_morton: bool = False
    bundled_scrambled: bool = False
    bundled_pow2_dims: bool = False

    @property
    def num_materials(self) -> int:
        return self.attrs.shape[0]


@dataclasses.dataclass
class EnvironmentMap:
    """Equirectangular HDR environment."""

    data: torch.Tensor             # [H,W,3] f32
    quads: torch.Tensor            # [H*W,12] f32
    quads_scrambled: bool = False
    cdf_rows: Optional[torch.Tensor] = None     # [H]
    cdf_cols: Optional[torch.Tensor] = None     # [H,W]
    alias_table: Optional[torch.Tensor] = None  # [H*W,4] f32 Vose table

    def replace(self, **kw) -> "EnvironmentMap":
        return dataclasses.replace(self, **kw)

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]


@dataclasses.dataclass
class Scene:
    """Geometry, materials, lighting and (optionally) an accel structure."""

    vertices: torch.Tensor   # [T,3,3] f32
    normals: torch.Tensor    # [T,3,3] f32
    uvs: torch.Tensor        # [T,3,2] f32
    mat_ids: torch.Tensor    # [T] i32
    tri_attrs: torch.Tensor  # [T,32] f32
    materials: MaterialTable
    env: EnvironmentMap
    accel: Optional[object] = None

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


def scramble_order(n_texels: int) -> np.ndarray:
    """[n] permutation: scramble_order[i] = hash-scattered row of texel i
    (power-of-two n)."""
    if n_texels & (n_texels - 1):
        raise ValueError(f"scramble_order needs a power of two: {n_texels}")
    i = np.arange(n_texels, dtype=np.uint64)
    return ((i * SCRAMBLE_MULT) & (n_texels - 1)).astype(np.int64)


def make_env(data, device=DEFAULT_DEVICE) -> EnvironmentMap:
    """EnvironmentMap with the packed quad table (x wraps, y clamps)."""
    device = resolve(device)
    arr = np.array(data, np.float32)
    h, w = arr.shape[:2]
    x1 = (np.arange(w) + 1) % w
    y1 = np.minimum(np.arange(h) + 1, h - 1)
    quads = np.concatenate(
        [arr, arr[:, x1], arr[y1, :], arr[y1][:, x1]], axis=-1
    ).reshape(h * w, 12)
    scrambled = (h * w) > 1 and ((h * w) & (h * w - 1)) == 0
    if scrambled:
        squads = np.empty_like(quads)
        squads[scramble_order(h * w)] = quads
        quads = squads
    return EnvironmentMap(
        data=torch.as_tensor(arr, device=device),
        quads=torch.as_tensor(quads, device=device),
        quads_scrambled=scrambled,
    )


def default_env(height: int = 8, width: int = 16, color=(0.4, 0.4, 0.6), device=DEFAULT_DEVICE) -> EnvironmentMap:
    """A tiny constant environment."""
    data = np.broadcast_to(np.asarray(color, np.float32), (height, width, 3))
    return make_env(data, device)


def pack_rgba8(img: np.ndarray) -> np.ndarray:
    """[H,W,3] float in [0,1] -> [H,W] uint32 RGBA8 words (A=255)."""
    img = np.asarray(img)
    work = np.float64 if img.dtype == np.float64 else np.float32
    u8 = np.clip(
        np.round(img.astype(work, copy=False) * work(255.0)), 0, 255
    ).astype(np.uint32)
    return u8[..., 0] | (u8[..., 1] << 8) | (u8[..., 2] << 16) | (np.uint32(255) << 24)


def make_texture_quads(img: np.ndarray) -> np.ndarray:
    """[H,W,3] float -> [H*W,4] uint32 quad rows (repeat wrap both axes)."""
    h, w = img.shape[:2]
    packed = pack_rgba8(img)
    x1 = (np.arange(w) + 1) % w
    y1 = (np.arange(h) + 1) % h
    quads = np.stack(
        [packed, packed[:, x1], packed[y1, :], packed[y1][:, x1]], axis=-1
    )
    return quads.reshape(h * w, 4)


def _part1by1_np(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32) & np.uint32(0xFFFF)
    v = (v | (v << 8)) & np.uint32(0x00FF00FF)
    v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
    v = (v | (v << 2)) & np.uint32(0x33333333)
    v = (v | (v << 1)) & np.uint32(0x55555555)
    return v


def morton_order(width: int, height: int) -> np.ndarray:
    """[H*W] permutation: morton_order[y*W+x] = Z-curve index of (x, y)."""
    y, x = np.mgrid[0:height, 0:width]
    return (_part1by1_np(x) | (_part1by1_np(y) << 1)).reshape(-1)


def pack_bundle_rows(quads_albedo, quads_rough, quads_normal, quads_metal, n_texels: int) -> np.ndarray:
    """Four [n,4] RGBA8 quad arrays (None = absent map) -> [n,8] u32 rows:
    cols 0-3 word A (albedo.rgb | roughness.r<<24), cols 4-7 word B
    (normal.rgb | metallic.r<<24), one per quad corner."""
    def _byte(q, b):
        if q is None:
            return np.zeros((n_texels, 4), np.uint32)
        return (q >> np.uint32(8 * b)) & np.uint32(0xFF)

    word_a = (
        _byte(quads_albedo, 0)
        | (_byte(quads_albedo, 1) << np.uint32(8))
        | (_byte(quads_albedo, 2) << np.uint32(16))
        | (_byte(quads_rough, 0) << np.uint32(24))
    )
    word_b = (
        _byte(quads_normal, 0)
        | (_byte(quads_normal, 1) << np.uint32(8))
        | (_byte(quads_normal, 2) << np.uint32(16))
        | (_byte(quads_metal, 0) << np.uint32(24))
    )
    return np.concatenate([word_a, word_b], axis=1).astype(np.uint32)


def pack_tri_attrs(vertices, normals, uvs, mat_ids) -> np.ndarray:
    t = vertices.shape[0]
    attrs = np.zeros((max(t, 1), 32), np.float32)
    if t:
        attrs[:, TRI_V] = vertices.reshape(t, 9)
        attrs[:, TRI_N] = normals.reshape(t, 9)
        attrs[:, TRI_UV] = uvs.reshape(t, 6)
        attrs[:, TRI_MAT] = mat_ids.astype(np.float32)
    return attrs


def _pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def make_material_table(
    materials: list[dict],
    texture_quads: Optional[np.ndarray] = None,
    device=DEFAULT_DEVICE,
) -> MaterialTable:
    """MaterialTable from material dicts (keys: color, specular, emission,
    roughness, metallic, transparent, ior, maps={kind: (offset, w, h)}
    with kind in albedo/roughness/normal/metallic, offsets into
    `texture_quads`).  emission_color = color * emission.

    When every material's maps share dimensions, the four kinds are
    interleaved into one bundle pool so one row read serves all four.  The
    mip ladder the JAX package builds for pools over 16 MB is not built
    here (see ROADMAP)."""
    device = resolve(device)
    kinds = ["albedo", "roughness", "normal", "metallic"]
    m = len(materials)
    attrs = np.zeros((m, MAT_COLS), np.float32)
    attrs[:, MAT_MAP_WIDTH] = 1.0
    attrs[:, MAT_MAP_HEIGHT] = 1.0
    attrs[:, MAT_MIP_WIDTH] = 1.0
    attrs[:, MAT_MIP_HEIGHT] = 1.0

    for i, mat in enumerate(materials):
        color = np.asarray(mat.get("color", (0.5, 0.5, 0.5)), np.float32)
        attrs[i, MAT_DIFFUSE] = color
        attrs[i, MAT_SPECULAR] = np.asarray(mat.get("specular", color), np.float32)
        attrs[i, MAT_EMISSION] = color * np.float32(mat.get("emission", 0.0))
        attrs[i, MAT_ROUGHNESS] = np.float32(mat.get("roughness", 0.5))
        attrs[i, MAT_METALLIC] = 1.0 if mat.get("metallic", False) else 0.0
        attrs[i, MAT_TRANSPARENT] = 1.0 if mat.get("transparent", False) else 0.0
        attrs[i, MAT_IOR] = np.float32(mat.get("ior", 0.0))
        for k, kind in enumerate(kinds):
            desc = mat.get("maps", {}).get(kind)
            if desc is not None:
                off, w, h = desc
                attrs[i, 12 + k] = 1.0
                attrs[i, 16 + k] = float(off)
                attrs[i, 20 + k] = float(w)
                attrs[i, 24 + k] = float(h)

    if texture_quads is None or len(texture_quads) == 0:
        texture_quads = np.zeros((1, 4), np.uint32)
    if texture_quads.shape[0] >= (1 << 24):
        raise ValueError("texture pool exceeds 16.7M texels; offsets lose f32 precision")

    descs = [d for mat in materials for d in mat.get("maps", {}).values()]
    bundled = all(
        len({(d[1], d[2]) for d in mat.get("maps", {}).values()}) <= 1
        for mat in materials
    )
    bundled_scrambled = bundled and all(_pow2(d[1] * d[2]) for d in descs)
    bundled_morton = (
        not bundled_scrambled
        and bundled
        and all(d[1] == d[2] and _pow2(d[1]) for d in descs)
    )
    bundle_rows = [np.zeros((1, 8), np.uint32)]  # row 0 = no-map sink
    bundle_off = 1
    if bundled:
        attrs[:, MAT_BUNDLE_WIDTH] = 1.0
        attrs[:, MAT_BUNDLE_HEIGHT] = 1.0
        for i, mat in enumerate(materials):
            maps = mat.get("maps", {})
            if not maps:
                continue
            _, w, h = next(iter(maps.values()))
            n_texels = w * h

            def _kind_quads(kind):
                desc = maps.get(kind)
                if desc is None:
                    return None
                return texture_quads[desc[0] : desc[0] + n_texels]

            bundle = pack_bundle_rows(
                _kind_quads("albedo"), _kind_quads("roughness"),
                _kind_quads("normal"), _kind_quads("metallic"), n_texels,
            )
            if n_texels > 1 and (bundled_scrambled or bundled_morton):
                order = scramble_order(n_texels) if bundled_scrambled else morton_order(w, h)
                placed = np.empty_like(bundle)
                placed[order] = bundle
                bundle = placed
            bundle_rows.append(bundle)
            attrs[i, MAT_BUNDLE_OFFSET] = float(bundle_off)
            attrs[i, MAT_BUNDLE_WIDTH] = float(w)
            attrs[i, MAT_BUNDLE_HEIGHT] = float(h)
            bundle_off += n_texels
    texture_bundles = np.concatenate(bundle_rows, axis=0)

    return MaterialTable(
        attrs=torch.as_tensor(attrs, device=device),
        texture_quads=_u32_tensor(texture_quads, device),
        texture_bundles=_u32_tensor(texture_bundles, device),
        bundled=bundled,
        bundled_morton=bundled_morton,
        bundled_scrambled=bundled_scrambled,
        bundled_pow2_dims=bundled_scrambled,
    )


def make_scene(
    vertices: np.ndarray,
    normals: np.ndarray,
    uvs: Optional[np.ndarray],
    mat_ids: np.ndarray,
    materials: MaterialTable,
    env: Optional[EnvironmentMap] = None,
    device=DEFAULT_DEVICE,
) -> Scene:
    """Assemble a Scene from host numpy arrays ([T,3,3]/[T,3,2]/[T])."""
    device = resolve(device)
    t = vertices.shape[0]
    vertices = np.asarray(vertices, np.float32)
    normals = np.asarray(normals, np.float32)
    mat_ids = np.asarray(mat_ids, np.int32)
    uvs = np.zeros((t, 3, 2), np.float32) if uvs is None else np.asarray(uvs, np.float32)
    if env is None:
        env = default_env(device=device)

    def up(a):
        return torch.as_tensor(a, device=device)

    return Scene(
        vertices=up(vertices),
        normals=up(normals),
        uvs=up(uvs),
        mat_ids=up(mat_ids),
        tri_attrs=up(pack_tri_attrs(vertices, normals, uvs, mat_ids)),
        materials=materials,
        env=env,
    )
