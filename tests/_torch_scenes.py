"""Small OBJ/MTL/PNG scenes written into a directory from a numpy seed, for
the port's scene, AOV, progressive and CLI tests (and the CUDA tests on
the card, which have neither JAX nor PIL: this module imports neither at
import time).

`write_mtl_scene(dir)`: one OBJ with three MTL materials: a box of quads
with per-face normals and uvs and albedo/roughness/metallic/normal maps
(`map_Kd`, `map_Pr`, `map_Pm`, `norm`), a glass sphere (`d` < 1, `Ni`
1.45) written with negative indices, and an emissive quad (`Ke`) without
normals.  `write_convention_scene(dir)`: two OBJ files, one with the
four `<stem>_<kind>.png` maps (sizes given per kind) and one without.
`oracle_case(name, device)`: a case of tests/test_oracle.py on the
port's procedural scenes.  `SCHEDULES`: a config for each frame
schedule on a 64x48 frame (the host-sync and span tests).
"""

from __future__ import annotations

import math
import os

import numpy as np

KINDS = ("albedo", "roughness", "metallic", "normal")


def write_png(path: str, img_u8: np.ndarray) -> None:
    """PIL when it is importable (its adaptive row filters, Paeth
    included, exercise the port's decoder), else the port's encoder."""
    try:
        from PIL import Image
    except ImportError:
        from tpu_pathtracer_torch.utils.image import save_png

        save_png(path, img_u8)
        return
    Image.fromarray(np.ascontiguousarray(img_u8), "RGB").save(path)


def texture(rs: np.random.RandomState, h: int, w: int, kind: str) -> np.ndarray:
    """A seeded [h,w,3] uint8 pattern: smooth bands plus noise; normal
    maps stay near +z (128, 128, 255)."""
    y, x = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.25 * np.sin(x * 0.7)[..., None] * np.cos(y * 0.4)[..., None] * rs.rand(1, 1, 3)
    img = np.clip(base + 0.2 * rs.rand(h, w, 3), 0.0, 1.0)
    if kind == "normal":
        img = np.concatenate([0.5 + 0.15 * (img[..., :2] - 0.5), np.ones((h, w, 1))], axis=-1)
    return (img * 255.0).astype(np.uint8)


def _box(lo, hi):
    """A box as 6 quads: (v [8,3], vt [4,2], vn [6,3], faces of 4 (v, vt, vn)
    1-based triples)."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    v = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    vt = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    quads = (  # corner ids (x*4 + y*2 + z), normal
        ((0, 1, 3, 2), (-1, 0, 0)), ((4, 6, 7, 5), (1, 0, 0)),
        ((0, 4, 5, 1), (0, -1, 0)), ((2, 3, 7, 6), (0, 1, 0)),
        ((0, 2, 6, 4), (0, 0, -1)), ((1, 5, 7, 3), (0, 0, 1)),
    )
    vn = np.array([n for _, n in quads], float)
    faces = [[(c + 1, k + 1, i + 1) for k, c in enumerate(q)] for i, (q, _) in enumerate(quads)]
    return v, vt, vn, faces


def _sphere(center, radius, stacks, slices):
    """Triangles of a UV sphere: (v [P,3], vn [P,3], vt [P,2], faces of 3
    0-based ids)."""
    v, vn, vt = [], [], []
    for i in range(stacks + 1):
        phi = math.pi * i / stacks
        for j in range(slices + 1):
            theta = 2 * math.pi * j / slices
            n = (math.sin(phi) * math.cos(theta), math.cos(phi), math.sin(phi) * math.sin(theta))
            vn.append(n)
            v.append(tuple(c + radius * a for c, a in zip(center, n)))
            vt.append((j / slices, 1.0 - i / stacks))
    faces = []
    for i in range(stacks):
        for j in range(slices):
            a, b = i * (slices + 1) + j, (i + 1) * (slices + 1) + j
            faces += [(a, b, a + 1), (a + 1, b, b + 1)]
    return np.array(v), np.array(vn), np.array(vt), faces


def _fmt(prefix, rows):
    return "".join(f"{prefix} " + " ".join(f"{x:.6f}" for x in r) + "\n" for r in rows)


def write_mtl_scene(d: str, seed: int = 0, tex: int = 32) -> str:
    """The textured, glass and emissive OBJ of the module docstring, with
    `tex` x `tex` maps; returns the OBJ's path."""
    rs = np.random.RandomState(seed)
    for kind in KINDS:
        write_png(os.path.join(d, f"box_{kind}.png"), texture(rs, tex, tex, kind))
    with open(os.path.join(d, "scene.mtl"), "w") as f:
        f.write(
            "# the port's test materials\n"
            "newmtl textured\nKd 0.8 0.8 0.8\nKs 0.5 0.5 0.5\nPr 0.5\n"
            "map_Kd box_albedo.png\nmap_Pr box_roughness.png\nmap_Pm box_metallic.png\nnorm box_normal.png\n"
            "newmtl glass\nKd 1.0 1.0 1.0\nKs 1.0 1.0 1.0\nNs 200\nd 0.3\nNi 1.45\nillum 4\n"
            "newmtl light\nKd 0.0 0.0 0.0\nKe 6.0 5.0 4.0\n"
        )
    bv, bvt, bvn, bfaces = _box((-1.6, 0.0, -0.6), (-0.4, 1.2, 0.6))
    sv, svn, svt, sfaces = _sphere((0.9, 0.7, 0.0), 0.7, 6, 12)
    lines = ["# test scene\nmtllib scene.mtl\no box\n", _fmt("v", bv), _fmt("vt", bvt), _fmt("vn", bvn),
             "usemtl textured\ns 1\n"]
    lines += ["f " + " ".join(f"{a}/{b}/{c}" for a, b, c in face) + "\n" for face in bfaces]
    # The sphere by negative (relative) indices, right after its attributes.
    lines += ["g glass\n", _fmt("v", sv), _fmt("vt", svt), _fmt("vn", svn), "usemtl glass\n"]
    n = len(sv)
    lines += ["f " + " ".join(f"{i - n}/{i - n}/{i - n}" for i in face) + "\n" for face in sfaces]
    # The light: a quad without normals or uvs.
    lines += ["o light\n", _fmt("v", [(-0.5, 2.2, -0.5), (0.5, 2.2, -0.5), (0.5, 2.2, 0.5), (-0.5, 2.2, 0.5)]),
              "usemtl light\nf -4 -3 -2 -1\n"]
    path = os.path.join(d, "scene.obj")
    with open(path, "w") as f:
        f.write("".join(lines))
    return path


def write_convention_scene(d: str, seed: int = 0, sizes=None) -> list:
    """Two OBJ files: `box.obj` with the four convention maps (`sizes`:
    kind -> (h, w), default 16x16 each) and `ball.obj` without (a random
    material).  Returns their paths."""
    rs = np.random.RandomState(seed)
    sizes = sizes or {k: (16, 16) for k in KINDS}
    for kind, (h, w) in sizes.items():
        write_png(os.path.join(d, f"box_{kind}.png"), texture(rs, h, w, kind))
    bv, bvt, bvn, bfaces = _box((-1.0, 0.0, -1.0), (1.0, 1.0, 1.0))
    with open(os.path.join(d, "box.obj"), "w") as f:
        f.write(_fmt("v", bv) + _fmt("vt", bvt) + _fmt("vn", bvn))
        f.write("".join("f " + " ".join(f"{a}/{b}/{c}" for a, b, c in face) + "\n" for face in bfaces))
    sv, svn, svt, sfaces = _sphere((2.0, 0.5, 0.0), 0.5, 4, 8)
    with open(os.path.join(d, "ball.obj"), "w") as f:
        f.write(_fmt("v", sv) + _fmt("vt", svt))  # no normals: the (0,1,0) fallback
        f.write("".join("f " + " ".join(f"{i + 1}/{i + 1}" for i in face) + "\n" for face in sfaces))
    return [os.path.join(d, "box.obj"), os.path.join(d, "ball.obj")]


# The port's frame schedules: BASE with each one's overrides takes it on a
# 64x48 frame (NEE's scene needs an environment with its alias table).
BASE = dict(width=64, height=48, samples_per_launch=2, max_depth=4, dof=False, intersector="cluster",
            env_mode="sunsky", stream_lanes=512)
NEE = dict(env_mode="equirect", rr_mode="standard", env_importance_sampling=True)
SCHEDULES = {
    "stream_fused": dict(fused_schedule="on"),
    "stream": dict(fused_schedule="off"),
    "stream_nee": NEE,
    "stream_deferred": dict(fused_schedule="off", deferred_shade=True),
    "regen": dict(stream_lanes=4096),
    "rays": dict(samples_per_launch=1),
}


# tests/test_oracle.py's cases, which the port's renders are held against
# the numpy oracle on (tests/test_torch_oracle.py, tests/test_torch_cuda.py,
# chip_smoke.py).
ORACLE_CASES = ("sunsky", "dof_constant", "glass", "nee", "nee_defensive_mix", "nee_mis_spec")
ORACLE_NEE = dict(env_mode="equirect", env_importance_sampling=True, rr_mode="standard")


def oracle_case(name: str, device):
    """(scene on `device`, config overrides, camera keyword arguments) of
    the case `name` of ORACLE_CASES.  The glass sphere is
    tests/test_integrator.py's single-material sphere; the NEE cases' sky
    is procedural_hdr(16, 32, seed=5) with its alias table."""
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.scene import procedural
    from tpu_pathtracer_torch.scene.scene import make_env, make_material_table, make_scene
    from tpu_pathtracer_torch.utils.image import procedural_hdr

    if name == "dof_constant":
        scene = procedural.single_sphere_scene(stacks=6, slices=12, device=device)
        return scene, dict(dof=True, env_mode="constant"), {}
    if name == "glass":
        sv, sn = procedural.sphere_mesh((0.0, 0.0, 0.0), 1.0, 10, 20)
        mats = make_material_table([dict(color=(1, 1, 1), roughness=0.1, transparent=True)], device=device)
        scene = make_scene(sv, sn, None, np.zeros(len(sv), np.int32), mats, device=device)
        return scene, dict(env_mode="constant"), dict(eye=(0, 0, 4))
    scene = procedural.three_spheres_scene(6, 12, device=device)
    if name == "sunsky":
        return scene, dict(env_mode="sunsky"), {}
    env = with_importance_sampling(make_env(procedural_hdr(16, 32, seed=5), device))
    kw = dict(ORACLE_NEE, nee_defensive_mix=name == "nee_defensive_mix", nee_mis_spec=name == "nee_mis_spec")
    return scene.replace(env=env), kw, {}


# Texture layouts of shade_scene: for each of its two textured materials,
# the (w, h) of its albedo, roughness, normal and metallic maps (the CPU
# shade tests' LAYOUTS, and square maps, which a Morton order needs).
# Maps of one size bundle; pow2 texel counts scramble; mixed sizes keep
# the quad pool.
SHADE_LAYOUTS = {
    "bundled_scrambled": [[(8, 8)] * 4, [(16, 4)] * 4],
    "bundled_rowmajor": [[(6, 10)] * 4, [(5, 5)] * 4],
    "unbundled": [[(8, 8), (4, 4), (8, 8), (2, 3)], [(6, 10)] * 4],
    "bundled_square": [[(8, 8)] * 4, [(16, 16)] * 4],
}


def shade_scene(layout: str, device, seed: int = 11, degenerate: int = 6):
    """The CPU shade tests' scene on `device` from the port alone: a ground
    quad (material 0, textured) and four UV spheres (1 glass, 2 emissive, 3
    textured, 4 metallic) with random uvs in [-1, 2), under a procedural
    32x64 equirect sky with its alias table.  The first `degenerate`
    sphere triangles have zero normals (the degenerate test)."""
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.scene import procedural
    from tpu_pathtracer_torch.scene.scene import make_env, make_material_table, make_scene, make_texture_quads
    from tpu_pathtracer_torch.utils.image import procedural_hdr

    rs = np.random.RandomState(seed)
    pool, off, textured = [], 0, []
    for sizes in SHADE_LAYOUTS[layout]:
        maps = {}
        for kind, (w, h) in zip(("albedo", "roughness", "normal", "metallic"), sizes):
            pool.append(make_texture_quads(rs.rand(h, w, 3)))
            maps[kind] = (off, w, h)
            off += w * h
        textured.append(dict(color=(0.6, 0.5, 0.4), roughness=0.4, maps=maps))
    mats = [
        textured[0],
        dict(color=(0.9, 0.9, 1.0), roughness=0.1, transparent=True, ior=1.45),
        dict(color=(1.0, 0.8, 0.6), emission=4.0),
        textured[1],
        dict(color=(0.8, 0.7, 0.2), roughness=0.3, metallic=True),
    ]
    gv, gn = procedural.ground_plane(0.0, 10.0)
    verts, norms, ids = [gv], [gn], [np.zeros(2, np.int32)]
    for i, x in enumerate((-4.5, -1.5, 1.5, 4.5)):
        sv, sn = procedural.sphere_mesh((x, 1.0, 0.0), 1.0, 6, 12)
        verts.append(sv)
        norms.append(sn)
        ids.append(np.full(len(sv), i + 1, np.int32))
    v, n, ids = np.concatenate(verts), np.concatenate(norms), np.concatenate(ids)
    n[2:2 + degenerate] = 0.0
    uvs = (rs.rand(len(v), 3, 2) * 3.0 - 1.0).astype(np.float32)
    env = with_importance_sampling(make_env(procedural_hdr(32, 64), device))
    return make_scene(v, n, uvs, ids, make_material_table(mats, np.concatenate(pool), device=device), env,
                      device=device)


def shade_rays(n: int, seed: int, device):
    """n rays at shade_scene: three quarters from in front of it toward
    it, one quarter from inside the glass sphere (centre (-4.5, 1, 0)) in
    random directions, which leave through its inner surface (refraction
    and total internal reflection).  Returns (origins, directions) float32
    tensors."""
    import torch

    rs = np.random.RandomState(seed)
    o = (np.array([0.0, 2.0, 7.0]) + rs.randn(n, 3) * 0.3).astype(np.float32)
    target = rs.rand(n, 3) * np.array([12.0, 2.5, 3.0]) - np.array([6.0, 0.0, 1.5])
    d = target - o
    k = n // 4
    o[:k] = np.array([-4.5, 1.0, 0.0]) + rs.randn(k, 3) * 0.2
    d[:k] = rs.randn(k, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.as_tensor(o, device=device), torch.as_tensor(d, device=device)
