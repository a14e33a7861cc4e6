"""The PyTorch port's shading against the JAX package: `_shade` on fixed
hit records (plain, glass, emissive, metallic and textured materials, in
the three texture-pool layouts), including the fields that next-event
estimation reads, `eval_env`, texture sampling and the BSDF terms."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several worker processes: one intra-op thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.ops.intersect import Hit as JHit  # noqa: E402
from tpu_pathtracer.ops.intersect import intersect_brute as j_brute  # noqa: E402
from tpu_pathtracer.render import bsdf as j_bsdf  # noqa: E402
from tpu_pathtracer.render import envmap as j_envmap  # noqa: E402
from tpu_pathtracer.render import integrator as j_integ  # noqa: E402
from tpu_pathtracer.render import texsample as j_tex  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402
from tpu_pathtracer.scene import scene as j_scene  # noqa: E402
from tpu_pathtracer.utils.image import procedural_hdr  # noqa: E402

from test_torch_intersect import assert_close_fma  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops.intersect import Hit  # noqa: E402
from tpu_pathtracer_torch.render import bsdf, envmap, integrator, texsample  # noqa: E402
from tpu_pathtracer_torch.scene import scene  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
FLOAT_KEYS = ("new_origin", "new_direction", "att_factor", "emission")
BOOL_KEYS = ("att_ok", "emissive", "degenerate", "done")
# The fields next-event estimation reads.
NEE_FLOAT_KEYS = ("normal", "diffuse_albedo", "spec_prob", "idotn", "brdf_combined", "spec_dir",
                  "f_vec", "alpha")
NEE_BOOL_KEYS = ("glass", "choose_spec")

# Texture layouts: for each of the two textured materials, the (w, h) of
# its albedo, roughness, normal and metallic maps.  A material whose maps
# differ in size turns bundling off (material_property samples each map).
KINDS = ("albedo", "roughness", "normal", "metallic")
LAYOUTS = {
    "bundled_scrambled": [[(8, 8)] * 4, [(16, 4)] * 4],
    "bundled_rowmajor": [[(6, 10)] * 4, [(5, 5)] * 4],
    "unbundled": [[(8, 8), (4, 4), (8, 8), (2, 3)], [(6, 10)] * 4],
}


def materials_for(dims, rs):
    """Five materials over a quad pool: 0 ground and 3 textured with all
    four maps (sizes from `dims`), 1 glass, 2 emissive, 4 metallic."""
    pool, off, textured = [], 0, []
    for sizes in dims:
        maps = {}
        for kind, (w, h) in zip(KINDS, sizes):
            pool.append(j_scene.make_texture_quads(rs.rand(h, w, 3)))
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
    return mats, np.concatenate(pool)


def geometry(rs):
    """Ground quad and four UV spheres (materials 1-4), random UVs in [-1,2)."""
    gv, gn = j_proc.ground_plane(0.0, 10.0)
    verts, norms, ids = [gv], [gn], [np.zeros(2, np.int32)]
    for i, x in enumerate((-4.5, -1.5, 1.5, 4.5)):
        sv, sn = j_proc.sphere_mesh((x, 1.0, 0.0), 1.0, 6, 12)
        verts.append(sv)
        norms.append(sn)
        ids.append(np.full(len(sv), i + 1, np.int32))
    v, n, ids = np.concatenate(verts), np.concatenate(norms), np.concatenate(ids)
    uvs = (rs.rand(len(v), 3, 2) * 3.0 - 1.0).astype(np.float32)
    return v, n, uvs, ids


def build_scenes(layout):
    rs = np.random.RandomState(11)
    mats, pool = materials_for(LAYOUTS[layout], rs)
    v, n, uvs, ids = geometry(rs)
    env = procedural_hdr(16, 32)
    j = j_scene.make_scene(v, n, uvs, ids, j_scene.make_material_table(mats, pool), j_scene.make_env(env))
    t = scene.make_scene(v, n, uvs, ids, scene.make_material_table(mats, pool, device="cpu"),
                         scene.make_env(env, "cpu"), device="cpu")
    return j, t


def camera_hits(j, n=3000, seed=12):
    """Rays from in front of the scene toward it, their brute-force hits,
    seeds and depths (0 on a tenth of the lanes, so depth ends paths)."""
    rs = np.random.RandomState(seed)
    o = (np.array([0.0, 2.0, 7.0]) + rs.randn(n, 3) * 0.3).astype(np.float32)
    target = (rs.rand(n, 3) * np.array([12.0, 2.5, 3.0]) - np.array([6.0, 0.0, 1.5])).astype(np.float32)
    d = (target - o) / np.linalg.norm(target - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    h = j_brute(j.vertices, jnp.asarray(o), jnp.asarray(d), 0.01, 1e16)
    hit = {k: np.asarray(getattr(h, k)) for k in ("t", "prim", "bary", "hit")}
    seeds = rs.randint(1, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    depth = np.where(rs.rand(n) < 0.1, 0, rs.randint(1, 8, size=n)).astype(np.int32)
    return o, d, hit, seeds, depth


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def shaded(request):
    j, t = build_scenes(request.param)
    o, d, hit, seeds, depth = camera_hits(j)
    cfg_kw = dict(max_depth=8, dof=False)
    want = j_integ._shade(
        j, JConfig(**cfg_kw), JHit(**{k: jnp.asarray(v) for k, v in hit.items()}),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(seeds), jnp.asarray(depth),
    )
    got = integrator._shade(
        t, RenderConfig(**cfg_kw), Hit(**{k: torch.tensor(v) for k, v in hit.items()}),
        torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(seeds.astype(np.int64)), torch.as_tensor(depth),
    )
    return request.param, t, hit, got, want


def test_shade_layout_matches_jax(shaded):
    layout, t, _, _, _ = shaded
    assert t.materials.bundled == (layout != "unbundled")
    assert t.materials.bundled_scrambled == (layout == "bundled_scrambled")


def test_shade_seeds_exact(shaded):
    *_, got, want = shaded
    np.testing.assert_array_equal(got["seeds"].numpy().astype(np.uint32), np.asarray(want["seeds"]))


@pytest.mark.parametrize("key", BOOL_KEYS + NEE_BOOL_KEYS)
def test_shade_flags_match_jax(shaded, key):
    _, _, hit, got, want = shaded
    m = hit["hit"]
    np.testing.assert_array_equal(got[key].numpy()[m], np.asarray(want[key])[m])


@pytest.mark.parametrize("key", FLOAT_KEYS + NEE_FLOAT_KEYS)
def test_shade_outputs_match_jax(shaded, key):
    """Hit lanes to rtol 1e-5, atol 1e-6 on 99.5% of values and 100x that
    on all: XLA:CPU contracts multiply-adds into FMAs (see
    assert_close_fma), and the GGX sample at small alpha and the
    normal-map blend magnify one rounding (measured: at most 0.23% of
    values off, by at most 1.1e-3 relative).  Every material is hit."""
    _, t, hit, got, want = shaded
    m = hit["hit"]
    mats = t.tri_attrs[torch.as_tensor(hit["prim"][m]).long(), 24].numpy()
    assert set(np.unique(mats).astype(int)) == {0, 1, 2, 3, 4}
    assert_close_fma(got[key].numpy()[m], np.asarray(want[key])[m], rtol=RTOL, atol=ATOL, loose=100.0)


def test_shade_spec_pdf_matches_jax(shaded):
    """spec_pdf = D n.h / (4 v.h).  At alpha near roughness_min^2 the GGX
    D divides by (n.h)^2 (alpha^2 - 1) + 1, which cancels, so one rounding
    of n.h (XLA:CPU's fused multiply-adds, see assert_close_fma) moves it
    by up to 7.2% (measured on these lanes, three layouts: 27% outside
    rtol 1e-5, 99% within 1e-2).  brdf_combined, where D cancels, is held
    to 1e-5 above.  Here: 99% of hit lanes within rtol 1e-2, all within
    1e-1."""
    _, _, hit, got, want = shaded
    m = hit["hit"]
    assert_close_fma(got["spec_pdf"].numpy()[m], np.asarray(want["spec_pdf"])[m], rtol=1e-2, loose=10.0, share=0.99)


@pytest.mark.parametrize("mode,shape", [("equirect", (32, 64)), ("equirect", (12, 20)), ("sunsky", None), ("constant", None)])
def test_eval_env_matches_jax(mode, shape):
    rs = np.random.RandomState(13)
    d = rs.randn(5000, 3).astype(np.float32)
    d[:3] = [[0, 1, 0], [0, -1, 0], [1e-9, 0, -1]]  # poles and the seam
    d[3:200] = [0.0, 2.0, 3.0] + rs.randn(197, 3).astype(np.float32) * 0.05  # sun
    hdr = procedural_hdr(*(shape or (8, 16)))
    want = j_envmap.eval_env(j_scene.make_env(hdr), jnp.asarray(d), JConfig(env_mode=mode))
    got = envmap.eval_env(scene.make_env(hdr, "cpu"), torch.as_tensor(d), RenderConfig(env_mode=mode))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _tex_inputs(seed, n=4000):
    rs = np.random.RandomState(seed)
    return (rs.rand(n).astype(np.float32) * 5 - 2, rs.rand(n).astype(np.float32) * 5 - 2)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_texture_sampling_matches_jax(layout):
    """sample_bundle (bundled layouts) or material_property (per-material
    dims) on every textured material, with u, v wrapping."""
    rs = np.random.RandomState(14)
    mats, pool = materials_for(LAYOUTS[layout], rs)
    jt, tt = j_scene.make_material_table(mats, pool), scene.make_material_table(mats, pool, device="cpu")
    u, v = _tex_inputs(15)
    n = len(u)
    rows = np.asarray(jt.attrs)[np.array([0, 3])[np.arange(n) % 2]]
    if jt.bundled:
        cols = [j_scene.MAT_BUNDLE_OFFSET, j_scene.MAT_BUNDLE_WIDTH, j_scene.MAT_BUNDLE_HEIGHT]
        off, w, h = (rows[:, c].astype(np.int32) for c in cols)
        flags = dict(morton=jt.bundled_morton, scrambled=jt.bundled_scrambled, pow2_dims=jt.bundled_pow2_dims)
        want = j_tex.sample_bundle(jt.texture_bundles, *map(jnp.asarray, (off, w, h, u, v)), **flags)
        got = texsample.sample_bundle(tt.texture_bundles, *map(torch.as_tensor, (off, w, h, u, v)), **flags)
    else:
        fallback = np.full((n, 3), 0.25, np.float32)
        has = np.arange(n) % 3 > 0
        # The roughness map, whose size differs from the albedo's.
        off, w, h = (rows[:, s][:, 1].astype(np.int32) for s in (j_scene.MAT_MAP_OFFSET, j_scene.MAT_MAP_WIDTH, j_scene.MAT_MAP_HEIGHT))
        want = [j_tex.material_property(jt.texture_quads, *map(jnp.asarray, (has, off, w, h, fallback, u, v)))]
        got = [texsample.material_property(tt.texture_quads, *map(torch.as_tensor, (has, off, w, h, fallback, u, v)))]
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=RTOL, atol=ATOL)


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("term", ["d_ggx", "g_smith", "fresnel", "fresnel_scalar", "importance", "pdf"])
def test_bsdf_terms_match_jax(term):
    rs = np.random.RandomState(16)
    n = 4000
    nv, hv, lv = _unit(rs, n), _unit(rs, n), _unit(rs, n)
    hv = (hv + 2 * nv) / np.linalg.norm(hv + 2 * nv, axis=1, keepdims=True)
    alpha = (rs.rand(n) * 0.98 + 0.0002).astype(np.float32)
    c = rs.rand(n).astype(np.float32)
    f0 = rs.rand(n, 3).astype(np.float32)
    args = {
        "d_ggx": (nv, hv, alpha),
        "g_smith": (alpha, nv, hv, lv),
        "fresnel": (c, f0),
        "fresnel_scalar": (c, (c + 1.1).astype(np.float32)),
        "importance": (c, rs.rand(n).astype(np.float32), alpha),
        "pdf": (alpha + 1.0, c + 0.1, c + 0.2),
    }[term]
    name = {"fresnel": "fresnel_schlick", "fresnel_scalar": "fresnel_schlick_scalar",
            "importance": "ggx_importance_sample", "pdf": "ggx_pdf"}.get(term, term)
    want = getattr(j_bsdf, name)(*map(jnp.asarray, args))
    got = getattr(bsdf, name)(*map(torch.as_tensor, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
