"""The PyTorch port's host-side builders against the JAX package: config,
procedural scenes, material tables, environment maps, the cluster accel,
and the bridge that carries a JAX scene across leaf by leaf."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several worker processes: one intra-op thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

from tpu_pathtracer.accel.build import build_accel as j_build_accel  # noqa: E402
from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402
from tpu_pathtracer.scene import scene as j_scene  # noqa: E402
from tpu_pathtracer.utils.image import procedural_hdr as j_hdr  # noqa: E402

from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.accel.cluster import build_cluster_accel  # noqa: E402
from tpu_pathtracer_torch.bridge import scene_from_numpy  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.scene import procedural, scene  # noqa: E402
from tpu_pathtracer_torch.utils.image import procedural_hdr  # noqa: E402

LEAF_FIELDS = {
    "": ("vertices", "normals", "uvs", "mat_ids", "tri_attrs"),
    "materials": ("attrs", "texture_quads", "texture_bundles", "bundled",
                  "bundled_morton", "bundled_scrambled", "bundled_pow2_dims"),
    "env": ("data", "quads", "quads_scrambled", "cdf_rows", "cdf_cols", "alias_table"),
    "accel": ("tris16bw", "aabb8", "order", "scene_lo", "scene_hi", "aabb8_child",
              "aabb8_super", "order_super", "tris16", "cluster_size", "super_branch"),
}


def jax_scene_leaves(obj) -> dict:
    """Flatten a JAX Scene (or the port's) to {field path: numpy array};
    fields that are None are left out."""
    leaves = {}
    for group, names in LEAF_FIELDS.items():
        holder = getattr(obj, group) if group else obj
        if holder is None:
            continue
        for name in names:
            value = getattr(holder, name)
            if value is None:
                continue
            if isinstance(value, torch.Tensor):
                value = value.cpu().numpy()
            leaves[f"{group}.{name}" if group else name] = np.asarray(value)
    return leaves


def assert_leaves_equal(port_scene, jax_leaves):
    port = jax_scene_leaves(port_scene)
    assert port.keys() == jax_leaves.keys()
    for key, want in jax_leaves.items():
        got = port[key]
        if want.dtype == np.uint32:
            want = want.astype(np.int64)  # the port holds u32 words in int64
        np.testing.assert_array_equal(got, want, err_msg=key)
        assert got.shape == want.shape, key


def textured_materials(rs, dims):
    """Material dicts plus a quad pool: one textured material per (w, h)
    in `dims` with all four maps, and one plain material."""
    pool, mats, off = [], [], 0
    for w, h in dims:
        maps = {}
        for kind in ("albedo", "roughness", "normal", "metallic"):
            pool.append(j_scene.make_texture_quads(rs.rand(h, w, 3)))
            maps[kind] = (off, w, h)
            off += w * h
        mats.append(dict(color=(0.6, 0.5, 0.4), roughness=0.4, maps=maps))
    mats.append(dict(color=(0.2, 0.3, 0.9), roughness=0.9, metallic=True))
    return mats, np.concatenate(pool)


def test_procedural_hdr_matches_jax():
    np.testing.assert_array_equal(procedural_hdr(32, 64), j_hdr(32, 64))


@pytest.mark.parametrize("shape", [(32, 64), (12, 20)])
def test_make_env_matches_jax(shape):
    hdr = j_hdr(*shape)
    got = scene.make_env(hdr, "cpu")
    want = j_scene.make_env(hdr)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.quads.numpy(), np.asarray(want.quads))
    assert got.quads_scrambled == want.quads_scrambled


def test_three_spheres_with_accel_matches_jax():
    hdr = j_hdr(32, 64)
    want = j_build_accel(
        j_proc.three_spheres_scene(8, 16).replace(env=j_scene.make_env(hdr)),
        kind="cluster",
    )
    got = build_accel(procedural.three_spheres_scene(8, 16, device="cpu").replace(env=scene.make_env(hdr, "cpu")))
    assert_leaves_equal(got, jax_scene_leaves(want))


@pytest.mark.parametrize(
    "make",
    [
        lambda m, **kw: m.single_sphere_scene(stacks=6, slices=12, **kw),
        lambda m, **kw: m.high_poly_scene(total_tris=2000, n_objects=3, seed=3, **kw),
    ],
    ids=["single_sphere", "high_poly"],
)
def test_other_procedural_scenes_match_jax(make):
    want = j_build_accel(make(j_proc), kind="cluster", cluster_size=64)
    got = build_accel(make(procedural, device="cpu"), kind="cluster", cluster_size=64)
    assert_leaves_equal(got, jax_scene_leaves(want))


@pytest.mark.parametrize(
    "dims",
    [[(8, 8), (8, 8)], [(16, 4)], [(6, 10)], [(8, 8), (4, 4)]],
    ids=["bundled_scrambled", "bundled_pow2_rect", "bundled_rowmajor", "per_material_dims"],
)
def test_material_table_matches_jax(dims):
    mats, pool = textured_materials(np.random.RandomState(7), dims)
    want = j_scene.make_material_table(mats, pool)
    got = scene.make_material_table(mats, pool, device="cpu")
    np.testing.assert_array_equal(got.attrs.numpy(), np.asarray(want.attrs))
    np.testing.assert_array_equal(got.texture_quads.numpy(), np.asarray(want.texture_quads).astype(np.int64))
    np.testing.assert_array_equal(got.texture_bundles.numpy(), np.asarray(want.texture_bundles).astype(np.int64))
    for flag in ("bundled", "bundled_morton", "bundled_scrambled", "bundled_pow2_dims"):
        assert getattr(got, flag) == getattr(want, flag), flag


@pytest.mark.parametrize(
    "make,cluster_size",
    [
        (lambda m, **kw: m.three_spheres_scene(8, 16, **kw), 8),
        (lambda m, **kw: m.high_poly_scene(total_tris=13_000, **kw), 128),
    ],
    ids=["three_spheres_97_clusters", "high_poly_98_clusters"],
)
def test_two_level_accel_matches_jax(make, cluster_size):
    """Scenes on the two-level route: the supercluster arrays (child boxes
    with far point padding, super boxes from real children only, super
    visit orders) and the Moller-Trumbore rows, bit for bit."""
    want = j_build_accel(make(j_proc), kind="cluster", cluster_size=cluster_size)
    got = build_accel(make(procedural, device="cpu"), kind="cluster", cluster_size=cluster_size)
    acc = got.accel
    assert acc.num_clusters >= RenderConfig().hier_min_clusters
    assert acc.num_clusters % acc.super_branch != 0  # a part-padded last super
    assert_leaves_equal(got, jax_scene_leaves(want))


def test_bridge_round_trip():
    want = j_build_accel(
        j_proc.three_spheres_scene(6, 12).replace(env=j_scene.make_env(j_hdr(16, 32))),
        kind="cluster",
    )
    leaves = jax_scene_leaves(want)
    carried = scene_from_numpy(leaves, "cpu")
    assert_leaves_equal(carried, leaves)
    assert carried.accel.num_clusters == want.accel.num_clusters
    assert carried.tri_attrs.dtype == torch.float32
    assert carried.materials.texture_quads.dtype == torch.int64


def test_bridge_two_level_scene_intersects():
    """A JAX scene on the two-level route carried across: its arrays are
    the port's own, and its accel gives the port-built accel's hits."""
    want = j_build_accel(j_proc.three_spheres_scene(8, 16), kind="cluster", cluster_size=8)
    leaves = jax_scene_leaves(want)
    carried = scene_from_numpy(leaves, "cpu")
    assert_leaves_equal(carried, leaves)
    assert carried.accel.super_branch == want.accel.super_branch == 8
    cfg = RenderConfig()
    assert carried.accel.route(cfg) == "hier"
    built = build_accel(procedural.three_spheres_scene(8, 16, device="cpu"), cluster_size=8)
    rs = np.random.RandomState(3)
    o = torch.as_tensor((rs.randn(1000, 3) * 3).astype(np.float32))
    d = torch.as_tensor(rs.randn(1000, 3).astype(np.float32))
    a = carried.accel.intersect(carried.vertices, o, d, 0.01, 1e16, cfg)
    b = built.accel.intersect(built.vertices, o, d, 0.01, 1e16, cfg)
    assert torch.equal(a.prim, b.prim) and torch.equal(a.t, b.t) and torch.equal(a.bary, b.bary)
    assert a.hit.sum() > 100


def test_bridge_without_accel():
    want = j_proc.single_sphere_scene(stacks=4, slices=8)
    leaves = jax_scene_leaves(want)
    assert not any(k.startswith("accel.") for k in leaves)
    assert scene_from_numpy(leaves, "cpu").accel is None


def test_config_defaults_match_jax():
    got, want = RenderConfig(), JConfig()
    for field in dataclasses.fields(RenderConfig):
        assert getattr(got, field.name) == getattr(want, field.name), field.name


@pytest.mark.parametrize(
    "bad",
    [
        dict(rr_mode="bogus"),
        dict(env_mode="hdr"),
        dict(intersector="bvh"),
        dict(sort_rays="sideways"),
        dict(tri_test="xyz"),
        dict(sort_spatial_bits=10),
        dict(sort_dir_bits=5),
        dict(hier_min_clusters=1),
        dict(stream_lanes=-1),
        dict(env_importance_sampling=True),
        dict(nee_defensive_mix=True),
        dict(nee_mis_spec=True),
    ],
)
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        JConfig(**bad)
    with pytest.raises(ValueError):
        RenderConfig(**bad)


@pytest.mark.parametrize(
    "make",
    [
        lambda: procedural.three_spheres_scene(4, 8).vertices,
        lambda: procedural.single_sphere_scene(stacks=4, slices=8).vertices,
        lambda: procedural.high_poly_scene(total_tris=500, n_objects=2).vertices,
        lambda: scene.make_env(j_hdr(8, 16)).data,
        lambda: scene.default_env().data,
        lambda: scene.make_material_table([dict(color=(0.5, 0.5, 0.5))]).attrs,
        lambda: build_cluster_accel(procedural.three_spheres_scene(4, 8, device="cpu").vertices.numpy()).aabb8,
    ],
    ids=["three_spheres", "single_sphere", "high_poly", "make_env", "default_env", "material_table",
         "cluster_accel"],
)
def test_constructors_default_to_the_card(make):
    """The entry points build on the card unless asked for another device;
    without a card they refuse, naming device='cpu', instead of building
    on the CPU."""
    if torch.cuda.is_available():
        assert make().is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
