"""The port's scene builder, packed-scene cache and scene files against
the JAX package's: every packed array bit for bit (geometry, tri_attrs,
material attrs, texture quads and bundle rows, the Morton permutation and
the cluster accel), in convention and mtl modes, with and without a
bundled pool; the cache's round trip, invalidation and torn entries."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_pathtracer.scene import builder as j_builder  # noqa: E402
from tpu_pathtracer.scene import scenefile as j_scenefile  # noqa: E402

from tpu_pathtracer_torch import bridge  # noqa: E402
from tpu_pathtracer_torch.assets import native  # noqa: E402
from tpu_pathtracer_torch.scene import builder, cache, scenefile  # noqa: E402
from tpu_pathtracer_torch.utils.device import to_device  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_scenes as ts  # noqa: E402


def assert_scene_equal(t, j):
    """The port's Scene against the JAX package's, leaf by leaf, exact
    (u32 pools compared by value: the port holds them as int64)."""
    def same(a, b, name):
        a, b = a.cpu().numpy(), np.asarray(b)
        if b.dtype == np.uint32:
            b = b.astype(np.int64)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name

    for k in bridge.SCENE_KEYS:
        same(getattr(t, k), getattr(j, k), k)
    for k in bridge.MATERIAL_KEYS:
        same(getattr(t.materials, k), getattr(j.materials, k), f"materials.{k}")
    for k in bridge.MATERIAL_FLAGS:
        assert getattr(t.materials, k) == getattr(j.materials, k), k
    assert j.materials.texture_bundles_mip is None  # below the JAX mip threshold
    assert (t.accel is None) == (j.accel is None)
    if t.accel is not None:
        for k in bridge.ACCEL_KEYS:
            same(getattr(t.accel, k), getattr(j.accel, k), f"accel.{k}")
        for k in bridge.ACCEL_STATICS:
            assert getattr(t.accel, k) == getattr(j.accel, k), k


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> (OBJ paths, load_scene keywords)."""
    d = tmp_path_factory.mktemp("scenes")
    mixed = d / "mixed"
    mixed.mkdir()
    out = {
        "mtl": ([ts.write_mtl_scene(str(d), tex=16)], dict(material_source="mtl")),
        "convention bundled": (ts.write_convention_scene(str(d)), {}),
        # maps of different sizes: no bundle pool, the per-kind quads
        "convention unbundled": (ts.write_convention_scene(str(mixed), sizes={
            "albedo": (16, 24), "roughness": (8, 8), "metallic": (16, 24), "normal": (12, 10)}), dict(rng_seed=3)),
    }
    return out


@pytest.mark.parametrize("accel", [None, "cluster"])
@pytest.mark.parametrize("name", ["mtl", "convention bundled", "convention unbundled"])
def test_load_scene_matches_jax(files, name, accel):
    paths, kw = files[name]
    t = builder.load_scene(paths, accel=accel, device="cpu", scale=0.5, **kw)
    j = j_builder.load_scene(paths, accel=accel, scale=0.5, **kw)
    assert_scene_equal(t, j)
    assert t.materials.bundled == (name != "convention unbundled")
    if name == "mtl":
        attrs = t.materials.attrs.numpy()
        assert attrs[1, 11] == 1.0 and attrs[1, 31] == np.float32(1.45)  # the glass: transparent, Ni
        assert (attrs[2, 6:9] == [6.0, 5.0, 4.0]).all()  # the light's Ke
        assert attrs[0, 12:16].tolist() == [1.0, 1.0, 1.0, 1.0]  # every map kind on the box


def test_load_scene_floor_and_random_materials(files):
    """The floor at the scene's lowest vertex with its material last, and
    the random material of a map-less file drawn from the seed."""
    paths, _ = files["convention bundled"]
    a = builder.load_scene(paths, device="cpu", rng_seed=11)
    b = builder.load_scene(paths, device="cpu", rng_seed=12)
    assert_scene_equal(a, j_builder.load_scene(paths, rng_seed=11))
    assert not torch.equal(a.materials.attrs[1], b.materials.attrs[1])
    assert torch.equal(a.materials.attrs[2, 0:3], torch.tensor([0.2, 0.2, 0.2]))
    floor = a.vertices[-2:]
    assert float(floor[..., 1].max()) == float(a.vertices[:-2, :, 1].min())
    nofloor = builder.load_scene(paths, device="cpu", add_floor=False)
    assert nofloor.num_triangles == a.num_triangles - 2


def test_native_and_python_parsers_give_one_scene(files):
    paths, kw = files["mtl"]
    before = native.used_native()
    a = builder.load_scene(paths, accel="cluster", device="cpu", **kw)
    assert native.used_native() == before + 1
    b = builder.load_scene(paths, accel="cluster", device="cpu", use_native=False, **kw)
    assert native.used_native() == before + 1
    for k in bridge.SCENE_KEYS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_load_scene_timings_and_device(files):
    paths, kw = files["mtl"]
    timings = {}
    scene = builder.load_scene(paths, accel="cluster", device="cpu", timings=timings, **kw)
    assert set(timings) == {"parse", "pack", "upload"} and all(v >= 0 for v in timings.values())
    assert scene.device.type == "cpu" and scene.accel.aabb8.device.type == "cpu"
    with pytest.raises(ValueError):
        builder.load_scene(paths, material_source="bogus", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder.load_scene(paths, **kw)  # the card is the default


def test_to_device_resets_caches(files):
    paths, kw = files["mtl"]
    scene = builder.load_scene(paths, accel="cluster", device="cpu", **kw)
    scene.accel.streamed_pads(16)
    moved = to_device(scene, "cpu")
    assert moved.accel._pads == {} and scene.accel._pads
    assert torch.equal(moved.accel.tris16bw, scene.accel.tris16bw)


# ---------------------------------------------------------------------------
# the packed-scene cache


def _cached(paths, d, **kw):
    timings = {}
    scene = cache.load_scene_cached(paths, cache_dir=str(d), device="cpu", timings=timings, accel="cluster", **kw)
    return scene, timings["cache"]


def _same_scene(a, b):
    for k in bridge.SCENE_KEYS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in bridge.MATERIAL_KEYS:
        assert torch.equal(getattr(a.materials, k), getattr(b.materials, k)), k
        assert getattr(a.materials, k).dtype == getattr(b.materials, k).dtype
    for k in bridge.MATERIAL_FLAGS:
        assert getattr(a.materials, k) == getattr(b.materials, k)
    for k in bridge.ACCEL_KEYS:
        assert torch.equal(getattr(a.accel, k), getattr(b.accel, k)), k
    for k in bridge.ACCEL_STATICS:
        assert getattr(a.accel, k) == getattr(b.accel, k)


@pytest.mark.parametrize("name", ["mtl", "convention unbundled"])
def test_cache_roundtrip_bitwise(files, tmp_path, name):
    paths, kw = files[name]
    cold, how = _cached(paths, tmp_path, **kw)
    assert how == "miss"
    warm, how = _cached(paths, tmp_path, **kw)
    assert how == "hit"
    _same_scene(cold, warm)
    _same_scene(warm, builder.load_scene(paths, accel="cluster", device="cpu", **kw))
    assert len(os.listdir(tmp_path)) == 1


def test_cache_env_attached_fresh(files, tmp_path):
    from tpu_pathtracer_torch.scene.scene import make_env

    paths, kw = files["mtl"]
    _cached(paths, tmp_path, **kw)
    env = make_env(np.full((4, 8, 3), 0.25, np.float32), "cpu")
    scene, how = _cached(paths, tmp_path, env=env, **kw)
    assert how == "hit" and scene.env is env


def test_cache_invalidated_by_texture_mtime(files, tmp_path):
    paths, kw = files["mtl"]
    _cached(paths, tmp_path, **kw)
    tex = os.path.join(os.path.dirname(paths[0]), "box_albedo.png")
    st = os.stat(tex)
    os.utime(tex, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    try:
        assert _cached(paths, tmp_path, **kw)[1] == "miss"
        assert _cached(paths, tmp_path, **kw)[1] == "hit"
    finally:
        os.utime(tex, ns=(st.st_atime_ns, st.st_mtime_ns))


def test_cache_invalidated_when_a_texture_appears(tmp_path):
    d = tmp_path / "s"
    d.mkdir()
    paths = ts.write_convention_scene(str(d), sizes={"albedo": (8, 8)})
    before, how = _cached(paths, tmp_path / "c")
    assert how == "miss" and _cached(paths, tmp_path / "c")[1] == "hit"
    ts.write_png(str(d / "box_roughness.png"), ts.texture(np.random.RandomState(1), 8, 8, "roughness"))
    after, how = _cached(paths, tmp_path / "c")
    assert how == "miss"
    assert after.materials.attrs[0, 13] == 1.0 and before.materials.attrs[0, 13] == 0.0


def test_cache_torn_entry_is_a_miss(files, tmp_path):
    paths, kw = files["mtl"]
    _cached(paths, tmp_path, **kw)
    (entry,) = os.listdir(tmp_path)
    path = tmp_path / entry
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    assert cache.load_packed_scene(str(path), device="cpu") is None
    scene, how = _cached(paths, tmp_path, **kw)
    assert how == "miss"
    assert _cached(paths, tmp_path, **kw)[1] == "hit"


def test_cache_key_and_deps(files, tmp_path):
    paths, kw = files["mtl"]
    k1 = cache.cache_key(paths, {"scale": 1.0})
    assert k1 == cache.cache_key(paths, {"scale": 1.0}) != cache.cache_key(paths, {"scale": 0.5})
    deps = cache.scene_deps(paths, "mtl", None)
    names = [os.path.basename(p) for p, _, _ in deps]
    assert names[:2] == ["scene.obj", "scene.mtl"] and "box_normal.png" in names
    conv = cache.scene_deps(files["convention bundled"][0], "convention", None)
    assert sum(size == -1 for _, size, _ in conv) == 4  # ball.obj's absent maps
    assert cache.default_cache_dir().endswith(os.path.join(".cache", "tpu_pathtracer_torch", "scenes"))
    assert cache.SCHEMA >= 1 and not cache.cache_key(paths, {}).startswith("0" * 20)


def test_cache_bypass(files, tmp_path, monkeypatch):
    paths, kw = files["mtl"]
    assert _cached(paths, "", **kw)[1] == "off"
    monkeypatch.setenv("TPU_PT_SCENE_CACHE", "0")
    assert _cached(paths, tmp_path, **kw)[1] == "off"
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# scene files

_TOML = """
[scene]
objects = ["scene.obj"]
scale = 0.5
material_source = "mtl"
rng_seed = 0
accel = "cluster"

[environment]
mode = "equirect"
procedural = {{ height = 16, width = 32 }}
importance_sampling = {nee}

[camera]
eye = [0.0, 2.0, 5.0]
lookat = [0.0, 0.6, 0.0]
fov_y = 45.0

[render]
width = 64
height = 48
samples_per_launch = 2
max_depth = 4
dof = false
texture_lod = "{lod}"
"""


@pytest.mark.parametrize("nee", [False, True])
def test_load_scene_file_matches_jax(files, tmp_path, monkeypatch, nee):
    monkeypatch.setenv("TPU_PT_SCENE_CACHE", "0")
    d = os.path.dirname(files["mtl"][0][0])
    path = os.path.join(d, f"scene_{nee}.toml")
    with open(path, "w") as f:
        f.write(_TOML.format(nee=str(nee).lower(), lod="off"))
    t, tcam, tcfg = scenefile.load_scene_file(path, {"max_depth": 3}, device="cpu")
    j, jcam, jcfg = j_scenefile.load_scene_file(path, {"max_depth": 3})
    assert_scene_equal(t, j)
    for k in ("data", "quads"):
        assert np.array_equal(getattr(t.env, k).numpy(), np.asarray(getattr(j.env, k)))
    assert (t.env.alias_table is not None) == nee
    if nee:
        assert np.array_equal(t.env.alias_table.numpy(), np.asarray(j.env.alias_table))
    assert (tcam.eye, tcam.lookat, tcam.fov_y) == (jcam.eye, jcam.lookat, jcam.fov_y)
    for field in ("width", "height", "samples_per_launch", "max_depth", "dof", "env_mode", "rr_mode",
                  "env_importance_sampling"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert tcfg.max_depth == 3 and tcfg.rr_mode == ("standard" if nee else "reference")


def test_load_scene_file_refusals(files, tmp_path):
    d = os.path.dirname(files["mtl"][0][0])
    path = os.path.join(d, "mip.toml")
    with open(path, "w") as f:
        f.write(_TOML.format(nee="false", lod="mip"))
    with pytest.raises(ValueError, match="mip ladder"):
        scenefile.load_scene_file(path, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        scenefile.load_scene_file(path, {"texture_lod": "auto", "bogus": 1}, device="cpu")


def test_repo_scene_files_parse():
    """scenes/spheres.toml (procedural) loads as it is; the others name
    OBJ files outside the checkout."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene, cam, cfg = scenefile.load_scene_file(os.path.join(root, "scenes", "spheres.toml"), device="cpu")
    assert scene.num_triangles > 0 and cfg.env_mode == "sunsky" and cam.eye == (0.0, 2.0, 8.0)
