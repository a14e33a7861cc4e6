"""The port's OBJ/MTL parser (Python and native), image codecs (PNG
against PIL, EXR against the JAX package's), logging, profiler, camera
interaction and weighted accumulation, each against its JAX-package
counterpart on the same inputs; and the port's modules importing with
JAX, the JAX package and PIL made unimportable."""

import dataclasses
import io
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_pathtracer.assets import obj as j_obj  # noqa: E402
from tpu_pathtracer.render import film as j_film  # noqa: E402
from tpu_pathtracer.render.camera import Camera as JCamera  # noqa: E402
from tpu_pathtracer.utils import image as j_image  # noqa: E402

from tpu_pathtracer_torch.assets import native, obj  # noqa: E402
from tpu_pathtracer_torch.render import film  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera  # noqa: E402
from tpu_pathtracer_torch.runtime import profiler  # noqa: E402
from tpu_pathtracer_torch.runtime.profiler import xla_trace  # noqa: E402
from tpu_pathtracer_torch.utils import image, logging as plog  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_scenes as ts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("objs"))
    paths = [ts.write_mtl_scene(d, tex=8)] + ts.write_convention_scene(d)
    quad = os.path.join(d, "edge.obj")
    with open(quad, "w") as f:  # a pentagon, a line, a relative-index quad, an unknown usemtl, a continuation
        f.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0.5 1.5 0\nv 0 1 \\\n 0\nvn 0 0 2\nvt 0.25 0.75\n"
                "usemtl nothing\nf 1//1 2//1 3//1 4//1 5//1\nl 1 2\nf -5/1 -4/1 -3/1 -2/1\nf 1 2\nfoo bar\n")
    return d, paths + [quad]


def _model_equal(a, b):
    for k in ("vertices", "normals", "texcoords"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert [dataclasses.asdict(s) for s in a.shapes] == [dataclasses.asdict(s) for s in b.shapes]
    assert [dataclasses.asdict(m) for m in a.materials] == [dataclasses.asdict(m) for m in b.materials]
    assert a.warnings == b.warnings


def test_parse_obj_matches_jax(scene_dir):
    """ObjModel field for field: negative indices, quads and a pentagon,
    missing normals, usemtl grouping, the PBR MTL keys, warnings."""
    _, paths = scene_dir
    for p in paths:
        _model_equal(obj.parse_obj(p), j_obj.parse_obj(p))


def test_parse_mtl_matches_jax(scene_dir):
    d, _ = scene_dir
    got, want = obj.parse_mtl(os.path.join(d, "scene.mtl")), j_obj.parse_mtl(os.path.join(d, "scene.mtl"))
    assert {k: dataclasses.asdict(m) for k, m in got.items()} == {k: dataclasses.asdict(m) for k, m in want.items()}
    assert got["textured"].roughness == 0.5 and got["textured"].normal_texname == "box_normal.png"
    assert got["glass"].dissolve == 0.3 and got["light"].emission == (6.0, 5.0, 4.0)


@pytest.mark.parametrize("scale,skip", [(1.0, False), (0.05, False), (1.0, True)])
def test_triangulate_matches_jax(scene_dir, scale, skip):
    _, paths = scene_dir
    for p in paths:
        got = obj.triangulate(obj.parse_obj(p), scale=scale, skip_non_triangles=skip)
        want = j_obj.triangulate(j_obj.parse_obj(p), scale=scale, skip_non_triangles=skip)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("scale,skip", [(1.0, False), (0.05, True)])
def test_native_matches_python_and_jax(scene_dir, scale, skip):
    """The port's copy of the native parser against its Python parser and
    JAX's triangulate, bit for bit, with usemtl names in first-use order."""
    _, paths = scene_dir
    before = native.used_native()
    for p in paths:
        out = native.parse_obj_native(p, scale, skip)
        assert out is not None, "the native parser did not build"
        tv, tn, tuv, tm, names, _ = out
        model = obj.parse_obj(p)
        py = obj.triangulate(model, scale=scale, skip_non_triangles=skip)
        jx = j_obj.triangulate(j_obj.parse_obj(p), scale=scale, skip_non_triangles=skip)
        for a, b, c in zip((tv, tn, tuv), py, jx):
            assert np.array_equal(a, b) and np.array_equal(a, c)
        # Faces under a known usemtl name the same material (an unknown
        # name is -1 to the Python parser and a name of its own to the
        # native one, in both packages).
        mat_names = [m.name for m in model.materials]
        known = py[3] >= 0
        assert [mat_names[i] for i in py[3][known]] == [names[i] for i in tm[known]]
    assert native.used_native() == before + len(paths)
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.is_relative_to(os.path.join(REPO, "build"))


def test_native_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_obj_native(str(tmp_path / "missing.obj"))


# ---------------------------------------------------------------------------
# PNG

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _filter_rows(rows, kinds, bpp):
    """Reference PNG row filtering, byte by byte."""
    out, prev = [], bytes(len(rows[0]))
    for r, k in zip(rows, kinds):
        f = bytearray(len(r))
        for i in range(len(r)):
            a = r[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            if k == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) // 2)[k]
            f[i] = (r[i] - pred) & 0xFF
        out.append(bytes([k]) + bytes(f))
        prev = r
    return b"".join(out)


def _png(arr, color, kinds, palette=None, depth=8, interlace=0):
    h, w = arr.shape[:2]

    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes())
    data = _filter_rows([arr[y].tobytes() for y in range(h)], kinds, _CHANNELS[color])
    # two IDAT chunks: the stream may be split anywhere
    z = zlib.compress(data)
    body += chunk(b"IDAT", z[:7]) + chunk(b"IDAT", z[7:])
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b"")


@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("color", [0, 2, 3, 4, 6])
def test_png_decode_matches_pil(color, filters):
    """Every colour type under every row filter, bit for bit against
    PIL's Image.open(...).convert("RGB")."""
    Image = pytest.importorskip("PIL.Image")
    rs = np.random.RandomState(color * 7 + len(filters))
    h, w = 11, 13
    arr = rs.randint(0, 256, (h, w, _CHANNELS[color])).astype(np.uint8)
    palette = None
    if color == 3:
        palette = rs.randint(0, 256, (37, 3)).astype(np.uint8)
        arr %= 37
    names = ["none", "sub", "up", "average", "paeth"]
    kinds = list(rs.randint(0, 5, h)) if filters == "mixed" else [names.index(filters)] * h
    data = _png(arr, color, kinds, palette)
    got = image.decode_png(data)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    assert np.array_equal(got, want)


def test_png_textures_match_pil(tmp_path):
    """The textures the tests write (PIL's adaptive filters), decoded as
    PIL decodes them, and load_image equal to the JAX package's."""
    Image = pytest.importorskip("PIL.Image")
    rs = np.random.RandomState(0)
    for kind in ts.KINDS:
        p = str(tmp_path / f"t_{kind}.png")
        ts.write_png(p, ts.texture(rs, 48, 40, kind))
        assert np.array_equal(image.load_png(p), np.asarray(Image.open(p).convert("RGB")))
        got, want = image.load_image(p), j_image.load_image(p)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


def test_png_encode_roundtrip():
    """The encoder's output read back by PIL and by the port's decoder."""
    Image = pytest.importorskip("PIL.Image")
    img = np.random.RandomState(3).randint(0, 256, (21, 34, 3)).astype(np.uint8)
    for level in (1, 6, 9):
        data = image.encode_png(img, level)
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img)
        assert np.array_equal(image.decode_png(data), img)


def test_save_png_matches_jax_pixels(tmp_path):
    """save_png and the JAX package's (PIL) save_png: the same pixels."""
    pytest.importorskip("PIL")
    img = np.random.RandomState(4).randint(0, 256, (9, 14, 3)).astype(np.uint8)
    image.save_image(str(tmp_path / "a.png"), img)
    j_image.save_image(str(tmp_path / "b.png"), img)
    assert np.array_equal(image.load_png(str(tmp_path / "a.png")), image.load_png(str(tmp_path / "b.png")))


@pytest.mark.parametrize("case", ["16-bit", "interlaced", "not png", "bad crc", "jpeg name"])
def test_png_refuses_what_it_does_not_read(tmp_path, case):
    arr = np.zeros((4, 4, 3), np.uint8)
    data = {
        "16-bit": _png(arr, 2, [0] * 4, depth=16),
        "interlaced": _png(arr, 2, [0] * 4, interlace=1),
        "not png": b"GIF89a" + bytes(30),
        "bad crc": _png(arr, 2, [0] * 4)[:-1] + b"\x00",
        "jpeg name": b"\xff\xd8\xff\xe0" + bytes(30),
    }[case]
    p = tmp_path / ("x.jpg" if case == "jpeg name" else "x.png")
    p.write_bytes(data)
    with pytest.raises(ValueError, match=str(p).replace(".", r"\.")):
        image.load_image(str(p))


# ---------------------------------------------------------------------------
# EXR, PPM


@pytest.mark.parametrize("compression", [0, 2, 3])
def test_exr_bytes_match_jax(tmp_path, compression):
    """save_exr writes the JAX package's bytes; both load each other's
    file back exactly, compressible or not."""
    rs = np.random.RandomState(compression)
    smooth = np.linspace(0.0, 5.0, 37 * 23 * 3, dtype=np.float32).reshape(23, 37, 3)
    for k, img in enumerate((rs.rand(23, 37, 3).astype(np.float32) * 8.0, smooth)):
        a, b = str(tmp_path / f"a{k}.exr"), str(tmp_path / f"b{k}.exr")
        image.save_exr(a, img, compression=compression)
        j_image.save_exr(b, img, compression=compression)
        assert open(a, "rb").read() == open(b, "rb").read()
        assert np.array_equal(image.load_exr(b), img) and np.array_equal(j_image.load_exr(a), img)


def test_exr_rejects_garbage(tmp_path):
    p = tmp_path / "bad.exr"
    p.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError):
        image.load_exr(str(p))


def test_save_image_ppm_and_exr(tmp_path):
    img = np.random.RandomState(5).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    image.save_image(str(tmp_path / "a.ppm"), img)
    j_image.save_image(str(tmp_path / "b.ppm"), img)
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()
    image.save_image(str(tmp_path / "a.exr"), img)
    assert np.array_equal(image.load_image(str(tmp_path / "a.exr")), img.astype(np.float32))


@pytest.mark.parametrize("header", [
    b"P6\n7 5\n255\n", b"P6 7 5 255 ", b"P6\n# a comment\n7 # the width\n5\n255\n", b"P5\n7 5\n255\n",
])
def test_ppm_load_matches_jax(tmp_path, header):
    """load_image of binary PPM and PGM files, comments in the header
    included, equals the JAX package's (PIL's)."""
    rs = np.random.RandomState(len(header))
    arr = rs.randint(0, 256, (5, 7, 1 if header.startswith(b"P5") else 3)).astype(np.uint8)
    p = tmp_path / "x.ppm"
    p.write_bytes(header + arr.tobytes())
    got, want = image.load_image(str(p)), j_image.load_image(str(p))
    assert got.dtype == want.dtype == np.float32 and got.shape == (5, 7, 3)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["16-bit", "truncated data", "truncated header"])
def test_ppm_refuses_what_it_does_not_read(tmp_path, case):
    data = {
        "16-bit": b"P6\n2 2\n65535\n" + bytes(24),
        "truncated data": b"P6\n2 2\n255\n" + bytes(5),
        "truncated header": b"P6\n2",
    }[case]
    p = tmp_path / "x.ppm"
    p.write_bytes(data)
    with pytest.raises(ValueError, match=str(p).replace(".", r"\.")):
        image.load_image(str(p))


# ---------------------------------------------------------------------------
# logging, profiler, camera, accumulation


def test_logging_format_and_levels(capsys):
    plog.set_verbosity(4)
    plog.info("scene", "hello")
    plog.debug("scene", "hidden")
    plog.warn_once("tag", "once")
    plog.warn_once("tag", "once")
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0].startswith("[ 4][       scene][") and err[0].endswith("]: hello")
    assert err[1].startswith("[ 3][         tag][")


def test_profiler(tmp_path):
    """The span recorder: off by default, spans with their parents while
    on, clear(); xla_trace writes the Chrome trace and the spans beside
    it, and leaves the recorder as it found it."""
    profiler.clear()
    with profiler.span("render"):
        pass
    assert profiler.spans() == [] and not profiler.enabled()
    profiler.enable()
    with profiler.span("render"):
        with profiler.span("read"):
            pass
    profiler.disable()
    (render, read) = profiler.spans()
    assert render[0] == "render" and render[3] is None and read[3] == 0 and render[1] <= read[1] <= read[2] <= render[2]
    assert set(profiler.self_times()) == {"render", "read"}
    profiler.clear()
    assert not profiler.spans()
    with xla_trace(str(tmp_path / "trace")):
        with profiler.span("render"):
            torch.ones(8).sum()
    files = sorted(os.listdir(tmp_path / "trace"))
    assert len(files) == 2 and files[0].startswith("spans-") and files[1].startswith("trace-")
    with open(tmp_path / "trace" / files[0]) as f:
        assert [s[0] for s in json.load(f)["spans"]] == ["render"]
    assert not profiler.enabled()
    profiler.clear()


@pytest.mark.parametrize("move", ["orbit", "orbit_clamped", "zoom", "pan"])
def test_camera_interaction_matches_jax(move):
    args = {"orbit": (25.0, -10.0), "orbit_clamped": (5.0, 120.0), "zoom": (0.8,), "pan": (0.3, -0.2)}[move]
    name = move.split("_")[0]
    t = getattr(Camera(eye=(0.5, 2.0, 6.0), lookat=(0.0, 0.5, 0.0)), name)(*args)
    j = getattr(JCamera(eye=(0.5, 2.0, 6.0), lookat=(0.0, 0.5, 0.0)), name)(*args)
    assert t.eye == j.eye and t.lookat == j.lookat and t.up == j.up


def test_accumulate_weighted_equals_accumulate_at_constant_spp():
    """Bit for bit over 40 launches of 10 spp: the float32 quotient
    10/(10(k+1)) is 1/(k+1)."""
    rs = np.random.RandomState(6)
    acc_a = acc_b = None
    for k in range(40):
        frame = torch.as_tensor(rs.rand(6, 5, 3).astype(np.float32) * 3.0)
        acc_a = frame if k == 0 else film.accumulate(acc_a, frame, k)
        acc_b = frame if k == 0 else film.accumulate_weighted(acc_b, frame, 10 * k, 10)
        assert torch.equal(acc_a, acc_b), k


def test_accumulate_weighted_matches_jax_on_a_ramp():
    """The converge ramp's 1, 1, 2, 4, 8 spp launches, then 10s: equal to
    the JAX package's accumulate_weighted bit for bit."""
    rs = np.random.RandomState(7)
    acc_t, acc_j, spp = None, None, 0
    for n in (1, 1, 2, 4, 8, 10, 10):
        frame = rs.rand(6, 5, 3).astype(np.float32) * 3.0
        acc_t = film.accumulate_weighted(acc_t, torch.as_tensor(frame), spp, n)
        acc_j = np.asarray(j_film.accumulate_weighted(acc_j if acc_j is not None else np.zeros_like(frame),
                                                      frame, spp, n))
        spp += n
        assert np.array_equal(acc_t.numpy(), acc_j)


# ---------------------------------------------------------------------------
# imports

_BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_pathtracer", "PIL", "flax"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in list(sys.modules):
    if m.split(".")[0] in ("jax", "jaxlib", "tpu_pathtracer", "PIL", "flax"):
        del sys.modules[m]
import pkgutil, importlib, tpu_pathtracer_torch
names = [m.name for m in pkgutil.walk_packages(tpu_pathtracer_torch.__path__, "tpu_pathtracer_torch.")]
for n in names:
    importlib.import_module(n)
assert {"tpu_pathtracer_torch.cli", "tpu_pathtracer_torch.viewer", "tpu_pathtracer_torch.bench",
        "tpu_pathtracer_torch.tools.compare_images", "tpu_pathtracer_torch.tools.exp_nee_quality",
        "tpu_pathtracer_torch.render.graph_loop",
        "tpu_pathtracer_torch.ops.bounce", "tpu_pathtracer_torch.ops.camera"} <= set(names)
assert not any(m.split(".")[0] in ("jax", "tpu_pathtracer", "PIL") for m in sys.modules)
print(len(names))
"""


def test_port_imports_without_jax_or_pil():
    """Every module of the port, the cli, viewer, bench, comparison gate and
    NEE quality study included, imports in a process where jax, the JAX package and PIL
    cannot be imported."""
    out = subprocess.run([sys.executable, "-c", _BLOCK], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30
