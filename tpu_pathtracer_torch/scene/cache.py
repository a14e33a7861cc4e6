"""On-disk packed-scene cache: warm loads skip OBJ parsing, PNG decoding
and packing.  Counterpart of `tpu_pathtracer/scene/cache.py`.

A cold `builder.load_scene` decodes every texture and packs the quad,
bundle and accel tables on the host; a CLI render pays that on every
process.  This module keeps the packed arrays (geometry, material table
and texture pools, the cluster accel) as one uncompressed .npz keyed by
the build parameters, so a warm load is one sequential file read and the
upload.  The entries are the port's own (their own directory and a key
that names the package): they restore the port's `MaterialTable` and
`ClusterAccel`.

Invalidation is by dependency fingerprint: the entry records (path,
size, mtime_ns) of every file the build probes: OBJ files, mtllib
targets, the convention-map candidates (including missing ones, so a
texture appearing later invalidates) and MTL-referenced textures.  Any
mismatch rebuilds.  `SCHEMA` must be bumped whenever a packed layout
changes.

The environment map is not cached: the caller builds it and it is
attached fresh, as with `builder.load_scene(env=...)`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.utils.device import DEFAULT_DEVICE, resolve

SCHEMA = 1
_GEOMETRY = ("vertices", "normals", "uvs", "mat_ids", "tri_attrs")
# int64 tensors that hold u32 words: stored as uint32.
_U32 = ("texture_quads", "texture_bundles")


def default_cache_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "tpu_pathtracer_torch", "scenes")


# ---------------------------------------------------------------------------
# dependency fingerprinting


def _sig(path: str) -> Tuple[str, int, int]:
    """(abspath, size, mtime_ns); (-1,-1) for a probed-but-missing file."""
    ap = os.path.abspath(path)
    try:
        st = os.stat(ap)
        return (ap, st.st_size, st.st_mtime_ns)
    except OSError:
        return (ap, -1, -1)


_MTLLIB_RE = re.compile(rb"^\s*mtllib\s+(.+?)\s*$", re.MULTILINE)
_KINDS = ("albedo", "roughness", "normal", "metallic")


def _mtllibs(obj_path: str) -> List[str]:
    """mtllib targets named by an OBJ file (a byte scan, no parse)."""
    try:
        with open(obj_path, "rb") as f:
            data = f.read()
    except OSError:
        return []
    return [m.group(1).decode("utf-8", "replace") for m in _MTLLIB_RE.finditer(data)]


def scene_deps(filenames: Sequence[str], material_source: str, mtl_basepath: Optional[str]) -> List[Tuple[str, int, int]]:
    """Every file the build will probe, with its current signature, in
    builder.load_scene's probe order: per OBJ, the OBJ, its mtllib
    targets, then the four convention-map candidates ("convention") or
    the MTL-referenced textures ("mtl").  Missing files are recorded with
    size -1 so that their later appearance invalidates the entry."""
    from tpu_pathtracer_torch.assets.obj import parse_mtl

    deps: List[Tuple[str, int, int]] = []
    for path in filenames:
        deps.append(_sig(path))
        mdir = mtl_basepath or os.path.dirname(os.path.abspath(path))
        libs = [os.path.join(mdir, lib) for lib in _mtllibs(path)]
        deps.extend(_sig(lib) for lib in libs)
        if material_source == "convention":
            stem = os.path.splitext(path)[0]
            deps.extend(_sig(f"{stem}_{kind}.png") for kind in _KINDS)
        else:
            for lib in libs:
                for m in parse_mtl(lib).values():
                    for texname in (m.diffuse_texname, m.roughness_texname,
                                    m.normal_texname or m.bump_texname, m.metallic_texname):
                        if texname:
                            deps.append(_sig(os.path.join(mdir, texname)))
    return deps


def cache_key(filenames: Sequence[str], params: dict) -> str:
    """Stable entry name from the build parameters (not file contents:
    those are the dependency check's, so an edited scene reuses its
    slot)."""
    blob = json.dumps(
        {"package": "tpu_pathtracer_torch", "schema": SCHEMA,
         "files": [os.path.abspath(p) for p in filenames], "params": params},
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


# ---------------------------------------------------------------------------
# packed save / load


def _split(prefix: str, obj, arrays: dict, statics: dict) -> None:
    """A dataclass's tensor fields into `arrays` and its plain fields into
    `statics`, under `prefix`; private caches are skipped."""
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if f.name.startswith("_") or val is None:
            continue
        if isinstance(val, torch.Tensor):
            a = val.cpu().numpy()
            arrays[prefix + f.name] = a.astype(np.uint32) if f.name in _U32 else a
        else:
            statics[prefix + f.name] = val


def save_packed_scene(path: str, scene, meta: dict) -> None:
    """Write a packed Scene (without its env) and `meta` to an uncompressed
    npz, atomically (a temp file, then a rename): a killed process leaves
    no torn entry."""
    arrays: dict = {f"s.{k}": getattr(scene, k).cpu().numpy() for k in _GEOMETRY}
    statics: dict = {}
    _split("m.", scene.materials, arrays, statics)
    if scene.accel is not None:
        _split("a.", scene.accel, arrays, statics)
    meta = dict(meta, schema=SCHEMA, statics=statics, has_accel=scene.accel is not None)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)

    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _read_meta(npz) -> Optional[dict]:
    try:
        return json.loads(bytes(npz["__meta__"]).decode())
    except Exception:  # noqa: BLE001 — a torn or foreign file is a miss
        return None


def load_packed_scene(path: str, env=None, device=DEFAULT_DEVICE, timings: Optional[dict] = None):
    """The Scene of a cache entry on `device`, or None on any mismatch
    (missing file, schema bump, stale deps, torn write).  `timings`
    receives the seconds of the file read ("read") and of the upload."""
    from tpu_pathtracer_torch.accel.cluster import ClusterAccel
    from tpu_pathtracer_torch.scene.scene import MaterialTable, Scene, default_env

    device = resolve(device)
    t0 = time.perf_counter()
    try:
        npz = np.load(path)
    except Exception:  # noqa: BLE001 — a torn zip raises BadZipFile et al.
        return None
    with npz:
        meta = _read_meta(npz)
        if meta is None or meta.get("schema") != SCHEMA:
            return None
        if any(tuple(dep) != _sig(dep[0]) for dep in meta.get("deps", [])):
            return None
        try:
            host = {name: npz[name] for name in npz.files if name != "__meta__"}
        except Exception:  # noqa: BLE001 — a member torn inside the zip
            return None
    t1 = time.perf_counter()
    statics = meta["statics"]

    def part(prefix, cls):
        kw = {k[len(prefix):]: v for k, v in statics.items() if k.startswith(prefix)}
        for name, a in host.items():
            if name.startswith(prefix):
                a = a.astype(np.int64) if name[len(prefix):] in _U32 else a
                kw[name[len(prefix):]] = torch.as_tensor(a, device=device)
        return cls(**kw)

    scene = Scene(
        **{k: torch.as_tensor(host[f"s.{k}"], device=device) for k in _GEOMETRY},
        materials=part("m.", MaterialTable),
        env=env if env is not None else default_env(device=device),
        accel=part("a.", ClusterAccel) if meta.get("has_accel") else None,
    )
    if timings is not None:
        timings.update(read=t1 - t0, upload=time.perf_counter() - t1)
    return scene


# ---------------------------------------------------------------------------
# the cached loader


def load_scene_cached(
    filenames: Sequence[str],
    env=None,
    cache_dir: Optional[str] = None,
    refresh: bool = False,
    device=DEFAULT_DEVICE,
    timings: Optional[dict] = None,
    **kw,
):
    """`builder.load_scene` behind the packed cache.

    Accepts every load_scene keyword.  `env` is attached fresh either way
    (never cached).  `refresh=True` forces a rebuild.  cache_dir="" (or
    the environment variable TPU_PT_SCENE_CACHE=0) bypasses the cache.
    `timings` receives the load's seconds and "cache": "hit", "miss" or
    "off"."""
    from tpu_pathtracer_torch.scene.builder import load_scene
    from tpu_pathtracer_torch.utils import logging as plog

    timings = {} if timings is None else timings
    if cache_dir == "" or os.environ.get("TPU_PT_SCENE_CACHE") == "0":
        timings["cache"] = "off"
        return load_scene(filenames, env=env, device=device, timings=timings, **kw)
    cache_dir = cache_dir or default_cache_dir()

    params = dict(kw)
    params.pop("use_native", None)  # the two parsers' output is the same
    params["accel_kw"] = sorted((params.pop("accel_kw", None) or {}).items())
    key = cache_key(filenames, {k: params[k] for k in sorted(params)})
    path = os.path.join(cache_dir, f"scene-{key}.npz")

    if not refresh and os.path.exists(path):
        scene = load_packed_scene(path, env=env, device=device, timings=timings)
        if scene is not None:
            timings["cache"] = "hit"
            plog.info("scene", f"packed-scene cache hit: {path}")
            return scene
        plog.info("scene", "packed-scene cache stale; rebuilding")

    # Deps are fingerprinted before the build: a file changing mid-build
    # leaves a stale-looking entry (rebuilt next time), not a wrong one.
    deps = scene_deps(filenames, kw.get("material_source", "convention"), kw.get("mtl_basepath"))
    scene = load_scene(filenames, env=env, device=device, timings=timings, **kw)
    timings["cache"] = "miss"
    try:
        save_packed_scene(path, scene, {"deps": deps})
        plog.info("scene", f"packed-scene cache write: {path}")
    except OSError as e:  # read-only FS / disk full: render anyway
        plog.info("scene", f"packed-scene cache write failed: {e}")
    return scene
