"""ctypes bindings for the native OBJ parser (objparser.cpp), as
`tpu_pathtracer/assets/native/__init__.py`.

Compiled with g++ at first use into `build/tpu_pathtracer_torch/native/`
at the root of the checkout (git-ignored), named by a hash of the source,
so nothing is written inside the package.  `parse_obj_native` returns
None when the toolchain or the build is unavailable, and the scene
builder then takes the pure-Python parser (`assets/obj.py`), whose output
is the same bit for bit; `used_native()` says whether the native parser
has served a call in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "objparser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "tpu_pathtracer_torch" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_build_failed = False
_calls = 0


class _ObjResult(ctypes.Structure):
    _fields_ = [
        ("tri_v", ctypes.POINTER(ctypes.c_float)),
        ("tri_n", ctypes.POINTER(ctypes.c_float)),
        ("tri_uv", ctypes.POINTER(ctypes.c_float)),
        ("tri_mat", ctypes.POINTER(ctypes.c_int32)),
        ("num_tris", ctypes.c_int64),
        ("mat_names", ctypes.c_char_p),
        ("mtl_libs", ctypes.c_char_p),
        ("error", ctypes.c_char_p),
        ("state", ctypes.c_void_p),
    ]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libobjparser-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native parser; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.obj_parse.restype = ctypes.POINTER(_ObjResult)
        lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_float, ctypes.c_int]
        lib.obj_free.argtypes = [ctypes.POINTER(_ObjResult)]
        lib.obj_free.restype = None
        _lib = lib
        return _lib


def used_native() -> int:
    """Calls of parse_obj_native that the native parser served."""
    return _calls


def parse_obj_native(
    path: str, scale: float = 1.0, skip_non_triangles: bool = False
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list, list]]:
    """Parse with the native library.

    Returns (vertices [T,3,3], normals [T,3,3], uvs [T,3,2],
    face_mat_ids [T] — indices into usemtl first-use order, -1 none,
    usemtl_names, mtllib_names) or None when the library is unavailable.
    Raises FileNotFoundError for a missing file.
    """
    global _calls
    lib = get_lib()
    if lib is None:
        return None
    res = lib.obj_parse(os.fspath(path).encode(), ctypes.c_float(scale), int(skip_non_triangles))
    try:
        r = res.contents
        if r.error:
            raise FileNotFoundError(r.error.decode())
        t = int(r.num_tris)
        names = (r.mat_names or b"").decode().split("\n")[:-1]
        libs = (r.mtl_libs or b"").decode().split("\n")[:-1]
        _calls += 1
        if t == 0:
            return (
                np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3, 2), np.float32),
                np.zeros((0,), np.int32),
                names,
                libs,
            )
        tv = np.ctypeslib.as_array(r.tri_v, shape=(t, 3, 3)).copy()
        tn = np.ctypeslib.as_array(r.tri_n, shape=(t, 3, 3)).copy()
        tuv = np.ctypeslib.as_array(r.tri_uv, shape=(t, 3, 2)).copy()
        tm = np.ctypeslib.as_array(r.tri_mat, shape=(t,)).copy()
        return tv, tn, tuv, tm, names, libs
    finally:
        lib.obj_free(res)
