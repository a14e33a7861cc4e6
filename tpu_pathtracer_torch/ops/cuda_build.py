"""Build the CUDA sources of this package into shared libraries and load them.

The sources in `tpu_pathtracer_torch/csrc/` have a plain C interface, so
they compile with `nvcc` alone in seconds (no PyTorch headers) and bind
with `ctypes`.  Libraries go to `build/tpu_pathtracer_torch/` at the root
of the checkout, named by a hash of every file in `csrc/` (a source and
the headers it includes) and the flags, and are built at first use.
`nvcc`'s `-Xptxas -v` report (registers, shared memory, spills) is kept
beside each library as a `.log` file.  `library(source)` loads one and
sets the argument types of its launch function from `LAUNCHERS` and of
its other functions from `HELPERS`.

The wrappers of the kernels that stand in for the JAX package's fused
eager work (the brute-force traversal, the bounce's shading, NEE, the
camera spawn, the schedule steps, the traversal's ray ordering) launch
them where `on_card` says,
and take their tensors through `kernel_arg`; `plain()` is the A/B switch
that runs their plain versions on the card too.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_pathtracer_torch"

# -fmad=false: no contraction of a*b+c into one rounding, so a kernel
# computes what its plain PyTorch version computes, op for op.  Without
# --use_fast_math division and square root stay IEEE-rounded.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# source: (its launch function, the function's argument types)
LAUNCHERS = {
    "cluster_intersect.cu": (
        "cluster_intersect_launch",
        [_P] * 6 + [_I] * 3 + [_F] * 2 + [_I] * 2 + [_P] * 6,
    ),
    "cluster_hier.cu": (
        "cluster_hier_launch",
        [_P] * 7 + [_I] * 5 + [_F] * 2 + [_I] * 2 + [_P] * 6,
    ),
    "cluster_streamed.cu": (
        "cluster_streamed_launch",
        [_P] * 6 + [_I] * 5 + [_F] * 2 + [_I] * 2 + [_P] * 6,
    ),
    "cluster_occluded.cu": (
        "cluster_occluded_launch",
        [_P] * 6 + [_I] * 3 + [_F] * 2 + [_I] * 2 + [_P] * 3,
    ),
    "cluster_occluded_hier.cu": (
        "cluster_occluded_hier_launch",
        [_P] * 7 + [_I] * 5 + [_F] * 2 + [_I] * 2 + [_P] * 3,
    ),
    "cluster_occluded_streamed.cu": (
        "cluster_occluded_streamed_launch",
        [_P] * 6 + [_I] * 5 + [_F] * 2 + [_I] * 2 + [_P] * 3,
    ),
    # the launch's arguments by pointer (a struct mirrored by ctypes), the
    # entry point (the stream step or the path step), whether it is a
    # programmatic dependent of the launch before it (the path step only),
    # the stream
    "fused_schedule.cu": ("fused_step_launch", [_P, _I, _I, _P]),
    "unit_sphere.cu": ("unit_sphere_launch", [_P] * 3 + [_I] + [_P]),
    # the launch's arguments by pointer (a struct mirrored by ctypes), the
    # bounce kernel's entry point, the stream
    "bounce.cu": ("bounce_launch", [_P, _I, _P]),
    # the launch's arguments by pointer, whether it is a programmatic
    # dependent of the launch before it (csrc/launch_order.cuh), the stream
    "nee.cu": ("nee_launch", [_P, _I, _P]),
    "camera.cu": ("camera_launch", [_P, _I, _P]),
    # the sort: origins, directions, scene lo, hi, active (or null), n,
    # spatial bits, direction bits, digit passes, key and index scratch
    # (null up to 16,384 rays), the status scratch, tiles, origins out,
    # directions out, perm out, stream; the packet order is a HELPER of
    # the same library
    "ray_sort.cu": ("ray_sort_rays_launch", [_P] * 5 + [_I] * 4 + [_P] * 3 + [_I] * 2 + [_P] * 4),
    # brute force: any hit (0 or 1), vertices, triangles, origins,
    # directions, active (or null), n, t_min, t_max, t, prim, bary and hit
    # out (any hit: the flags into hit), stream
    "brute.cu": ("brute_launch", [_I, _P, _LL, _P, _P, _P, _LL, _F, _F] + [_P] * 5),
}
# source: {another function of its library: the function's argument types}.
# The traversal kernels (flat, hier and streamed) have a packet-weight
# pre-pass (boxes, rays, n, boxes' count, t_min, t_max, rays per packet,
# weights out, stream) and a launch-shape query (n, rays per packet,
# cluster_k, tri_test, int out[6]).
_WEIGHTS = [_P] * 3 + [_I] * 2 + [_F] * 2 + [_I] + [_P] * 2
_SHAPE = [_I] * 4 + [ctypes.POINTER(ctypes.c_int)]
HELPERS = {
    f"{stem}.cu": {f"{stem}_weights": _WEIGHTS, f"{stem}_shape": _SHAPE}
    for stem in ("cluster_intersect", "cluster_hier", "cluster_streamed",
                 "cluster_occluded", "cluster_occluded_hier", "cluster_occluded_streamed")
}
# The shading kernels and the schedule steps report the size of their
# argument struct; the bounce kernel's library also holds the probe of the
# math functions it calls (a, b, out, n, which function, pow's exponent,
# stream)
HELPERS.update({f"{stem}.cu": {f"{stem}_params_size": []}
                for stem in ("bounce", "nee", "camera", "fused_schedule")})
HELPERS["bounce.cu"]["shade_math_probe"] = [_P] * 3 + [_I] * 2 + [_F] + [_P]
# and the report of what the card made of its kernels (entry, int out[5])
HELPERS["bounce.cu"]["bounce_attributes"] = [_I, ctypes.POINTER(ctypes.c_int)]
# and the size of the schedule steps' scratch (entry, tiles)
HELPERS["fused_schedule.cu"]["fused_step_scratch_words"] = [_I, _I]
# The ray ordering's other kernel: the packet order (weights, packets,
# order out, stream).
HELPERS["ray_sort.cu"] = {"ray_sort_order_launch": [_P] + [_I] + [_P] * 2}
# The brute-force kernels' launch shape (n, any hit, int out[5]).
HELPERS["brute.cu"] = {"brute_shape": [_LL, _I, ctypes.POINTER(ctypes.c_int)]}


def check_tensor(name, x, dtype, shape, dev) -> None:
    """Raise unless `x` is what a kernel takes: on `dev`, of `dtype` and
    `shape`, contiguous."""
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


_plain = False


@contextlib.contextmanager
def plain():
    """Within the block, the wrappers that follow this switch run their
    plain versions on the card too (the A/B against the kernels)."""
    global _plain
    was, _plain = _plain, True
    try:
        yield
    finally:
        _plain = was


def is_plain() -> bool:
    return _plain


def on_card(device) -> bool:
    """Whether a wrapper on `device` launches its kernel: a CUDA device
    outside `plain()`.  The CPU runs the plain versions; another device
    has neither and raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return not _plain
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernels or plain versions for device {dev}")


# The most lanes (rays, packets) a kernel's int32 count and index take.
MAX_LANES = 2**31 - 1


def check_lanes(what: str, n: int) -> int:
    """n, refused above MAX_LANES with a message naming the int32 count
    (ctypes would cut a larger int silently)."""
    if n > MAX_LANES:
        raise ValueError(f"{what}: the kernel counts and indexes them with int32: at most {MAX_LANES} (2^31 - 1), "
                         f"got {n}")
    return n


def kernel_arg(name, x, dtype, shape, dev, written=False):
    """`x` as a kernel reads it: contiguous (a copy if not, unless the
    kernel writes it), of `dtype` and `shape`, on `dev`; anything else
    raises."""
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got "
                         f"{x.device if isinstance(x, torch.Tensor) else type(x).__name__}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if written and not x.is_contiguous():
        raise ValueError(f"{name}: the kernel writes it in place, it must be contiguous")
    return x.contiguous()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[str]:
    """Every kernel source (`*.cu`) in csrc/."""
    return sorted(p.name for p in CSRC_DIR.glob("*.cu"))


def library_path(source: str) -> Path:
    """Where the library built from csrc/`source` goes.  The name hashes
    every file in csrc/, so an edit to a shared header rebuilds each
    source that may include it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        if p.is_file():
            h.update(p.name.encode() + b"\0" + p.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_libraries(names=None) -> None:
    """Compile each csrc/ source in `names` (default: all) that has no
    up-to-date library, one nvcc process per source, all started at once."""
    todo = [s for s in (sources() if names is None else names) if not library_path(s).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for s in todo:
        out = library_path(s)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / s)]
        jobs.append((s, out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for s, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {s}:\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def ptxas_report(log: str) -> dict:
    """nvcc's `-Xptxas -v` report (a library's `.log`): {kernel (its
    mangled name): {"registers", "stack", "spill_stores", "spill_loads"}}
    of each entry function, in bytes but registers."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


@functools.lru_cache(maxsize=None)
def library(source: str) -> ctypes.CDLL:
    """The library of csrc/`source`, compiled unless an up-to-date one
    exists, with its launch function's signature set."""
    build_libraries([source])
    lib = ctypes.CDLL(str(library_path(source)))
    launcher, launcher_argtypes = LAUNCHERS[source]
    for name, argtypes in {launcher: launcher_argtypes, **HELPERS.get(source, {})}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
