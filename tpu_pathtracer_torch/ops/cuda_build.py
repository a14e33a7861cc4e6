"""Build a CUDA source of this package into a shared library and load it.

The sources in `tpu_pathtracer_torch/csrc/` have a plain C interface, so
they compile with `nvcc` alone in seconds (no PyTorch headers) and bind
with `ctypes`.  Libraries go to `build/tpu_pathtracer_torch/` at the root
of the checkout, named by a hash of the source and the flags, and are
built at first use.  `nvcc`'s `-Xptxas -v` report (registers, shared
memory, spills) is kept beside each library as a `.log` file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(source: str) -> Path:
    """Where the library built from csrc/`source` goes."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_library(source: str) -> ctypes.CDLL:
    """Compile csrc/`source` unless an up-to-date library exists; load it."""
    out = library_path(source)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
            capture_output=True, text=True,
        )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
