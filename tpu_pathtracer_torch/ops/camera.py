"""Fresh camera paths as one CUDA kernel (`csrc/camera.cu`): for the lanes
of a mask, the seed hash of the (pixel, sample_offset + sample, subframe)
counters and `generate_camera_rays`, written in place.

It replaces no TPU kernel: it is the port's counterpart of the fusion
XLA makes of the JAX package's `make_seeds` and `generate_camera_rays`
under `jax.jit`.  Its plain version, `camera_paths_plain`, is the port's
eager chain (utils/rng.make_seeds, render/camera.generate_camera_rays and
a select).  The integrator calls `camera_paths` wherever a schedule
spawns camera paths (the stream's initial pool and its respawn, the regen
schedule's start and respawn, the 1-spp schedule's rays): on a CUDA
device it launches the kernel, on the CPU and under `ops.cuda_build.plain()`
it runs the plain version.

A lane's pixel is pix[min(i // per, n_ids - 1)] from an id table, else
base + i // per (an affine range; the identity without a base); its
sample is min(sample[i], sample_max) from a table, else i % per.  The
counters are 0-d int64 tensors on the device (a Python int becomes one,
filled on the device), so that a captured graph replays each frame's.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from tpu_pathtracer_torch.ops.bounce import _launch, _params
from tpu_pathtracer_torch.ops.cuda_build import kernel_arg, on_card
from tpu_pathtracer_torch.render.camera import generate_camera_rays
from tpu_pathtracer_torch.utils import math as vm
from tpu_pathtracer_torch.utils import rng

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class CameraParams(ctypes.Structure):
    """csrc/camera.cu: CameraParams."""

    _fields_ = [(k, _P) for k in (
        "eye", "u", "v", "w", "pix", "base", "sample", "mask", "sample_offset", "subframe",
        "origin", "direction", "seeds",
    )] + [(k, _I) for k in ("n", "per", "n_ids", "sample_max", "width", "dof")] + [
        (k, _F) for k in ("inv_width", "inv_height", "two_pi", "blur", "focus", "eps2")]


def camera_consts(cfg) -> dict:
    """The plain chain's float32 constants under `cfg`: / width and
    / height are products with the float32 reciprocals on the card."""
    f = np.float32
    return dict(inv_width=f(1.0) / f(float(cfg.width)), inv_height=f(1.0) / f(float(cfg.height)),
                two_pi=f(2.0 * math.pi), blur=f(cfg.dof_blurriness), focus=f(cfg.focus_distance),
                eps2=f(vm.EPS * vm.EPS))


def _counter(x, dev) -> torch.Tensor:
    """A seed counter as a 0-d int64 tensor on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to(device=dev, dtype=torch.int64)
    return torch.full((), int(x), dtype=torch.int64, device=dev)


def _lane_pixels(n: int, dev, pix=None, base=None, per: int = 1, sample=None, sample_max: int = 0):
    """(pixel, sample) of each of n lanes by the rule above, as [n] int32
    tensors (the plain version's)."""
    slot = torch.div(torch.arange(n, dtype=torch.int32, device=dev), per, rounding_mode="floor")
    if pix is not None:
        pixel = pix[torch.clamp_max(slot, pix.shape[0] - 1).long()]
    else:
        pixel = slot if base is None else base + slot
    s = (torch.remainder(torch.arange(n, dtype=torch.int32, device=dev), per) if sample is None
         else torch.clamp_max(sample, sample_max))
    return pixel, s


def camera_paths_plain(cam, cfg, subframe, sample_offset, n, *, pix=None, base=None, per=1, sample=None,
                       sample_max=0, mask=None, out=None):
    """The plain version: make_seeds and generate_camera_rays on every lane,
    selected into `out` on the mask.  Returns (origin, direction, seeds)."""
    dev = cam["eye"].device
    pixel, s = _lane_pixels(n, dev, pix, base, per, sample, sample_max)
    seeds = rng.make_seeds(pixel, sample_offset + s, subframe)
    o, d, seeds = generate_camera_rays(cam, pixel % cfg.width, pixel // cfg.width, seeds, cfg)
    if out is None:
        return o, d, seeds
    if mask is None:
        for dst, v in zip(out, (o, d, seeds)):
            dst.copy_(v)
    else:
        for dst, v in zip(out, (o, d, seeds)):
            dst.copy_(torch.where(mask[:, None] if v.dim() == 2 else mask, v, dst))
    return out


def camera_paths_cuda(cam, cfg, subframe, sample_offset, n, *, pix=None, base=None, per=1, sample=None,
                      sample_max=0, mask=None, out=None, dependent=False):
    """Launch the camera kernel on n lanes (the lanes of `mask`, all
    without one), writing into `out` = (origin [n,3], direction [n,3],
    seeds [n] int64) in place, or into new tensors.  Returns (origin,
    direction, seeds).

    `dependent`: launch it as a programmatic dependent of the launch just
    before it on the stream (csrc/launch_order.cuh): the caller vouches
    that that launch writes none of the camera's vectors, the counters and
    `base` (a schedule step, which writes the lanes' pixels, samples and
    mask), and that they are tensors on the device already (a Python
    counter would be filled just before the launch)."""
    dev = cam["eye"].device
    if dependent:
        early = [cam[k] for k in ("eye", "U", "V", "W")] + [sample_offset, subframe] + ([] if base is None else [base])
        if not all(isinstance(x, torch.Tensor) and x.device == dev and x.is_contiguous()
                   and x.dtype == (torch.float32 if x.dim() else torch.int64) for x in early):
            raise ValueError("a dependent camera launch reads the camera and the counters before its wait: they must "
                             "be contiguous device tensors of the kernel's types, not made by a copy or fill here")
    # pixel ids past 2^31 do not occur; an int64 table (an affine range
    # with a tensor base) is read as int32
    pix = pix if pix is None or pix.dtype == torch.int32 else pix.to(torch.int32)
    sample = sample if sample is None or sample.dtype == torch.int32 else sample.to(torch.int32)
    if out is None:
        out = (torch.empty((n, 3), dtype=torch.float32, device=dev),
               torch.empty((n, 3), dtype=torch.float32, device=dev), torch.empty(n, dtype=torch.int64, device=dev))
    tensors = dict(
        eye=kernel_arg("eye", cam["eye"], torch.float32, (3,), dev),
        u=kernel_arg("U", cam["U"], torch.float32, (3,), dev),
        v=kernel_arg("V", cam["V"], torch.float32, (3,), dev),
        w=kernel_arg("W", cam["W"], torch.float32, (3,), dev),
        pix=None if pix is None else kernel_arg("pix", pix, torch.int32, (pix.shape[0],), dev),
        base=None if base is None else _counter(base, dev),
        sample=None if sample is None else kernel_arg("sample", sample, torch.int32, (n,), dev),
        mask=None if mask is None else kernel_arg("mask", mask, torch.bool, (n,), dev),
        sample_offset=_counter(sample_offset, dev), subframe=_counter(subframe, dev),
        origin=kernel_arg("origin", out[0], torch.float32, (n, 3), dev, written=True),
        direction=kernel_arg("direction", out[1], torch.float32, (n, 3), dev, written=True),
        seeds=kernel_arg("seeds", out[2], torch.int64, (n,), dev, written=True),
    )
    ints = dict(n=n, per=per, n_ids=0 if pix is None else pix.shape[0], sample_max=sample_max, width=cfg.width,
                dof=int(cfg.dof))
    params = _params(CameraParams, tensors, ints, None)
    for k, v in camera_consts(cfg).items():
        setattr(params, k, float(v))
    if n:
        _launch("camera.cu", "camera_launch", params, int(dependent),
                stream=torch.cuda.current_stream(dev).cuda_stream)
        camera_paths.launches += 1
    return out


def camera_paths(cam, cfg, subframe, sample_offset, n, dependent=False, **lanes):
    """Fresh camera paths on n lanes by the rule above (keywords as
    camera_paths_plain's): the kernel for a camera on a CUDA device
    outside `ops.cuda_build.plain()` (`dependent` as camera_paths_cuda
    takes it), else the plain version.  Returns (origin, direction,
    seeds)."""
    if on_card(cam["eye"].device):
        return camera_paths_cuda(cam, cfg, subframe, sample_offset, n, dependent=dependent, **lanes)
    return camera_paths_plain(cam, cfg, subframe, sample_offset, n, **lanes)


# Kernel launches since the count was last set to 0.
camera_paths.launches = 0
