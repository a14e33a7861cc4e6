"""Where the port's constructors put their tensors: on the card, unless the
caller names another device (the tests pass device="cpu"); and the small
constant tensors that the render loop reuses on each device; and moving
a scene's tensors to another device."""

from __future__ import annotations

import dataclasses
import functools

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device) -> torch.device:
    """`device` as a torch.device; a CUDA device on a machine without one
    is refused, rather than quietly built on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available: "
            "pass device='cpu' to build on the CPU"
        )
    return dev


@functools.lru_cache(maxsize=None)
def _constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor (a Python number or a tuple of them), built
    once per device and then reused.  Building it from host data copies it
    to the card and waits for every queued kernel (a stream sync), so the
    render loop must not build one per call.  Callers must not write to
    it."""
    return _constant(values, dtype, torch.device(device))


def to_device(obj, device):
    """A copy of the dataclass `obj` (a Scene, its MaterialTable,
    EnvironmentMap or ClusterAccel) with every tensor on `device`, nested
    dataclasses included.  Private cache fields (a leading underscore,
    such as ClusterAccel._pads) start empty again."""
    device = resolve(device)
    kw = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if f.name.startswith("_") and f.default_factory is not dataclasses.MISSING:
            kw[f.name] = f.default_factory()
        elif isinstance(val, torch.Tensor):
            kw[f.name] = val.to(device)
        elif dataclasses.is_dataclass(val):
            kw[f.name] = to_device(val, device)
    return dataclasses.replace(obj, **kw)
