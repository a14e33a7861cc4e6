"""Where the port's constructors put their tensors: on the card, unless the
caller names another device (the tests pass device="cpu")."""

from __future__ import annotations

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
