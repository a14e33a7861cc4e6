"""Rejection sampling in the unit ball, per lane: one CUDA kernel on the
card (`csrc/unit_sphere.cu`), the plain version
(`utils.rng.random_in_unit_sphere_plain`) on the CPU.

Counterpart of the JAX package's `utils/rng.py: random_in_unit_sphere`, a
`lax.while_loop` that the port's eager loop could only end by reading the
device.  Every `_shade` calls it once (twice under `seed_advance_quirk`).
"""

from __future__ import annotations

import torch

from tpu_pathtracer_torch.ops.cuda_build import check_tensor, library
from tpu_pathtracer_torch.utils import rng


def random_in_unit_sphere_cuda(seed: torch.Tensor):
    """Launch the kernel on a CUDA tensor; same contract as the plain
    version."""
    if not seed.is_cuda:
        raise ValueError(f"the kernel needs a CUDA tensor, got {seed.device}")
    flat = seed.reshape(-1)
    n = flat.shape[0]
    check_tensor("seed", flat, torch.int64, (n,), seed.device)
    seed_out = torch.empty_like(flat)
    p = torch.empty((n, 3), dtype=torch.float32, device=seed.device)
    if n:
        err = library("unit_sphere.cu").unit_sphere_launch(
            flat.data_ptr(), seed_out.data_ptr(), p.data_ptr(), n,
            torch.cuda.current_stream(seed.device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"unit_sphere_kernel launch failed: CUDA error {err}")
        random_in_unit_sphere.launches += 1
    return seed_out.reshape(seed.shape), p.reshape(*seed.shape, 3)


def random_in_unit_sphere(seed: torch.Tensor):
    """Rejection-sample points in the unit ball, per lane (the JAX
    package's `random_in_unit_sphere`): the kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns (new_seed, p [...,3])."""
    if seed.is_cuda:
        return random_in_unit_sphere_cuda(seed)
    if seed.device.type != "cpu":
        raise ValueError(f"no unit-ball sampler for device {seed.device}")
    return rng.random_in_unit_sphere_plain(seed)


# Kernel launches since the count was last set to 0.
random_in_unit_sphere.launches = 0
