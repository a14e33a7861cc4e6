"""Counter-seeded, per-lane PCG chains on int64 tensors.

Bit-exact with `tpu_pathtracer/utils/rng.py`.  PyTorch has no arithmetic on
`uint32` tensors (add and right shift are not implemented), so every seed
is an int64 tensor that holds a 32-bit value, masked back to 32 bits after
each operation.  A product can exceed 2^63; int64 arithmetic wraps modulo
2^64, which keeps the low 32 bits right.

Nothing here builds a tensor from host data: Python numbers enter the
arithmetic as scalars, so the render loop queues these ops without a
stream sync.  The unit-ball sampler's plain version is here; its kernel
and the dispatch between the two are `ops/unit_sphere.py`.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
# 1/2^32: maps a 32-bit value to [0, 1).  A float32 tensor times this
# Python float is a float32 product on every device, by exactly 2^-32.
_INV_U32 = 2.3283064365386963e-10


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """One round of the PCG-RXS-M-XS output permutation."""
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def _counter_term(counter, mult: int):
    """counter * mult modulo 2^32: a Python int for a Python int counter
    (no tensor built from it), else an int64 tensor holding u32."""
    if isinstance(counter, int):
        return (counter * mult) & MASK32
    return (torch.as_tensor(counter).to(torch.int64) & MASK32) * mult & MASK32


def make_seeds(pixel_id, sample_id, subframe) -> torch.Tensor:
    """Initial seed hash(pixel, sample, subframe) as int64 holding u32."""
    p = torch.as_tensor(pixel_id).to(torch.int64) & MASK32
    h = pcg_hash(p ^ 0x9E3779B9)
    h = pcg_hash((h + _counter_term(sample_id, 0x85EBCA6B)) & MASK32)
    h = pcg_hash((h + _counter_term(subframe, 0xC2B2AE35)) & MASK32)
    return h | 1


def uniform(seed: torch.Tensor):
    """Advance each lane's chain once.  Returns (new_seed, u in [0,1]).

    The u32 -> f32 conversion rounds to nearest even, as XLA's does, so
    values near 2^32 round up to exactly 1.0 there too."""
    seed = pcg_hash(seed)
    return seed, seed.to(torch.float32) * _INV_U32


def uniform2(seed: torch.Tensor):
    seed, u1 = uniform(seed)
    seed, u2 = uniform(seed)
    return seed, u1, u2


def uniform3(seed: torch.Tensor):
    seed, u1 = uniform(seed)
    seed, u2 = uniform(seed)
    seed, u3 = uniform(seed)
    return seed, u1, u2, u3


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    # Left-to-right sum, the order of XLA's reduction over the 3-axis:
    # acceptance at |p| ~ 1 decides how far each seed chain advances.
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]


def random_in_unit_sphere_plain(seed: torch.Tensor, draws_per_check: int = 8):
    """Rejection-sample points in the unit ball, per lane: the plain
    version of the kernel in csrc/unit_sphere.cu (the JAX package's
    `lax.while_loop`).

    Accepted lanes stop advancing their seed, so each lane's draw count is
    that of a scalar loop.  The loop checks for completion only every
    `draws_per_check` draws (one host read each): extra draws after every
    lane has accepted are masked no-ops, so the result does not depend on
    it.  Returns (new_seed, p [...,3])."""

    def draw(seed):
        seed, u1, u2, u3 = uniform3(seed)
        return seed, 2.0 * torch.stack([u1, u2, u3], dim=-1) - 1.0

    seed, p = draw(seed)
    accepted = _sq_norm(p) < 1.0
    while not bool(accepted.all()):
        for _ in range(draws_per_check):
            seed_n, p_n = draw(seed)
            seed = torch.where(accepted, seed, seed_n)
            p = torch.where(accepted[..., None], p, p_n)
            accepted = accepted | (_sq_norm(p_n) < 1.0)
    return seed, p


def cosine_sample_hemisphere(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere sample with the cosine axis in +y."""
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    x = r * torch.cos(phi)
    z = r * torch.sin(phi)
    y = torch.sqrt(torch.clamp_min(1.0 - x * x - z * z, 0.0))
    return torch.stack([x, y, z], dim=-1)
