"""Environment lighting, evaluation side: direction -> equirect (u, v),
bilinear fetch from the quad table, procedural sun+sky, `eval_env`.
Counterpart of `tpu_pathtracer/render/envmap.py` (importance sampling is not
ported yet)."""

from __future__ import annotations

import math

import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.scene.scene import SCRAMBLE_MULT, EnvironmentMap
from tpu_pathtracer_torch.utils import math as vm


def direction_to_uv(direction: torch.Tensor):
    """u = 0.5 + atan2(z, x)/2pi;  v = 0.5 - asin(y)/pi."""
    d = vm.normalize(direction)
    u = 0.5 + torch.atan2(d[..., 2], d[..., 0]) / (2.0 * math.pi)
    v = 0.5 - torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def sample_equirect(env: EnvironmentMap, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch at (u, v) in [0,1] through the [H*W,12] quad table:
    x wraps with a floor-mod, y clamps."""
    h, w = env.height, env.width
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xi0 = torch.remainder(x0.to(torch.int32), w)
    yi0 = torch.clamp(y0.to(torch.int32), 0, h - 1)
    rows = yi0 * w + xi0
    if env.quads_scrambled:
        rows = ((rows.to(torch.int64) & 0xFFFFFFFF) * SCRAMBLE_MULT) & (h * w - 1)
    q = env.quads[rows.long()]                              # [N,12]
    c00, c10, c01, c11 = q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12]
    s = (x - x0)[..., None]
    t = (y - y0)[..., None]
    c0 = c00 + (c10 - c00) * s
    c1 = c01 + (c11 - c01) * s
    return c0 + (c1 - c0) * t


def sunsky(direction: torch.Tensor) -> torch.Tensor:
    """A disk of (200,175,125) around normalize(0,2,3), else (0.4,0.4,0.6)."""
    dev = direction.device
    d = vm.normalize(direction)
    sun_dir = vm.normalize(torch.tensor([0.0, 2.0, 3.0], dtype=torch.float32, device=dev))
    in_sun = vm.dot(d, sun_dir) > 0.99
    sun = torch.tensor([200.0, 175.0, 125.0], dtype=torch.float32, device=dev)
    sky = torch.tensor([0.4, 0.4, 0.6], dtype=torch.float32, device=dev)
    return torch.where(in_sun[..., None], sun, sky)


def eval_env(env: EnvironmentMap, direction: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Environment radiance for ray directions [...,3]."""
    if cfg.env_mode == "constant":
        c = torch.tensor(cfg.env_constant, dtype=torch.float32, device=direction.device)
        return c.expand(direction.shape)
    if cfg.env_mode == "sunsky":
        return sunsky(direction)
    u, v = direction_to_uv(direction)
    return sample_equirect(env, u, v)
