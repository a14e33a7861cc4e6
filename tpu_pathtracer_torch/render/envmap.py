"""Environment lighting: direction <-> equirect (u, v), bilinear fetch from
the quad table, procedural sun+sky, `eval_env`, and importance sampling of
the environment for next-event estimation.

Counterpart of `tpu_pathtracer/render/envmap.py`.  Two samplers over the
luminance * sin(theta) texel distribution: CDF tables (`build_env_cdf`,
`sample_env`, `env_pdf`), the textbook method kept for tests, and a Vose
alias table (`build_env_alias`, `sample_env_alias`, `env_pdf_alias`), one
row gather per draw, which the NEE path uses.  The alias table is built in
numpy float64, as the JAX package builds it, so the two tables are the
same bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.scene.scene import SCRAMBLE_MULT, EnvironmentMap
from tpu_pathtracer_torch.utils import math as vm
from tpu_pathtracer_torch.utils.device import constant

_LUMA = (0.2126, 0.7152, 0.0722)


def direction_to_uv(direction: torch.Tensor):
    """u = 0.5 + atan2(z, x)/2pi;  v = 0.5 - asin(y)/pi."""
    d = vm.normalize(direction)
    u = 0.5 + torch.atan2(d[..., 2], d[..., 0]) / (2.0 * math.pi)
    v = 0.5 - torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def uv_to_direction(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inverse of direction_to_uv."""
    phi = (u - 0.5) * (2.0 * math.pi)
    theta = (0.5 - v) * math.pi          # elevation; y = sin(theta)
    y = torch.sin(theta)
    c = torch.cos(theta)
    return torch.stack([c * torch.cos(phi), y, c * torch.sin(phi)], dim=-1)


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
    sun_dir = vm.normalize(constant((0.0, 2.0, 3.0), torch.float32, dev))
    in_sun = vm.dot(d, sun_dir) > 0.99
    sun = constant((200.0, 175.0, 125.0), torch.float32, dev)
    sky = constant((0.4, 0.4, 0.6), torch.float32, dev)
    return torch.where(in_sun[..., None], sun, sky)


def eval_env(env: EnvironmentMap, direction: torch.Tensor, cfg: RenderConfig, active=None, uv=None) -> torch.Tensor:
    """Environment radiance for ray directions [...,3].

    `uv`: the exact equirect (u, v) when the caller has them (an alias
    draw computes its direction from them), so the radiance is fetched
    where the pdf was computed.  `active` is accepted for the JAX
    signature; lanes outside it are computed all the same (the TPU's
    gather-spreading trick is not needed here).  Both are ignored by the
    constant and sunsky modes."""
    del active
    if cfg.env_mode == "constant":
        c = constant(tuple(cfg.env_constant), torch.float32, direction.device)
        return c.expand(direction.shape)
    if cfg.env_mode == "sunsky":
        return sunsky(direction)
    u, v = uv if uv is not None else direction_to_uv(direction)
    return sample_equirect(env, u, v)


# ---------------------------------------------------------------------------
# Importance sampling
# ---------------------------------------------------------------------------

def _texel_weights(data: torch.Tensor):
    """luminance * sin(theta) + 1e-12 per texel [H,W], and theta [H] at the
    row centres."""
    h = data.shape[0]
    lum = data[..., 0] * _LUMA[0] + data[..., 1] * _LUMA[1] + data[..., 2] * _LUMA[2]
    theta = (torch.arange(h, dtype=torch.float32, device=data.device) + 0.5) / h * math.pi
    return lum * torch.sin(theta)[:, None] + 1e-12, theta


def build_env_cdf(env: EnvironmentMap) -> EnvironmentMap:
    """Marginal row CDF [H] and conditional column CDFs [H,W]."""
    weights, _ = _texel_weights(env.data)
    row_sums = weights.sum(dim=1)
    cdf_rows = torch.cumsum(row_sums, dim=0) / row_sums.sum()
    cdf_cols = torch.cumsum(weights, dim=1) / row_sums[:, None]
    return env.replace(cdf_rows=cdf_rows, cdf_cols=cdf_cols)


def _texel_pdf(env: EnvironmentMap, row, col):
    """Solid-angle pdf of the CDF sampler at texel (row, col)."""
    h, w = env.height, env.width
    weights, theta = _texel_weights(env.data)
    p_texel = weights[row, col] / weights.sum()
    sin_theta = torch.clamp_min(torch.sin(theta)[row], 1e-6)
    return p_texel * (h * w) / (2.0 * math.pi * math.pi * sin_theta)


def sample_env(env: EnvironmentMap, u1: torch.Tensor, u2: torch.Tensor):
    """Draw env directions by luminance through the CDF tables.  Returns
    (direction [...,3], pdf [...]) at the texel centre."""
    if env.cdf_rows is None:
        raise ValueError("call build_env_cdf(env) first")
    h, w = env.height, env.width
    row = torch.clamp(torch.searchsorted(env.cdf_rows, u1, side="left"), 0, h - 1)
    cols = env.cdf_cols[row]                                  # [...,W]
    col = torch.clamp((cols < u2[..., None]).to(torch.int32).sum(dim=-1), 0, w - 1)
    u = (col.to(torch.float32) + 0.5) / w
    v = (row.to(torch.float32) + 0.5) / h
    return uv_to_direction(u, v), _texel_pdf(env, row, col.long())


def env_pdf(env: EnvironmentMap, direction: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of sample_env at the given directions."""
    h, w = env.height, env.width
    u, v = direction_to_uv(direction)
    col = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    row = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    return _texel_pdf(env, row, col)


def build_env_alias(env: EnvironmentMap) -> torch.Tensor:
    """Vose alias table over the texels, in float64 numpy: [H*W,4] f32
    (accept probability, alias index, own mass, alias's mass).  The mass
    is the texel's probability; the solid-angle pdf is computed at draw
    time at the jittered elevation, where the sample lands."""
    data = env.data.cpu().numpy().astype(np.float64)
    h = data.shape[0]
    lum = data @ np.array(_LUMA)
    theta = (np.arange(h) + 0.5) / h * np.pi
    weights = lum * np.sin(theta)[:, None] + 1e-12
    p = (weights / weights.sum()).reshape(-1)
    n = p.size

    scaled = p * n
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    prob = np.ones(n)
    alias = np.arange(n)
    while small and large:
        s = small.pop()
        big = large.pop()
        prob[s] = scaled[s]
        alias[s] = big
        scaled[big] = scaled[big] - (1.0 - scaled[s])
        (small if scaled[big] < 1.0 else large).append(big)

    table = np.zeros((n, 4), np.float32)
    table[:, 0] = prob
    table[:, 1] = alias.astype(np.float32)
    table[:, 2] = p
    table[:, 3] = p[alias]
    return torch.as_tensor(table, device=env.data.device)


def _alias_pdf(pmass, v, height: int, width: int):
    """Solid-angle pdf at elevation (0.5 - v)*pi of a texel of mass pmass:
    the (u,v) -> sphere Jacobian is 2*pi^2*cos(elev)."""
    cos_elev = torch.clamp_min(torch.cos((0.5 - v) * math.pi), 1e-6)
    return pmass * (height * width) / (2.0 * math.pi * math.pi * cos_elev)


def sample_env_alias(table: torch.Tensor, height: int, width: int, u1, u2, u3, u4):
    """One env direction per lane from the alias table: u1 picks a slot,
    u2 accepts it or takes its alias, u3/u4 jitter within the texel.
    Returns (direction [...,3], pdf [...] in solid angle, u, v); pass
    (u, v) to eval_env(uv=...)."""
    n = height * width
    i = torch.clamp_max((u1 * n).to(torch.int32), n - 1)
    row = table[i.long()]                                # [N,4]
    take_self = u2 < row[..., 0]
    texel = torch.where(take_self, i, row[..., 1].to(torch.int32))
    pmass = torch.where(take_self, row[..., 2], row[..., 3])
    ty = torch.div(texel, width, rounding_mode="floor")
    tx = texel % width
    u = (tx.to(torch.float32) + u3) / width
    v = (ty.to(torch.float32) + u4) / height
    return uv_to_direction(u, v), _alias_pdf(pmass, v, height, width), u, v


def with_importance_sampling(env: EnvironmentMap) -> EnvironmentMap:
    """Attach the CDF and alias tables; cfg.env_importance_sampling needs
    them."""
    env = build_env_cdf(env)
    return env.replace(alias_table=build_env_alias(env))


def env_pdf_alias(table: torch.Tensor, height: int, width: int, direction: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of sample_env_alias at arbitrary directions: the
    texel's mass from column 2 of the table, with the sampler's own
    continuous-elevation Jacobian."""
    u, v = direction_to_uv(direction)
    col = torch.clamp((u * width).to(torch.int32), 0, width - 1)
    row = torch.clamp((v * height).to(torch.int32), 0, height - 1)
    pmass = table[(row * width + col).long(), 2]
    return _alias_pdf(pmass, v, height, width)
