"""Film: progressive accumulation and the reference's post chain.
Counterpart of `tpu_pathtracer/render/film.py`:

    accum = lerp(prev, new, 1/(subframe+1))
    rgb   = aces_fit(accum * exp2(exposure)), clamped to [0,1]
    rgb   = 0.5 + contrast * (rgb ** (1/gamma) - 0.5), clamped
    rgb   = toSRGB(rgb) when cfg.srgb_output
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pathtracer_torch.config import RenderConfig


def accumulate(prev_accum: torch.Tensor, new_frame: torch.Tensor, subframe: int) -> torch.Tensor:
    """Progressive EWMA: accum_k = lerp(accum_{k-1}, frame, 1/(k+1))."""
    return accumulate_weighted(prev_accum, new_frame, subframe, 1)


def accumulate_weighted(prev_accum: torch.Tensor, new_frame: torch.Tensor, prev_spp: int, new_spp: int) -> torch.Tensor:
    """Sample-count-weighted accumulation: lerp(prev, new, new_spp /
    (prev_spp + new_spp)), or `new_frame` when nothing is accumulated.

    The factor is a float32 quotient formed on the host, as the JAX
    package forms it on the device: IEEE division is correctly rounded,
    so at a constant spp per launch spp / ((k+1) spp) and 1 / (k+1) give
    the same float32 and this equals `accumulate` bit for bit.  It enters
    as a Python scalar factor: a product, with no device constant built
    per call (a scalar divisor would become a reciprocal multiply on the
    card)."""
    if prev_spp <= 0:
        return new_frame
    a = float(np.float32(new_spp) / (np.float32(prev_spp) + np.float32(new_spp)))
    return prev_accum + (new_frame - prev_accum) * a


def aces_fit_tonemap(x: torch.Tensor) -> torch.Tensor:
    """Rational-polynomial filmic fit with the reference's constants."""
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return (x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F) - E / F


def to_srgb(x: torch.Tensor) -> torch.Tensor:
    lo = 12.92 * x
    hi = 1.055 * torch.pow(torch.clamp_min(x, 1e-10), 1.0 / 2.4) - 0.055
    return torch.where(x <= 0.0031308, lo, hi)


def post_process(accum_rgb: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """HDR accumulation -> display-ready float RGB in [0,1]."""
    # exp2 in float32 on the host, entering as a Python scalar factor: no
    # device constant is built per call.
    rgb = accum_rgb * float(torch.exp2(torch.tensor(cfg.exposure, dtype=torch.float32)))
    rgb = aces_fit_tonemap(rgb)
    rgb = torch.clamp(rgb, 0.0, 1.0)
    rgb = torch.pow(torch.clamp_min(rgb, 1e-10), 1.0 / cfg.gamma)
    rgb = 0.5 + cfg.contrast * (rgb - 0.5)
    rgb = torch.clamp(rgb, 0.0, 1.0)
    if cfg.srgb_output:
        rgb = to_srgb(rgb)
    return rgb


def to_uint8(rgb01: torch.Tensor) -> torch.Tensor:
    """min(uint(x*256), 255), as helpers.h quantizeUnsigned8Bits."""
    q = (torch.clamp(rgb01, 0.0, 1.0) * 256.0).to(torch.int64)
    return torch.clamp_max(q, 255).to(torch.uint8)
