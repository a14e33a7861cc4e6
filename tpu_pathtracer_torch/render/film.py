"""Film: progressive accumulation and the reference's post chain.
Counterpart of `tpu_pathtracer/render/film.py`:

    accum = lerp(prev, new, 1/(subframe+1))
    rgb   = aces_fit(accum * exp2(exposure)), clamped to [0,1]
    rgb   = 0.5 + contrast * (rgb ** (1/gamma) - 0.5), clamped
    rgb   = toSRGB(rgb) when cfg.srgb_output
"""

from __future__ import annotations

import torch

from tpu_pathtracer_torch.config import RenderConfig


def accumulate(prev_accum: torch.Tensor, new_frame: torch.Tensor, subframe: int) -> torch.Tensor:
    """Progressive EWMA: accum_k = lerp(accum_{k-1}, frame, 1/(k+1))."""
    if subframe <= 0:
        return new_frame
    a = 1.0 / (torch.tensor(float(subframe), dtype=torch.float32) + 1.0)
    return prev_accum + (new_frame - prev_accum) * a.to(new_frame.device)


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
    exposure = torch.exp2(torch.tensor(cfg.exposure, dtype=torch.float32))
    rgb = accum_rgb * exposure.to(accum_rgb.device)
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
