"""Procedural HDR environment (numpy), as `tpu_pathtracer/utils/image.py`."""

from __future__ import annotations

import numpy as np


def procedural_hdr(
    height: int = 256,
    width: int = 512,
    sun_dir=(0.0, 2.0, 3.0),
    sun_intensity: float = 200.0,
    seed: int = 0,
) -> np.ndarray:
    """Synthesize an equirect HDR [H,W,3] f32: gradient sky, warm sun disc
    and glow, ground below the horizon, 2% multiplicative noise."""
    v, u = np.meshgrid(
        (np.arange(height) + 0.5) / height,
        (np.arange(width) + 0.5) / width,
        indexing="ij",
    )
    phi = (u - 0.5) * 2.0 * np.pi
    theta = (0.5 - v) * np.pi
    y = np.sin(theta)
    c = np.cos(theta)
    dirs = np.stack([c * np.cos(phi), y, c * np.sin(phi)], axis=-1)

    sd = np.asarray(sun_dir, np.float64)
    sd = sd / np.linalg.norm(sd)
    cos_sun = dirs @ sd

    horizon = np.array([0.55, 0.6, 0.7])
    zenith = np.array([0.15, 0.25, 0.5])
    tsky = np.clip(y, 0.0, 1.0)[..., None]
    sky = horizon + (zenith - horizon) * tsky
    ground = np.array([0.25, 0.2, 0.15]) * (1.0 + 0.3 * np.clip(-y, 0, 1))[..., None]
    img = np.where(y[..., None] >= 0.0, sky, ground)

    sun_col = np.array([1.0, 0.875, 0.625]) * sun_intensity
    disc = np.clip((cos_sun - 0.995) / 0.005, 0.0, 1.0) ** 2
    img = img + disc[..., None] * sun_col
    glow = np.clip(cos_sun, 0.0, 1.0) ** 32
    img = img + glow[..., None] * np.array([1.5, 1.0, 0.5])

    rs = np.random.RandomState(seed)
    img *= 1.0 + 0.02 * rs.randn(height, width, 1)
    return np.maximum(img, 0.0).astype(np.float32)
