"""An equirect HDR environment [H,W,3] float32: gradient sky, warm sun
disc and glow, ground below the horizon, 2% multiplicative noise from a
fixed generator seed."""

from __future__ import annotations

import numpy as np


def build(height: int = 256, width: int = 512, sun_dir=(0.0, 2.0, 3.0), sun_intensity: float = 200.0,
          seed: int = 0) -> np.ndarray:
    v, u = np.meshgrid((np.arange(height) + 0.5) / height, (np.arange(width) + 0.5) / width, indexing="ij")
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
    sky = horizon + (zenith - horizon) * np.clip(y, 0.0, 1.0)[..., None]
    ground = np.array([0.25, 0.2, 0.15]) * (1.0 + 0.3 * np.clip(-y, 0, 1))[..., None]
    img = np.where(y[..., None] >= 0.0, sky, ground)
    disc = np.clip((cos_sun - 0.995) / 0.005, 0.0, 1.0) ** 2
    img = img + disc[..., None] * (np.array([1.0, 0.875, 0.625]) * sun_intensity)
    img = img + (np.clip(cos_sun, 0.0, 1.0) ** 32)[..., None] * np.array([1.5, 1.0, 0.5])
    img *= 1.0 + 0.02 * np.random.RandomState(seed).randn(height, width, 1)
    return np.maximum(img, 0.0).astype(np.float32)
