"""Mean SSIM (Wang et al., 11x11 Gaussian window, sigma 1.5) in numpy,
as `tpu_pathtracer/utils/ssim.py`, for image gates that run without JAX."""

from __future__ import annotations

import numpy as np


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'valid' 2-D correlation per channel."""
    kh, kw = kernel.shape
    windows = np.lib.stride_tricks.sliding_window_view(img, (kh, kw), axis=(0, 1))
    return np.einsum("ij...kl,kl->ij...", windows, kernel)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM between two images ([H,W] or [H,W,C] float)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]

    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    mu_a = _filter2(a, k)
    mu_b = _filter2(b, k)
    mu_a2 = mu_a * mu_a
    mu_b2 = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_a2 = _filter2(a * a, k) - mu_a2
    sigma_b2 = _filter2(b * b, k) - mu_b2
    sigma_ab = _filter2(a * b, k) - mu_ab

    num = (2 * mu_ab + c1) * (2 * sigma_ab + c2)
    den = (mu_a2 + mu_b2 + c1) * (sigma_a2 + sigma_b2 + c2)
    return float(np.mean(num / den))
