"""Microfacet BSDF math: GGX NDF, Smith/Schlick-GGX geometry, Fresnel.
Counterpart of `tpu_pathtracer/render/bsdf.py`; vectors have a trailing
3-axis."""

from __future__ import annotations

import math

import torch

from tpu_pathtracer_torch.utils import math as vm


def d_ggx(n: torch.Tensor, h: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """GGX normal distribution; the denominator is floored at 1e-12 so a
    tiny alpha with n.h ~ 1 gives a large finite D, not inf."""
    a2 = alpha * alpha
    ndoth = torch.clamp_min(vm.dot(n, h), 1e-10)
    ndoth2 = ndoth * ndoth
    denom = ndoth2 * (a2 - 1.0) + 1.0
    denom = math.pi * denom * denom
    return a2 / torch.clamp_min(denom, 1e-12)


def g_schlick_ggx(alpha: torch.Tensor, n: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """|n.x| / (|n.x|(1-k)+k) with k = alpha/2."""
    ndotx = torch.abs(vm.dot(n, x))
    k = alpha / 2.0
    return ndotx / torch.clamp_min(ndotx * (1.0 - k) + k, 1e-10)


def g_smith(alpha, n, v, l) -> torch.Tensor:
    return g_schlick_ggx(alpha, n, v) * g_schlick_ggx(alpha, n, l)


def fresnel_schlick(cos_theta: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    """Vector Fresnel-Schlick; f0 [...,3]."""
    c = torch.clamp(cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * torch.pow(1.0 - c, 5.0)[..., None]


def fresnel_schlick_scalar(cosine: torch.Tensor, refraction_index) -> torch.Tensor:
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(1.0 - cosine, 5.0)


def ggx_importance_sample(r1: torch.Tensor, r2: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """GGX half-vector in tangent space (cosine axis +y)."""
    phi = (2.0 * math.pi) * r1
    cos_theta = torch.sqrt((1.0 - r2) / (1.0 + (alpha * alpha - 1.0) * r2))
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    h = torch.stack(
        [sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)], dim=-1
    )
    return vm.normalize(h)


def ggx_pdf(d_term: torch.Tensor, ndoth: torch.Tensor, vdoth: torch.Tensor) -> torch.Tensor:
    """D * n.h / (4 v.h), in light-direction measure."""
    return d_term * ndoth / (4.0 * vdoth)
