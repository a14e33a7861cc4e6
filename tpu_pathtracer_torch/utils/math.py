"""Vector math for batched rays: tensors whose last axis is the 3-vector.

Counterpart of `tpu_pathtracer/utils/math.py`.  Dot products are written out
component by component, left to right, which is the order of XLA's
reduction over a 3-wide axis, so the two agree to the bit where the
elementwise functions do.
"""

from __future__ import annotations

import torch

from tpu_pathtracer_torch.utils.device import constant

EPS = 1e-10


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis; keeps no dims."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product with the last axis kept (broadcasts vs [...,3])."""
    return dot(a, b)[..., None]


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def normalize(v: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Safe normalize: v * rsqrt(max(|v|^2, eps^2))."""
    n2 = vdot(v, v)
    return v * torch.rsqrt(torch.clamp_min(n2, eps * eps))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection i - 2 n (i.n)."""
    return i - 2.0 * vdot(i, n) * n


def faceforward(n: torch.Tensor, i: torch.Tensor, nref: torch.Tensor) -> torch.Tensor:
    """n * copysign(1, dot(i, nref)), with sign(0) taken as +1."""
    s = torch.sign(dot(i, nref))
    s = torch.where(s == 0, 1.0, s)
    return n * s[..., None]


def refract(i: torch.Tensor, n: torch.Tensor, eta_passed: torch.Tensor):
    """sutil `refract` as the reference calls it: the effective index ratio
    is 1/eta_passed.  Returns (direction, total-internal-reflection mask);
    the direction is zero on TIR."""
    eta = 1.0 / eta_passed
    cos_i = -dot(i, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    k_safe = torch.clamp_min(k, 0.0)
    r = eta[..., None] * i + (eta * cos_i - torch.sqrt(k_safe))[..., None] * n
    r = normalize(r)
    r = torch.where(tir[..., None], 0.0, r)
    return r, tir


def onb_from_normal(normal: torch.Tensor):
    """Orthonormal basis (tangent, binormal) of the reference's `Onb`:
    up = (0,1,0) unless |n.y| >= 0.9999, then (1,0,0)."""
    n = normalize(normal)
    ny = torch.abs(n[..., 1]) < 0.9999
    up_y = constant((0.0, 1.0, 0.0), n.dtype, n.device)
    up_x = constant((1.0, 0.0, 0.0), n.dtype, n.device)
    up = torch.where(ny[..., None], up_y, up_x)
    tangent = normalize(cross(up, n))
    binormal = normalize(cross(n, tangent))
    return tangent, binormal


def onb_transform(local: torch.Tensor, tangent, normal, binormal) -> torch.Tensor:
    """Tangent space -> world: p.x*T + p.y*N + p.z*B."""
    return (
        local[..., 0:1] * tangent
        + local[..., 1:2] * normal
        + local[..., 2:3] * binormal
    )


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec. 709 luma weights, in the order of `dot`."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def lerp(a, b, t):
    return a + (b - a) * t
