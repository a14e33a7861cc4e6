"""Bilinear texture sampling from the quad-packed pools, by plain indexing.

Counterpart of `tpu_pathtracer/render/texsample.py`.  Texels are RGBA8 words
held in int64 tensors; a bilinear tap reads one row holding the texel's
2x2 repeat-wrap neighbourhood.  Lanes whose result is not used read
whatever row their (garbage) coordinates name; callers select.
"""

from __future__ import annotations

import torch

from tpu_pathtracer_torch.scene.scene import SCRAMBLE_MULT

# 1/255: a float32 tensor times a Python float is a float32 product on
# every device, by the float32 rounding of 1/255.
_INV255 = 1.0 / 255.0


def _decode_rgb(word: torch.Tensor):
    """RGBA8 word -> (r, g, b) float32 in [0,1]."""
    return tuple(((word >> s) & 0xFF).to(torch.float32) * _INV255 for s in (0, 8, 16))


def _texel_coords(width, height, u, v):
    """Repeat-wrapped (x0f, y0f, s, t) for a bilinear tap at (u, v)."""
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    x = u * width.to(torch.float32) - 0.5
    y = v * height.to(torch.float32) - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    return x0f, y0f, x - x0f, y - y0f


def _lerp2(c00, c10, c01, c11, s, t):
    c0 = c00 + (c10 - c00) * s
    c1 = c01 + (c11 - c01) * s
    return c0 + (c1 - c0) * t


def sample_bilinear_pool(quads, offset, width, height, u, v) -> torch.Tensor:
    """Repeat-wrap bilinear sample from [P,4] quad rows; returns [N,3]."""
    x0f, y0f, s, t = _texel_coords(width, height, u, v)
    x0 = torch.remainder(x0f.to(torch.int32), width)
    y0 = torch.remainder(y0f.to(torch.int32), height)
    q = quads[(offset + y0 * width + x0).long()]
    corners = [_decode_rgb(q[:, j]) for j in range(4)]
    return torch.stack(
        [_lerp2(*(corners[j][ch] for j in range(4)), s, t) for ch in range(3)], dim=-1
    )


def _part1by1(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of v so bit i lands at bit 2i (Z-curve)."""
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def sample_bundle(bundles, offset, width, height, u, v, morton: bool = False, scrambled: bool = False, pow2_dims: bool = False):
    """Bilinear-sample all four map kinds from one [Pb,8] bundle row.

    Returns four [N,3] tensors in kind order (albedo, roughness, normal,
    metallic); roughness and metallic repeat their scalar across rgb."""
    x0f, y0f, s, t = _texel_coords(width, height, u, v)
    if pow2_dims:
        x0 = x0f.to(torch.int32) & (width - 1)
        y0 = y0f.to(torch.int32) & (height - 1)
    else:
        x0 = torch.remainder(x0f.to(torch.int32), width)
        y0 = torch.remainder(y0f.to(torch.int32), height)

    if scrambled:
        t_row = (y0 * width + x0).to(torch.int64) & 0xFFFFFFFF
        wh_mask = (width * height - 1).to(torch.int64) & 0xFFFFFFFF
        texel = (t_row * SCRAMBLE_MULT) & wh_mask
    elif morton:
        texel = _part1by1(x0) | (_part1by1(y0) << 1)
    else:
        texel = y0 * width + x0
    rows = bundles[(offset + texel).long()]                  # [N,8]

    outs = []
    for base in (0, 4):                                      # word A, word B
        q = rows[:, base : base + 4]
        corners = [_decode_rgb(q[:, j]) for j in range(4)]
        rgb = torch.stack(
            [_lerp2(*(corners[j][ch] for j in range(4)), s, t) for ch in range(3)],
            dim=-1,
        )
        alpha = [((q[:, j] >> 24) & 0xFF).to(torch.float32) * _INV255 for j in range(4)]
        scalar = _lerp2(*alpha, s, t)
        outs.append(rgb)
        outs.append(torch.stack([scalar] * 3, dim=-1))
    return outs


def material_property(quads, has_map, offset, width, height, fallback, u, v) -> torch.Tensor:
    """The map's bilinear sample where the material has one, else the
    per-material constant `fallback` [N,3]."""
    sampled = sample_bilinear_pool(quads, offset, width, height, u, v)
    return torch.where(has_map[..., None], sampled, fallback)
