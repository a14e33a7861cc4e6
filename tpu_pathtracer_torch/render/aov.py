"""AOV (arbitrary output variable) G-buffer pass and the edge-avoiding
denoiser.  Counterpart of `tpu_pathtracer/render/aov.py`.

`render_aov` renders per-pixel geometry buffers (normal, depth, albedo,
material id, hit) with one deterministic centre ray per pixel (no
jitter, no DOF, no RNG draws), through the scene's intersector: on the
card the route's closest-hit kernel.  `atrous_denoise` is the classic
edge-avoiding A-Trous wavelet filter (Dammertz et al. 2010) guided by
them, run on the linear accumulated radiance before the film chain, so
`denoise` off leaves every image as it was.
"""

from __future__ import annotations

import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.ops.intersect import intersect_scene
from tpu_pathtracer_torch.render.envmap import eval_env
from tpu_pathtracer_torch.render.integrator import _interp
from tpu_pathtracer_torch.render.texsample import material_property, sample_bundle
from tpu_pathtracer_torch.scene import scene as S
from tpu_pathtracer_torch.scene.scene import Scene
from tpu_pathtracer_torch.utils import math as vm
from tpu_pathtracer_torch.utils.device import constant


def render_aov(scene: Scene, cam: dict, cfg: RenderConfig) -> dict:
    """G-buffer at pixel centres: dict of [H,W,...] tensors (row 0 the
    bottom, as the frame).

    {"normal": [H,W,3] smooth shading normal (no normal map: guidance
    wants geometry), "depth": [H,W] hit distance (0 where missed),
    "albedo": [H,W,3] base colour (texture sample or material diffuse;
    the environment's radiance where missed), "mat": [H,W] int32 material
    id (-1 where missed), "hit": [H,W] bool}.  The closest-hit program's
    conventions: barycentric smooth normal with the flat-normal fallback
    for backfacing normals, UV v-flip under cfg.flip_v."""
    dev = scene.device
    n_pix = cfg.width * cfg.height
    pix = torch.arange(n_pix, dtype=torch.int32, device=dev)
    px = (pix % cfg.width).to(torch.float32)
    py = (pix // cfg.width).to(torch.float32)

    # Centre rays: the camera's NDC map with the jitter at 0.5, no DOF.
    # The divisors are tensors: a Python-scalar divisor is a reciprocal
    # multiply on the card.
    dx = 2.0 * (px + 0.5) / constant(float(cfg.width), torch.float32, dev) - 1.0
    dy = 2.0 * (py + 0.5) / constant(float(cfg.height), torch.float32, dev) - 1.0
    target = dx[:, None] * cam["U"] + dy[:, None] * cam["V"] + cam["W"]
    directions = vm.normalize(target)
    origins = cam["eye"].expand_as(directions)

    hit = intersect_scene(scene, origins, directions, cfg.t_min, cfg.t_max, cfg)

    prim = torch.clamp_min(hit.prim, 0).long()  # miss lanes read row 0
    ta = scene.tri_attrs[prim]
    tri_v = ta[:, S.TRI_V].reshape(-1, 3, 3)
    tri_n = ta[:, S.TRI_N].reshape(-1, 3, 3)
    tri_uv = ta[:, S.TRI_UV].reshape(-1, 3, 2)
    mat = ta[:, S.TRI_MAT].to(torch.int32)
    m = scene.materials
    ma = m.attrs[mat.long()]

    v0, v1, v2 = tri_v[:, 0], tri_v[:, 1], tri_v[:, 2]
    flat_n = vm.normalize(vm.cross(v1 - v0, v2 - v0))
    flat_n = vm.faceforward(flat_n, -directions, flat_n)

    beta, gamma = hit.bary[:, 0], hit.bary[:, 1]
    w_interp = torch.stack([1.0 - beta - gamma, beta, gamma], dim=-1)
    uv = _interp(w_interp, tri_uv)
    tex_u = uv[:, 0]
    tex_v = (1.0 - uv[:, 1]) if cfg.flip_v else uv[:, 1]

    normal = vm.normalize(_interp(w_interp, tri_n))
    normal = torch.where((vm.dot(normal, directions) > 0.0)[:, None], flat_n, normal)

    # Base-colour albedo: the texture sample where mapped, the material's
    # diffuse colour otherwise.
    has_alb = ma[:, S.MAT_HAS_MAP][:, 0] > 0.5
    if m.bundled:
        tex_albedo = sample_bundle(
            m.texture_bundles,
            ma[:, S.MAT_BUNDLE_OFFSET].to(torch.int32),
            ma[:, S.MAT_BUNDLE_WIDTH].to(torch.int32),
            ma[:, S.MAT_BUNDLE_HEIGHT].to(torch.int32),
            tex_u, tex_v,
            morton=m.bundled_morton,
            scrambled=m.bundled_scrambled,
            pow2_dims=m.bundled_pow2_dims,
        )[0]
    else:
        tex_albedo = material_property(
            m.texture_quads, has_alb,
            ma[:, S.MAT_MAP_OFFSET][:, 0].to(torch.int32),
            ma[:, S.MAT_MAP_WIDTH][:, 0].to(torch.int32),
            ma[:, S.MAT_MAP_HEIGHT][:, 0].to(torch.int32),
            ma[:, S.MAT_DIFFUSE], tex_u, tex_v,
        )
    albedo = torch.where(has_alb[:, None], tex_albedo, ma[:, S.MAT_DIFFUSE])
    # Missed lanes: the environment's radiance (what the pixel shows).
    albedo = torch.where(hit.hit[:, None], albedo, eval_env(scene.env, directions, cfg))

    hm = hit.hit
    shape = (cfg.height, cfg.width)
    return {
        "normal": torch.where(hm[:, None], normal, 0.0).reshape(*shape, 3),
        "depth": torch.where(hm, hit.t, 0.0).reshape(shape),
        "albedo": albedo.reshape(*shape, 3),
        "mat": torch.where(hm, mat, -1).reshape(shape),
        "hit": hm.reshape(shape),
    }


def defocus_mask(aov: dict, cfg: RenderConfig):
    """[H,W] defocus weight in [0,1] from the thin-lens circle of
    confusion, or None when DOF is off.

    The G-buffer is rendered pinhole (sharp) while the accumulated
    radiance is defocus-blurred under cfg.dof, so out of focus the sharp
    guide edges do not line up with the blurred signal.  0 = in focus
    (full guidance), 1 = the CoC spans several pixels (spatial and colour
    weights only).  CoC ~ A |t - f| / t, times height / 4 for pixels."""
    if not cfg.dof or cfg.dof_blurriness <= 0.0:
        return None
    t = aov["depth"]
    coc_px = cfg.dof_blurriness * torch.abs(t - cfg.focus_distance) / torch.clamp_min(t, 1e-6) * (cfg.height / 4.0)
    return torch.where(aov["hit"], torch.clamp(coc_px, 0.0, 1.0), 0.0)


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped spatial shift of [H,W,...] by (dy, dx):
    out[y, x] = in[clamp(y - dy), clamp(x - dx)]."""
    h, w = x.shape[0], x.shape[1]
    ys = torch.clamp(torch.arange(h, device=x.device) - dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=x.device) - dx, 0, w - 1)
    return x.index_select(0, ys).index_select(1, xs)


# B3-spline 5-tap weights of the A-Trous kernel (Dammertz et al. 2010).
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def atrous_denoise(
    radiance: torch.Tensor,  # [H,W,3] linear
    aov: dict,               # render_aov output (normal/depth/albedo/hit)
    defocus=None,            # [H,W] in [0,1] (defocus_mask) or None
    iterations: int = 4,
    sigma_color: float = 4.0,
    sigma_normal: float = 0.25,
    sigma_depth: float = 0.02,
    firefly_clamp: float = 4.0,
) -> torch.Tensor:
    """Edge-avoiding A-Trous wavelet denoise of linear radiance.

    Each iteration convolves with a 5x5 B3-spline kernel dilated by 2^i,
    with per-tap bilateral weights from the G-buffer (the luminance
    weight in units of the local 3x3 luminance deviation, SVGF-style):
      w = kernel * exp(-|l_p-l_q| / (sc * std3x3(l)_p + eps))
                 * max(0, n_p.n_q)^(1/sn)
                 * exp(-|z_p-z_q|^2 / sz^2)        [z normalised]
    Hit and miss pixels never mix; texture detail is divided out by the
    albedo before filtering and multiplied back after.

    firefly_clamp > 0 first replaces hit pixels whose demodulated value
    exceeds firefly_clamp x the mean of their hit neighbours with that
    mean: isolated outliers look like edges to the colour weight."""
    normal, depth, albedo, hit = aov["normal"], aov["depth"], aov["albedo"], aov["hit"]
    hitm = hit.to(torch.float32)

    alb_safe = torch.clamp_min(albedo, 0.02)
    img = torch.where(hit[..., None], radiance / alb_safe, radiance)

    z = depth / torch.clamp_min(depth.max(), 1e-6)

    if firefly_clamp > 0:
        # The neighbourhood mean over hit pixels only: at silhouettes the
        # environment's radiance must not enter the replacement.
        nsum = torch.zeros_like(img)
        ncnt = torch.zeros_like(hitm)
        for ky in (-1, 0, 1):
            for kx in (-1, 0, 1):
                if ky or kx:
                    nsum = nsum + _shift2d(img * hitm[..., None], ky, kx)
                    ncnt = ncnt + _shift2d(hitm, ky, kx)
        nmean = nsum / torch.clamp_min(ncnt, 1.0)[..., None]
        spike = (img.amax(dim=-1) > firefly_clamp * (nmean.amax(dim=-1) + 1e-3)) & (ncnt > 0)
        img = torch.where((spike & hit)[..., None], nmean, img)

    for i in range(iterations):
        step = 1 << i
        lum = vm.luminance(img)
        mu = torch.zeros_like(lum)
        mu2 = torch.zeros_like(lum)
        for ky in (-1, 0, 1):
            for kx in (-1, 0, 1):
                lq = _shift2d(lum, ky, kx)
                mu = mu + lq
                mu2 = mu2 + lq * lq
        mu = mu / 9.0
        sdev = torch.sqrt(torch.clamp_min(mu2 / 9.0 - mu * mu, 0.0))

        acc = torch.zeros_like(img)
        wsum = torch.zeros_like(lum)
        for ky in range(-2, 3):
            for kx in range(-2, 3):
                k = _B3[ky + 2] * _B3[kx + 2]
                dy, dx = ky * step, kx * step
                cq = _shift2d(img, dy, dx)
                nq = _shift2d(normal, dy, dx)
                zq = _shift2d(z, dy, dx)
                hq = _shift2d(hitm, dy, dx)
                lq = _shift2d(lum, dy, dx)
                wc = torch.exp(-torch.abs(lum - lq) / (sigma_color * sdev + 1e-3))
                wn = torch.clamp_min(vm.dot(normal, nq), 0.0) ** (1.0 / sigma_normal)
                wz = torch.exp(-((z - zq) ** 2) / (sigma_depth**2))
                g = wn * wz
                if defocus is not None:
                    # Out of focus, fade the geometry guidance towards pure
                    # spatial smoothing (see defocus_mask).
                    g = g + defocus * (1.0 - g)
                same = 1.0 - torch.abs(hitm - hq)  # hit pixels average hit pixels
                w = k * wc * g * same
                acc = acc + w[..., None] * cq
                wsum = wsum + w
        img = acc / torch.clamp_min(wsum, 1e-10)[..., None]

    return torch.where(hit[..., None], img * alb_safe, radiance)
