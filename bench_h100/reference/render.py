"""The plain reference: a path tracer in plain PyTorch that recomputes any
sample of any launch from the benchmark's own scene arrays.

It follows the algorithm of the reference renderer as the port states it
(the scalar oracle of `tpu_pathtracer_torch/oracle.py` at the time this
benchmark was written), vectorised over paths: the same counter-seeded
PCG draws in the same order, including the draws that the program makes
for every lane and then discards (the glass branch's), the same
estimator (the reference's Russian roulette, or the textbook one under
next-event estimation), the same GGX and diffuse lobes.  It shares no
code with the program: brute-force Moller-Trumbore over every triangle
(the program traverses a cluster accel with another triangle test), its
own camera frame, environment lookup and Vose alias table.

Every floating-point value is held in `dtype`: float32 is the reference,
and a lower precision (bfloat16) is the control that the check has to
refuse.  The PCG state stays integer in either.

Scope: what the benchmark's configurations use.  Materials from the
scene's material dicts (no texture maps), the equirect environment,
pinhole camera, depth-limited paths, NEE without the defensive mixture
and without spec-lobe MIS; anything else is refused."""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
INV_U32 = 2.3283064365386963e-10      # 2^-32
LUMA = (0.2126, 0.7152, 0.0722)


# ---------------------------------------------------------------------------
# Counter-based random numbers: int64 tensors holding 32-bit values
# ---------------------------------------------------------------------------

def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def make_seeds(pixel: torch.Tensor, sample: torch.Tensor, subframe: torch.Tensor) -> torch.Tensor:
    """hash(pixel, sample, subframe) | 1, the seed of one sample's path."""
    h = pcg_hash((pixel & MASK32) ^ 0x9E3779B9)
    h = pcg_hash((h + ((sample & MASK32) * 0x85EBCA6B & MASK32)) & MASK32)
    h = pcg_hash((h + ((subframe & MASK32) * 0xC2B2AE35 & MASK32)) & MASK32)
    return h | 1


def uniform(seed: torch.Tensor, dtype):
    seed = pcg_hash(seed)
    return seed, seed.to(dtype) * INV_U32


# ---------------------------------------------------------------------------
# Vectors: [..., 3] tensors
# ---------------------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize(v):
    return v * (1.0 / torch.sqrt(torch.clamp_min(dot(v, v), 1e-20)))[..., None]


def onb(n):
    """Tangent and binormal around n: up = (0,1,0) unless |n.y| >= 0.9999."""
    n = normalize(n)
    up = torch.zeros_like(n)
    side = torch.abs(n[..., 1]) >= 0.9999
    up[..., 1] = torch.where(side, 0.0, 1.0).to(n.dtype)
    up[..., 0] = torch.where(side, 1.0, 0.0).to(n.dtype)
    t = normalize(cross(up, n))
    return t, normalize(cross(n, t))


def to_world(local, t, n, b):
    return local[..., 0:1] * t + local[..., 1:2] * n + local[..., 2:3] * b


def reflect(i, n):
    return i - 2.0 * dot(i, n)[..., None] * n


def schlick(cos, r0):
    return r0 + (1.0 - r0) * torch.pow(1.0 - cos, 5.0)


# ---------------------------------------------------------------------------
# The scene as the reference holds it
# ---------------------------------------------------------------------------

def alias_table(env: np.ndarray) -> np.ndarray:
    """Vose alias table over the texels' luminance * sin(theta), in float64:
    [H*W,4] float32 rows (accept probability, alias, own mass, alias's
    mass)."""
    data = env.astype(np.float64)
    h = data.shape[0]
    lum = data @ np.array(LUMA)
    theta = (np.arange(h) + 0.5) / h * np.pi
    p = (lum * np.sin(theta)[:, None] + 1e-12)
    p = (p / p.sum()).reshape(-1)
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
    return np.stack([prob, alias.astype(np.float64), p, p[alias]], axis=-1).astype(np.float32)


def camera_frame(eye, lookat, up, fov_y: float, aspect: float):
    """(eye, U, V, W) float32: W = lookat - eye, U and V spanning the image
    plane at the focal distance |W| (computed in float64)."""
    eye64, w = np.asarray(eye, np.float64), np.asarray(lookat, np.float64) - np.asarray(eye, np.float64)
    u = np.cross(w, np.asarray(up, np.float64))
    u /= np.linalg.norm(u)
    v = np.cross(u, w)
    v /= np.linalg.norm(v)
    vlen = np.linalg.norm(w) * math.tan(0.5 * math.radians(fov_y))
    return tuple(a.astype(np.float32) for a in (eye64, u * vlen * aspect, v * vlen, w))


class RefScene:
    """Triangles, materials and environment on `device` in `dtype`."""

    def __init__(self, arrays, env: np.ndarray, device, dtype=torch.float32, alias=None):
        def dev(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), device=device).to(dt)

        for m in arrays.materials:
            if m.get("maps"):
                raise ValueError("the reference renders untextured materials only")
        self.dtype, self.device = dtype, device
        v = dev(arrays.vertices)
        self.v0, self.e1, self.e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        self.verts, self.normals = v, dev(arrays.normals)
        self.mat_ids = dev(arrays.mat_ids, torch.int64)
        mats = arrays.materials
        color = np.array([m.get("color", (0.5, 0.5, 0.5)) for m in mats], np.float32)
        self.albedo = dev(color)
        self.emission = dev(color * np.array([[m.get("emission", 0.0)] for m in mats], np.float32))
        self.rough = dev([np.float32(m.get("roughness", 0.5)) for m in mats])
        self.metal = dev([1.0 if m.get("metallic", False) else 0.0 for m in mats])
        self.glass = dev([bool(m.get("transparent", False)) for m in mats], torch.bool)
        self.ior = dev([np.float32(m.get("ior", 0.0)) for m in mats])
        self.env = dev(env)
        self.env_h, self.env_w = env.shape[:2]
        if alias is not None:
            # the alias index is an integer; the probabilities and masses are in dtype
            self.alias_p, self.alias_i = dev(alias[:, 0]), dev(alias[:, 1], torch.int64)
            self.alias_own, self.alias_other = dev(alias[:, 2]), dev(alias[:, 3])

    # -- intersection: brute-force Moller-Trumbore -------------------------
    def _mt(self, o, d, v0, e1, e2, t_min, t_max):
        """Every ray of o, d [R,1] components against every triangle of v0,
        e1, e2 [1,C] components: (t, u, v, hit) [R,C]."""
        px, py, pz = d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2], d[0] * e2[1] - d[1] * e2[0]
        det = e1[0] * px + e1[1] * py + e1[2] * pz
        ok = torch.abs(det) > 1e-12
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        tx, ty, tz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
        u = (tx * px + ty * py + tz * pz) * inv
        qx, qy, qz = ty * e1[2] - tz * e1[1], tz * e1[0] - tx * e1[2], tx * e1[1] - ty * e1[0]
        v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv
        t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv
        ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) & (t < t_max)
        return t, u, v, ok

    def _blocks(self, n_rays: int):
        n_tris = self.v0.shape[0]
        cols = min(n_tris, 8192)
        rows = max(1, (1 << 24) // cols)
        return rows, cols

    @staticmethod
    def _split(x, lo, hi, col: bool):
        x = x[lo:hi]
        return [x[:, k][None, :] if col else x[:, k][:, None] for k in range(3)]

    def closest(self, o, d, t_min: float, t_max: float):
        """Closest hit of each ray [N,3]: (hit, prim, t, u, v); ties in t go
        to the lower triangle index."""
        n, n_tris = o.shape[0], self.v0.shape[0]
        rows, cols = self._blocks(n)
        best_t = torch.full((n,), math.inf, dtype=self.dtype, device=o.device)
        best = torch.zeros(n, dtype=torch.int64, device=o.device)
        for r0 in range(0, n, rows):
            oo, dd = self._split(o, r0, r0 + rows, False), self._split(d, r0, r0 + rows, False)
            bt, bp = best_t[r0:r0 + rows], best[r0:r0 + rows]
            for c0 in range(0, n_tris, cols):
                t, _, _, ok = self._mt(oo, dd, self._split(self.v0, c0, c0 + cols, True),
                                       self._split(self.e1, c0, c0 + cols, True),
                                       self._split(self.e2, c0, c0 + cols, True), t_min, t_max)
                tmin, arg = torch.min(torch.where(ok, t, math.inf), dim=1)
                closer = tmin < bt
                bt.copy_(torch.where(closer, tmin, bt))
                bp.copy_(torch.where(closer, arg + c0, bp))
        hit = torch.isfinite(best_t)
        # t, u and v again for each ray's own triangle, by the same arithmetic
        t, u, v, _ = self._mt(*(self._split(a, 0, n, False) for a in (o, d, self.v0[best], self.e1[best],
                                                                      self.e2[best])), t_min, t_max)
        return hit, best, t[:, 0], u[:, 0], v[:, 0]

    def occluded(self, o, d, t_min: float, t_max: float):
        """Whether anything lies between t_min and t_max along each ray."""
        n, n_tris = o.shape[0], self.v0.shape[0]
        rows, cols = self._blocks(n)
        out = torch.zeros(n, dtype=torch.bool, device=o.device)
        for r0 in range(0, n, rows):
            oo, dd = self._split(o, r0, r0 + rows, False), self._split(d, r0, r0 + rows, False)
            acc = out[r0:r0 + rows]
            for c0 in range(0, n_tris, cols):
                ok = self._mt(oo, dd, self._split(self.v0, c0, c0 + cols, True),
                              self._split(self.e1, c0, c0 + cols, True),
                              self._split(self.e2, c0, c0 + cols, True), t_min, t_max)[3]
                acc |= ok.any(dim=1)
        return out

    # -- environment -------------------------------------------------------
    def env_uv(self, d):
        dn = normalize(d)
        u = 0.5 + torch.atan2(dn[:, 2], dn[:, 0]) / (2 * math.pi)
        v = 0.5 - torch.asin(torch.clamp(dn[:, 1], -1, 1)) / math.pi
        return u, v

    def eval_env(self, u, v):
        """Bilinear lookup at equirect (u, v): x wraps, y clamps."""
        h, w = self.env_h, self.env_w
        x, y = u * w - 0.5, v * h - 0.5
        x0f, y0f = torch.floor(x), torch.floor(y)
        s, t = (x - x0f)[:, None], (y - y0f)[:, None]
        x0 = torch.remainder(x0f.to(torch.int64), w)
        x1 = (x0 + 1) % w
        y0 = torch.clamp(y0f.to(torch.int64), 0, h - 1)
        y1 = torch.clamp_max(y0 + 1, h - 1)
        e = self.env
        c0 = e[y0, x0] + (e[y0, x1] - e[y0, x0]) * s
        c1 = e[y1, x0] + (e[y1, x1] - e[y1, x0]) * s
        return c0 + (c1 - c0) * t

    def sample_light(self, u1, u2, u3, u4):
        """One alias-table draw a lane: (direction, solid-angle pdf, u, v)."""
        h, w = self.env_h, self.env_w
        n = h * w
        i = torch.clamp_max((u1 * n).to(torch.int64), n - 1)
        take = u2 < self.alias_p[i]
        texel = torch.where(take, i, self.alias_i[i])
        pmass = torch.where(take, self.alias_own[i], self.alias_other[i])
        u = ((texel % w).to(self.dtype) + u3) / w
        v = ((texel // w).to(self.dtype) + u4) / h
        phi, theta = (u - 0.5) * (2 * math.pi), (0.5 - v) * math.pi
        c = torch.cos(theta)
        d = torch.stack([c * torch.cos(phi), torch.sin(theta), c * torch.sin(phi)], dim=-1)
        cos_elev = torch.clamp_min(torch.cos((0.5 - v) * math.pi), 1e-6)
        return d, pmass * (h * w) / (2.0 * math.pi * math.pi * cos_elev), u, v


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------

def unit_ball(seed, dtype):
    """Rejection-sampled point in the unit ball a lane; a lane's seed stops
    at its first accepted draw."""
    p = torch.zeros(seed.shape + (3,), dtype=dtype, device=seed.device)
    todo = torch.ones_like(seed, dtype=torch.bool)
    while bool(todo.any()):
        s = seed[todo]
        s, u1 = uniform(s, dtype)
        s, u2 = uniform(s, dtype)
        s, u3 = uniform(s, dtype)
        q = 2.0 * torch.stack([u1, u2, u3], dim=-1) - 1.0
        seed[todo] = s
        p[todo] = q
        todo[todo.clone()] = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]) >= 1.0
    return seed, p


def _shade(sc: RefScene, cfg, prim, t_hit, beta, gamma, o, d, seed, depth):
    """Closest-hit shading of the lanes that hit: their next ray, throughput
    factor, emission and the NEE terms."""
    dt = sc.dtype
    tri_v, tri_n = sc.verts[prim], sc.normals[prim]
    mat = sc.mat_ids[prim]
    v0, v1, v2 = tri_v[:, 0], tri_v[:, 1], tri_v[:, 2]
    flat_n = normalize(cross(v1 - v0, v2 - v0))
    flat_n = torch.where((dot(-d, flat_n) < 0)[:, None], -flat_n, flat_n)
    w0, w1, w2 = (1.0 - beta - gamma)[:, None], beta[:, None], gamma[:, None]
    n_raw = (w0 * tri_n[:, 0] + w1 * tri_n[:, 1]) + w2 * tri_n[:, 2]
    degenerate = torch.sqrt(dot(n_raw, n_raw)) <= 0.01
    normal = normalize(n_raw)
    normal = torch.where((dot(normal, d) > 0)[:, None], flat_n, normal)
    hit_pos = o + t_hit[:, None] * d

    albedo = sc.albedo[mat]
    # No normal map: the map's (0,1,0) taken to world space and blended in.
    t1, b1 = onb(normal)
    nmap_world = 0.0 * t1 + 1.0 * normal + 0.0 * b1
    s_ = cfg.normal_map_strength
    normal = normalize(s_ * nmap_world + (1.0 - s_) * normal)
    emission = sc.emission[mat]
    rough = torch.clamp(sc.rough[mat], cfg.roughness_min, cfg.roughness_max)
    metal = sc.metal[mat]
    glass = sc.glass[mat]
    ior = torch.where(sc.ior[mat] > 0.0, sc.ior[mat], torch.full_like(rough, cfg.ior))
    emissive = torch.sqrt(dot(emission, emission)) > 0.0001
    depth_done = depth <= 0

    # GGX half vector and the cosine-weighted diffuse direction
    seed, r1 = uniform(seed, dt)
    seed, r2 = uniform(seed, dt)
    alpha = rough * rough
    phi = (2 * math.pi) * r1
    cos_t = torch.sqrt((1.0 - r2) / (1.0 + (alpha * alpha - 1.0) * r2))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    half_local = normalize(torch.stack([sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi)], dim=-1))
    t2, b2 = onb(normal)
    half = to_world(half_local, t2, normal, b2)
    light_dir = reflect(d, half)
    seed, r3 = uniform(seed, dt)
    seed, r4 = uniform(seed, dt)
    rr_, phi2 = torch.sqrt(r3), (2 * math.pi) * r4
    lx, lz = rr_ * torch.cos(phi2), rr_ * torch.sin(phi2)
    ly = torch.sqrt(torch.clamp_min(1.0 - lx * lx - lz * lz, 0.0))
    light_diffuse = to_world(torch.stack([lx, ly, lz], dim=-1), t2, normal, b2)

    # Specular BRDF, lobe probabilities
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    f0 = r0[:, None] + (albedo - r0[:, None]) * metal[:, None]
    ndotv_raw = dot(normal, -d)
    cosc = torch.clamp(torch.clamp_min(ndotv_raw, 0.0), 0.0, 1.0)
    f_vec = f0 + (1.0 - f0) * torch.pow(1.0 - cosc, 5.0)[:, None]
    ndoth = torch.clamp_min(dot(normal, half), 1e-10)
    a2 = alpha * alpha
    den = ndoth * ndoth * (a2 - 1.0) + 1.0
    d_term = a2 / torch.clamp_min(math.pi * den * den, 1e-12)
    k = alpha / 2.0

    def g1(x):
        nx = torch.abs(dot(normal, x))
        return nx / torch.clamp_min(nx * (1.0 - k) + k, 1e-10)

    g_term = g1(-d) * g1(light_dir)
    denom = 4.0 * torch.abs(ndotv_raw) * torch.abs(dot(normal, light_dir))
    brdf_spec = f_vec * (d_term * g_term / torch.clamp_min(denom, 1e-10))[:, None]
    vdoth = torch.clamp_min(dot(-d, half), 1e-10)
    ndotv = torch.clamp_min(ndotv_raw, 0.0)
    idotn = torch.abs(dot(normal, normalize(light_dir)))
    spec_prob = metal + (1.0 - metal) * schlick(ndotv, r0)
    spdf = d_term * ndoth / (4.0 * vdoth)
    seed, u_lobe = uniform(seed, dt)
    choose_spec = u_lobe < spec_prob
    dir_surface = torch.where(choose_spec[:, None], normalize(light_dir), normalize(light_diffuse))
    brdf = (spec_prob[:, None] * (brdf_spec / torch.clamp_min(spdf, 1e-20)[:, None])
            + (1.0 - spec_prob)[:, None] * (albedo / (1.0 / math.pi)))

    # Glass: its draws are made on every lane
    cos_ti = dot(normal, -d)
    inside = cos_ti < 0
    n_glass = torch.where(inside[:, None], -normal, normal)
    eta = 1.0 / torch.where(inside, 1.0 / ior, ior)
    reflectance = schlick(torch.abs(cos_ti), r0)
    seed, u_reflect = uniform(seed, dt)
    cos_i = -dot(d, n_glass)
    kk = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    refr = normalize(eta[:, None] * d + (eta * cos_i - torch.sqrt(torch.clamp_min(kk, 0.0)))[:, None] * n_glass)
    refr = torch.where((kk < 0)[:, None], 0.0, refr)
    seed, ball = unit_ball(seed, dt)
    refr = refr + cfg.glass_roughness_perturb * alpha[:, None] * ball
    glass_dir = torch.where((u_reflect < reflectance)[:, None], light_dir, refr)

    brdf_ok = torch.sqrt(dot(brdf, brdf)) >= 1e-10
    return dict(origin=hit_pos, direction=torch.where(glass[:, None], glass_dir, dir_surface),
                att_factor=brdf * idotn[:, None], att_ok=brdf_ok & ~glass & ~emissive & ~degenerate,
                emission=emission, emissive=emissive & ~degenerate, done=degenerate | emissive | depth_done,
                seed=seed, normal=normal, brdf=brdf, spec_prob=spec_prob, idotn=idotn, degenerate=degenerate,
                glass=glass, choose_spec=choose_spec)


def check_config(cfg) -> None:
    if cfg.get("dof") or cfg.get("seed_advance_quirk") or cfg.get("nee_defensive_mix") or cfg.get("nee_mis_spec"):
        raise ValueError("the reference renders pinhole cameras and plain NEE only")
    if cfg.get("env_mode", "equirect") != "equirect":
        raise ValueError("the reference renders the equirect environment only")


class Settings:
    """The render settings the reference reads, from the configuration as
    it is run (the same dict the program's RenderConfig is made from)."""

    KEYS = ("t_min", "t_max", "max_depth", "normal_map_strength", "roughness_min", "roughness_max", "ior",
            "glass_roughness_perturb", "rr_mode")

    def __init__(self, render: dict):
        check_config(render)
        for key in self.KEYS:
            setattr(self, key, render[key])
        self.env_importance_sampling = bool(render.get("env_importance_sampling", False))


def trace(sc: RefScene, cfg: Settings, origin, direction, seed):
    """Radiance of one path a lane, from its camera ray and seed."""
    dt, dev = sc.dtype, origin.device
    n = origin.shape[0]
    nee = cfg.env_importance_sampling
    att = torch.ones((n, 3), dtype=dt, device=dev)
    radiance = torch.zeros((n, 3), dtype=dt, device=dev)
    result = torch.zeros((n, 3), dtype=dt, device=dev)
    depth = torch.full((n,), cfg.max_depth, dtype=torch.int64, device=dev)
    spec_last = torch.ones(n, dtype=torch.bool, device=dev)
    live = torch.arange(n, device=dev)
    for _ in range(cfg.max_depth + 2):
        if live.numel() == 0:
            break
        o, d, s, a, rad = origin[live], direction[live], seed[live], att[live], radiance[live]
        hit, prim, t, bu, bv = sc.closest(o, d, cfg.t_min, cfg.t_max)
        done = ~hit
        miss = torch.nonzero(~hit)[:, 0]
        if miss.numel():
            env = a[miss] * sc.eval_env(*sc.env_uv(d[miss]))
            credit = spec_last[live][miss] if nee else torch.ones_like(miss, dtype=torch.bool)
            rad[miss] = rad[miss] + torch.where(credit[:, None], env, 0.0)
        h = torch.nonzero(hit)[:, 0]
        new_o, new_d = o.clone(), d.clone()
        if h.numel():
            sh = _shade(sc, cfg, prim[h], t[h], bu[h], bv[h], o[h], d[h], s[h], depth[live][h])
            rh = torch.where(sh["emissive"][:, None], rad[h] + a[h] * sh["emission"], rad[h])
            sh_seed = sh["seed"]
            if nee:
                sh_seed, u1 = uniform(sh_seed, dt)
                sh_seed, u2 = uniform(sh_seed, dt)
                sh_seed, u3 = uniform(sh_seed, dt)
                sh_seed, u4 = uniform(sh_seed, dt)
                ldir, pdf, lu, lv = sc.sample_light(u1, u2, u3, u4)
                cos_l = torch.clamp_min(dot(sh["normal"], ldir), 0.0)
                cand = ~sh["done"] & ~sh["glass"] & ~sh["emissive"] & ~sh["degenerate"] & (cos_l > 0.0)
                visible = cand.clone()
                ci = torch.nonzero(cand)[:, 0]
                if ci.numel():
                    visible[ci] = ~sc.occluded(sh["origin"][ci], ldir[ci], cfg.t_min, cfg.t_max)
                weight = (1.0 - sh["spec_prob"]) * sh["idotn"] * cos_l / (math.pi * torch.clamp_min(pdf, 1e-12))
                contrib = a[h] * sh["brdf"] * weight[:, None] * sc.eval_env(lu, lv)
                rh = rh + torch.where(visible[:, None], contrib, 0.0)
                sl = spec_last[live]
                sl[h] = sh["choose_spec"] | sh["glass"]
                spec_last[live] = sl
            rad[h] = rh
            a[h] = torch.where(sh["att_ok"][:, None], a[h] * sh["att_factor"], a[h])
            new_o[h], new_d[h] = sh["origin"], sh["direction"]
            done[h] = sh["done"]
            s[h] = sh_seed
        # Russian roulette on the throughput's largest channel
        s, u_rr = uniform(s, dt)
        p = torch.max(a, dim=1).values
        ended = done | (u_rr > p)
        p_safe = torch.where(p > 0, p, torch.ones_like(p))
        res = rad / p_safe[:, None] if cfg.rr_mode == "reference" else rad
        result[live[ended]] = res[ended]
        go = ~ended
        if cfg.rr_mode == "standard":
            a = torch.where(go[:, None], a / torch.clamp_max(p_safe, 1.0)[:, None], a)
        att[live], radiance[live], seed[live] = a, rad, s
        origin[live], direction[live] = new_o, new_d
        depth[live] = depth[live] - 1
        live = live[go]
    result[live] = radiance[live]     # paths cut by the bounce cap keep what they gathered
    return result


def camera_rays(frame, width: int, height: int, pixel, seed, dtype):
    """Jittered pinhole rays through `pixel` (flat ids, row 0 the bottom);
    `frame` is (eye, U, V, W), each [N,3] or [3]."""
    eye, u_vec, v_vec, w_vec = (torch.as_tensor(a, device=pixel.device).to(dtype) for a in frame)
    seed, jx = uniform(seed, dtype)
    seed, jy = uniform(seed, dtype)
    dx = 2.0 * ((pixel % width).to(dtype) + jx) / width - 1.0
    dy = 2.0 * ((pixel // width).to(dtype) + jy) / height - 1.0
    target = dx[:, None] * u_vec + dy[:, None] * v_vec + w_vec
    direction = normalize(target)
    return eye.expand_as(direction).clone(), direction, seed


def launch_values(sc: RefScene, cfg: Settings, frames, width: int, height: int, pixels, spp: int, subframes,
                  chunk: int = 1 << 19):
    """Each pixel's mean over each launch's `spp` samples, [L,P,3] in
    `sc`'s dtype: launch l renders with camera frames[l] at subframes[l];
    a pixel's samples are summed in sample order, then divided by spp."""
    dev, dt = sc.device, sc.dtype
    n_l, n_p = len(frames), len(pixels)
    pix = torch.as_tensor(np.asarray(pixels), dtype=torch.int64, device=dev)
    launch = torch.arange(n_l, device=dev).repeat_interleave(n_p * spp)
    p_all = pix.repeat_interleave(spp).repeat(n_l)
    s_all = torch.arange(spp, device=dev).repeat(n_l * n_p)
    sub = torch.as_tensor(np.asarray(subframes, np.int64), device=dev)
    cams = [torch.as_tensor(np.stack([f[i] for f in frames]), device=dev) for i in range(4)]
    out = []
    for k in range(0, p_all.numel(), chunk):
        p, s, l = p_all[k:k + chunk], s_all[k:k + chunk], launch[k:k + chunk]
        o, d, seed = camera_rays([c[l] for c in cams], width, height, p, make_seeds(p, s, sub[l]), dt)
        out.append(trace(sc, cfg, o, d, seed))
    rad = torch.cat(out).reshape(n_l, n_p, spp, 3)
    total = rad[:, :, 0]
    for k in range(1, spp):
        total = total + rad[:, :, k]
    return total / torch.full((), float(spp), dtype=dt, device=dev)


def accumulate(values: list, spp: int):
    """The film's running mean over launches of `spp` samples each:
    acc_k = acc_{k-1} + (f_k - acc_{k-1}) * spp / ((k+1) spp), the factor a
    float32 quotient."""
    acc = values[0]
    for k, f in enumerate(values[1:], start=1):
        a = float(np.float32(spp) / (np.float32(k * spp) + np.float32(spp)))
        acc = acc + (f - acc) * a
    return acc
