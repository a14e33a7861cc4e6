"""Pinhole / thin-lens camera with a sutil-compatible UVW frame, and the
primary-ray generator.  Counterpart of `tpu_pathtracer/render/camera.py`,
`integrator.generate_camera_rays` and `integrator.camera_arrays`.

    W = lookat - eye                      (|W| = focal length)
    U = normalize(cross(W, up)) * |W| * tan(fovY/2) * aspect
    V = normalize(cross(U, W)) * |W| * tan(fovY/2)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.utils import math as vm
from tpu_pathtracer_torch.utils import rng

Vec3 = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Camera:
    """Host-side camera state; arrays are derived on demand."""

    eye: Vec3 = (0.0, 2.0, 6.0)
    lookat: Vec3 = (0.0, 0.0, 0.0)
    up: Vec3 = (0.0, 1.0, 0.0)
    fov_y: float = 50.0
    aspect: float = 4.0 / 3.0

    def with_aspect(self, width: int, height: int) -> "Camera":
        return dataclasses.replace(self, aspect=float(width) / float(height))

    def uvw_frame(self):
        """(U, V, W) as float32 numpy [3] arrays (computed in float64)."""
        eye = np.asarray(self.eye, dtype=np.float64)
        lookat = np.asarray(self.lookat, dtype=np.float64)
        up = np.asarray(self.up, dtype=np.float64)

        w = lookat - eye
        wlen = np.linalg.norm(w)
        u = np.cross(w, up)
        u /= np.linalg.norm(u)
        v = np.cross(u, w)
        v /= np.linalg.norm(v)

        vlen = wlen * math.tan(0.5 * math.radians(self.fov_y))
        ulen = vlen * self.aspect
        return (
            (u * ulen).astype(np.float32),
            (v * vlen).astype(np.float32),
            w.astype(np.float32),
        )

    def eye_np(self):
        return np.asarray(self.eye, dtype=np.float32)

    # ---- trackball-style interaction (viewer) -------------------------
    def orbit(self, d_yaw: float, d_pitch: float) -> "Camera":
        """Orbit the eye around the look-at point (degrees), pitch held
        inside +-1.55 rad."""
        eye = np.asarray(self.eye, dtype=np.float64)
        lookat = np.asarray(self.lookat, dtype=np.float64)
        rel = eye - lookat
        r = np.linalg.norm(rel)
        yaw = math.atan2(rel[0], rel[2]) + math.radians(d_yaw)
        pitch = math.asin(np.clip(rel[1] / max(r, 1e-9), -1.0, 1.0))
        pitch = np.clip(pitch + math.radians(d_pitch), -1.55, 1.55)
        new_rel = r * np.array(
            [math.cos(pitch) * math.sin(yaw), math.sin(pitch), math.cos(pitch) * math.cos(yaw)]
        )
        return dataclasses.replace(self, eye=tuple((lookat + new_rel).tolist()))

    def zoom(self, factor: float) -> "Camera":
        """Dolly toward (factor < 1) or away from the look-at point."""
        eye = np.asarray(self.eye, dtype=np.float64)
        lookat = np.asarray(self.lookat, dtype=np.float64)
        rel = (eye - lookat) * factor
        return dataclasses.replace(self, eye=tuple((lookat + rel).tolist()))

    def pan(self, dx: float, dy: float) -> "Camera":
        """Translate eye and look-at in the view plane."""
        u, v, _ = self.uvw_frame()
        delta = (dx * u + dy * v).astype(np.float64)
        eye = np.asarray(self.eye, dtype=np.float64) + delta
        lookat = np.asarray(self.lookat, dtype=np.float64) + delta
        return dataclasses.replace(self, eye=tuple(eye.tolist()), lookat=tuple(lookat.tolist()))


def camera_arrays(camera: Camera, cfg: RenderConfig, device) -> dict:
    """Camera -> {"eye","U","V","W"} float32 [3] tensors on `device`."""
    cam = camera.with_aspect(cfg.width, cfg.height)
    u, v, w = cam.uvw_frame()
    return {
        k: torch.as_tensor(a, device=device)
        for k, a in (("eye", cam.eye_np()), ("U", u), ("V", v), ("W", w))
    }


def generate_camera_rays(
    cam: dict,
    pixel_x: torch.Tensor,   # [N] int
    pixel_y: torch.Tensor,   # [N] int
    seeds: torch.Tensor,     # [N] int64 holding u32
    cfg: RenderConfig,
):
    """Primary rays with sub-pixel jitter and optional thin-lens DOF.
    Returns (origins [N,3], directions [N,3], seeds)."""
    eye, u_vec, v_vec, w_vec = cam["eye"], cam["U"], cam["V"], cam["W"]
    width = float(cfg.width)
    height = float(cfg.height)

    seeds, jx, jy = rng.uniform2(seeds)
    dx = 2.0 * (pixel_x.to(torch.float32) + jx) / width - 1.0
    dy = 2.0 * (pixel_y.to(torch.float32) + jy) / height - 1.0

    target = dx[:, None] * u_vec + dy[:, None] * v_vec + w_vec

    if cfg.dof:
        # The reference passes the seed by value to its defocus sampler, so
        # these two draws come from a discarded local chain.
        local = seeds
        local, r_u = rng.uniform(local)
        local, theta_u = rng.uniform(local)
        r = torch.sqrt(r_u)
        theta = (2.0 * math.pi) * theta_u
        # radius ~ u^(1/4): the reference applies sqrt twice.
        radius = cfg.dof_blurriness * torch.sqrt(r)
        off = (radius * torch.cos(theta))[:, None] * u_vec + (
            radius * torch.sin(theta)
        )[:, None] * v_vec
        directions = vm.normalize(cfg.focus_distance * target - off)
        origins = off + eye
    else:
        directions = vm.normalize(target)
        origins = eye.expand_as(directions).clone()

    return origins, directions, seeds
