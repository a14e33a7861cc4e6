"""Progressive rendering driver: the per-launch loop, the accumulation
reset on camera change, checkpoint/resume and per-launch metrics.
Counterpart of `tpu_pathtracer/runtime/progressive.py`.  With a `mesh`
(parallel/shard.py) each launch is rendered across its ranks
(`render_frame_sharded` in `shard_mode`): every rank runs the same
renderer and holds the whole accumulation, and rank 0 alone writes
checkpoints.

The renderer's whole state is (accumulation buffer, subframe index,
samples accumulated, camera, config): the counter-based RNG makes that
enough to resume bit for bit, so a checkpoint taken at any subframe and
reloaded gives the same image as an uninterrupted run.

Host and device: the buffer lives on the scene's device.  A step queues
its launch and the accumulation and then waits for the device once, for
its timing (`torch.cuda.synchronize`); the image comes to the host only
at output (`image_u8`, `image_hdr`), checkpoint and fingerprint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays
from tpu_pathtracer_torch.render.film import accumulate_weighted, post_process, to_uint8
from tpu_pathtracer_torch.render.integrator import render_frame
from tpu_pathtracer_torch.utils import logging as plog


def _wait(t: torch.Tensor) -> None:
    """Wait for the device's queued work (the step's one sync)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class ProgressiveRenderer:
    """Owns the accumulation buffer and the subframe counter."""

    def __init__(self, scene, camera: Camera, cfg: RenderConfig, mesh=None, shard_mode: str = "pixels",
                 preview_scale="auto", preview_budget_s: float = 0.125, denoise: bool = False,
                 check_finite: bool = False):
        self.scene = scene
        self.device = scene.device
        self.mesh = mesh
        self.shard_mode = shard_mode
        # Edge-avoiding A-Trous denoise of the displayed and saved image,
        # guided by a per-camera G-buffer (render/aov.py).  Display path
        # only: the accumulation, checkpoints and EXR stay raw.
        self.denoise = denoise
        # Test every launch's frame for a non-finite value and raise at the
        # first (the CLI's --debug-nans; a host read a launch when on).
        self.check_finite = check_finite
        self._aov = None
        self.cfg = cfg
        self.camera = camera.with_aspect(cfg.width, cfg.height)
        self.accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=self.device)
        self.subframe = 0
        # Samples accumulated so far: the converge ramp mixes launch sizes,
        # so this is not always subframe * samples_per_launch.
        self._accum_spp = 0
        self._cam_arrays = camera_arrays(self.camera, cfg, self.device)
        self.frame_times: list[float] = []
        self._frame_paths: list[int] = []  # traced paths per step, for stats
        # Adaptive preview: while the camera moves the viewer renders at
        # 1/preview_scale resolution and 1 spp.  An int fixes the scale
        # (0/1 disables); "auto" starts at 1/4 and steps finer while the
        # measured preview frames stay under preview_budget_s, backing off
        # from (and barring, for a while) a scale that misses it.
        self.preview_budget_s = preview_budget_s
        self._pv_auto = preview_scale == "auto"
        self._pv_scale = 4 if self._pv_auto else int(preview_scale or 0)
        self._pv_floor = 1          # finest scale auto may try
        self._pv_good = 0           # consecutive fast frames at the floor
        self._pv_times: dict[int, list] = {}
        self._pv_cams: dict[tuple, dict] = {}  # preview camera arrays by size
        self._preview_img: Optional[torch.Tensor] = None

    @property
    def preview_scale(self) -> int:
        return self._pv_scale

    @property
    def _preview_cfg(self) -> Optional[RenderConfig]:
        return self._make_preview_cfg(self._pv_scale)

    def _make_preview_cfg(self, scale: int) -> Optional[RenderConfig]:
        if not scale:
            return None
        if scale <= 1:
            if not self._pv_auto:
                return None          # explicit 0/1 = previews disabled
            return self.cfg.replace(samples_per_launch=1)  # full-res 1 spp
        pw = max(16, (self.cfg.width // scale) // 16 * 16)
        ph = max(8, (self.cfg.height // scale) // 8 * 8)
        return self.cfg.replace(width=pw, height=ph, samples_per_launch=1)

    def _pv_update(self, dt: float) -> None:
        """Auto-preview controller: step finer while comfortably under
        budget, back off (and bar) a scale that misses it.  The bar ages:
        after 8 consecutive fast frames at the floor the next finer scale
        gets one fresh try."""
        ts = self._pv_times.setdefault(self._pv_scale, [])
        ts.append(dt)
        del ts[:-8]                  # bounded per-scale history
        if len(ts) < 3:              # the first frames include kernel builds
            return
        med = sorted(ts[-3:])[1]
        if med > 1.25 * self.preview_budget_s and self._pv_scale < 16:
            self._pv_floor = max(self._pv_floor, self._pv_scale * 2)
            self._pv_scale *= 2
            self._pv_good = 0
        elif med < 0.5 * self.preview_budget_s:
            if self._pv_scale > self._pv_floor:
                self._pv_scale //= 2
            elif self._pv_floor > 1:
                self._pv_good += 1
                if self._pv_good >= 8:
                    self._pv_good = 0
                    self._pv_floor //= 2
                    self._pv_scale = self._pv_floor
                    self._pv_times.pop(self._pv_scale, None)

    # -- camera interaction ----------------------------------------------
    def set_camera(self, camera: Camera) -> None:
        """A camera change resets the accumulation."""
        self.camera = camera.with_aspect(self.cfg.width, self.cfg.height)
        self._cam_arrays = camera_arrays(self.camera, self.cfg, self.device)
        self._pv_cams.clear()
        self._aov = None            # the G-buffer is per camera
        self.reset()

    def reset(self) -> None:
        self.accum = torch.zeros_like(self.accum)
        self.subframe = 0
        self._accum_spp = 0
        self.frame_times.clear()
        self._frame_paths.clear()

    def _check(self, frame: torch.Tensor) -> None:
        if self.check_finite and not bool(torch.isfinite(frame).all()):
            bad = int((~torch.isfinite(frame)).any(dim=-1).sum())
            raise FloatingPointError(f"launch {self.subframe}: {bad} pixels are not finite")

    # -- adaptive preview (camera in motion) ------------------------------
    def step_preview(self) -> bool:
        """Render one low-res 1-spp frame into the preview buffer (shown by
        image_u8 until the next full-res step).  False when previews are
        off."""
        pcfg = self._preview_cfg
        if pcfg is None:
            return False
        t0 = time.perf_counter()
        size = (pcfg.width, pcfg.height)
        if size not in self._pv_cams:
            self._pv_cams[size] = camera_arrays(self.camera.with_aspect(*size), pcfg, self.device)
        pcam = self._pv_cams[size]
        frame = render_frame(self.scene, pcam, pcfg, self.subframe)
        if self.denoise:
            # One cheap G-buffer pass at preview size turns 1-spp speckle
            # into a stable image while the camera moves.
            from tpu_pathtracer_torch.render.aov import atrous_denoise, defocus_mask, render_aov

            paov = render_aov(self.scene, pcam, pcfg)
            frame = atrous_denoise(frame, paov, defocus=defocus_mask(paov, pcfg), iterations=3, sigma_color=4.0)
        self._check(frame)
        _wait(frame)
        self._preview_img = frame
        if self._pv_auto:
            self._pv_update(time.perf_counter() - t0)
        return True

    # -- the per-launch step ------------------------------------------------
    def step(self, spp: Optional[int] = None) -> torch.Tensor:
        """Render one launch, accumulate, advance the subframe; returns the
        accumulation.  `spp` overrides the launch's sample count (the
        converge ramp); accumulation weighs by sample count, so mixed
        launches stay an unbiased mean and constant-spp histories equal
        the plain EWMA bit for bit (film.accumulate_weighted)."""
        launch_spp = spp or self.cfg.samples_per_launch
        cfg_l = (self.cfg if launch_spp == self.cfg.samples_per_launch
                 else self.cfg.replace(samples_per_launch=launch_spp))
        t0 = time.perf_counter()
        if self.mesh is not None:
            from tpu_pathtracer_torch.parallel.shard import render_frame_sharded

            frame = render_frame_sharded(self.scene, self._cam_arrays, cfg_l, self.subframe, self.mesh,
                                         mode=self.shard_mode)
        else:
            frame = render_frame(self.scene, self._cam_arrays, cfg_l, self.subframe)
        self._check(frame)
        self.accum = accumulate_weighted(self.accum, frame, self._accum_spp, launch_spp)
        _wait(self.accum)
        self.frame_times.append(time.perf_counter() - t0)
        self._frame_paths.append(self.cfg.width * self.cfg.height * launch_spp)
        self.subframe += 1
        self._accum_spp += launch_spp
        self._preview_img = None  # full-res data supersedes the preview
        return self.accum

    def step_converge(self) -> torch.Tensor:
        """`step()`, but the first launches after a reset follow a doubling
        ramp (1, 1, 2, 4, ... up to half the configured batch) so that the
        display refines within about one 1-spp launch of the camera
        settling.  Sharded renderers skip the ramp (mode "samples" needs
        the launch's spp to divide across the ranks)."""
        full = self.cfg.samples_per_launch
        if self.mesh is not None or full <= 2:
            return self.step()
        if self._accum_spp < full // 2:
            return self.step(spp=max(1, min(self._accum_spp, full // 2)))
        return self.step()

    def render_spp(self, total_spp: int, log_every: int = 10) -> torch.Tensor:
        """Progressive loop until >= total_spp samples are accumulated."""
        spp_per_frame = self.cfg.samples_per_launch
        n_frames = max(1, -(-total_spp // spp_per_frame))
        target = n_frames * spp_per_frame
        while self._accum_spp < target:
            self.step()
            if log_every and self.subframe % log_every == 0:
                plog.info(
                    "progressive",
                    f"subframe {self.subframe}/{n_frames} ({self._accum_spp} spp, "
                    f"{self.frame_times[-1]*1e3:.1f} ms/frame)",
                )
        return self.accum

    @property
    def spp(self) -> int:
        return self._accum_spp

    def image_u8(self) -> np.ndarray:
        """Post-processed display image, [H,W,3] uint8 with row 0 the top
        (PNG order).  While a preview frame is pending (camera in motion,
        nothing accumulated yet) it is shown instead, nearest-upscaled to
        the display size."""
        if self._preview_img is not None and self.subframe == 0:
            out = to_uint8(post_process(self._preview_img, self.cfg)).cpu().numpy()[::-1]
            ry = self.cfg.height / out.shape[0]
            rx = self.cfg.width / out.shape[1]
            yi = np.minimum((np.arange(self.cfg.height) / ry).astype(np.int32), out.shape[0] - 1)
            xi = np.minimum((np.arange(self.cfg.width) / rx).astype(np.int32), out.shape[1] - 1)
            return out[yi][:, xi]
        return to_uint8(post_process(self._linear_image(), self.cfg)).cpu().numpy()[::-1]

    def _linear_image(self) -> torch.Tensor:
        """Linear radiance for display and output: the accumulation,
        A-Trous-denoised when enabled and something is accumulated."""
        if not self.denoise or self.subframe == 0:
            return self.accum
        from tpu_pathtracer_torch.render.aov import atrous_denoise, defocus_mask, render_aov

        if self._aov is None:
            self._aov = render_aov(self.scene, self._cam_arrays, self.cfg)
        return atrous_denoise(self.accum, self._aov, defocus=defocus_mask(self._aov, self.cfg))

    def image_hdr(self) -> np.ndarray:
        """Raw linear HDR accumulation (row 0 = top) for EXR output: never
        denoised, since external denoisers and compositors want the
        unfiltered signal."""
        return self.accum.cpu().numpy()[::-1]

    def stats(self) -> dict:
        drop = 1 if len(self.frame_times) > 1 else 0  # the first builds kernels
        times = self.frame_times[drop:]
        paths = self._frame_paths[drop:]
        if not times:
            return {}
        st = {
            "subframe": self.subframe,
            "spp": self.spp,
            "ms_per_frame": float(np.mean(times)) * 1e3,
            "paths_per_sec": float(np.sum(paths)) / float(np.sum(times)),
        }
        pts = self._pv_times.get(self._pv_scale)
        if pts:
            st["preview_scale"] = self._pv_scale
            st["preview_ms"] = float(sorted(pts[-3:])[len(pts[-3:]) // 2]) * 1e3
        return st

    # -- checkpoint / resume ------------------------------------------------
    def _scene_fingerprint(self) -> str:
        """Content hash of the scene's geometry, materials and lighting, so
        that a resume against a different scene (same config) is refused
        instead of blending two renders."""
        h = hashlib.sha1()
        for t in (self.scene.vertices, self.scene.mat_ids, self.scene.materials.attrs, self.scene.env.data):
            a = t.cpu().numpy()
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    def save_checkpoint(self, path: str) -> None:
        """Write the accumulation and its metadata (rank 0 alone under a
        mesh: every rank holds the same accumulation)."""
        if self.mesh is not None and self.mesh.rank != 0:
            return
        meta = {
            "subframe": self.subframe,
            "accum_spp": self._accum_spp,
            "camera": dataclasses.asdict(self.camera),
            "config": dataclasses.asdict(self.cfg),
            "scene": self._scene_fingerprint(),
            "version": 3,
        }
        np.savez_compressed(path, accum=self.accum.cpu().numpy(), meta=json.dumps(meta))
        plog.info("checkpoint", f"saved {path} @ subframe {self.subframe}")

    def load_checkpoint(self, path: str) -> None:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        # The JSON round trip turns tuples into lists: normalise both sides.
        cfg_d = json.loads(json.dumps(dataclasses.asdict(self.cfg)))
        if meta["config"] != cfg_d:
            diff = {k: (meta["config"].get(k), cfg_d[k]) for k in cfg_d if meta["config"].get(k) != cfg_d[k]}
            raise ValueError(f"checkpoint config mismatch: {diff}")
        ckpt_scene = meta.get("scene")
        if ckpt_scene is not None and ckpt_scene != self._scene_fingerprint():
            raise ValueError(
                "checkpoint scene mismatch: the checkpoint was rendered from different "
                "geometry/materials/lighting than the current scene"
            )
        self.accum = torch.as_tensor(data["accum"], device=self.device)
        self.subframe = int(meta["subframe"])
        self._accum_spp = int(meta.get("accum_spp", self.subframe * self.cfg.samples_per_launch))
        cam = meta["camera"]
        self.camera = Camera(eye=tuple(cam["eye"]), lookat=tuple(cam["lookat"]), up=tuple(cam["up"]),
                             fov_y=cam["fov_y"], aspect=cam["aspect"])
        self._cam_arrays = camera_arrays(self.camera, self.cfg, self.device)
        self._pv_cams.clear()
        self._aov = None
        plog.info("checkpoint", f"resumed {path} @ subframe {self.subframe}")
