"""Before each launch the camera orbits the look-at point by the mix's
`yaw_step_deg` (pitch unchanged), which restarts the image, as a user
dragging in the viewer.  The seed sets the starting yaw; a camera move
sets the renderer's subframe to 0.  The check compares every launch's
image."""

from __future__ import annotations

import contextlib
import math

import numpy as np


def subframe(tr, k: int) -> int:
    return 0


def eye(tr, k: int):
    """The eye at launch k (the look-at point and up fixed)."""
    eye0 = np.asarray(tr.camera["eye"], np.float64)
    lookat = np.asarray(tr.camera["lookat"], np.float64)
    rel = eye0 - lookat
    r = np.linalg.norm(rel)
    yaw = math.atan2(rel[0], rel[2]) + math.radians(tr.yaw0 + k * float(tr.mix["yaw_step_deg"]))
    pitch = math.asin(np.clip(rel[1] / max(r, 1e-9), -1.0, 1.0))
    new = r * np.array([math.cos(pitch) * math.sin(yaw), math.sin(pitch), math.cos(pitch) * math.cos(yaw)])
    return tuple((lookat + new).tolist())


class Loop:
    def __init__(self, tr, r, program, device):
        self.tr, self.r, self.program = tr, r, program
        self.pix, self.got = tr.pixels_on(device), []

    def launch(self, k: int, spans=None):
        cam = self.program.camera(self.tr.camera, eye(self.tr, k))
        with spans.span("set_camera") if spans else contextlib.nullcontext():
            self.r.set_camera(cam)
        return self.r.step()

    def keep(self, img) -> None:
        self.got.append(img.reshape(-1, 3)[self.pix])

    def values(self):
        """[L,P,3]: each launch's image at the checked pixels."""
        import torch

        return torch.stack(self.got).cpu().numpy()


def expected(per_launch, tr, ref):
    return per_launch
