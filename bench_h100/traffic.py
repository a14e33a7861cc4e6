"""The one traffic generator: what each launch of a window asks for, from
a mix's parameters (mixes/<traffic>.json), the cell's configuration and
the run's seed.  One client in a closed loop: the next launch starts
when the last one has ended, as in the viewer and the CLI.

A mix names its `kind`, the launch loop `kinds/<kind>.py`: the subframe
and the eye of launch k, what a launch does (`Loop.launch`), what it
keeps for the check (`Loop.keep`, `Loop.values`) and how the reference's
launches fold into what is compared (`expected`).  The seed draws, in
this order, the starting subframe, the starting yaw and the pixels that
the check compares; it never changes the scene, the image size or the
samples a launch."""

from __future__ import annotations

import numpy as np

from bench_h100 import spec

SUBFRAMES = 1 << 24


class Traffic:
    def __init__(self, mix: dict, config: dict, seed: int):
        self.mix = mix
        self.kind = spec.kind(mix["kind"])
        rng = np.random.default_rng(seed)
        self.spp = int(mix["samples_per_launch"])
        self.render = dict(config["render"], samples_per_launch=self.spp, **mix.get("render", {}))
        self.width, self.height = self.render["width"], self.render["height"]
        self.start_subframe = int(rng.integers(0, SUBFRAMES))
        self.camera = config["camera"]
        self.yaw0 = float(rng.uniform(0.0, 360.0))
        self.pixels = np.sort(rng.choice(self.width * self.height, int(mix["check_pixels"]), replace=False))
        self.trace_start = float(mix.get("trace_start", 1 / 3))
        self.trace_seconds = float(mix.get("trace_seconds", 1.5))

    def subframe(self, k: int) -> int:
        """The subframe launch k renders (the renderer's counter)."""
        return self.kind.subframe(self, k)

    def eye(self, k: int):
        """The camera's eye at launch k."""
        return self.kind.eye(self, k)

    def pixels_on(self, device):
        import torch

        return torch.as_tensor(self.pixels, device=device)
