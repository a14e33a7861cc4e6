"""Profiling: wall-clock buckets and an optional device trace, as
`tpu_pathtracer/runtime/profiler.py`.

`FrameStats` keeps named wall-clock buckets (the reference's
state/render/display accumulators).  `xla_trace` keeps the JAX package's
name for the CLI's `--profile` and captures a `torch.profiler` trace
(CPU activity, and CUDA activity when a card is present) into a Chrome
trace file under `logdir`, viewable in Perfetto or chrome://tracing."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class FrameStats:
    """Accumulating wall-clock buckets (state/render/display analog)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def bucket(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        parts = []
        for name in sorted(self.totals):
            n = max(self.counts[name], 1)
            parts.append(f"{name}: {self.totals[name]/n*1e3:.2f} ms/it (x{n})")
        return " | ".join(parts)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def xla_trace(logdir: str) -> Iterator[None]:
    """Trace the block with torch.profiler and write it to
    `logdir/trace-<pid>.json` (the --profile flag)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}.json"))
