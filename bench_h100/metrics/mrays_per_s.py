"""Millions of ray segments per second over the traced slice: path
segments plus NEE's shadow segments by the schedule's own count, over
the slice's wall time."""

UNIT = "Mrays/s"
LAYER = "frame"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ()


def read(ctx):
    rays = ctx.segments + ctx.shadow_segments
    return rays / ctx.wall_s / 1e6 if rays and ctx.wall_s > 0 else None
