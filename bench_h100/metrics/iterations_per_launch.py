"""Loop iterations per launch, by the schedule's own count
(`render_frame_stats`' iters of each traced launch, rendered again after
the window: the counts are deterministic)."""

UNIT = "iterations"
LAYER = "frame"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ()


def read(ctx):
    return ctx.iters / ctx.launches if ctx.launches else None
