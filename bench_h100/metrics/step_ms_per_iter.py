"""Device milliseconds per loop iteration of the schedule steps: the
stream's step (TPU kernel 7) and the path step (ops/fused_schedule.py)."""

UNIT = "ms"
LAYER = "schedule"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ("fused_step_kernel", "path_step_kernel")


def read(ctx):
    seconds = ctx.seconds_of(ctx.device, KERNELS)
    return seconds / ctx.iters * 1e3 if seconds > 0 and ctx.iters else None
