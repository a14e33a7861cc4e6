"""Device milliseconds per loop iteration of the shading kernels: the
bounce kernel (ops/bounce.py), the NEE kernel and the camera kernel
(ops/camera.py).  A programmatic dependent's traced time holds its wait
behind the launch before it."""

UNIT = "ms"
LAYER = "bounce"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ("bounce_kernel", "shade_lanes_kernel", "nee_kernel", "camera_kernel")


def read(ctx):
    seconds = ctx.seconds_of(ctx.device, KERNELS)
    return seconds / ctx.iters * 1e3 if seconds > 0 and ctx.iters else None
