"""The device's idle share of the traced slice, in percent: one less the
union of the device events' intervals over the slice's wall time."""

UNIT = "%"
LAYER = "device"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ()


def read(ctx):
    return (1.0 - ctx.busy_s / ctx.wall_s) * 100.0 if ctx.busy_s > 0 and ctx.wall_s > 0 else None
