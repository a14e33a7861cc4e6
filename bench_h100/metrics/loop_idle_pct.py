"""The device's idle time inside the port's loops, in percent of the
traced slice: the slice's wall less the union of its device events,
intersected with the `loop.run` spans moved onto the trace's clock, over
the slice's wall time.  At most `device_idle_pct`; the rest of that idle
lies in the frame's set-up, after the loop and between launches."""

from bench_h100 import devtrace, program_spans

UNIT = "%"
LAYER = "loop"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ()


def read(ctx):
    p = program_spans.of(ctx)
    if p is None or not ctx.device or ctx.wall_s <= 0:
        return None
    runs = [(start, end) for name, start, end, _ in p.spans if name == "loop.run"]
    if not runs:
        return None
    busy = devtrace.busy_intervals(ctx.device)
    idle = sum(program_spans.idle_within(busy, start, end) for start, end in runs)
    return idle / (ctx.wall_s * 1e9) * 100.0
