"""The host's set-up of a frame before its loop, in milliseconds a
launch: the port's `frame.setup` spans (the schedule's choice, the
camera spawn, the fresh buffers, the plan's lookup and its buffers
written: ROADMAP §1.2c) summed over the traced slice, over its
launches."""

from bench_h100 import program_spans

UNIT = "ms"
LAYER = "frame"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ()


def read(ctx):
    p = program_spans.of(ctx)
    if p is None:
        return None
    setups = [end - start for name, start, end, _ in p.spans if name == "frame.setup"]
    return sum(setups) / p.launches / 1e6 if setups else None
