"""CUDA graphs the loop captured during the window
(`graph_loop.stats["captures"]`): every launch should replay the graph the
warm launch captured, a camera move included."""

UNIT = "count"
LAYER = "loop"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ()


def read(ctx):
    return ctx.captures_in_window
