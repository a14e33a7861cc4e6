"""The host's milliseconds per loop iteration when it is not blocked in
the loop's read of the card: the port's `loop.run` spans less their
`loop.read` children, summed over the traced slice, over its iterations
(the growth of `graph_loop.stats["iterations"]`).  It is the host's share
of each iteration's gap on the card, which reading `live` every k-th
iteration (ROADMAP §1.2b) would hide."""

from bench_h100 import program_spans

UNIT = "ms"
LAYER = "loop"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ()


def read(ctx):
    p = program_spans.of(ctx)
    if p is None or not p.iterations:
        return None
    runs = sum(end - start for name, start, end, _ in p.spans if name == "loop.run")
    reads = sum(end - start for name, start, end, parent in p.spans if name == "loop.read" and parent == "loop.run")
    return (runs - reads) / p.iterations / 1e6 if runs else None
