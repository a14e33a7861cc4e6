"""The share of the lanes traced that carried a live path, in percent:
the path segments the slice's schedules traced (the port's recorder's
device totals) over the lanes its loops ran (the growth of
`graph_loop.stats["lanes"]`: each plan's lane count once an iteration).
What skipping ended lanes (ROADMAP §1.2e) would cut is the rest."""

from bench_h100 import program_spans

UNIT = "%"
LAYER = "frame"
MOVES = {"batch": "msamples_per_s", "orbit": "preview_ms_p95"}
KERNELS = ()


def read(ctx):
    p = program_spans.of(ctx)
    if p is None or not p.lanes or not p.segments:
        return None
    return p.segments / p.lanes * 100.0
