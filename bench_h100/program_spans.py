"""The port's own spans and counters over the traced slice, for the
readers in metrics/ whose source is `program_span` or `program_counter`.

The port's recorder (tpu_pathtracer_torch/runtime/profiler.py) records
every launch that starts while torch.profiler records, so the traced
slice's launches are the last `ctx.launches` it recorded (a retaken
slice records its launches again, after the first take's).  Each
launch's record holds the wall clock's offset from
`time.perf_counter_ns()`; torch.profiler stamps its events on the wall
clock, so a span moves onto the trace's clock by that offset.  Where the
program has no recorder, or it recorded nothing, `of` gives None and so
does every reader that needs it."""

from __future__ import annotations

import bisect
import statistics
from types import SimpleNamespace


def of(ctx):
    """The slice's program spans and counters, read once a context:
    `launches`, `spans` [(name, start_ns, end_ns, parent's name)] on the
    trace's clock, `iterations`, `lanes`, `segments`, `shadow_segments`;
    or None."""
    if not hasattr(ctx, "program"):
        ctx.program = _recorded(ctx.launches)
    return ctx.program


def _recorded(count: int):
    try:
        from tpu_pathtracer_torch.runtime import profiler
    except ImportError:
        return None
    if not count or not hasattr(profiler, "launches"):
        return None
    records = profiler.launches()
    chosen = sorted(records)[-count:]
    if len(chosen) < count:
        return None
    shift = int(statistics.median(records[k]["wall_offset_ns"] for k in chosen))
    every, keep = profiler.spans(), set(chosen)
    spans = [(name, start + shift, end + shift, None if parent is None else every[parent][0])
             for name, start, end, parent, launch in every if launch in keep and end is not None]
    return SimpleNamespace(launches=count, spans=spans, iterations=sum(records[k]["iterations"] for k in chosen),
                           lanes=sum(records[k]["lanes"] for k in chosen), **profiler.totals(chosen))


def idle_within(busy: list, start: int, end: int) -> int:
    """Nanoseconds of [start, end) that no interval of `busy` (sorted,
    disjoint [start_ns, end_ns] pairs, devtrace.busy_intervals) covers."""
    covered = 0
    for b0, b1 in busy[max(0, bisect.bisect_right(busy, [start]) - 1):]:
        if b0 >= end:
            break
        covered += max(0, min(b1, end) - max(b0, start))
    return (end - start) - covered
