"""Profiling: the port's span recorder and a device trace.

The recorder keeps host spans at the port's layer boundaries, in memory,
as `(name, start_ns, end_ns, parent, launch)`: both times from
`time.perf_counter_ns()`, `parent` the index of the enclosing span in
`spans()` (None at the top), `launch` the number of the launch the span
belongs to (each `ProgressiveRenderer.step` takes the next; a span
outside a step, such as `entry.set_camera`, carries the number of the
step that follows it).

    entry.step        ProgressiveRenderer.step, step_preview
    entry.set_camera  ProgressiveRenderer.set_camera
    entry.accumulate  the accumulation of a step
    entry.sync        the step's wait for the card (progressive._wait)
    frame.render      integrator.render_frame_stats
    frame.setup       render_pixels up to its schedule's loop: the
                      schedule, the camera spawn, the fresh buffers, the
                      plan's lookup and its buffers written
    loop.run          a schedule's loop
    loop.step         graph_loop.Plan.step: eager, warm-up, capture or replay
    loop.capture      graph_loop.Plan._capture
    loop.read         integrator._read, the loop's read of the card

It is off by default, and then `span()` tests one module flag and
records nothing: no allocation, no device operation, no sync.  It is on
after `enable()`, and for every launch that starts while a
`torch.profiler` session records (the switch follows the profiler at
each entry call: `ProgressiveRenderer.step`, `step_preview`,
`set_camera` and `render_frame_stats`), so a profiled run carries the
port's spans with no call of its own.  While on, it also keeps each
launch's record (`launches()`: the growth of `graph_loop.stats` over the
step, and the offset of the wall clock, on which `torch.profiler`
stamps its events, from `perf_counter_ns`) and each frame's counts of
the path and shadow segments its schedules traced, the 0-d tensors on
the card that the schedules' stats hold (`totals()` sums them: no device
operation until then).

`xla_trace` keeps the JAX package's name for the CLI's `--profile`: it
captures a `torch.profiler` trace (CPU activity, and CUDA activity when
a card is present) into a Chrome trace file under `logdir`, viewable in
Perfetto or chrome://tracing, and the recorder's spans beside it."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch

_forced = False      # enable() / disable()
_on = False          # the switch span() tests: _forced, or a profiler records
# Span i is (_names[i], _starts[i], _ends[i], _parents[i], _of_launch[i]):
# columns of strings and integers, which the garbage collector does not
# track, so a long recording adds nothing to its passes.
_names: list = []
_starts: list = []
_ends: list = []     # None while the span is open
_parents: list = []
_of_launch: list = []
_open: list = []     # indices of the open spans, innermost last
_launch = 0          # the number of the running step, or of the next one
_launches: dict = {}  # launch -> its record (the recorder on at its start)
_totals: dict = {}   # launch -> [(path segments, shadow segments)], 0-d tensors on the card
_OFF = contextlib.nullcontext()


def enable() -> None:
    global _forced, _on
    _forced = _on = True


def disable() -> None:
    global _forced, _on
    _forced = _on = False


def enabled() -> bool:
    return _on


def follow() -> bool:
    """Set the switch at an entry call: on after enable(), or while a
    torch.profiler session records."""
    global _on
    _on = _forced or torch.autograd._profiler_enabled()
    return _on


class _Span:
    __slots__ = ("name", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.index = len(_names)
        _names.append(self.name)
        _parents.append(_open[-1] if _open else None)
        _of_launch.append(_launch)
        _ends.append(None)
        _open.append(self.index)
        _starts.append(time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        i = self.index
        if i < len(_ends) and _ends[i] is None:  # not ended early, nor cleared
            _ends[i] = time.perf_counter_ns()
        if _open and _open[-1] == i:
            _open.pop()
        elif i in _open:
            _open.remove(i)


def span(name: str):
    """A span around a `with` block, recorded while the recorder is on."""
    if not _on:
        return _OFF
    return _Span(name)


def end(name: str) -> None:
    """End the innermost open span early if it is `name` (a span that a
    callee ends: `frame.setup` ends where the schedule's loop starts)."""
    if _open and _names[_open[-1]] == name:
        _ends[_open.pop()] = time.perf_counter_ns()


@contextlib.contextmanager
def launch(counters: dict) -> Iterator[None]:
    """One launch of the entry layer (a step): it takes the next launch
    number, follows the profiler, and while on records the growth of
    `counters` (graph_loop.stats) over the step and the wall clock's
    offset, under an `entry.step` span."""
    global _launch
    record = None
    if follow():
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        record = _launches[_launch] = dict(wall_offset_ns=wall - (p0 + p1) // 2)
        before = dict(counters)
    try:
        with span("entry.step"):
            yield
    finally:
        if record is not None:
            record.update((k, counters[k] - v) for k, v in before.items())
        _launch += 1


def add_totals(segments: torch.Tensor, shadow: torch.Tensor) -> None:
    """Keep a frame's 0-d segment counts, tensors that nothing writes
    again, for its launch's totals, while on."""
    if _on:
        _totals.setdefault(_launch, []).append((segments, shadow))


def spans() -> list:
    """The recorded spans, as tuples; an open span's end is None."""
    return list(zip(_names, _starts, _ends, _parents, _of_launch))


def launches() -> dict:
    """{launch: record} of the launches that started with the recorder on."""
    return {k: dict(v) for k, v in _launches.items()}


def totals(of: Optional[list] = None) -> dict:
    """The segments traced in the launches `of` (all by default), summed
    and read from the card once: {"segments", "shadow_segments"}."""
    found = [torch.stack(pair) for k in (_totals if of is None else of) for pair in _totals.get(k, ())]
    if not found:
        return dict(segments=0, shadow_segments=0)
    segments, shadow = torch.stack(found).sum(0).tolist()
    return dict(segments=segments, shadow_segments=shadow)


def clear() -> None:
    """Drop every span, launch record and segment count."""
    for column in (_names, _starts, _ends, _parents, _of_launch, _open):
        column.clear()
    _launches.clear()
    _totals.clear()


def self_times(of: Optional[list] = None) -> dict:
    """{name: ns}: each name's summed duration less what its child spans
    cover, over the closed spans of `of` (spans() by default)."""
    of = spans() if of is None else of
    covered = [0] * len(of)
    for name, start, end_, parent, _ in of:
        if parent is not None and end_ is not None:
            covered[parent] += end_ - start
    out = {}
    for (name, start, end_, _, _), kids in zip(of, covered):
        if end_ is not None:
            out[name] = out.get(name, 0) + (end_ - start) - kids
    return out


@contextlib.contextmanager
def xla_trace(logdir: str) -> Iterator[None]:
    """Trace the block with torch.profiler and the recorder, and write
    them to `logdir/trace-<pid>.json` and `logdir/spans-<pid>.json` (the
    --profile flag)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = _forced
    enable()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        if not was:
            disable()
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}.json"))
    with open(os.path.join(logdir, f"spans-{os.getpid()}.json"), "w") as f:
        json.dump(dict(spans=spans(), launches=launches(), totals=totals()), f)
