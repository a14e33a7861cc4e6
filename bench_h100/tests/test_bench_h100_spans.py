"""The readers of the port's own spans and counters (program_spans.py and
metrics/loop_host_ms_per_iter.py, loop_idle_pct.py, frame_setup_ms.py,
live_lane_pct.py) on a synthetic slice with known spans and idle
intervals; their silence where the program has no recorder; and the
recorder read after real launches under torch.profiler on the CPU, its
spans moved onto the profiler's clock."""

import sys
import types
from types import SimpleNamespace

import pytest

from bench_h100 import devtrace, program_spans, spec

MS = 1_000_000  # ns


def ev(start_ms, dur_ms):
    return ("k", int(start_ms * MS), int(dur_ms * MS))


def span(name, start_ms, end_ms, parent):
    return (name, int(start_ms * MS), int(end_ms * MS), parent)


# Two launches on the trace's clock.  Launch 1: set-up 0-2 ms, its loop
# 2-10 ms with two reads (3-4, 6-7) and a read inside a step (8.5-8.6);
# launch 2: set-up 10-11, loop 11-15.  The card is busy 1.5-2.2, 2.5-3.5,
# 4-6, 8-9 and 12-14 ms, in a slice of 20 ms.
SPANS = [span("entry.step", 0, 10, None), span("frame.setup", 0, 2, "frame.render"),
         span("loop.run", 2, 10, "frame.render"), span("loop.read", 3, 4, "loop.run"),
         span("loop.read", 6, 7, "loop.run"), span("loop.read", 8.5, 8.6, "loop.step"),
         span("frame.setup", 10, 11, "frame.render"), span("loop.run", 11, 15, "frame.render")]
EVENTS = [ev(1.5, 0.7), ev(2.5, 1), ev(4, 2), ev(8, 1), ev(12, 2)]


def synthetic():
    program = SimpleNamespace(launches=2, spans=SPANS, iterations=5, lanes=1000, segments=300, shadow_segments=0)
    return SimpleNamespace(device=EVENTS, wall_s=0.02, busy_s=devtrace.busy_seconds(EVENTS), launches=2,
                           program=program)


@pytest.mark.parametrize("metric, value", [
    # (8 + 4 ms of loop - 1 - 1 ms of its own reads) / 5 iterations
    ("loop_host_ms_per_iter", (12 - 2) / 5),
    # idle in the loops: 8 - (0.2 + 1 + 2 + 1) and 4 - 2 ms, of 20
    ("loop_idle_pct", (3.8 + 2) / 20 * 100),
    # (2 + 1 ms) over 2 launches
    ("frame_setup_ms", 1.5),
    # 300 segments over 1,000 lanes
    ("live_lane_pct", 30.0),
])
def test_reader_on_a_synthetic_slice(metric, value):
    ctx = synthetic()
    assert spec.reader(metric).read(ctx) == pytest.approx(value)
    if metric == "loop_idle_pct":
        assert value <= spec.reader("device_idle_pct").read(ctx)


def test_idle_within_an_interval():
    busy = devtrace.busy_intervals(EVENTS)
    assert program_spans.idle_within(busy, 2 * MS, 10 * MS) == pytest.approx(3.8 * MS)
    assert program_spans.idle_within(busy, 0, MS) == MS
    assert program_spans.idle_within(busy, 4 * MS, 6 * MS) == 0
    assert program_spans.idle_within([], 0, 5) == 5


@pytest.mark.parametrize("metric", ["loop_host_ms_per_iter", "loop_idle_pct", "frame_setup_ms", "live_lane_pct"])
def test_readers_are_silent_without_the_recorder(monkeypatch, metric):
    """A program without the recorder (an older port's profiler module),
    or one that recorded fewer launches than the slice, gives nothing."""
    import tpu_pathtracer_torch.runtime

    older = types.ModuleType("tpu_pathtracer_torch.runtime.profiler")
    monkeypatch.setitem(sys.modules, "tpu_pathtracer_torch.runtime.profiler", older)
    monkeypatch.setattr(tpu_pathtracer_torch.runtime, "profiler", older, raising=False)
    ctx = SimpleNamespace(device=EVENTS, wall_s=0.02, launches=2)
    assert spec.reader(metric).read(ctx) is None
    monkeypatch.undo()
    from tpu_pathtracer_torch.runtime import profiler

    profiler.clear()
    assert spec.reader(metric).read(SimpleNamespace(device=EVENTS, wall_s=0.02, launches=2)) is None


def test_the_recorder_read_after_profiled_launches():
    """Three launches under torch.profiler on the CPU: the slice is the
    last two the recorder kept, with their own counters; once moved onto
    the profiler's clock, each `loop.read` span of the slice holds the
    read the profiler stamped (its `aten::item`), within 50 us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch import Camera, RenderConfig
    from tpu_pathtracer_torch.accel.build import build_accel
    from tpu_pathtracer_torch.runtime import profiler
    from tpu_pathtracer_torch.runtime.progressive import ProgressiveRenderer
    from tpu_pathtracer_torch.scene.procedural import three_spheres_scene

    cfg = RenderConfig(width=32, height=24, samples_per_launch=2, max_depth=3, dof=False, env_mode="sunsky",
                       intersector="cluster", stream_lanes=256)
    r = ProgressiveRenderer(build_accel(three_spheres_scene(8, 16, device="cpu")), Camera(), cfg)
    r.step()
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            r.step()
    ctx = SimpleNamespace(device=[], wall_s=1.0, launches=2)
    p = program_spans.of(ctx)
    assert p.launches == 2 and program_spans.of(ctx) is p
    assert sum(1 for s in p.spans if s[0] == "entry.step") == 2
    assert p.iterations == sum(1 for s in p.spans if s[0] == "loop.step") > 2
    assert p.lanes == 256 * p.iterations and 0 < p.segments <= p.lanes and p.shadow_segments == 0
    items = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CPU and e.name() == "aten::item"]
    reads = [(start, end) for name, start, end, _ in p.spans if name == "loop.read"]
    margin = 50_000
    assert len(reads) == p.iterations
    for a, b in reads:
        assert any(a - margin <= i0 and i1 <= b + margin for i0, i1 in items)
    assert spec.reader("frame_setup_ms").read(ctx) > 0 and spec.reader("live_lane_pct").read(ctx) > 0
    profiler.clear()
