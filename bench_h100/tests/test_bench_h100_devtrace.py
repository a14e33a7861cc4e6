"""The profiler arithmetic on synthetic device events, and the byte count
behind the traversal's roofline share."""

import pytest

from bench_h100 import devtrace, roofline

MS = 1_000_000  # ns


def ev(name, start_ms, dur_ms):
    return (name, int(start_ms * MS), int(dur_ms * MS))


def test_busy_is_the_union_of_overlapping_intervals():
    events = [ev("a", 0, 2), ev("b", 1, 2), ev("c", 5, 1), ev("d", 5.5, 0.2), ev("e", 7, 1)]
    assert devtrace.busy_intervals(events) == [[0, 3 * MS], [5 * MS, 6 * MS], [7 * MS, 8 * MS]]
    assert devtrace.busy_seconds(events) == pytest.approx(5e-3)
    assert devtrace.busy_seconds(list(reversed(events))) == pytest.approx(5e-3)
    assert devtrace.busy_seconds([]) == 0


def test_idle_gaps_are_named_by_the_innermost_open_span():
    events = [ev("a", 0, 1), ev("b", 4, 1), ev("c", 5.5, 1)]
    spans = [("render_frame", 0, 10 * MS), ("sync", int(4.8 * MS), int(6 * MS))]
    gaps = devtrace.idle_gaps(events, spans)
    assert gaps == [["render_frame", pytest.approx(3e-3)], ["sync", pytest.approx(0.5e-3)]]
    assert devtrace.idle_gaps(events, []) [0][0] == "other"


@pytest.mark.parametrize("name, label", [
    ("void streamed_kernel<false, (Visit)2, (TriTest)1, 8>(Params)", "streamed_kernel (flat, closest hit)"),
    ("void streamed_kernel<true, (Visit)1, (TriTest)1, 8>(Params)", "streamed_kernel (hier, any hit)"),
    ("void streamed_kernel<false, (Visit)0, (TriTest)1, 8>(Params)", "streamed_kernel (streamed, closest hit)"),
    ("void brute_kernel<true, 0>(BruteArgs)", "brute_kernel (any hit)"),
    ("fused_step_kernel(StepArgs)", "fused_step_kernel"),
    ("sort_pass_kernel", "sort_pass_kernel"),
    ("Memset (Device)", None),
])
def test_kernel_label(name, label):
    assert devtrace.kernel_label(name) == label


def test_seconds_of_a_family_and_top_kernels():
    events = [ev("void streamed_kernel<false, (Visit)2, x>()", 0, 2), ev("packet_weight_kernel()", 2, 0.5),
              ev("bounce_kernel()", 3, 0.25), ev("void brute_kernel<false, 8>()", 4, 1)]
    traversal = ("streamed_kernel", "packet_weight_kernel", "brute_kernel")
    assert devtrace.seconds_of(events, traversal) == pytest.approx(3.5e-3)
    assert devtrace.seconds_of(events, ("nee_kernel",)) == 0
    top = devtrace.top_kernels(events)
    assert top[0] == ["streamed_kernel (flat, closest hit)", pytest.approx(2e-3)] and len(top) == 4


def test_traversal_bytes():
    # 1,000 closest-hit rays (24 B in, 16 B out), 10 shadow rays (24 B in,
    # one flag out), two launches over a 3-triangle scene (36 B a triangle)
    assert roofline.traversal_bytes(1000, 10, 2, 3) == 1000 * 40 + 10 * 25 + 2 * 3 * 36
    assert roofline.traversal_bytes(0, 0, 0, 98002) == 0


def test_peaks_table():
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks("cpu") == {}


def test_readers_find_nothing_where_nothing_ran():
    from types import SimpleNamespace

    from bench_h100 import spec

    ctx = SimpleNamespace(device=[], wall_s=1.0, busy_s=0.0, launches=0, iters=0, segments=0, shadow_segments=0,
                          traversal_launches=0, triangles=3, captures_in_window=0, peak_mem_bytes=0, peaks={},
                          traversal_bytes=0, seconds_of=devtrace.seconds_of)
    for name in ("traversal_ms_per_iter", "traversal_roofline", "ray_order_ms_per_iter", "shade_ms_per_iter",
                 "step_ms_per_iter", "iterations_per_launch", "mrays_per_s", "device_idle_pct", "peak_mem_gib"):
        assert spec.reader(name).read(ctx) is None, name
    assert spec.reader("captures_in_window").read(ctx) == 0


def test_roofline_readers_on_a_synthetic_slice():
    from types import SimpleNamespace

    from bench_h100 import spec

    events = [ev("void streamed_kernel<false, (Visit)2, x>()", 0, 4), ev("path_step_kernel()", 4, 1)]
    ctx = SimpleNamespace(device=events, wall_s=0.01, busy_s=devtrace.busy_seconds(events), launches=2, iters=4,
                          segments=10**6, shadow_segments=0, traversal_launches=4, triangles=100,
                          captures_in_window=0, peak_mem_bytes=2**30, peaks={"hbm_bytes_per_s": 3.35e12},
                          seconds_of=devtrace.seconds_of)
    ctx.traversal_bytes = roofline.traversal_bytes(ctx.segments, 0, 4, 100)
    assert spec.reader("traversal_ms_per_iter").read(ctx) == pytest.approx(1.0)
    share = spec.reader("traversal_roofline").read(ctx)
    assert share == pytest.approx(ctx.traversal_bytes / 3.35e12 / 4e-3 * 100)
    assert spec.reader("device_idle_pct").read(ctx) == pytest.approx(50.0)
    assert spec.reader("iterations_per_launch").read(ctx) == 2
    assert spec.reader("peak_mem_gib").read(ctx) == 1.0
