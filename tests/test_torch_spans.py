"""The port's span recorder (tpu_pathtracer_torch/runtime/profiler.py) on
the CPU: one `ProgressiveRenderer.step` of each frame schedule records
the layers' span tree, one launch number throughout; the loop's spans
and the recorder's device totals agree with the schedule's own counts
and with `graph_loop.stats`; self times on a hand-built tree; nothing is
recorded or allocated while it is off; a torch.profiler session switches
it on for the launches that start inside it.  On the card (marked cuda):
the spans moved onto the profiler's clock bracket the kernels of their
iterations.  This file imports no JAX:

    python -m pytest tests/test_torch_spans.py
    python -m pytest --noconftest tests/test_torch_spans.py -m cuda   # on the card
"""

import itertools
import os
import sys
import time
import tracemalloc

import pytest

torch = pytest.importorskip("torch")
# The suite runs in several worker processes: one intra-op thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.render import graph_loop, integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.render.envmap import with_importance_sampling  # noqa: E402
from tpu_pathtracer_torch.runtime import profiler  # noqa: E402
from tpu_pathtracer_torch.runtime.progressive import ProgressiveRenderer  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402
from tpu_pathtracer_torch.scene.scene import make_env  # noqa: E402
from tpu_pathtracer_torch.utils.image import procedural_hdr  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from _torch_scenes import BASE, SCHEDULES  # noqa: E402

CAMERA = Camera(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0))
# span: the span that encloses it in a step (the deferred shade's second
# read lies inside the step it belongs to)
PARENT = {"entry.step": None, "frame.render": "entry.step", "frame.setup": "frame.render",
          "loop.run": "frame.render", "loop.step": "loop.run", "loop.read": ("loop.run", "loop.step"),
          "entry.accumulate": "entry.step", "entry.sync": "entry.step"}


@pytest.fixture(autouse=True)
def recorder_off():
    profiler.disable()
    profiler.clear()
    yield
    profiler.disable()
    profiler.clear()


def setup(which, device="cpu"):
    cfg = RenderConfig(**{**BASE, **SCHEDULES[which]})
    scene = procedural.three_spheres_scene(8, 16, device=device)
    if cfg.env_importance_sampling:
        scene = scene.replace(env=with_importance_sampling(make_env(procedural_hdr(16, 32), device)))
    return build_accel(scene), cfg


@pytest.mark.parametrize("which", list(SCHEDULES))
def test_a_step_records_the_span_tree(which):
    """Every span of one step nests in its parent's interval, under the
    parent its layer names, and carries the step's launch number; the
    launch's record holds the growth of graph_loop.stats over the step."""
    scene, cfg = setup(which)
    r = ProgressiveRenderer(scene, CAMERA, cfg)
    r.step()
    before = dict(graph_loop.stats)
    profiler.enable()
    r.step()
    spans = profiler.spans()
    names = [s[0] for s in spans]
    assert set(names) == set(PARENT) and names[0] == "entry.step"
    assert len({s[4] for s in spans}) == 1
    for name, start, end, parent, _ in spans:
        want = PARENT[name]
        assert start <= end
        if want is None:
            assert parent is None
            continue
        p = spans[parent]
        assert p[0] in (want if isinstance(want, tuple) else (want,))
        assert p[1] <= start and end <= p[2]
    (record,) = profiler.launches().values()
    grown = {k: graph_loop.stats[k] - before[k] for k in ("iterations", "lanes", "reads")}
    assert {k: record[k] for k in grown} == grown
    assert grown["iterations"] == names.count("loop.step") > 3 and grown["reads"] == names.count("loop.read")
    assert names.count("frame.setup") == names.count("loop.run") == 1


@pytest.mark.parametrize("which", list(SCHEDULES))
def test_loop_spans_and_totals_match_the_schedules_counts(which):
    """Over one render_frame_stats: a `loop.step` span an iteration, a
    `loop.read` span a read of stats["reads"], the plan's lanes once an
    iteration, and device totals equal to the schedule's segments and
    shadow segments."""
    scene, cfg = setup(which)
    cam = camera_arrays(CAMERA, cfg, "cpu")
    before = dict(graph_loop.stats)
    profiler.enable()
    _, st = integrator.render_frame_stats(scene, cam, cfg, 1)
    names = [s[0] for s in profiler.spans()]
    assert names.count("loop.step") == st["iters"] == graph_loop.stats["iterations"] - before["iterations"]
    assert names.count("loop.read") == graph_loop.stats["reads"] - before["reads"]
    n_pix = cfg.width * cfg.height
    lanes = {"rays": n_pix * cfg.samples_per_launch, "regen": n_pix}.get(
        st["schedule"], min(n_pix, integrator.resolve_stream_lanes(cfg, n_pix)))
    assert graph_loop.stats["lanes"] - before["lanes"] == st["iters"] * lanes
    assert profiler.totals() == dict(segments=int(st["segments"]), shadow_segments=int(st["shadow_segments"]))
    assert (int(st["shadow_segments"]) > 0) == cfg.env_importance_sampling


def test_tiles_record_a_setup_and_a_loop_each():
    """A tiled frame: one `frame.setup` and one `loop.run` a tile, under
    the one `frame.render`, and the device totals summed over the tiles."""
    cfg = RenderConfig(**{**BASE, "tile_pixels": 1024})
    scene = build_accel(procedural.three_spheres_scene(8, 16, device="cpu"))
    profiler.enable()
    _, st = integrator.render_frame_stats(scene, camera_arrays(CAMERA, cfg, "cpu"), cfg, 1)
    spans = profiler.spans()
    names = [s[0] for s in spans]
    assert names.count("frame.setup") == names.count("loop.run") == 3 and names.count("frame.render") == 1
    assert all(spans[s[3]][0] == "frame.render" for s in spans if s[0] in ("frame.setup", "loop.run"))
    assert profiler.totals()["segments"] == int(st["segments"])


def test_self_times_on_a_hand_built_tree():
    """A root of 100 ns with children of 30 and 20 (the first with a child
    of 10), and a second root of 5: each name's duration less what its
    children cover, summed over its spans; an open span is left out."""
    spans = [("a", 0, 100, None, 0), ("b", 10, 40, 0, 0), ("c", 15, 25, 1, 0), ("b", 50, 70, 0, 0),
             ("a", 200, 205, None, 1), ("d", 300, None, None, 1)]
    assert profiler.self_times(spans) == {"a": 100 - 50 + 5, "b": 20 + 20, "c": 10}


def test_off_records_and_allocates_nothing():
    """Off (the default): a step records no span, launch or total, and a
    span costs no allocation."""
    scene, cfg = setup("stream_fused")
    r = ProgressiveRenderer(scene, CAMERA, cfg)
    r.step()
    assert not profiler.enabled() and profiler.spans() == [] and profiler.launches() == {}
    assert profiler.totals() == dict(segments=0, shadow_segments=0)

    def traced(n):
        tracemalloc.start()
        try:
            for _ in itertools.repeat(None, n):
                with profiler.span("loop.step"):
                    pass
                profiler.end("frame.setup")
            return tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()

    traced(10)
    (kept, peak), (kept_many, peak_many) = traced(10), traced(10_000)
    assert kept == kept_many == 0 and peak_many == peak  # the loop's own frame, whatever the count


def test_a_profiler_session_switches_the_recorder():
    """Launches that start inside a torch.profiler session are recorded
    with no call to enable(), with their wall clock's offset; the first
    launch after it records nothing."""
    from torch.profiler import ProfilerActivity, profile

    scene, cfg = setup("rays")
    r = ProgressiveRenderer(scene, CAMERA, cfg)
    r.step()
    with profile(activities=[ProfilerActivity.CPU]):
        r.set_camera(CAMERA.orbit(15.0, 0.0))
        r.step()
    recorded = profiler.spans()
    assert {s[0] for s in recorded} == set(PARENT) | {"entry.set_camera"}
    assert len({s[4] for s in recorded}) == 1
    (record,) = profiler.launches().values()
    assert abs(record["wall_offset_ns"] - (time.time_ns() - time.perf_counter_ns())) < 10**9
    r.set_camera(CAMERA)
    r.step()
    assert not profiler.enabled() and profiler.spans() == recorded


def test_end_closes_only_its_own_span():
    """`end(name)` closes the innermost open span when it has that name
    and leaves another open span alone; a span ended early keeps its end
    when its block exits."""
    profiler.enable()
    with profiler.span("frame.render"):
        with profiler.span("frame.setup"):
            profiler.end("loop.run")
            profiler.end("frame.setup")
            with profiler.span("loop.run"):
                pass
    (render, setup_, run) = profiler.spans()
    assert setup_[3] == 0 and run[3] == 0
    assert setup_[2] <= run[1] and run[2] <= render[2]


@pytest.mark.cuda
def test_spans_bracket_their_kernels_on_the_card():
    """On the card, with the spans moved onto torch.profiler's clock by
    each launch's wall-clock offset: every graph launch of a `loop.step`
    lies inside that span, the span starts before the graph's first
    kernel, and the iteration's `loop.read` ends after its last kernel,
    within a margin of MARGIN_NS for the clocks' conversion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphed loop has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    MARGIN_NS = 20_000
    cuda = torch.autograd.DeviceType.CUDA
    scene, cfg = setup("stream_fused", "cuda")
    r = ProgressiveRenderer(scene, CAMERA, cfg)
    r.step()
    r.step()  # warm, then captured: the next launch replays
    profiler.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r.step()
    (record,) = profiler.launches().values()
    shift = record["wall_offset_ns"]
    spans = profiler.spans()
    steps = [(s[1] + shift, s[2] + shift) for s in spans if s[0] == "loop.step"]
    reads = [(s[1] + shift, s[2] + shift) for s in spans if s[0] == "loop.read" and spans[s[3]][0] == "loop.run"]
    events = list(prof.profiler.kineto_results.events())
    graphs = sorted((e for e in events if e.device_type() != cuda and e.name() == "cudaGraphLaunch"),
                    key=lambda e: e.start_ns())
    kernels = {}
    for e in events:
        if e.device_type() == cuda:
            kernels.setdefault(e.correlation_id(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    assert len(graphs) == len(steps) == len(reads) > 3
    for g, (s0, s1), (_, r1) in zip(graphs, steps, reads):
        ran = kernels[g.correlation_id()]
        assert s0 - MARGIN_NS <= g.start_ns() <= s1 + MARGIN_NS
        assert s0 - MARGIN_NS <= min(a for a, _ in ran)
        assert max(b for _, b in ran) <= r1 + MARGIN_NS
