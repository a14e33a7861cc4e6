"""Each frame schedule's iteration as one CUDA graph, captured once and
replayed: the port's counterpart of the JAX package's `jax.jit` over
`render_frame`, whose `lax.while_loop`s keep the host out of the loop.

A schedule's loop (render/integrator.py) is a per-frame set-up that
writes the plan's static buffers and a step that reads and writes only
those buffers (with `copy_`, never by rebinding a name).  A `Plan` holds
the buffers, the step and, on a CUDA device, the step captured as a
`torch.cuda.CUDAGraph`: the first iteration the plan ever runs is eager,
on the plan's side stream (it builds the kernels' libraries, the device
constants of `utils.device.constant`, the fused step's scratch and the
sort's workspace outside any capture), the second is captured on that
stream and every one after it is one graph launch.  The host loop keeps
its one read an iteration (`integrator._read`) and its iteration cap, so
the iteration count stays exact.

Plans sit in a small cache, least recently used first out (`MAX_PLANS`),
so that the graphs' memory pools are freed; the caller's key names the
scene (by identity: a plan keeps a reference to its scene, so that the
captured pointers cannot dangle), the RenderConfig, the schedule and the
shapes.  Per-frame inputs (camera, subframe, sample offset, pixel ids, an
affine range's base) are buffers of the plan, so one capture serves every
frame.

What stays eager: a plan on the CPU calls its step directly (the same
code, without capture), as does a plan whose step reads the device
(deferred shading's second read) and every plan made under `eager()`,
which also bypasses the cache.  A failed capture or replay raises; the
loop never falls back to eager by itself.

`stats` counts, whether or not the recorder of runtime/profiler.py is
on: `iterations` (calls of `Plan.step`), `lanes` (each plan's lane count,
added once an iteration: the lanes it traced), `reads` (the loops' reads
of the card, `integrator._read`) and the graphs captured.  `Plan.step`
is the `loop.step` span, `Plan._capture` the `loop.capture` span.

The kernels' launch counters (`launches` on each wrapper) advance when
Python calls a wrapper, which a replay does not do: a plan records each
counter's increment over the captured call (taking the capture's own
increments back, since capture launches nothing) and adds it on every
replay, so the counts are those of the eager loop.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

from tpu_pathtracer_torch.ops import bounce as bounce_ops
from tpu_pathtracer_torch.ops import intersect_cluster as ic
from tpu_pathtracer_torch.ops import ray_sort
from tpu_pathtracer_torch.ops.camera import camera_paths
from tpu_pathtracer_torch.ops.fused_schedule import fused_stream_step, path_step
from tpu_pathtracer_torch.ops.intersect import intersect_brute, occluded_brute
from tpu_pathtracer_torch.ops.unit_sphere import random_in_unit_sphere
from tpu_pathtracer_torch.runtime import profiler

# The wrappers whose `launches` count their kernel's launches.
COUNTED = (
    ic.intersect_clusters, ic.intersect_clusters_hier, ic.intersect_clusters_streamed,
    ic.occluded_clusters, ic.occluded_clusters_hier, ic.occluded_clusters_streamed,
    fused_stream_step, random_in_unit_sphere, bounce_ops.bounce, bounce_ops.next_event, camera_paths, path_step,
    ray_sort.sort_rays, ic.caller_order_stores, ray_sort.packet_order, intersect_brute, occluded_brute,
)
# Plans the cache holds.
MAX_PLANS = 8

_plans: collections.OrderedDict = collections.OrderedDict()
_eager = False
# Process-wide totals: graphs captured, their capture seconds, the loops'
# iterations, their lanes and reads, and the captures of each key (a key
# captured twice was evicted between).
stats = dict(captures=0, capture_seconds=0.0, iterations=0, lanes=0, reads=0)
captured: collections.Counter = collections.Counter()


def launch_counts() -> tuple:
    return tuple(f.launches for f in COUNTED)


def record_launches(fn) -> tuple:
    """Call fn() and return each counter's increment over the call, with
    the counters set back to their values before it."""
    before = launch_counts()
    try:
        fn()
    finally:
        after = launch_counts()
        for f, n in zip(COUNTED, before):
            f.launches = n
    return tuple(a - b for a, b in zip(after, before))


def add_launches(increments: tuple) -> None:
    for f, n in zip(COUNTED, increments):
        f.launches += n


@contextlib.contextmanager
def eager():
    """Within the block, every loop runs eagerly in a fresh, uncached plan
    (the A/B against the graphed loop)."""
    global _eager
    was, _eager = _eager, True
    try:
        yield
    finally:
        _eager = was


def clear() -> None:
    """Drop every cached plan (and with it its graph and memory pool)."""
    _plans.clear()


class Plan:
    """A schedule's static buffers (`state`) and its step, run directly or
    as a captured graph (`graphed`), over `lanes` lanes."""

    def __init__(self, key, scene, state: dict, step, graphed: bool, lanes: int = 0):
        self.key = key
        self.lanes = lanes
        self.scene = scene
        self.state = state
        self._step = step
        self.graphed = graphed
        self.graph = None
        self.increments = None
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self._warm = False
        self._stream = None

    def step(self) -> None:
        """One iteration: the step itself, or on a graphed plan its first
        call eagerly on the side stream, then capture, then replays."""
        stats["iterations"] += 1
        stats["lanes"] += self.lanes
        with profiler.span("loop.step"):
            if not self.graphed:
                self._step()
                return
            if self.graph is None:
                if not self._warm:
                    self._warm_up()
                    return
                with profiler.span("loop.capture"):
                    self._capture()
            self.graph.replay()
            add_launches(self.increments)

    def _warm_up(self) -> None:
        device = self.scene.device
        self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            self._step()
        torch.cuda.current_stream(device).wait_stream(self._stream)
        self._warm = True

    def _capture(self) -> None:
        device = self._stream.device
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()  # as torch.cuda.graph does: what stays reserved is in use
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
                self._step()

        try:
            self.increments = record_launches(capture)
        except Exception:
            _plans.pop(self.key, None)
            raise
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.graph = graph
        stats["captures"] += 1
        stats["capture_seconds"] += self.capture_seconds
        captured[self.key] += 1


def plan(key, scene, build, capturable: bool = True, lanes: int = 0) -> Plan:
    """The plan of `key`, over `lanes` lanes: cached, or made by build() ->
    (state, step).  It is graphed on a CUDA device when the step is
    `capturable` (no read of the device inside it); under `eager()` it is
    fresh and never graphed."""
    if _eager:
        return Plan(key, scene, *build(), graphed=False, lanes=lanes)
    found = _plans.get(key)
    if found is not None:
        _plans.move_to_end(key)
        return found
    state, step = build()
    graphed = capturable and scene.device.type == "cuda"
    made = _plans[key] = Plan(key, scene, state, step, graphed, lanes)
    while len(_plans) > MAX_PLANS:
        _plans.popitem(last=False)
    return made
