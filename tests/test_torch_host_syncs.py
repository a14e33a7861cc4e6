"""The port's render loop queues its work without waiting on the device:
after the first iteration of each schedule nothing builds a tensor from
host data (on the card, a copy that waits for every queued kernel: a
stream sync) and nothing reads a tensor back, except the loop's own read
(`integrator._read`).  On the CPU the calls that would sync on the card
are counted where they are made.  Also the unit-ball sampler's dispatch
and its plain version against the JAX package."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several worker processes: one intra-op thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.utils import rng as j_rng  # noqa: E402

from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import unit_sphere  # noqa: E402
from tpu_pathtracer_torch.render import integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.render.envmap import with_importance_sampling  # noqa: E402
from tpu_pathtracer_torch.runtime import profiler  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402
from tpu_pathtracer_torch.scene.scene import make_env  # noqa: E402
from tpu_pathtracer_torch.utils import rng  # noqa: E402
from tpu_pathtracer_torch.utils.image import procedural_hdr  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
# schedule: the config that takes it on a 64x48 frame
from _torch_scenes import BASE, SCHEDULES  # noqa: E402


class HostCalls:
    """Counts, while armed, the calls that on the card copy host data to
    the device or read the device back."""

    def __init__(self, monkeypatch):
        self.armed = False
        self.calls = []
        for owner, name in ((torch, "tensor"), (torch, "as_tensor")):
            self._spy(monkeypatch, owner, name, from_host=True)
        for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
            self._spy(monkeypatch, torch.Tensor, name, from_host=False)

    def _spy(self, monkeypatch, owner, name, from_host):
        real = getattr(owner, name)

        def spy(*args, **kwargs):
            if self.armed and not (from_host and isinstance(args[0], torch.Tensor)):
                self.calls.append(name)
            return real(*args, **kwargs)

        monkeypatch.setattr(owner, name, spy)


def host_calls(monkeypatch, which, traced=False):
    """A 64x48 CPU render of schedule `which`, the span recorder on if
    `traced`: (the host calls made from the loop's first read after the
    first traced bounce to the end of the render, whether each `_read`
    was armed, the traces, the render's stats)."""
    overrides = SCHEDULES[which]
    cfg = RenderConfig(**{**BASE, **overrides})
    scene = procedural.three_spheres_scene(8, 16, device="cpu")
    if cfg.env_importance_sampling:
        scene = scene.replace(env=with_importance_sampling(make_env(procedural_hdr(16, 32), "cpu")))
    scene = build_accel(scene)
    cam = camera_arrays(Camera(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0)), cfg, "cpu")
    spy = HostCalls(monkeypatch)
    traces, reads = [], []
    trace, read = integrator._trace_bounce, integrator._read

    def counted_trace(*args, **kwargs):
        traces.append(1)
        return trace(*args, **kwargs)

    def checked_read(x):
        armed, spy.armed = spy.armed, False
        value = read(x)
        spy.armed = armed or bool(traces)
        reads.append(spy.armed)
        return value

    def unchecked(fn):
        # The sampler's plain version reads the device to end its loop; on
        # the card its kernel runs instead (tests/test_torch_cuda.py).
        def call(*args, **kwargs):
            armed, spy.armed = spy.armed, False
            try:
                return fn(*args, **kwargs)
            finally:
                spy.armed = armed

        return call

    monkeypatch.setattr(integrator, "_trace_bounce", counted_trace)
    monkeypatch.setattr(integrator, "_read", checked_read)
    monkeypatch.setattr(rng, "random_in_unit_sphere_plain", unchecked(rng.random_in_unit_sphere_plain))
    if traced:
        profiler.enable()
    try:
        _, stats = integrator.render_frame_stats(scene, cam, cfg, 1)
    finally:
        profiler.disable()
        spy.armed = False
    return spy.calls, reads, len(traces), stats


@pytest.mark.parametrize("which", list(SCHEDULES))
def test_iterations_build_nothing_from_host_data(monkeypatch, which):
    """A 64x48 CPU render of each schedule: from the loop's first read
    after the first traced bounce to the end of the render, the only host
    read is `_read`, once an iteration, and no tensor is built from host
    data."""
    calls, reads, traces, stats = host_calls(monkeypatch, which)
    assert stats["schedule"] == which.removesuffix("_nee").removesuffix("_deferred")
    assert stats["iters"] == traces > 3
    assert sum(reads) >= traces - 1  # one read an iteration, every one after the first armed
    assert calls == []


@pytest.mark.parametrize("which", list(SCHEDULES))
def test_tracing_on_adds_no_host_call(monkeypatch, which):
    """With the span recorder on (runtime/profiler.py), each schedule's
    render makes the same reads and no more host calls than with it off:
    its spans and device totals read nothing back and build nothing from
    host data."""
    runs = {}
    for traced in (False, True):
        profiler.clear()
        with monkeypatch.context() as m:
            calls, reads, traces, stats = host_calls(m, which, traced)
        runs[traced] = (calls, reads, traces, stats["iters"])
        recorded = len(profiler.spans())
        assert recorded > 2 * traces if traced else recorded == 0
    assert runs[True] == runs[False] and runs[True][0] == []
    profiler.clear()


@pytest.mark.parametrize("which", ["stream_fused", "stream", "regen", "rays"])
def test_deferred_shade_reads_once_more_an_iteration(monkeypatch, which):
    """Deferred shading reads its count of hit lanes through `_read`: two
    reads an iteration of the stream, one without it (regen and rays read
    once more, at the loop's end)."""
    scene = build_accel(procedural.three_spheres_scene(8, 16, device="cpu"))
    read = integrator._read
    counts = {}
    for on in (False, True):
        cfg = RenderConfig(**{**BASE, **SCHEDULES[which], "deferred_shade": on})
        reads = []
        monkeypatch.setattr(integrator, "_read", lambda x: reads.append(1) or read(x))
        _, stats = integrator.render_frame_stats(scene, camera_arrays(Camera(), cfg, "cpu"), cfg, 1)
        assert stats["schedule"] == which
        counts[on] = (stats["iters"], len(reads))
    (iters, dense_reads), (iters_on, deferred_reads) = counts[False], counts[True]
    assert iters == iters_on > 3
    assert deferred_reads == dense_reads + iters
    if which.startswith("stream"):
        assert dense_reads == iters and deferred_reads == 2 * iters


def test_sampler_runs_plain_version_on_cpu(monkeypatch):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    calls = []
    plain = rng.random_in_unit_sphere_plain

    def spy(seed):
        calls.append(seed.shape)
        return plain(seed)

    monkeypatch.setattr(rng, "random_in_unit_sphere_plain", spy)
    before = unit_sphere.random_in_unit_sphere.launches
    seed = torch.arange(1000, dtype=torch.int64)
    s, p = unit_sphere.random_in_unit_sphere(seed)
    assert calls == [(1000,)] and unit_sphere.random_in_unit_sphere.launches == before
    assert torch.equal(s, plain(seed)[0]) and p.shape == (1000, 3)


def test_sampler_refuses_other_devices():
    """No silent fallback: a tensor neither on the CPU nor on the card is
    refused."""
    with pytest.raises(ValueError, match="meta"):
        unit_sphere.random_in_unit_sphere(torch.empty(8, dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("draws_per_check", [1, 3, 8, 64])
def test_sampler_plain_independent_of_draws_per_check(draws_per_check):
    """The plain version's seeds and points equal the JAX package's bit
    for bit however often it checks for completion: the extra draws are
    masked no-ops."""
    rs = np.random.RandomState(11)
    x = np.concatenate([[0, 1, 2**31, 2**32 - 1], rs.randint(0, 2**32, 8188, dtype=np.uint64)]).astype(np.uint32)
    s_got, p_got = rng.random_in_unit_sphere_plain(torch.as_tensor(x.astype(np.int64)), draws_per_check)
    s_want, p_want = j_rng.random_in_unit_sphere(jnp.asarray(x))
    np.testing.assert_array_equal(s_got.numpy().astype(np.uint32), np.asarray(s_want))
    np.testing.assert_array_equal(p_got.numpy().view(np.int32), np.asarray(p_want).view(np.int32))


def longest_chains(lo, hi, least, chunk=1 << 22):
    """{seed: draws} for every u32 seed in [lo, hi) whose lane takes at
    least `least` rejection draws, in the plain version's arithmetic done
    in numpy (three PCG steps a draw, u32 -> float32 rounded to nearest,
    2u - 1, (x*x + y*y) + z*z < 1).  Over all 2^32 seeds (about ten
    minutes on one core) it finds 5 seeds of 28 draws, 8 of 27 and none
    longer: tests/test_torch_cuda.py holds the kernel to them."""
    f32 = np.float32

    def draw(s):
        p = []
        for _ in range(3):
            s = pcg_hash_np(s)
            p.append(f32(2.0) * (s.astype(f32) * f32(2.3283064365386963e-10)) - f32(1.0))
        return s, (p[0] * p[0] + p[1] * p[1]) + p[2] * p[2] < f32(1.0)

    found = {}
    for start in range(lo, hi, chunk):
        ids = np.arange(start, min(start + chunk, hi), dtype=np.uint64).astype(np.uint32)
        s, draws = ids, 0
        while ids.size:
            draws += 1
            s, accepted = draw(s)
            if draws >= least:
                found.update((int(i), draws) for i in ids[accepted])
            ids, s = ids[~accepted], s[~accepted]
    return found


def pcg_hash_np(x):
    with np.errstate(over="ignore"):
        s = x * np.uint32(747796405) + np.uint32(2891336453)
        w = ((s >> ((s >> np.uint32(28)) + np.uint32(4))) ^ s) * np.uint32(277803737)
    return (w >> np.uint32(22)) ^ w


def test_long_chain_search():
    """The search behind the card's long-chain test, on two ranges that
    hold a 28-draw seed each: it finds them, and the plain version takes
    as many draws (its seed has advanced 3 x draws PCG steps)."""
    found = {}
    for seed in (957305047, 2947995425):
        found.update(longest_chains(seed - 50_000, seed + 50_000, 24))
    assert found[957305047] == found[2947995425] == 28
    seeds = torch.tensor(sorted(found), dtype=torch.int64)
    end, _ = rng.random_in_unit_sphere_plain(seeds)
    x, steps = seeds, torch.zeros_like(seeds)
    for k in range(1, 3 * 28 + 1):
        x = rng.pcg_hash(x)
        steps = torch.where((x == end) & (steps == 0), k, steps)
    assert (steps // 3).tolist() == [found[s] for s in sorted(found)]
