"""The port's render loop queues its work without waiting on the device:
after the first iteration of each schedule nothing builds a tensor from
host data (on the card, a copy that waits for every queued kernel: a
stream sync) and nothing reads a tensor back, except the loop's own read
(`integrator._read`).  On the CPU the calls that would sync on the card
are counted where they are made.  Also the unit-ball sampler's dispatch
and its plain version against the JAX package."""

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
from tpu_pathtracer_torch.render import integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.render.envmap import with_importance_sampling  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402
from tpu_pathtracer_torch.scene.scene import make_env  # noqa: E402
from tpu_pathtracer_torch.utils import rng  # noqa: E402
from tpu_pathtracer_torch.utils.image import procedural_hdr  # noqa: E402

BASE = dict(width=64, height=48, samples_per_launch=2, max_depth=4, dof=False, intersector="cluster",
            env_mode="sunsky", stream_lanes=512)
NEE = dict(env_mode="equirect", rr_mode="standard", env_importance_sampling=True)
# schedule: the config that takes it on a 64x48 frame
SCHEDULES = {
    "stream_fused": dict(fused_schedule="on"),
    "stream": dict(fused_schedule="off"),
    "stream_nee": NEE,
    "regen": dict(stream_lanes=4096),
    "rays": dict(samples_per_launch=1),
}


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


@pytest.mark.parametrize("which", list(SCHEDULES))
def test_iterations_build_nothing_from_host_data(monkeypatch, which):
    """A 64x48 CPU render of each schedule: from the loop's first read
    after the first traced bounce to the end of the render, the only host
    read is `_read`, once an iteration, and no tensor is built from host
    data."""
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
    _, stats = integrator.render_frame_stats(scene, cam, cfg, 1)
    spy.armed = False
    assert stats["schedule"] == which.removesuffix("_nee")
    assert stats["iters"] == len(traces) > 3
    assert sum(reads) >= len(traces) - 1  # one read an iteration, every one after the first armed
    assert spy.calls == []


def test_sampler_runs_plain_version_on_cpu(monkeypatch):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    calls = []
    plain = rng.random_in_unit_sphere_plain

    def spy(seed):
        calls.append(seed.shape)
        return plain(seed)

    monkeypatch.setattr(rng, "random_in_unit_sphere_plain", spy)
    before = rng.random_in_unit_sphere.launches
    seed = torch.arange(1000, dtype=torch.int64)
    s, p = rng.random_in_unit_sphere(seed)
    assert calls == [(1000,)] and rng.random_in_unit_sphere.launches == before
    assert torch.equal(s, plain(seed)[0]) and p.shape == (1000, 3)


def test_sampler_refuses_other_devices():
    """No silent fallback: a tensor neither on the CPU nor on the card is
    refused."""
    with pytest.raises(ValueError, match="meta"):
        rng.random_in_unit_sphere(torch.empty(8, dtype=torch.int64, device="meta"))


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
