"""The port's sharded rendering (parallel/shard.py) and the affine pixel
ranges it passes to render_pixels.

Pixel and sample sharding run in gloo groups of 2 and 4 CPU processes
(`tests/_torch_dist_worker.py`, started together on free localhost
ports): pixel-sharded frames equal the port's render_frame bit for bit,
the stream and NEE included; sample-sharded frames agree within rtol 2e-4 /
atol 2e-5 (the JAX package's rule, tests/test_parallel.py); indivisible
sizes raise ValueError.  The 2-rank image is held against the JAX
package's render_frame_sharded on two of conftest's virtual devices; the
affine range against an id tensor and against the JAX package's affine
render_pixels; ProgressiveRenderer and the CLI in a one-rank group
against their unsharded runs.  Sizes are the JAX sharding tests' (32x16,
8 spp, depth 3)."""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.parallel.shard import make_mesh as j_make_mesh  # noqa: E402
from tpu_pathtracer.parallel.shard import render_frame_sharded as j_render_frame_sharded  # noqa: E402
from tpu_pathtracer.render import integrator as j_integ  # noqa: E402
from tpu_pathtracer.render.camera import Camera as JCamera  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402

from tpu_pathtracer_torch import cli  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.parallel.shard import free_port, make_mesh, render_frame_sharded  # noqa: E402
from tpu_pathtracer_torch.render import integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.runtime.progressive import ProgressiveRenderer  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dist_worker as worker  # noqa: E402

WORLDS = (2, 4)
PIXEL_CASES = [c for c, (mode, _) in worker.CASES.items() if mode == "pixels"]
SAMPLE_CASES = [c for c, (mode, _) in worker.CASES.items() if mode == "samples"]


def close_to_jax(timg, jimg):
    """The port's render tolerance against the JAX package (tests/
    test_torch_render.py): 99% of values within rtol 1e-3 / atol 1e-4, each
    channel's mean within 1%."""
    assert timg.shape == jimg.shape
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, f"only {close.mean():.4%} of values agree"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: rank 0's results} for gloo groups of 2 and 4 CPU
    processes, all started at once."""
    d = tmp_path_factory.mktemp("shard")
    groups = [worker.start_group(world, d / f"w{world}.npz") for world in WORLDS]
    try:
        for procs in groups:
            worker.wait_group(procs)
    finally:  # a group that failed leaves none of the other's ranks running
        for p in (p for procs in groups for p in procs if p.poll() is None):
            p.kill()
            p.wait()
    return {world: dict(np.load(d / f"w{world}.npz")) for world in WORLDS}


@pytest.mark.parametrize("case", PIXEL_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_pixel_sharding_bitwise(worlds, world, case):
    """Pixel-sharded frames equal render_frame bit for bit: one lane per
    pixel, the stream (48 lanes) and NEE."""
    got, want = worlds[world][case], worlds[world][f"{case}_single"]
    assert got.shape == (16, 32, 3) and want.max() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", SAMPLE_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_sample_sharding_allclose(worlds, world, case):
    """The same samples in other sums: close, not bit-equal."""
    np.testing.assert_allclose(worlds[world][case], worlds[world][f"{case}_single"], rtol=2e-4, atol=2e-5)


def test_device_count_invariance(worlds):
    for case in PIXEL_CASES:
        np.testing.assert_array_equal(worlds[2][case], worlds[4][case])


@pytest.mark.parametrize("mode,match", [("pixels", "width\\*height \\(465\\) must divide across"),
                                        ("samples", "samples_per_launch \\(3\\) must divide across")])
@pytest.mark.parametrize("world", WORLDS)
def test_indivisible_rejected(worlds, world, mode, match):
    """Every rank raised the JAX package's ValueError, before any
    collective (a rank that went on would have hung its group)."""
    assert re.search(match, str(worlds[world][f"refused_{mode}"]))


@pytest.mark.parametrize("case", ["pixels", "samples"])
def test_two_ranks_match_jax(worlds, case):
    """The port's 2-rank frame against the JAX package's
    render_frame_sharded on two virtual devices."""
    jcfg = JConfig(**worker.BASE)
    j_scene = j_proc.single_sphere_scene(stacks=6, slices=12)
    jimg = j_render_frame_sharded(j_scene, j_integ.camera_arrays(JCamera(), jcfg), jcfg, jnp.int32(1),
                                  j_make_mesh(2), mode=case)
    close_to_jax(worlds[2][case], np.asarray(jimg))


# ---------------------------------------------------------------------------
# Affine pixel ranges
# ---------------------------------------------------------------------------

AFFINE_CFG = dict(width=32, height=16, samples_per_launch=4, max_depth=3, dof=False, env_mode="sunsky",
                  intersector="cluster")
# schedule: the overrides that make a 256-pixel range take it
AFFINE_SCHEDULES = {
    "stream": dict(stream_lanes=48, fused_schedule="on"),  # a range refuses the fused step
    "regen": dict(),
    "rays": dict(samples_per_launch=1),
}


@pytest.fixture(scope="module")
def affine_scene():
    from tpu_pathtracer_torch.accel.build import build_accel

    return build_accel(procedural.three_spheres_scene(8, 16, device="cpu"))


@pytest.mark.parametrize("base_kind", ["int", "tensor"])
@pytest.mark.parametrize("which", list(AFFINE_SCHEDULES))
def test_affine_range_equals_ids(affine_scene, which, base_kind):
    """(base, count) renders what the id tensor base + arange(count)
    renders, bit for bit, through each schedule, with base a Python int or
    a 0-d tensor."""
    cfg = RenderConfig(**{**AFFINE_CFG, **AFFINE_SCHEDULES[which]})
    cam = camera_arrays(Camera(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0)), cfg, "cpu")
    base = 200 if base_kind == "int" else torch.tensor(200)
    got, stats = integrator.render_pixels(affine_scene, cam, cfg, (base, 256), 1, return_stats=True)
    ids = torch.arange(200, 456, dtype=torch.int32)
    want, want_stats = integrator.render_pixels(affine_scene, cam, cfg, ids, 1, return_stats=True)
    assert stats["schedule"] == want_stats["schedule"] == which
    assert got.shape == (256, 3) and float(got.max()) > 0
    assert torch.equal(got, want)
    assert int(stats["segments"]) == int(want_stats["segments"])


def test_affine_range_matches_jax(affine_scene):
    """The stream over a range against the JAX package's affine
    render_pixels, at the port's render tolerance."""
    import jax

    overrides = AFFINE_SCHEDULES["stream"]
    cfg = RenderConfig(**{**AFFINE_CFG, **overrides, "intersector": "brute"})
    jcfg = JConfig(**{**AFFINE_CFG, **overrides, "intersector": "brute"})
    eye = dict(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0))
    j_scene = j_proc.three_spheres_scene(8, 16)
    jcam = j_integ.camera_arrays(JCamera(**eye), jcfg)
    jimg = jax.jit(lambda base: j_integ.render_pixels(j_scene, jcam, jcfg, (base, 256), jnp.int32(1)))(
        jnp.int32(200))
    got = integrator.render_pixels(affine_scene, camera_arrays(Camera(**eye), cfg, "cpu"), cfg, (200, 256), 1)
    close_to_jax(got.numpy().reshape(16, 16, 3), np.asarray(jimg).reshape(16, 16, 3))


# ---------------------------------------------------------------------------
# The progressive renderer and the CLI in a group of one rank
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["pixels", "samples"])
def test_progressive_mesh_bitwise(one_rank_group, mode, tmp_path):
    """ProgressiveRenderer(mesh=...) equals the unsharded renderer bit for
    bit over three launches, with the converge ramp skipped under the mesh;
    rank 0 writes its checkpoint."""
    cfg = RenderConfig(**{**worker.BASE, "samples_per_launch": 4})
    scene = procedural.single_sphere_scene(stacks=6, slices=12, device="cpu")
    sharded = ProgressiveRenderer(scene, Camera(), cfg, mesh=one_rank_group, shard_mode=mode)
    single = ProgressiveRenderer(scene, Camera(), cfg)
    for _ in range(3):
        sharded.step_converge()
        single.step()
    assert sharded.spp == single.spp == 12
    assert torch.equal(sharded.accum, single.accum)
    assert (sharded.mesh.size, sharded.mesh.rank) == (1, 0)
    sharded.save_checkpoint(str(tmp_path / "ck.npz"))
    assert (tmp_path / "ck.npz").exists()


def test_sharded_frame_refuses_unknown_mode(one_rank_group):
    cfg = RenderConfig(**worker.BASE)
    scene = procedural.single_sphere_scene(stacks=6, slices=12, device="cpu")
    with pytest.raises(ValueError, match="unknown sharding mode"):
        render_frame_sharded(scene, camera_arrays(Camera(), cfg, "cpu"), cfg, 0, one_rank_group, mode="rows")


@pytest.mark.parametrize("mode", ["pixels", "samples"])
def test_cli_shard_bitwise(tmp_path, mode):
    """`--shard pixels|samples` outside torchrun renders in a group of one
    rank (left again when the CLI returns) and writes the PNG that
    `--shard none` writes, byte for byte."""
    argv = ["--dim", "32x16", "-s", "4", "--spp", "8", "--max-depth", "3", "--no-dof", "--env", "constant",
            "--device", "cpu"]
    assert cli.main(argv + ["--shard", mode, "--file", str(tmp_path / "s.png")]) == 0
    assert not dist.is_initialized()
    assert cli.main(argv + ["--file", str(tmp_path / "n.png")]) == 0
    assert (tmp_path / "s.png").read_bytes() == (tmp_path / "n.png").read_bytes()
