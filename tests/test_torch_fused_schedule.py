"""The PyTorch port's fused schedule step (TPU kernel 7's contract) against
the JAX package's `fused_stream_step` in interpret mode, the port's fused
render against its unfused render and against the JAX fused render, and
the envelope of `_fused_stream_ok`."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.ops.fused_schedule import fused_stream_step as j_fused_stream_step  # noqa: E402
from tpu_pathtracer.render import integrator as j_integ  # noqa: E402
from tpu_pathtracer.render.camera import Camera as JCamera  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402

from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import fused_schedule as fs  # noqa: E402
from tpu_pathtracer_torch.render import integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402

SPP, MAX_DEPTH = 3, 4


def step_inputs(lanes, seed):
    """A lane pool after a trace, from a numpy seed: distinct live slots
    below the head, a tenth of the lanes retired (slot >= n_pix), and a
    head close enough to n_pix that some lanes retire past it.  The
    payload's attenuations include zeros (p = 0), values above 1 (the
    standard estimator's min(p, 1)) and a few NaNs."""
    rs = np.random.RandomState(seed)
    n_pix = 4 * lanes
    head = n_pix - lanes // 16
    slot = rs.permutation(head)[:lanes].astype(np.int32)
    dead = rs.rand(lanes) < 0.1
    slot[dead] = n_pix + rs.randint(0, 3, dead.sum())
    pix = np.where(dead, rs.randint(0, n_pix, lanes), slot).astype(np.int32)

    def vec3(lo, hi):
        return rs.uniform(lo, hi, (lanes, 3)).astype(np.float32)

    att = vec3(0.0, 1.3)
    att[rs.rand(lanes) < 0.05] = 0.0
    att[rs.rand(lanes) < 0.01, 1] = np.nan
    tb = dict(
        origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=att, radiance=vec3(0, 4),
        seeds=rs.randint(0, 2**32, lanes, dtype=np.uint64), done=rs.rand(lanes) < 0.3,
    )
    st = dict(
        origin=vec3(-5, 5), direction=vec3(-1, 1), attenuation=vec3(0, 1), radiance=vec3(0, 2),
        seeds=rs.randint(0, 2**32, lanes, dtype=np.uint64), slot=slot, pix=pix,
        sample_i=rs.randint(0, SPP, lanes).astype(np.int32),
        depth=rs.randint(0, MAX_DEPTH + 1, lanes).astype(np.int32), lane_accum=vec3(0, 6),
    )
    return tb, st, n_pix, head, 1000


def jax_step(tb, st, n_pix, head, segments, rr_reference):
    """JAX's fused_stream_step in interpret mode on the same inputs, with
    a one-deep retire FIFO scattered into a zero image.  Returns the
    outputs as numpy arrays keyed as the port's state."""
    lanes = st["slot"].shape[0]
    s = lanes // 128

    def pack3(x):
        return jnp.asarray(x.T.reshape(3, s, 128))

    def pack1(x, dtype):
        return jnp.asarray(x.astype(dtype).reshape(s, 128))

    ints = jnp.stack([pack1(st[k], np.int32) for k in ("slot", "pix", "sample_i", "depth")]
                     + [jnp.zeros((s, 128), jnp.int32)])
    (o, d, att, rad, seeds, ints, _, accum, pend_slot, pend_rgb, regen, scal) = j_fused_stream_step(
        jnp.asarray([head, 0, 0, segments], jnp.int32),
        pack3(tb["origin"]), pack3(tb["direction"]), pack3(tb["attenuation"]), pack3(tb["radiance"]),
        pack1(tb["seeds"], np.uint32), pack1(tb["done"], np.int32),
        pack3(st["origin"]), pack3(st["direction"]), pack3(st["attenuation"]), pack3(st["radiance"]),
        pack1(st["seeds"], np.uint32), ints, jnp.ones((s, 128), jnp.int32), pack3(st["lane_accum"]),
        jnp.full((1, s, 128), n_pix, jnp.int32), jnp.zeros((1, 3, s, 128), jnp.float32),
        spp=SPP, n_pix=n_pix, max_depth=MAX_DEPTH, rr_reference=rr_reference, interpret=True,
    )
    ints = np.asarray(ints).reshape(5, lanes)
    out = jnp.zeros((n_pix + 1, 3), jnp.float32).at[pend_slot.reshape(-1)].add(
        pend_rgb.transpose(0, 2, 3, 1).reshape(-1, 3))
    scal = np.asarray(scal)
    return dict(
        origin=np.asarray(o).reshape(3, lanes).T, direction=np.asarray(d).reshape(3, lanes).T,
        attenuation=np.asarray(att).reshape(3, lanes).T, radiance=np.asarray(rad).reshape(3, lanes).T,
        seeds=np.asarray(seeds).reshape(lanes).astype(np.int64), slot=ints[0], pix=ints[1],
        sample_i=ints[2], depth=ints[3], lane_accum=np.asarray(accum).reshape(3, lanes).T,
        regen=np.asarray(regen).reshape(lanes) > 0, out=np.asarray(out),
        head=int(scal[0, 0]), segments=int(scal[0, 2]),
    )


def port_step(tb, st, n_pix, head, segments, rr_reference):
    tb_t = {k: torch.tensor(v.astype(np.int64) if k == "seeds" else v) for k, v in tb.items()}
    st_t = {k: torch.tensor(v.astype(np.int64) if k == "seeds" else v) for k, v in st.items()}
    out = torch.zeros((n_pix + 1, 3))
    regen, head_n, seg_n, live = fs.fused_stream_step(
        tb_t, st_t, out, torch.tensor(head), torch.tensor(segments), spp=SPP, n_pix=n_pix,
        max_depth=MAX_DEPTH, rr_reference=rr_reference, inv_spp=1.0 / SPP,
    )
    got = {k: v.numpy() for k, v in st_t.items()}
    got.update(regen=regen.numpy(), out=out.numpy(), head=int(head_n), segments=int(seg_n))
    return got, int(live)


@pytest.mark.parametrize("lanes", [512, 32768])
@pytest.mark.parametrize("rr_mode", ["reference", "standard"])
def test_fused_step_plain_matches_jax(rr_mode, lanes):
    """Every state output, the image rows, the regen mask, head and
    segments bit for bit (NaN where JAX has NaN).  At 32,768 lanes the JAX
    kernel runs two chunks of 128 rows, so its running head crosses a
    chunk; some lanes retire past n_pix."""
    tb, st, n_pix, head, segments = step_inputs(lanes, seed=lanes + (rr_mode == "standard"))
    want = jax_step(tb, st, n_pix, head, segments, rr_mode == "reference")
    got, live = port_step(tb, st, n_pix, head, segments, rr_mode == "reference")
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    retired = int((got["slot"] != st["slot"]).sum())
    assert 0 < n_pix - head < retired  # the queue ran past its end
    assert live == int((got["slot"] < n_pix).sum()) < lanes
    assert got["head"] == head + retired


def test_fused_step_plain_empty_retire():
    """A step in which no pixel finishes leaves the head and the image
    alone."""
    tb, st, n_pix, head, segments = step_inputs(512, seed=9)
    tb["done"][:] = False
    tb["attenuation"][:] = 2.0  # u_rr > p never fires
    got, live = port_step(tb, st, n_pix, head, segments, True)
    assert got["head"] == head and not got["out"].any() and not got["regen"].any()
    assert live == int((st["slot"] < n_pix).sum()) and got["segments"] == segments + live


def test_fused_step_refuses_other_devices():
    tb, st, n_pix, head, segments = step_inputs(512, seed=1)
    st_t = {k: torch.tensor(v.astype(np.int64) if k == "seeds" else v) for k, v in st.items()}
    with pytest.raises(ValueError, match="CUDA"):
        fs.fused_stream_step_cuda({}, st_t, None, None, None, spp=SPP, n_pix=n_pix, max_depth=MAX_DEPTH,
                                  rr_reference=True, inv_spp=1.0 / SPP)


def fused_cfg(**kw):
    base = dict(width=64, height=48, samples_per_launch=SPP, max_depth=MAX_DEPTH, dof=False,
                env_mode="sunsky", intersector="brute", stream_lanes=512, fused_schedule="on")
    return base | kw


@pytest.fixture(scope="module")
def spheres():
    return procedural.three_spheres_scene(stacks=8, slices=16, device="cpu")


FUSED_CASES = {
    "reference": dict(),
    "standard": dict(rr_mode="standard"),
    "dof": dict(dof=True),
    "sample_offset": dict(),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_render_bitwise_equals_unfused(spheres, case):
    """The port's fused schedule renders the unfused schedule's image bit
    for bit, with the same iterations and segments."""
    offset = 7 if case == "sample_offset" else 0
    res = {}
    for mode in ("on", "off"):
        cfg = RenderConfig(**fused_cfg(fused_schedule=mode, **FUSED_CASES[case]))
        cam = camera_arrays(Camera(eye=(0, 2, 8), lookat=(0, 1, 0)), cfg, "cpu")
        assert integrator._fused_stream_ok(cfg, None, 512, "cpu") == (mode == "on")
        res[mode] = integrator.render_pixels(spheres, cam, cfg, None, 2, sample_offset=offset, return_stats=True)
    (img_f, st_f), (img_u, st_u) = res["on"], res["off"]
    assert torch.equal(img_f, img_u)
    assert st_f["iters"] == st_u["iters"] > 1
    assert int(st_f["segments"]) == int(st_u["segments"])
    assert int(st_f["shadow_segments"]) == 0


def test_fused_render_matches_jax(spheres):
    """The port's fused render against JAX's render_pixels_stream_fused
    (interpret mode): 99% of values within rtol 1e-3 / atol 1e-4 and
    channel means within 1% (test_torch_render's rule: XLA:CPU contracts
    multiply-adds in the shading), iterations and segments equal."""
    jcfg, tcfg = JConfig(**fused_cfg()), RenderConfig(**fused_cfg())
    eye = dict(eye=(0, 2, 8), lookat=(0, 1, 0))
    jax.clear_caches()
    try:
        jimg, jstats = j_integ.render_pixels_stream_fused(
            j_proc.three_spheres_scene(stacks=8, slices=16), j_integ.camera_arrays(JCamera(**eye), jcfg), jcfg,
            jnp.int32(2), jnp.int32(0), SPP, 512, return_stats=True)
    finally:
        jax.clear_caches()
    timg, tstats = integrator.render_pixels_stream_fused(
        spheres, camera_arrays(Camera(**eye), tcfg, "cpu"), tcfg, 2, 0, SPP, 512, return_stats=True)
    jimg, timg = np.asarray(jimg), timg.numpy()
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, f"only {close.mean():.4%} of values agree"
    np.testing.assert_allclose(timg.mean(axis=0), jimg.mean(axis=0), rtol=0.01)
    assert tstats["iters"] == int(jstats["iters"])
    assert int(tstats["segments"]) == int(jstats["segments"])


def test_fused_envelope_gate():
    """tests/test_fused_schedule.py's gate, with the port's auto rule:
    "auto" takes the fused step on a CUDA device and never on the CPU."""
    cfg = RenderConfig(**fused_cfg())
    ok = integrator._fused_stream_ok
    assert ok(cfg, None, 512, "cpu")
    assert not ok(cfg.replace(fused_schedule="off"), None, 512, "cpu")
    # a pixel list and NEE fall back; DOF is covered (regen runs outside)
    assert not ok(cfg, torch.arange(4), 512, "cpu")
    assert ok(cfg.replace(dof=True), None, 512, "cpu")
    assert not ok(cfg.replace(env_importance_sampling=True, rr_mode="standard"), None, 512, "cpu")
    # lane pools the JAX kernel's (rows, 128) chunks cannot divide fall back
    assert not ok(cfg, None, 500, "cpu")
    assert not ok(cfg, None, 128 * 130, "cpu")
    assert ok(cfg, None, 128 * 256, "cpu")
    auto = cfg.replace(fused_schedule="auto")
    assert not ok(auto, None, 512, "cpu")
    assert ok(auto, None, 16384, "cuda") and ok(auto, None, 131072, torch.device("cuda"))
    assert not ok(auto.replace(env_importance_sampling=True, rr_mode="standard"), None, 131072, "cuda")


def test_every_kernel_source_has_a_launcher():
    """cuda_build.library can load every csrc/ source: each names its
    launch function and argument types (for the fused step its StepParams
    by pointer, the entry point, whether the launch is a programmatic
    dependent (the path step's) and the stream; the struct has a field for
    each tensor of the payload and of the lane state)."""
    from tpu_pathtracer_torch.ops import cuda_build

    assert set(cuda_build.sources()) == set(cuda_build.LAUNCHERS)
    assert len(cuda_build.LAUNCHERS["fused_schedule.cu"][1]) == 4
    fields = {f[0] for f in fs.StepParams._fields_}
    assert {f"tb_{k}" for k in fs.TB_KEYS} | {k.removeprefix("lane_") for k in fs.STATE_KEYS} <= fields


def test_fused_schedule_validated():
    with pytest.raises(ValueError, match="invalid fused_schedule"):
        RenderConfig(fused_schedule="yes")
