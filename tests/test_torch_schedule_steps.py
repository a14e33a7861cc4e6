"""The schedules' steps after a trace, on the CPU (their plain versions):

* kernel 7's contract widened to every pixel map (the whole frame, an
  affine range, an id list) and to next-event estimation, through the
  unfused `render_pixels_stream`, against the JAX package's
  `render_pixels_stream` with the same pixel ids, and against the port's
  own whole-frame stream (exact);
* the path step of `render_rays` and `render_pixels_regen`
  (`ops.fused_schedule.path_step_plain`), through those functions, with
  and without NEE, against the JAX package's functions of those names;
* a numpy model of the self-clearing grid sum the kernels' totals use
  (csrc/fused_schedule.cu: grid_sum), over 32 consecutive launches with
  the blocks in any order;
* the kernels' argument struct against its ctypes mirror.

Inputs are made from seeds with numpy.  Tolerances against JAX on the
CPU: iterations and segments exact; images by tests/test_golden.py's rule
after post_process (exact, else SSIM > 0.995 and atol 5e-3); lane
radiance by the share rule of test_torch_intersect.assert_close_fma.
Shadow segments through the stream are held to within one of JAX's:
XLA:CPU contracts multiply-adds in the shading, and in this scene that
sends one path another way (one shadow segment fewer of 2,810-5,674; see
test_torch_render.test_golden_nee_image); the port's own counts are held
exact against each other."""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.render import envmap as j_envmap  # noqa: E402
from tpu_pathtracer.render import integrator as j_integ  # noqa: E402
from tpu_pathtracer.render.camera import Camera as JCamera  # noqa: E402
from tpu_pathtracer.scene import procedural as j_proc  # noqa: E402
from tpu_pathtracer.scene import scene as j_scene  # noqa: E402
from tpu_pathtracer.utils.image import procedural_hdr  # noqa: E402

from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import camera as camera_ops  # noqa: E402
from tpu_pathtracer_torch.ops import fused_schedule as fs  # noqa: E402
from tpu_pathtracer_torch.render import envmap, film, integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.scene import procedural, scene  # noqa: E402
from tpu_pathtracer_torch.utils.ssim import ssim  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_fused_schedule import step_inputs  # noqa: E402

W, H, SPP, LANES = 64, 48, 2, 256
CFG = dict(width=W, height=H, samples_per_launch=SPP, max_depth=4, dof=False, stream_lanes=LANES,
           intersector="brute", env_mode="equirect")
NEE = dict(rr_mode="standard", env_importance_sampling=True)
EYE = dict(eye=(0.0, 2.0, 6.0), lookat=(0.0, 0.5, 0.0))
# pixel maps: an affine range (base, count), and an id list from a seed
RANGE = (640, 1536)
IDS = np.random.RandomState(3).permutation(W * H)[:1536].astype(np.int32)


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene): three spheres under a procedural equirect
    sky with its alias table, brute force (the step is what is tested)."""
    hdr = procedural_hdr(32, 64)
    j = j_proc.three_spheres_scene(8, 16).replace(env=j_envmap.with_importance_sampling(j_scene.make_env(hdr)))
    t = procedural.three_spheres_scene(8, 16, device="cpu").replace(
        env=envmap.with_importance_sampling(scene.make_env(hdr, "cpu")))
    return j, t


def configs(nee):
    kw = dict(CFG, **(NEE if nee else {}))
    return JConfig(**kw), RenderConfig(**kw)


def golden_rule(got, want, cfg):
    """tests/test_golden.py's rule on [N,3] pixel lists laid out as rows of
    the frame's width, after post_process: exact, else SSIM > 0.995 and
    atol 5e-3."""
    got = film.post_process(torch.as_tensor(got).reshape(-1, W, 3), cfg).numpy()
    want = film.post_process(torch.as_tensor(want).reshape(-1, W, 3), cfg).numpy()
    if not np.array_equal(got, want):
        assert ssim(got, want) > 0.995
        np.testing.assert_allclose(got, want, atol=5e-3)


def same(a, b):
    """Equal bit for bit (NaN bits included: the CPU's ops make the same)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def stats_of(stats):
    return {k: int(v) for k, v in stats.items() if k in ("iters", "segments", "shadow_segments")}


# ---------------------------------------------------------------------------
# (a) kernel 7's contract through the unfused stream, every pixel map
# ---------------------------------------------------------------------------

MAPS = ("frame", "range", "ids")


@pytest.fixture(scope="module", params=[(m, nee) for nee in (False, True) for m in MAPS],
                ids=[f"{m}-{'nee' if nee else 'off'}" for nee in (False, True) for m in MAPS])
def stream_renders(request, scenes):
    """(case, config, port image, port stats, JAX image, JAX stats) of
    subframe 1 through the unfused stream on 256 lanes: the whole frame,
    the affine range RANGE (JAX: its ids, arange(base, base + count)) or
    the id list IDS."""
    kind, nee = request.param
    j, t = scenes
    jcfg, tcfg = configs(nee)
    j_ids = {"frame": None, "range": jnp.arange(RANGE[0], sum(RANGE), dtype=jnp.int32), "ids": jnp.asarray(IDS)}[kind]
    t_ids = {"frame": None, "range": RANGE, "ids": torch.as_tensor(IDS)}[kind]
    jimg, jstats = j_integ.render_pixels_stream(j, j_integ.camera_arrays(JCamera(**EYE), jcfg), jcfg, j_ids,
                                                jnp.int32(1), jnp.int32(0), SPP, LANES, return_stats=True)
    timg, tstats = integrator.render_pixels_stream(t, camera_arrays(Camera(**EYE), tcfg, "cpu"), tcfg, t_ids, 1, 0,
                                                   SPP, LANES, return_stats=True)
    return request.param, tcfg, timg.numpy(), stats_of(tstats), np.array(jimg), stats_of(jstats)


def test_stream_image_matches_jax(stream_renders):
    """The image under tests/test_golden.py's rule, for every pixel map,
    NEE off and on."""
    _, cfg, timg, _, jimg, _ = stream_renders
    assert timg.shape == jimg.shape and np.isfinite(timg).all() and timg.max() > 0
    golden_rule(timg, jimg, cfg)


def test_stream_stats_match_jax(stream_renders):
    """Iterations and segments exact; shadow segments within one (one
    path of this scene rounds another way under XLA:CPU's contractions:
    see the module's docstring)."""
    (_, nee), _, _, tstats, _, jstats = stream_renders
    assert tstats["iters"] == jstats["iters"] > 3
    assert tstats["segments"] == jstats["segments"]
    got, want = tstats["shadow_segments"], jstats["shadow_segments"]
    assert abs(got - want) <= 1 and (want > 0) == nee


@pytest.mark.parametrize("nee", [False, True], ids=["off", "nee"])
def test_stream_maps_add_up_to_the_frame(scenes, nee):
    """The port against itself, exactly: the frame's two halves as affine
    ranges, and every pixel as an id list (last first), give the
    whole-frame stream's pixels bit for bit, and their segments and
    shadow segments sum to the frame's."""
    _, t = scenes
    _, cfg = configs(nee)
    cam = camera_arrays(Camera(**EYE), cfg, "cpu")
    n = W * H

    def render(pixels):
        img, stats = integrator.render_pixels_stream(t, cam, cfg, pixels, 1, 0, SPP, LANES, return_stats=True)
        return img, stats_of(stats)

    frame, f_stats = render(None)
    halves = [render((base, n // 2)) for base in (0, n // 2)]
    ids = torch.arange(n - 1, -1, -1, dtype=torch.int32)
    listed, l_stats = render(ids)
    assert torch.equal(torch.cat([h[0] for h in halves]), frame)
    assert torch.equal(listed, frame[ids.long()])
    for key in ("segments", "shadow_segments"):
        assert sum(h[1][key] for h in halves) == l_stats[key] == f_stats[key]
    assert (f_stats["shadow_segments"] > 0) == nee


def test_stream_step_plain_pixel_maps_and_nee():
    """fused_stream_step_plain on a random lane pool: a retired lane's new
    pixel is base + slot (affine) or ids[min(slot, n_pix - 1)] (id table);
    the map changes nothing else; under NEE the shadow count adds the live
    lanes that hit and spec_last is 1 where a lane respawns, the payload's
    elsewhere (bool, and float32 weights under MIS)."""
    tb, st, n_pix, head, segments = step_inputs(512, seed=21)
    rs = np.random.RandomState(22)
    tb_t = {k: torch.tensor(v.astype(np.int64) if k == "seeds" else v) for k, v in tb.items()}
    kw = dict(spp=3, n_pix=n_pix, max_depth=4, rr_reference=False, inv_spp=1.0 / 3)

    def run(extra, nee=None):
        st_t = {k: torch.tensor(v.astype(np.int64) if k == "seeds" else v) for k, v in st.items()}
        shadow = None
        if nee is not None:
            st_t["spec_last"] = nee[1]
            shadow = torch.tensor(5)
        out = torch.zeros((n_pix + 1, 3))
        res = fs.fused_stream_step_plain(dict(tb_t, **(nee[0] if nee else {})), st_t, out, torch.tensor(head),
                                         torch.tensor(segments), shadow, **kw, **extra)
        return st_t, out, res

    base_st, base_out, base_res = run({})
    retired = base_st["slot"] != torch.as_tensor(st["slot"])
    ids = torch.as_tensor(rs.permutation(2 * n_pix)[:n_pix].astype(np.int32))
    for extra, want in ((dict(base=torch.tensor(1000)), 1000 + base_st["slot"]),
                        (dict(ids=ids), ids[torch.clamp_max(base_st["slot"], n_pix - 1).long()])):
        got_st, got_out, got_res = run(extra)
        assert torch.equal(got_st["pix"][retired], want[retired].to(torch.int32))
        assert torch.equal(got_st["pix"][~retired], base_st["pix"][~retired])
        assert all(same(got_st[k], base_st[k]) for k in st if k != "pix") and same(got_out, base_out)
        assert [int(x) for x in got_res[1:]] == [int(x) for x in base_res[1:]]
    for spec in (torch.as_tensor(rs.rand(512) < 0.5), torch.as_tensor(rs.rand(512).astype(np.float32))):
        hit = torch.as_tensor(rs.rand(512) < 0.7)
        nee_tb = dict(hit=hit, spec_last=spec)
        got_st, _, got_res = run({}, (nee_tb, torch.zeros_like(spec)))
        regen = got_res[0]
        assert len(got_res) == 5 and int(got_res[4]) == 5 + int((hit & (torch.as_tensor(st["slot"]) < n_pix)).sum())
        assert torch.equal(got_st["spec_last"], torch.where(regen, torch.ones_like(spec), spec))
        assert got_st["spec_last"].dtype == spec.dtype and regen.any() and not regen.all()


# ---------------------------------------------------------------------------
# (b) the path step through render_rays and render_pixels_regen
# ---------------------------------------------------------------------------

def camera_rays(cfg, seed):
    """The frame's camera rays, one a pixel, as render_pixels hands
    render_rays its 1-spp rays, with u32 seeds from a numpy seed."""
    cam = camera_arrays(Camera(**EYE), cfg, "cpu")
    o, d, _ = camera_ops.camera_paths(cam, cfg, 1, 0, W * H)
    return o.numpy(), d.numpy(), np.random.RandomState(seed).randint(1, 2**32, W * H, dtype=np.uint64)


@pytest.fixture(scope="module", params=[(s, nee) for s in ("rays", "regen") for nee in (False, True)],
                ids=[f"{s}-{'nee' if nee else 'off'}" for s in ("rays", "regen") for nee in (False, True)])
def path_renders(request, scenes):
    """(case, config, port output, port stats, JAX output, JAX stats):
    render_rays on the frame's 3,072 camera rays with numpy seeds, or
    render_pixels_regen on 1,024 pixels of a numpy permutation at 3 spp,
    subframe 1."""
    schedule, nee = request.param
    j, t = scenes
    jcfg, tcfg = configs(nee)
    if schedule == "rays":
        o, d, seeds = camera_rays(tcfg, 5)
        jout, jstats = j_integ.render_rays(j, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(seeds.astype(np.uint32)),
                                           return_stats=True)
        tout, tstats = integrator.render_rays(t, tcfg, torch.as_tensor(o), torch.as_tensor(d),
                                              torch.as_tensor(seeds.astype(np.int64)), return_stats=True)
    else:
        ids = np.random.RandomState(4).permutation(W * H)[:1024].astype(np.int32)
        jout, jstats = j_integ.render_pixels_regen(j, j_integ.camera_arrays(JCamera(**EYE), jcfg), jcfg,
                                                   jnp.asarray(ids), jnp.int32(1), jnp.int32(0), 3, return_stats=True)
        tout, tstats = integrator.render_pixels_regen(t, camera_arrays(Camera(**EYE), tcfg, "cpu"), tcfg,
                                                      torch.as_tensor(ids), 1, 0, 3, return_stats=True)
    return request.param, tcfg, tout.numpy(), stats_of(tstats), np.array(jout), stats_of(jstats)


def test_path_step_output_matches_jax(path_renders):
    """render_rays' lane radiance: 99.5% of values within rtol 1e-3 /
    atol 1e-4 (assert_close_fma's share; a path that XLA:CPU's
    contractions send another way differs by more) and channel means
    within 1%; render_pixels_regen's pixel means under
    tests/test_golden.py's rule."""
    (schedule, _), cfg, tout, _, jout, _ = path_renders
    assert tout.shape == jout.shape and np.isfinite(tout).all() and tout.max() > 0
    if schedule == "rays":
        close = np.isclose(tout, jout, rtol=1e-3, atol=1e-4)
        assert close.mean() >= 0.995, f"only {close.mean():.5f} within rtol 1e-3 atol 1e-4"
        np.testing.assert_allclose(tout.mean(axis=0), jout.mean(axis=0), rtol=0.01)
    else:
        golden_rule(tout, jout, cfg)


def test_path_step_stats_match_jax(path_renders):
    """Segments and shadow segments exact (and iterations, which JAX's
    render_pixels_regen reports)."""
    (_, nee), _, _, tstats, _, jstats = path_renders
    for key, want in jstats.items():
        assert tstats[key] == want, key
    assert (tstats["shadow_segments"] > 0) == nee and tstats["segments"] > 0


def path_buffers(n, seed, schedule, nee):
    """A schedule's buffers and a trace payload, from a numpy seed."""
    tb, st, _, _, _ = step_inputs(n, seed)
    rs = np.random.RandomState(seed + 1)
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    tb = {k: t(v.astype(np.int64) if k == "seeds" else v) for k, v in tb.items()}
    buf = {k: t(st[k].astype(np.int64) if k == "seeds" else st[k])
           for k in ("origin", "direction", "attenuation", "radiance", "seeds", "depth")}
    buf.update(done=torch.tensor(False), segments=torch.tensor(100), shadow=torch.tensor(10),
               spec_last=t(rs.rand(n) < 0.5))
    if schedule == "rays":
        buf.update(terminated=t(rs.rand(n) < 0.3), result=t(rs.rand(n, 3).astype(np.float32)))
    else:
        buf.update(exhausted=t(rs.rand(n) < 0.3), sample_i=t(rs.randint(0, 3, n).astype(np.int32)),
                   accum=t(rs.rand(n, 3).astype(np.float32)), regen=torch.zeros(n, dtype=torch.bool))
        buf["accum"][::7] = -0.0
    if nee:
        tb.update(hit=t(rs.rand(n) < 0.7), spec_last=t(rs.rand(n) < 0.5))
    return tb, buf


@pytest.mark.parametrize("nee", [False, True], ids=["off", "nee"])
@pytest.mark.parametrize("schedule", ["rays", "regen"])
def test_path_step_plain_contract(schedule, nee):
    """path_step_plain writes into the buffers it is given (the graphed
    loop captures them), counts the live lanes into segments and, under
    NEE, the live lanes that hit into shadow; `done` says whether every
    lane has ended; regen returns its mask, rays None; a -0.0 pixel sum
    becomes +0.0 (the + where(newly, result, 0.0) add)."""
    tb, buf = path_buffers(1024, 31, schedule, nee)
    ended0 = buf["terminated" if schedule == "rays" else "exhausted"].clone()
    before = {k: v.clone() for k, v in buf.items()}
    ptrs = {k: v.data_ptr() for k, v in buf.items()}
    regen = fs.path_step_plain(tb, buf, schedule=schedule, spp=3, max_depth=4, rr_reference=False, nee=nee)
    assert {k: v.data_ptr() for k, v in buf.items()} == ptrs
    live = ~ended0
    assert int(buf["segments"]) == 100 + int(live.sum())
    assert int(buf["shadow"]) == 10 + (int((live & tb["hit"]).sum()) if nee else 0)
    ended = buf["terminated" if schedule == "rays" else "exhausted"]
    assert bool(buf["done"]) == bool(ended.all()) and (ended | ~ended0).all()
    if schedule == "rays":
        assert regen is None
    else:
        assert regen.dtype == torch.bool and regen.any() and not (regen & ended).any()
        assert not torch.signbit(buf["accum"]).any() and torch.signbit(before["accum"]).any()
    with pytest.raises(ValueError, match="schedule"):
        fs.path_step_plain(tb, buf, schedule="stream", spp=3, max_depth=4, rr_reference=False, nee=nee)


def test_path_step_runs_plain_on_cpu():
    """On CPU tensors path_step runs the plain version and counts no
    launch; the kernel's wrapper refuses them."""
    tb, buf = path_buffers(256, 41, "regen", False)
    want = {k: v.clone() for k, v in buf.items()}
    before = fs.path_step.launches
    kw = dict(schedule="regen", spp=3, max_depth=4, rr_reference=True, nee=False)
    got = fs.path_step(tb, buf, **kw)
    assert torch.equal(got, fs.path_step_plain(tb, want, **kw)) and fs.path_step.launches == before
    assert all(same(buf[k], want[k]) for k in buf)
    with pytest.raises(ValueError, match="CUDA"):
        fs.path_step_cuda(tb, buf, **kw)


# ---------------------------------------------------------------------------
# (c) the self-clearing grid sum (csrc/fused_schedule.cu: grid_sum)
# ---------------------------------------------------------------------------

def grid_sum_launch(scratch, counts, rs):
    """One launch of grid_sum over len(counts) blocks on `scratch`
    ([arrivals, sum 0, ..., sum K-1], never cleared by the host): each
    block adds its counts into the sums, then (after its fence) takes an
    arrival number; the block whose number is T - 1 modulo T reads every
    sum and sets it back to 0.  The blocks' steps interleave at random,
    each block's in its own order.  Returns the totals the last block
    read."""
    tiles = len(counts)
    steps = [0] * tiles  # 0: add next, 1: arrive next, 2: done
    total = None
    while any(s < 2 for s in steps):
        b = rs.choice([i for i, s in enumerate(steps) if s < 2])
        if steps[b] == 0:
            scratch[1:] += counts[b]
        else:
            arrival = scratch[0]
            scratch[0] += 1
            if arrival % tiles == tiles - 1:
                assert total is None
                total = scratch[1:].copy()
                scratch[1:] = 0
        steps[b] += 1
    return total


@pytest.mark.parametrize("tiles", [1, 7, 512])
def test_grid_sum_model_clears_itself(tiles):
    """32 consecutive launches on one scratch, zeroed once, blocks in any
    order: the last block to arrive reads exactly the launch's sums (as
    the path step's live lanes, hit lanes and lanes not ended once were;
    kernel 7's shadow count), and leaves them 0 for the next launch; the
    stream step's launches without NEE, which add and arrive nothing,
    may come between."""
    rs = np.random.RandomState(tiles)
    scratch = np.zeros(4, dtype=np.int64)
    for launch in range(32):
        if tiles > 1 and launch % 5 == 4:
            continue  # a launch that takes no part (kernel 7 without NEE)
        counts = rs.randint(0, 257, (tiles, 3))
        if launch % 3 == 0:
            counts[:, 2] = 0  # every lane ended: done
        total = grid_sum_launch(scratch, counts, rs)
        assert total is not None and (total == counts.sum(axis=0)).all()
        assert (total[2] == 0) == (counts[:, 2] == 0).all()
        assert (scratch[1:] == 0).all() and scratch[0] % tiles == 0


@pytest.mark.parametrize("tiles", [1, 7, 512, 8100])
def test_packed_count_model_clears_itself(tiles):
    """The path step's totals (csrc/fused_schedule.cu: path_step_kernel),
    each block's live lanes, whether it has a lane not ended and its
    arrival packed into one atomic add on one word, its hit lanes added
    into a second word first: over consecutive launches on one scratch,
    zeroed once, blocks in any order, each tile's counts up to 256 (8,100
    tiles: a 1080p frame's 2,073,600 lanes), the last block to arrive
    reads exactly its launch's live and hit lanes and whether any lane is
    not ended, and leaves both words 0: no memset, no host read."""
    from test_torch_path_step_design import packed_sum

    rs = np.random.RandomState(tiles)
    scratch = np.zeros(2, dtype=np.int64)
    for launch in range(32 if tiles < 1000 else 3):
        counts = rs.randint(0, 257, (tiles, 3))
        if launch % 3 == 0:
            counts[:, 2] = 0  # every lane ended: done
        total = packed_sum(scratch, counts, rs)
        assert total[0] == counts[:, 0].sum() and total[1] == counts[:, 1].sum()
        assert total[2] == (counts[:, 2] > 0).sum() and (scratch == 0).all()


# ---------------------------------------------------------------------------
# The kernels' argument struct
# ---------------------------------------------------------------------------

def test_step_params_mirror_the_source():
    """StepParams' ctypes mirror names the CUDA struct's fields in their
    order (the wrapper also checks the two sizes at each launch)."""
    from tpu_pathtracer_torch.ops.cuda_build import CSRC_DIR

    body = re.search(r"struct StepParams \{(.*?)\n\};", (CSRC_DIR / "fused_schedule.cu").read_text(), re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        names += [re.search(r"(\w+)\s*$", part).group(1) for part in decl.split(",") if decl]
    assert [f[0] for f in fs.StepParams._fields_] == names
