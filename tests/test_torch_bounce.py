"""The bounce's shading, NEE weights and camera spawns, whose plain
versions the CPU runs and whose hand-written kernels (csrc/bounce.cu,
csrc/nee.cu, csrc/camera.cu) the card runs: the port's `_trace_bounce`
after the traversal against the JAX package's on the same seeded hit
records (NEE off and on, MIS-spec, the defensive mixture, each env mode,
the quad-pool and bundled textures, glass, seed_advance_quirk), the
camera paths against the JAX package's `make_seeds` and
`generate_camera_rays` with and without DOF, the float32 constants the
wrappers pack on the host, the argument structs against the CUDA sources
they mirror, and the dispatch (the kernels never run on the CPU).  The
kernels against their plain versions, bit for bit: tests/test_torch_cuda.py
on a card."""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several worker processes: one intra-op thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.config import RenderConfig as JConfig  # noqa: E402
from tpu_pathtracer.ops import intersect as j_intersect  # noqa: E402
from tpu_pathtracer.ops.intersect import Hit as JHit  # noqa: E402
from tpu_pathtracer.render import envmap as j_envmap  # noqa: E402
from tpu_pathtracer.render import integrator as j_integ  # noqa: E402
from tpu_pathtracer.utils import rng as j_rng  # noqa: E402

from test_torch_intersect import assert_close_fma  # noqa: E402
from test_torch_shade import build_scenes, camera_hits  # noqa: E402
from tpu_pathtracer_torch.accel.build import build_accel  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import bounce as bounce_ops  # noqa: E402
from tpu_pathtracer_torch.ops import camera as camera_ops  # noqa: E402
from tpu_pathtracer_torch.ops import cuda_build  # noqa: E402
from tpu_pathtracer_torch.ops.intersect import Hit  # noqa: E402
from tpu_pathtracer_torch.render import envmap, graph_loop, integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402
from tpu_pathtracer_torch.scene import procedural  # noqa: E402
from tpu_pathtracer_torch.utils import rng  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "tpu_pathtracer_torch" / "csrc"
NEE = dict(env_mode="equirect", rr_mode="standard", env_importance_sampling=True)
# case: (texture layout, RenderConfig overrides)
CASES = {
    "equirect": ("bundled_scrambled", {}),
    "sunsky": ("bundled_rowmajor", dict(env_mode="sunsky")),
    "constant": ("unbundled", dict(env_mode="constant")),
    "quad_pool_quirk": ("unbundled", dict(seed_advance_quirk=True)),
    "nee": ("bundled_scrambled", NEE),
    "nee_mis": ("bundled_rowmajor", dict(NEE, nee_mis_spec=True)),
    "nee_defensive": ("unbundled", dict(NEE, nee_defensive_mix=True)),
    "nee_mis_defensive": ("bundled_scrambled", dict(NEE, nee_mis_spec=True, nee_defensive_mix=True)),
}
FLOAT_KEYS = ("radiance", "attenuation", "origin", "direction")


def bounce_inputs(case):
    """The two scenes (with alias tables under NEE), the two configs, and
    one bounce's seeded inputs: camera_hits' rays, hits, seeds and depths,
    an attenuation and radiance drawn in [0.2, 1.2) and [0, 0.5), NEE's
    env credit (a flag, or a weight in [0, 1]) and a fixed any-hit answer
    for the shadow rays (a third of them occluded)."""
    layout, overrides = CASES[case]
    j, t = build_scenes(layout)
    cfg_kw = dict(max_depth=8, dof=False, **overrides)
    if cfg_kw.get("env_importance_sampling"):
        j = j.replace(env=j_envmap.with_importance_sampling(j.env))
        t = t.replace(env=envmap.with_importance_sampling(t.env))
    o, d, hit, seeds, depth = camera_hits(j, n=2000, seed=21)
    rs = np.random.RandomState(22)
    n = len(o)
    att = (rs.rand(n, 3) + 0.2).astype(np.float32)
    rad = (rs.rand(n, 3) * 0.5).astype(np.float32)
    spec = (rs.rand(n).astype(np.float32) if cfg_kw.get("nee_mis_spec") else rs.rand(n) < 0.5)
    occluded = rs.rand(n) < 1.0 / 3.0
    return j, t, JConfig(**cfg_kw), RenderConfig(**cfg_kw), (o, d, att, rad, seeds, depth, spec), hit, occluded


@pytest.fixture(scope="module", params=sorted(CASES))
def bounced(request):
    """(case, config, hit record, radiance in, port payload, JAX payload)
    of `_trace_bounce` on the same inputs, the traversal and the any-hit
    answer fixed on both sides."""
    mp = pytest.MonkeyPatch()
    try:
        j, t, jcfg, cfg, (o, d, att, rad, seeds, depth, spec), hit, occluded = bounce_inputs(request.param)
        jhit = JHit(**{k: jnp.asarray(v) for k, v in hit.items()})
        thit = Hit(**{k: torch.tensor(v) for k, v in hit.items()})
        mp.setattr(j_integ, "intersect_scene", lambda *a, **k: jhit)
        mp.setattr(j_intersect, "occluded_scene", lambda *a, **k: jnp.asarray(occluded))
        mp.setattr(integrator, "intersect_scene", lambda *a, **k: thit)
        mp.setattr(integrator, "occluded_scene", lambda *a, **k: torch.as_tensor(occluded))
        nee = cfg.env_importance_sampling
        want = j_integ._trace_bounce(
            j, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(att), jnp.asarray(rad), jnp.asarray(seeds),
            jnp.asarray(depth), jnp.asarray(spec) if nee else None)
        got = integrator._trace_bounce(
            t, cfg, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(att), torch.as_tensor(rad),
            torch.as_tensor(seeds.astype(np.int64)), torch.as_tensor(depth), torch.as_tensor(spec) if nee else None)
    finally:
        mp.undo()
    return request.param, cfg, hit, rad, got, want


def test_bounce_flags_and_seeds_exact(bounced):
    """hit, done and the seed chains (the light draw's included) exactly."""
    _, _, hit, _, got, want = bounced
    np.testing.assert_array_equal(got["hit"].numpy(), hit["hit"])
    np.testing.assert_array_equal(got["done"].numpy(), np.asarray(want["done"]))
    np.testing.assert_array_equal(got["seeds"].numpy().astype(np.uint32), np.asarray(want["seeds"]))
    assert 0.2 < hit["hit"].mean() < 1.0


@pytest.mark.parametrize("key", FLOAT_KEYS)
def test_bounce_payload_matches_jax(bounced, key):
    """Every lane to rtol 1e-5, atol 1e-6 on 99.5% of values and 100x
    that on all, the shade's tolerance (tests/test_torch_shade.py: XLA:CPU
    contracts multiply-adds into FMAs, see assert_close_fma, and the GGX
    sample at small alpha magnifies one rounding)."""
    *_, got, want = bounced
    assert_close_fma(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-6, loose=100.0)


def test_bounce_env_credit_matches_jax(bounced):
    """The next segment's env credit on the hit lanes (a miss ends its
    path, so its credit, computed from the shade of row 0 that both
    packages discard, is never read): passed through without NEE, a flag
    held exactly under NEE, and under MIS-spec the weight w_b, which
    divides by the GGX pdf at the spec continuation, a pdf that moves by
    up to 7.2% with one rounding of n.h (test_torch_shade.py:
    test_shade_spec_pdf_matches_jax): 99% of lanes within rtol 1e-2, all
    within 1e-1 (atol 1e-6)."""
    _, cfg, hit, _, got, want = bounced
    m = hit["hit"]
    if not cfg.env_importance_sampling:
        assert got["spec_last"] is None and want["spec_last"] is None
    elif cfg.nee_mis_spec:
        assert_close_fma(got["spec_last"].numpy()[m], np.asarray(want["spec_last"])[m], rtol=1e-2, atol=1e-6,
                         loose=10.0, share=0.99)
    else:
        np.testing.assert_array_equal(got["spec_last"].numpy()[m], np.asarray(want["spec_last"])[m])


def test_bounce_gathers_light(bounced):
    """Radiance grows on a share of the lanes in every case: misses take
    the env's light (under NEE only where credited), and under NEE the
    visible light draws add to hit lanes (the fixed any-hit answer leaves
    two thirds of them visible)."""
    _, cfg, hit, rad, got, _ = bounced
    grew = (got["radiance"].numpy() > rad).any(axis=1)
    m = hit["hit"]
    assert grew[~m].mean() > (0.2 if cfg.env_importance_sampling else 0.99)
    if cfg.env_importance_sampling:
        assert grew[m].mean() > 0.2


# ---------------------------------------------------------------------------
# Camera paths
# ---------------------------------------------------------------------------

CAMERA_CFG = dict(width=64, height=48, max_depth=4)


@pytest.mark.parametrize("dof", [False, True], ids=["pinhole", "dof"])
@pytest.mark.parametrize("lanes", ["identity", "range", "ids", "sample_table"])
def test_camera_paths_match_jax(dof, lanes):
    """camera_paths on the CPU (the camera kernel's plain version) for
    every lane rule against the JAX package's make_seeds and
    generate_camera_rays: seeds exact, origins and directions to rtol
    1e-6 / atol 1e-6 (each a handful of roundings; XLA:CPU fuses the
    jitter's multiply-adds)."""
    cfg = RenderConfig(**CAMERA_CFG, dof=dof, dof_blurriness=0.3, focus_distance=2.5)
    jcfg = JConfig(**CAMERA_CFG, dof=dof, dof_blurriness=0.3, focus_distance=2.5)
    cam = camera_arrays(Camera(eye=(0.5, 2.0, 6.0), lookat=(0.0, 0.5, 0.0)), cfg, "cpu")
    rs = np.random.RandomState(23)
    n, spp, subframe, offset = 600, 3, 7, 5
    kw, sample = {}, None
    if lanes == "identity":
        kw = dict(per=spp)
        pixel = np.arange(n) // spp
        samp = np.arange(n) % spp
    elif lanes == "range":
        kw = dict(per=spp, base=torch.tensor(1000))
        pixel = 1000 + np.arange(n) // spp
        samp = np.arange(n) % spp
    elif lanes == "ids":
        ids = rs.randint(0, 64 * 48, size=n // spp).astype(np.int32)
        kw = dict(per=spp, pix=torch.as_tensor(ids))
        pixel = ids[np.arange(n) // spp]
        samp = np.arange(n) % spp
    else:
        ids = rs.randint(0, 64 * 48, size=n).astype(np.int32)
        sample = rs.randint(0, 9, size=n).astype(np.int32)
        kw = dict(pix=torch.as_tensor(ids), sample=torch.as_tensor(sample), sample_max=spp - 1)
        pixel, samp = ids, np.minimum(sample, spp - 1)
    o, d, s = camera_ops.camera_paths(cam, cfg, subframe, offset, n, **kw)
    pixel = jnp.asarray(pixel.astype(np.int32))
    jseeds = j_rng.make_seeds(pixel, jnp.asarray(offset + samp, jnp.int32), jnp.int32(subframe))
    jcam = {k: jnp.asarray(v.numpy()) for k, v in cam.items()}
    jo, jd, js = j_integ.generate_camera_rays(jcam, pixel % 64, pixel // 64, jseeds, jcfg)
    np.testing.assert_array_equal(s.numpy().astype(np.uint32), np.asarray(js))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The host-packed constants and the argument structs
# ---------------------------------------------------------------------------

def test_shade_consts_are_the_plain_codes_float32_values():
    """Each constant is what the plain code's float32 arithmetic uses: a
    Python constant expression folded in double and rounded once
    (2.0 * math.pi, 1.0 - s, 2 pi^2), a bound as torch rounds it, and for
    a tensor / Python scalar the float32 reciprocal of the float32 scalar
    (the card's product)."""
    cfg = RenderConfig(normal_map_strength=0.37, ior=1.33, roughness_min=0.02, glass_roughness_perturb=0.7,
                       env_constant=(0.1, 0.2, 0.3))
    c = bounce_ops.shade_consts(cfg)
    one = torch.ones(1)
    as_torch = lambda x: np.float32((one * x).item())  # noqa: E731  a float32 tensor times a Python float
    assert c["two_pi"] == as_torch(2.0 * math.pi) and c["pi"] == as_torch(math.pi)
    assert c["two_pi2"] == as_torch(2.0 * math.pi * math.pi) and c["two_pi2"] != np.float32(2 * np.float32(math.pi) ** 2)
    assert c["nmap_1ms"] == as_torch(1.0 - 0.37) and c["nmap_s"] == as_torch(0.37)
    assert c["inv255"] == as_torch(1.0 / 255.0)
    assert c["eps2"] == np.float32(torch.clamp_min(torch.zeros(1), 1e-10 * 1e-10).item())
    for key, value in (("deg_len", 0.01), ("emis_len", 0.0001), ("onb_y", 0.9999), ("tiny", 1e-10),
                       ("d_min", 1e-12), ("pdf_min", 1e-20), ("elev_min", 1e-6), ("sun_cos", 0.99),
                       ("ior", 1.33), ("rough_min", 0.02), ("glass_perturb", 0.7)):
        assert c[key] == np.float32(torch.tensor(value, dtype=torch.float32).item()), key
    for key, divisor in (("inv_two_pi", 2.0 * math.pi), ("inv_pi", math.pi), ("inv_dpdf", 1.0 / math.pi)):
        assert c[key] == np.float32(1.0) / np.float32(divisor), key
    np.testing.assert_array_equal(c["env_const"], np.float32([0.1, 0.2, 0.3]))
    packed = bounce_ops.pack_consts(cfg)
    for key in bounce_ops.CONST_SCALARS:
        assert np.float32(getattr(packed, key)) == c[key], key
    for key in bounce_ops.CONST_VECTORS:
        np.testing.assert_array_equal(np.float32(list(getattr(packed, key))), c[key])
    cc = camera_ops.camera_consts(RenderConfig(width=640, height=480, dof_blurriness=0.3))
    assert cc["inv_width"] == np.float32(1.0) / np.float32(640.0) and cc["two_pi"] == c["two_pi"]
    assert cc["blur"] == np.float32(0.3) and cc["eps2"] == c["eps2"]


def _struct_fields(source: str, name: str) -> list:
    """The field names of `struct name { ... };` in csrc/`source`."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, (CSRC / source).read_text(), re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        # each declarator's name: the last word of the part, before any [n]
        names += [re.search(r"(\w+)\s*(\[\w*\])?\s*$", part).group(1) for part in decl.split(",") if decl]
    return names


@pytest.mark.parametrize("source,struct,mirror", [
    ("shade_math.cuh", "ShadeConsts", bounce_ops.ShadeConsts),
    ("bounce.cu", "BounceParams", bounce_ops.BounceParams),
    ("nee.cu", "NeeParams", bounce_ops.NeeParams),
    ("camera.cu", "CameraParams", camera_ops.CameraParams),
])
def test_param_structs_mirror_the_sources(source, struct, mirror):
    """The ctypes mirrors name the CUDA structs' fields in their order (the
    wrappers also check the two sizes at each launch)."""
    assert [f[0] for f in mirror._fields_] == _struct_fields(source, struct)


def test_record_width_matches_the_source():
    src = (CSRC / "shade_math.cuh").read_text()
    assert f"constexpr int kRecord = {bounce_ops.RECORD};" in src


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_dispatch_by_device():
    """A CUDA device launches the kernels outside plain(), the CPU runs
    the plain versions, any other device raises."""
    assert cuda_build.on_card("cuda") and not cuda_build.on_card("cpu")
    with cuda_build.plain():
        assert not cuda_build.on_card("cuda") and cuda_build.is_plain()
    assert not cuda_build.is_plain()
    with pytest.raises(ValueError):
        cuda_build.on_card("meta")
    cfg = RenderConfig(**CAMERA_CFG, dof=False)
    cam = {k: v.to("meta") for k, v in camera_arrays(Camera(), cfg, "cpu").items()}
    with pytest.raises(ValueError):
        camera_ops.camera_paths(cam, cfg, 0, 0, 8)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: given the CPU's, they
    raise before any build or launch, and count nothing."""
    cfg = RenderConfig(**CAMERA_CFG, dof=False)
    scene = procedural.three_spheres_scene(4, 8, device="cpu")
    n = 8
    o, d = torch.zeros(n, 3), torch.ones(n, 3)
    hit = Hit(t=torch.ones(n), prim=torch.zeros(n, dtype=torch.int32), bary=torch.zeros(n, 2),
              hit=torch.ones(n, dtype=torch.bool))
    seeds, depth = torch.ones(n, dtype=torch.int64), torch.ones(n, dtype=torch.int32)
    before = (bounce_ops.bounce.launches, bounce_ops.next_event.launches, camera_ops.camera_paths.launches)
    with pytest.raises(ValueError, match="CUDA"):
        bounce_ops.bounce(scene, cfg, hit, o, d, o, o, seeds, depth)
    with pytest.raises(ValueError, match="CUDA"):
        camera_ops.camera_paths_cuda(camera_arrays(Camera(), cfg, "cpu"), cfg, 0, 0, n)
    out = {k: torch.zeros(n + 1, 3) for k in ("new_origin", "new_direction", "att_factor", "emission")}
    with pytest.raises(ValueError, match="CUDA"):
        bounce_ops.shade_lanes(scene, cfg, hit, o, d, seeds, depth, torch.zeros(n, dtype=torch.int64), out)
    assert (bounce_ops.bounce.launches, bounce_ops.next_event.launches, camera_ops.camera_paths.launches) == before


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_cpu_render_launches_no_shading_kernel(nee):
    """A CPU render runs the plain versions: no shading kernel counts a
    launch, and the plan's key names the arm (plain() or not), so an A/B
    never replays the other arm's plan."""
    cfg = RenderConfig(**CAMERA_CFG, samples_per_launch=2, dof=False, intersector="cluster", stream_lanes=512,
                       **(NEE if nee else dict(env_mode="sunsky")))
    scene = procedural.three_spheres_scene(6, 12, device="cpu")
    if nee:
        from tpu_pathtracer_torch.scene.scene import make_env
        from tpu_pathtracer_torch.utils.image import procedural_hdr

        scene = scene.replace(env=envmap.with_importance_sampling(make_env(procedural_hdr(8, 16), "cpu")))
    scene = build_accel(scene)
    cam = camera_arrays(Camera(), cfg, "cpu")
    graph_loop.clear()
    before = (bounce_ops.bounce.launches, bounce_ops.next_event.launches, camera_ops.camera_paths.launches)
    img, _ = integrator.render_frame_stats(scene, cam, cfg, 0)
    with cuda_build.plain():
        img_plain, _ = integrator.render_frame_stats(scene, cam, cfg, 0)
    assert (bounce_ops.bounce.launches, bounce_ops.next_event.launches, camera_ops.camera_paths.launches) == before
    assert torch.equal(img, img_plain)
    keys = list(graph_loop._plans)
    assert len(keys) == 2 and {k[2] for k in keys} == {False, True}
    graph_loop.clear()


def test_graph_loop_counts_the_shading_kernels():
    names = {f.__name__ for f in graph_loop.COUNTED}
    assert {"bounce", "next_event", "camera_paths", "random_in_unit_sphere"} <= names


def test_respawn_writes_the_regen_lanes_only():
    """The stream's respawn on the CPU (the camera spawn with a mask and
    the state's buffers): the regen lanes take the fresh path that an
    unmasked spawn gives them, the others keep theirs."""
    cfg = RenderConfig(**CAMERA_CFG, dof=True)
    cam = camera_arrays(Camera(), cfg, "cpu")
    spawn = integrator._spawner(cam, cfg, 3, 2)
    st = integrator._stream_state(cfg, spawn, lambda slot: slot * 7, 128, torch.device("cpu"))
    st["sample_i"] = torch.arange(128, dtype=torch.int32) % 5
    before = {k: st[k].clone() for k in ("origin", "direction", "seeds")}
    regen = torch.arange(128) % 2 == 1
    integrator._respawn(st, regen, spawn, 4)
    o, d, s = spawn(128, pix=st["pix"], sample=st["sample_i"], sample_max=3)
    assert torch.equal(st["origin"][regen], o[regen]) and torch.equal(st["seeds"][regen], s[regen])
    assert torch.equal(st["direction"][regen], d[regen])
    for k in ("origin", "direction", "seeds"):
        assert torch.equal(st[k][~regen], before[k][~regen])
    seeds0 = rng.make_seeds(torch.arange(128, dtype=torch.int32) * 7, 2, 3)
    assert torch.equal(before["seeds"], rng.uniform2(seeds0)[0])
