"""The design of the NEE kernel and the camera kernel, on the CPU.

Both are programmatic dependents of the launch before them
(csrc/launch_order.cuh): the NEE kernel of the shadow rays' any-hit
traversal, the camera kernel of kernel 7 or the path step.  Each may
start while that launch still runs, so:

* The sources keep the invariant, read as a compiler would not check it:
  no read of what the launch before writes (the any-hit flags
  `p.occluded`; the mask, pixel and sample tables `p.mask`, `p.pix`,
  `p.sample`) and no store comes before the kernel's one wait; the two
  launches set the attribute where the caller asks; the launches before
  them let them start at block entry and are made without it.  The
  integrator asks for a dependent launch only where that launch is the
  traversal or a schedule step, and the wrapper refuses one whose inputs
  a copy or a fill would make just before it.
* The NEE kernel computes every candidate's contribution before it has
  the any-hit answer and applies the answer last, as a select: a torch
  model of that order (the record unpacked by csrc/shade_math.cuh's
  layout, a lane without a candidate reading the texel at (0, 0), the
  contributions with no answer, then the answer) equals the NEE tail of
  `_bounce_plain` bit for bit, in each NEE mode (plain, MIS-spec, MIS-spec
  with the defensive mixture) and each environment mode, on
  tests/test_torch_bounce.py's inputs; an inf or a NaN put into an
  occluded lane's contribution never reaches radiance (a product with the
  flag would carry it).

The kernels against their plain versions, bit for bit and through 1,000
graph replays of each pair: tests/test_torch_cuda.py on a card.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_bounce import bounce_inputs  # noqa: E402
from tpu_pathtracer_torch.config import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops import bounce as bounce_ops  # noqa: E402
from tpu_pathtracer_torch.ops import camera as camera_ops  # noqa: E402
from tpu_pathtracer_torch.ops.intersect import Hit  # noqa: E402
from tpu_pathtracer_torch.render import graph_loop, integrator  # noqa: E402
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "tpu_pathtracer_torch" / "csrc"
WAIT = "launch_order::wait_for_launch_before();"
TRIGGER = "launch_order::let_dependents_start();"
# A store to memory: a store3, an element or pointee assigned, an atomic.
STORE = re.compile(r"store3\s*\(|\]\s*=(?!=)|\*\s*p\.\w+\s*=(?!=)|\batomic\w*\s*\(")


def code(source: str) -> str:
    """csrc/`source` without its comments."""
    return re.sub(r"//[^\n]*", "", (CSRC / source).read_text())


def body(source: str, name: str) -> str:
    """The body of the function `name` (its first definition) in
    csrc/`source`, comments removed."""
    text = code(source)
    m = re.search(r"\b%s\s*\(" % name, text)
    depth, start = 0, text.index("{", text.index(")", m.end()))
    for k in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[k], 0)
        if depth == 0:
            return text[start + 1 : k]
    raise AssertionError(f"{name}: unbalanced braces")


# (source, kernel, what the launch before writes and the kernel reads)
DEPENDENTS = (("nee.cu", "nee_kernel", ("occluded",)), ("camera.cu", "camera_kernel", ("mask", "pix", "sample")))


@pytest.mark.parametrize("source,kernel,late", DEPENDENTS, ids=["nee", "camera"])
def test_dependent_kernels_wait_before_they_read_the_launch_before(source, kernel, late):
    """One wait; none of what the launch before writes is read before it
    (and each of it after), and nothing is stored before it."""
    pre, wait, post = body(source, kernel).partition(WAIT)
    assert wait and WAIT not in post
    for field in late:
        assert not re.search(rf"\bp\.{field}\b", pre), field
        assert re.search(rf"\bp\.{field}\b", post), field
    assert not STORE.search(pre), STORE.search(pre)
    # the loads before the wait are the kernel's: the record, rays, state and tables
    assert len(re.findall(r"\bload3\s*\(|\brec\.|\*p\.", pre)) >= 4


@pytest.mark.parametrize("source,launcher,kernel", [("nee.cu", "nee_launch", "nee_kernel"),
                                                     ("camera.cu", "camera_launch", "camera_kernel")])
def test_dependent_launches_set_the_attribute_where_asked(source, launcher, kernel):
    """The launch function takes `dependent` and hands it to
    launch_order::launch, which sets programmatic stream serialization
    on that launch alone; the wrappers' argument types follow."""
    launch = body(source, launcher)
    assert f"launch_order::launch({kernel}," in launch and "dependent != 0" in launch
    assert re.search(r"int %s\(const \w+\* p, int dependent, void\* stream\)" % launcher, code(source))
    order = code("launch_order.cuh")
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in order
    assert "programmaticStreamSerializationAllowed = 1" in order and "numAttrs = dependent ? 1 : 0" in order
    assert "griddepcontrol.wait" in order and "griddepcontrol.launch_dependents" in order
    from tpu_pathtracer_torch.ops import cuda_build

    assert len(cuda_build.LAUNCHERS[source][1]) == 3


@pytest.mark.parametrize("source,kernel", [("cluster_streamed.cuh", "streamed_kernel"),
                                           ("brute.cu", "brute_kernel"),
                                           ("fused_schedule.cu", "fused_step_kernel"),
                                           ("fused_schedule.cu", "path_step_kernel"),
                                           ("bounce.cu", "bounce_kernel"),
                                           ("nee.cu", "nee_kernel")])
def test_launches_before_let_their_dependents_start_at_entry(source, kernel):
    """The launches that a dependent follows (the any-hit traversal, the
    cluster accel's or brute force's, its instantiations only; kernel 7;
    the bounce kernel; and the links with one behind them, the NEE kernel
    and the path step) let it start before any other statement that
    touches memory.  The heads of the chains (launch_order.cuh: the
    traversals, the bounce kernel, kernel 7, and the sort before them) are
    launched without the attribute and never wait; in fused_schedule.cu
    only the path step waits, and only it goes through
    launch_order::launch (both of its count layouts; kernel 7's two
    status word layouts are plain launches)."""
    first = body(source, kernel).split(TRIGGER)[0]
    assert TRIGGER in body(source, kernel)
    assert re.sub(r"\s+", " ", first).strip() in (
        "", "extern __shared__ float4 rows[]; __shared__ unsigned int slots[3]; if constexpr (kAnyHit)",
        "if constexpr (kAnyHit)",
        "using namespace shade;", "using namespace shade; namespace R = nee_record;")
    for src in ("cluster_streamed.cuh", "brute.cu", "fused_schedule.cu", "ray_sort.cu", "bounce.cu"):
        assert "ProgrammaticStreamSerialization" not in code(src)
    for src in ("cluster_streamed.cuh", "brute.cu", "ray_sort.cu", "bounce.cu"):
        assert WAIT not in code(src) and "launch_order::launch(" not in code(src)
    assert WAIT not in body("fused_schedule.cu", "fused_step_kernel")
    launch = body("fused_schedule.cu", "fused_step_launch")
    assert all(f"fused_step_kernel<{w}><<<" in launch for w in ("false", "true"))  # both status word layouts
    assert all(f"launch_order::launch(path_step_kernel<{w}>," in launch for w in ("false", "true"))


def test_integrator_asks_for_dependents_after_the_traversal_and_the_steps():
    """`dependent=True` at exactly two sites (the NEE kernel after the
    any-hit traversal, the regen respawn after the path step), the
    stream's respawn behind kernel 7 only, and the path step of render_rays
    and render_pixels_regen behind the trace's last launch wherever the
    bounce kernels ran (`_bounce_on_card`, the one rule `_trace_bounce`
    takes them by); and the stream writes its counters after the respawn,
    so that nothing runs between kernel 7 and the camera."""
    src = Path(integrator.__file__).read_text()
    assert src.count("dependent=True") == 2 and src.count("dependent=schedule_step is fused_stream_step") == 1
    assert src.count('dependent=_bounce_on_card(cfg, st["seeds"].device)') == 2
    trace = src[src.index("def _trace_bounce"):src.index("def _bounce_on_card")]
    assert "if _bounce_on_card(cfg, origin.device):" in trace
    step = src[src.index("def _stream_step"):src.index("def _fused_stream_ok")]
    assert step.index("_respawn(st, regen") < step.index("_write(st, new)")


def test_stream_respawn_asks_only_behind_kernel_7(monkeypatch):
    """On the CPU the fused stream's respawn passes dependent=True (on the
    card the step is kernel 7 there), the pool's set-up never; the image is
    the one the unfused stream (plain step, dependent=False) gives."""
    from tpu_pathtracer_torch.accel.build import build_accel
    from tpu_pathtracer_torch.scene import procedural

    seen = []
    real = camera_ops.camera_paths

    def spy(*args, dependent=False, **kw):
        seen.append(dependent)
        return real(*args, dependent=dependent, **kw)

    monkeypatch.setattr(camera_ops, "camera_paths", spy)
    scene = build_accel(procedural.three_spheres_scene(6, 12, device="cpu"))
    images = {}
    for fused in ("on", "off"):
        cfg = RenderConfig(width=32, height=24, samples_per_launch=2, max_depth=3, dof=False, env_mode="sunsky",
                           intersector="cluster", stream_lanes=256, fused_schedule=fused)
        graph_loop.clear()
        seen.clear()
        images[fused], stats = integrator.render_frame_stats(scene, camera_arrays(Camera(), cfg, "cpu"), cfg, 0)
        assert seen[0] is False and len(seen) == stats["iters"] + 1
        assert set(seen[1:]) == {fused == "on"}
    graph_loop.clear()
    assert torch.equal(images["on"], images["off"])


def test_dependent_launch_refuses_inputs_made_just_before_it():
    """A dependent camera launch with Python counters (a fill just before
    it) or a dependent NEE launch on a copied input raises before any
    build."""
    cfg = RenderConfig(width=16, height=8, dof=False)
    cam = camera_arrays(Camera(), cfg, "cpu")
    with pytest.raises(ValueError, match="dependent"):
        camera_ops.camera_paths_cuda(cam, cfg, 0, 0, 8, dependent=True)
    n = 8
    b = dict(record=torch.zeros(bounce_ops.RECORD, n), shadow_dir=torch.zeros(n, 3))
    with pytest.raises(ValueError, match="dependent"):
        bounce_ops.next_event(None, cfg, b, torch.zeros(n, dtype=torch.bool), torch.zeros(3, n).T,
                              torch.zeros(n, 3), dependent=True)


# ---------------------------------------------------------------------------
# The NEE kernel's order, as a torch model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def record_layout() -> dict:
    """csrc/shade_math.cuh's nee_record constants: field offsets and flag
    bits."""
    block = (CSRC / "shade_math.cuh").read_text().split("namespace nee_record {")[1].split("}  // namespace")[0]
    out = {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)", block)}
    assert out["kRecord"] == bounce_ops.RECORD
    return out


def pack_record(sh, hit, cand, pdf, u, v, cos_l) -> torch.Tensor:
    """The record the bounce kernel writes ([kRecord, n], field by field),
    from the plain shade and light draw."""
    f = record_layout()
    n = hit.shape[0]
    rec = torch.zeros((f["kRecord"], n), dtype=torch.float32)
    for key, field in (("normal", "kNormal"), ("brdf_combined", "kBrdf"), ("f_vec", "kFvec"),
                       ("diffuse_albedo", "kDiffuse"), ("spec_dir", "kSpecDir")):
        rec[f[field] : f[field] + 3] = sh[key].T
    for key, field in (("alpha", "kAlpha"), ("spec_prob", "kSpecProb"), ("idotn", "kIdotN"),
                       ("spec_pdf", "kSpecPdf")):
        rec[f[field]] = sh[key]
    for x, field in ((pdf, "kPdf"), (u, "kU"), (v, "kV"), (cos_l, "kCosL")):
        rec[f[field]] = x
    flags = (hit.int() * f["kHit"] | cand.int() * f["kCand"] | sh["glass"].int() * f["kGlass"]
             | sh["choose_spec"].int() * f["kChooseSpec"])
    rec[f["kFlags"]] = flags.to(torch.int32).view(torch.float32)
    return rec


def nee_model(scene, cfg, record, shadow_dir, direction, attenuation, radiance, occluded, poison=None):
    """The NEE kernel's order: round 1 every record field of every lane;
    round 2 the env texel at the draw's (u, v), a lane without a candidate
    at (0, 0); every lane's contribution as if its light were visible (the
    plain arithmetic, `_nee_weights`, told nothing is occluded); then, as
    after the kernel's wait, the any-hit answer as a select.  `poison`
    replaces the contribution of the occluded candidates first.  Returns
    (radiance, spec_next)."""
    f = record_layout()
    flags = record[f["kFlags"]].view(torch.int32)
    hit, cand, glass, choose = ((flags & f[k]) != 0 for k in ("kHit", "kCand", "kGlass", "kChooseSpec"))
    field3 = lambda k: record[f[k] : f[k] + 3].T  # noqa: E731
    sh = dict(normal=field3("kNormal"), alpha=record[f["kAlpha"]], spec_prob=record[f["kSpecProb"]],
              idotn=record[f["kIdotN"]], brdf_combined=field3("kBrdf"), f_vec=field3("kFvec"),
              diffuse_albedo=field3("kDiffuse"), spec_dir=field3("kSpecDir"), spec_pdf=record[f["kSpecPdf"]],
              glass=glass, choose_spec=choose)
    u = torch.where(cand, record[f["kU"]], 0.0)
    v = torch.where(cand, record[f["kV"]], 0.0)
    contrib, _, spec_next = integrator._nee_weights(scene, cfg, sh, cand, torch.zeros_like(cand), shadow_dir,
                                                    record[f["kPdf"]], u, v, record[f["kCosL"]], direction,
                                                    attenuation)
    if poison is not None:
        contrib = torch.where((cand & occluded)[:, None], poison, contrib)
    visible = cand & ~occluded  # the answer, last
    return torch.where(hit[:, None], radiance + torch.where(visible[:, None], contrib, 0.0), radiance), spec_next


NEE_MODES = {"nee": "nee", "mis": "nee_mis", "mis_defensive": "nee_mis_defensive"}


@functools.lru_cache(maxsize=None)
def nee_case(mode):
    """bounce_inputs' scene, config and lanes for one NEE mode, as torch
    tensors: (scene, cfg, args of _bounce_plain, the fixed any-hit answer)."""
    _, t, _, cfg, (o, d, att, rad, seeds, depth, spec), hit, occluded = bounce_inputs(NEE_MODES[mode])
    thit = Hit(**{k: torch.tensor(v) for k, v in hit.items()})
    args = (thit, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(att), torch.as_tensor(rad),
            torch.as_tensor(seeds.astype(np.int64)), torch.as_tensor(depth), torch.as_tensor(spec))
    return t, cfg, args, torch.as_tensor(occluded)


def plain_bounce(monkeypatch, scene, cfg, args, occluded):
    monkeypatch.setattr(integrator, "occluded_scene", lambda *a, **k: occluded)
    return integrator._bounce_plain(scene, cfg, *args)


@pytest.mark.parametrize("env_mode", ["equirect", "sunsky", "constant"])
@pytest.mark.parametrize("mode", list(NEE_MODES))
def test_nee_model_equals_the_plain_tail(monkeypatch, mode, env_mode):
    """The model's radiance and spec_next equal `_bounce_plain`'s bit for
    bit, and an inf or a NaN in an occluded candidate's contribution
    leaves them so (a product with the flag would not)."""
    scene, cfg, args, occluded = nee_case(mode)
    cfg = cfg.replace(env_mode=env_mode)
    hit, o, d, att = args[:4]
    want = plain_bounce(monkeypatch, scene, cfg, args, occluded)
    # the bounce kernel's radiance: the plain bounce with every light occluded
    pre = plain_bounce(monkeypatch, scene, cfg, args, torch.ones_like(occluded))["radiance"]
    assert not torch.signbit(pre).any()  # so pre + 0 is pre on the hit lanes
    sh = integrator._shade(scene, cfg, hit, o, d, args[5], args[6])
    _, env_dir, pdf, u, v = integrator._light_sample(scene, cfg, sh, sh["seeds"])
    cand, cos_l = integrator._shadow_candidates(hit.hit, sh, env_dir)
    record = pack_record(sh, hit.hit, cand, pdf, u, v, cos_l)
    blocked = cand & occluded
    assert 0 < int(blocked.sum()) < int(cand.sum())
    poison = torch.where((torch.arange(hit.hit.shape[0]) % 2 == 0)[:, None], float("inf"), float("nan"))
    for p in (None, poison):
        rad, spec_next = nee_model(scene, cfg, record, env_dir, d, att, pre, occluded, poison=p)
        assert torch.equal(rad.view(torch.int32), want["radiance"].view(torch.int32))
        assert torch.equal(spec_next.view(torch.int32) if spec_next.dtype == torch.float32 else spec_next,
                           want["spec_last"].view(torch.int32) if spec_next.dtype == torch.float32
                           else want["spec_last"])
    # the poison is live: a product with the visible flag carries it into radiance
    visible = (cand & ~occluded).float()[:, None]
    assert not torch.isfinite(pre + torch.where(blocked[:, None], poison, 0.0) * visible).all()
    assert torch.isfinite(want["radiance"]).all()
