"""The schedules' steps after a trace: the streaming schedule's post-trace
tail as one kernel launch per iteration (the stream step), and the
Russian roulette and state merges of `render_rays` and
`render_pixels_regen` as one launch per iteration (the path step).

The stream step is the counterpart of `tpu_pathtracer/ops/fused_schedule.py`
(`fused_stream_step`, TPU kernel `_fused_step_kernel`).  After
`_trace_bounce`, every lane of the pool takes the Russian-roulette draw
and estimator, adds a finished sample into its pixel's sum, retires a
finished pixel into the image, pulls its next pixel off the work queue (a
prefix sum over the lanes that retired, in lane order) and merges its
state.  Camera regeneration stays with the caller, which runs
`ops/camera.camera_paths` on the returned regen mask, as the JAX package
does.  The JAX kernel takes the identity pixel map and no NEE; the port's
kernel also takes an affine range (base + slot, `base` a 0-d tensor read
on the device) or an id table (ids[min(slot, n_pix - 1)]), and under NEE
(a `shadow` counter given) counts the live lanes that hit and sets each
lane's env credit `spec_last`, so that the unfused stream runs it too.

The path step replaces no TPU kernel: it is the counterpart of the fusion
XLA makes of the JAX package's `render_rays` and `render_pixels_regen`
loop bodies.  It also writes the loop's 0-d `done` flag and adds the
segments (and shadow segments) into their counters, on the device.

The kernels are `csrc/fused_schedule.cu` (entries 0 and 1).
`fused_stream_step` launches the stream step for CUDA tensors and runs
`fused_stream_step_plain` for CPU tensors; `path_step` launches the path
step on a CUDA device outside `ops.cuda_build.plain()` and runs
`path_step_plain` elsewhere, as the bounce's kernels do.  The kernels
update the state's tensors in place (the JAX kernel's input/output
aliases); the plain stream step rebinds the entries of the state dict,
the plain path step copies into them.  Each retired pixel's mean goes
into `out` directly: the JAX kernel's retire FIFO is not carried, and the
kernel writes only the retired rows.

The stream's lane state `st` is a dict of tensors over L lanes: origin,
direction, attenuation, radiance, lane_accum [L,3] f32; seeds [L] int64
holding u32; slot, pix, sample_i, depth [L] int32; under NEE spec_last
[L] bool (f32 under nee_mis_spec).  The payload `tb` is `_trace_bounce`'s
dict: origin, direction, attenuation, radiance [L,3] f32, seeds [L]
int64, done [L] bool, and under NEE hit [L] bool and spec_last.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_pathtracer_torch.ops import bounce as bounce_ops
from tpu_pathtracer_torch.ops.bounce import _launch, _params
from tpu_pathtracer_torch.ops.cuda_build import MAX_LANES, check_lanes, kernel_arg, on_card
from tpu_pathtracer_torch.utils import rng

TB_KEYS = ("origin", "direction", "attenuation", "radiance", "seeds", "done")
STATE_KEYS = ("origin", "direction", "attenuation", "radiance", "seeds",
              "slot", "pix", "sample_i", "depth", "lane_accum")
# Lanes a tile of the kernels: one block, one lane a thread (kThreads in csrc/fused_schedule.cu).
TILE_LANES = 256
# The path step's schedules (StepParams.schedule).
PATH_SCHEDULES = ("rays", "regen")
# The most lanes the stream step (kernel 7) takes: cuda_build.MAX_LANES
# (int32 lane indices), as the path step.  From NARROW_LANES on the stream
# step's tiles publish two status words each (retired lanes, live lanes),
# below it one word with both in 25-bit fields; the path step counts its
# totals in two words from there (csrc/fused_schedule.cu: kNarrowLanes).
STREAM_MAX_LANES = MAX_LANES
NARROW_LANES = 2**25

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class StepParams(ctypes.Structure):
    """csrc/fused_schedule.cu: StepParams."""

    _fields_ = [(k, _P) for k in (
        "tb_origin", "tb_direction", "tb_attenuation", "tb_radiance", "tb_seeds", "tb_done", "tb_hit", "tb_spec",
        "origin", "direction", "attenuation", "radiance", "seeds", "slot", "pix", "sample_i", "depth", "accum",
        "spec", "flag", "result", "out", "head", "base", "ids", "segments", "shadow", "scratch", "regen", "totals",
        "done",
    )] + [(k, _I) for k in ("n", "spp", "n_pix", "max_depth", "rr_reference", "pixel_map", "nee", "schedule")] + [
        ("inv_spp", _F)]


def roulette(tb, live, rr_reference: bool):
    """The Russian-roulette draw and estimator after a bounce, shared by
    every schedule.  Returns (seeds advanced once, newly: live lanes whose
    path ends here, adv: live lanes that go on, the ending path's result
    [L,3], the attenuation the surviving lanes carry on)."""
    seeds_new, u_rr = rng.uniform(tb["seeds"])
    att = tb["attenuation"]
    p = att.amax(dim=-1)
    rr_done = tb["done"] | (u_rr > p)
    newly = live & rr_done
    adv = live & ~rr_done
    p_safe = torch.where(p > 0.0, p, 1.0)
    if rr_reference:
        result = tb["radiance"] / p_safe[:, None]
    else:
        # Survival probability is min(p, 1).
        result = tb["radiance"]
        att = torch.where(adv[:, None], att / torch.clamp_max(p_safe, 1.0)[:, None], att)
    return seeds_new, newly, adv, result, att


def slot_pixels(slot, n_pix: int, base=None, ids=None):
    """The pixel ids of work-queue slots: base + slot for an affine range
    (`base` a Python int or a 0-d tensor), ids[min(slot, n_pix - 1)] for
    an id table, else the slots themselves (the whole frame)."""
    if base is not None:
        return base + slot
    if ids is not None:
        return ids[torch.clamp_max(slot, n_pix - 1)]
    return slot


def fused_stream_step_plain(tb, st, out, head, segments, shadow=None, *, spp: int, n_pix: int, max_depth: int,
                            rr_reference: bool, inv_spp: float, base=None, ids=None):
    """One schedule step, as the JAX kernel computes it, and the stream's
    tail before its camera respawn: updates the entries of `st` and adds
    each retired pixel's `lane_accum * inv_spp` into `out` [n_pix+1,3],
    rows by slot (lanes that retire nothing add zeros into the sink row
    n_pix; each pixel row takes one non-zero add, so the sum is exact in
    any order).  `head`, `segments` and `shadow` are 0-d int64 tensors; a
    retired lane's new pixel is `slot_pixels(slot, n_pix, base, ids)`.
    With `shadow` (NEE) the payload's hit flags over the live lanes are
    counted into it and st["spec_last"] is set: 1 where a lane respawns,
    the payload's elsewhere.  Returns (regen [L] bool, head', segments',
    lanes live after the step), the last three 0-d int64 tensors, and
    under NEE shadow' last."""
    slot = st["slot"]
    live = slot < n_pix
    seeds_new, newly, adv, result, att = roulette(tb, live, rr_reference)
    acc = st["lane_accum"] + torch.where(newly[:, None], result, 0.0)
    sample_i = st["sample_i"] + newly.to(torch.int32)
    pixel_done = newly & (sample_i >= spp)

    out.index_add_(0, torch.where(pixel_done, slot, n_pix).long(),
                   torch.where(pixel_done[:, None], acc * inv_spp, 0.0))

    # The work queue: retired lanes take the next slots in lane order.
    inc = torch.cumsum(pixel_done, dim=0)
    new_slot = torch.where(pixel_done, (head + inc - 1).to(torch.int32), slot)
    live_next = new_slot < n_pix
    # JAX's (newly & live_next) | (pixel_done & live_next); pixel_done
    # implies newly.
    regen = newly & live_next

    rg, av = regen[:, None], adv[:, None]
    st.update(
        origin=torch.where(av, tb["origin"], st["origin"]),
        direction=torch.where(av, tb["direction"], st["direction"]),
        attenuation=torch.where(rg, 1.0, torch.where(av, att, st["attenuation"])),
        radiance=torch.where(rg, 0.0, torch.where(av, tb["radiance"], st["radiance"])),
        seeds=torch.where(live, seeds_new, st["seeds"]),
        depth=torch.where(regen, max_depth, torch.where(adv, st["depth"] - 1, st["depth"])),
        pix=torch.where(pixel_done, slot_pixels(new_slot, n_pix, base, ids), st["pix"]),
        slot=new_slot,
        sample_i=torch.where(pixel_done, 0, sample_i),
        lane_accum=torch.where(pixel_done[:, None], 0.0, acc),
    )
    stats = (regen, head + inc[-1], segments + live.sum(), live_next.sum())
    if shadow is None:
        return stats
    # A lane that neither respawns nor goes on is not live again, so its
    # flag is never read.
    st["spec_last"] = torch.where(regen, torch.ones_like(st["spec_last"]), tb["spec_last"])
    return stats + (shadow + (live & tb["hit"]).sum(),)


def path_step_plain(tb, st, *, schedule: str, spp: int, max_depth: int, rr_reference: bool, nee: bool):
    """The step of render_rays (schedule "rays") or render_pixels_regen
    ("regen") after a trace, on the loop's buffers `st` (written in place
    with copy_): Russian roulette, the merges, the counters (segments, and
    under NEE shadow: the live lanes that hit) and the 0-d `done` flag.
    rays: result, terminated; regen: accum, sample_i, exhausted, and the
    regen mask (the lanes whose next sample the caller spawns) into the
    loop's buffer st["regen"], which it returns (rays: None)."""
    _check_schedule(st, schedule)
    if schedule == "rays":
        live = ~st["terminated"]
        seeds_new, newly, adv, result_t, att_new = roulette(tb, live, rr_reference)
        terminated = st["terminated"] | newly
        av = adv[:, None]
        regen = None
        new = dict(
            result=torch.where(newly[:, None], result_t, st["result"]),
            terminated=terminated, done=terminated.all(),
            origin=torch.where(av, tb["origin"], st["origin"]),
            direction=torch.where(av, tb["direction"], st["direction"]),
            attenuation=torch.where(av, att_new, st["attenuation"]),
            radiance=torch.where(av, tb["radiance"], st["radiance"]),
            seeds=torch.where(live, seeds_new, st["seeds"]),
            depth=torch.where(adv, st["depth"] - 1, st["depth"]),
            segments=st["segments"] + live.sum(),
        )
        if nee:
            new.update(spec_last=torch.where(adv, tb["spec_last"], st["spec_last"]),
                       shadow=st["shadow"] + (live & tb["hit"]).sum())
    else:
        live = ~st["exhausted"]
        seeds_new, newly, adv, result, att_new = roulette(tb, live, rr_reference)
        accum = st["accum"] + torch.where(newly[:, None], result, 0.0)
        sample_i = st["sample_i"] + newly.to(torch.int32)
        exhausted = st["exhausted"] | (newly & (sample_i >= spp))

        # Respawn the next sample on lanes that just finished one: the
        # camera spawn writes them into the buffers afterwards.
        regen = newly & ~exhausted
        rg, av = regen[:, None], adv[:, None]
        new = dict(
            accum=accum, sample_i=sample_i, exhausted=exhausted, done=exhausted.all(),
            origin=torch.where(av, tb["origin"], st["origin"]),
            direction=torch.where(av, tb["direction"], st["direction"]),
            seeds=torch.where(live, seeds_new, st["seeds"]),
            attenuation=torch.where(rg, 1.0, torch.where(av, att_new, st["attenuation"])),
            radiance=torch.where(rg, 0.0, torch.where(av, tb["radiance"], st["radiance"])),
            depth=torch.where(regen, max_depth, torch.where(adv, st["depth"] - 1, st["depth"])),
            segments=st["segments"] + live.sum(),
        )
        if nee:
            spec_last = st["spec_last"]
            new.update(spec_last=torch.where(regen, torch.ones_like(spec_last),
                                             torch.where(adv, tb["spec_last"], spec_last)),
                       shadow=st["shadow"] + (live & tb["hit"]).sum())
    for k, v in new.items():
        st[k].copy_(v)
    if regen is None:
        return None
    st["regen"].copy_(regen)
    return st["regen"]


def _check_schedule(st, schedule: str) -> None:
    if schedule not in PATH_SCHEDULES:
        raise ValueError(f"no path step for schedule {schedule!r}: expected one of {PATH_SCHEDULES}")
    if schedule == "regen" and "regen" not in st:
        raise ValueError('the regen schedule writes its mask into the loop\'s buffer st["regen"], which is missing')


def _scratch(device: torch.device, entry: int, lanes: int) -> torch.Tensor:
    """A kernel's scratch for launches of entry `entry` over `lanes` lanes
    on `device`, of as many words as the kernel's library says
    (csrc/fused_schedule.cu: fused_step_scratch_words).  The stream step's
    (entry 0): a ticket counter, the grid sum's arrival counter and sum,
    then a status word a tile (two from NARROW_LANES lanes on); the path
    step's (entry 1): its packed count word (live lanes, tiles not done,
    arrivals; from NARROW_LANES lanes live lanes and arrivals), its hit
    count and (from NARROW_LANES) its count of tiles not done.  Zeroed
    once and never again: a launch tags its status words with its own
    number, read off the ticket counter, and the block that arrives last
    sets the sums and the count words back to 0.  Launches that share one
    run one at a time, on one stream, in one layout: 2^25 - 1 and 2^25
    lanes take the same tiles, and a narrow launch would leave the wide
    words it does not write holding tags that go live again 4,095
    launches later."""
    tiles = -(-lanes // TILE_LANES)
    return _zeroed_scratch(device, entry, tiles, lanes >= NARROW_LANES,
                           bounce_ops.library("fused_schedule.cu").fused_step_scratch_words(entry, lanes))


@functools.lru_cache(maxsize=None)
def _zeroed_scratch(device: torch.device, entry: int, tiles: int, wide: bool, words: int) -> torch.Tensor:
    return torch.zeros(words, dtype=torch.int64, device=device)


def _stream_lanes(st) -> int:
    """The stream step's lanes, refused above STREAM_MAX_LANES."""
    return check_lanes("the stream step's lanes", st["seeds"].shape[0])


def _path_lanes(st) -> int:
    """The path step's lanes, refused above cuda_build.MAX_LANES."""
    return check_lanes("the path step's lanes", st["seeds"].shape[0])


def _nee_args(tb, st, lanes, dev) -> tuple[dict, int]:
    """The payload's hit flags and env credits and the lanes' env credits,
    by StepParams field, and the `nee` flag: 2 for f32 credits (MIS), 1
    for bool."""
    dtype = st["spec_last"].dtype
    if dtype not in (torch.bool, torch.float32):
        raise TypeError(f"spec_last: expected torch.bool or torch.float32, got {dtype}")
    return dict(tb_hit=kernel_arg("tb['hit']", tb["hit"], torch.bool, (lanes,), dev),
                tb_spec=kernel_arg("tb['spec_last']", tb["spec_last"], dtype, (lanes,), dev),
                spec=kernel_arg("st['spec_last']", st["spec_last"], dtype, (lanes,), dev, written=True)
                ), 2 if dtype == torch.float32 else 1


def _payload_args(tb, st, lanes, dev) -> dict:
    """The payload and the lane state both steps read and write, by
    StepParams field."""
    t = {f"tb_{k}": kernel_arg(f"tb[{k!r}]", tb[k], dt, shape, dev)
         for k, dt, shape in (("origin", torch.float32, (lanes, 3)), ("direction", torch.float32, (lanes, 3)),
                              ("attenuation", torch.float32, (lanes, 3)), ("radiance", torch.float32, (lanes, 3)),
                              ("seeds", torch.int64, (lanes,)), ("done", torch.bool, (lanes,)))}
    for k, dt, shape in (("origin", torch.float32, (lanes, 3)), ("direction", torch.float32, (lanes, 3)),
                         ("attenuation", torch.float32, (lanes, 3)), ("radiance", torch.float32, (lanes, 3)),
                         ("seeds", torch.int64, (lanes,)), ("depth", torch.int32, (lanes,))):
        t[k] = kernel_arg(f"st[{k!r}]", st[k], dt, shape, dev, written=True)
    return t


def _launch_step(params, entry: int, dev, dependent: bool = False) -> None:
    _launch("fused_schedule.cu", "fused_step_launch", params, entry, int(dependent),
            stream=torch.cuda.current_stream(dev).cuda_stream)


def fused_stream_step_cuda(tb, st, out, head, segments, shadow=None, *, spp: int, n_pix: int, max_depth: int,
                           rr_reference: bool, inv_spp: float, base=None, ids=None):
    """Launch the stream step on CUDA tensors; the plain version's
    contract, with the state updated in place."""
    dev = st["slot"].device
    lanes = _stream_lanes(st)
    if not st["slot"].is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    if n_pix + lanes >= 2**31:
        raise ValueError(f"the kernel takes slots below 2^31: {lanes} lanes, {n_pix} pixels")
    if base is not None and ids is not None:
        raise ValueError("a pixel map is an affine range or an id table, not both")
    t = _payload_args(tb, st, lanes, dev)
    for k in ("slot", "pix", "sample_i"):
        t[k] = kernel_arg(f"st[{k!r}]", st[k], torch.int32, (lanes,), dev, written=True)
    t["accum"] = kernel_arg("st['lane_accum']", st["lane_accum"], torch.float32, (lanes, 3), dev, written=True)
    t.update(out=kernel_arg("out", out, torch.float32, (n_pix + 1, 3), dev, written=True),
             head=kernel_arg("head", head, torch.int64, (), dev),
             segments=kernel_arg("segments", segments, torch.int64, (), dev))
    nee = 0
    if shadow is not None:
        nee_t, nee = _nee_args(tb, st, lanes, dev)
        t.update(nee_t, shadow=kernel_arg("shadow", shadow, torch.int64, (), dev))
    if base is not None:
        t["base"] = kernel_arg("base", torch.as_tensor(base, device=dev).to(torch.int64), torch.int64, (), dev)
    if ids is not None:
        t["ids"] = kernel_arg("ids", ids.to(torch.int32), torch.int32, (n_pix,), dev)
    regen = torch.empty(lanes, dtype=torch.bool, device=dev)
    totals = torch.empty(4, dtype=torch.int64, device=dev)  # head', segments', live', shadow'
    t.update(scratch=_scratch(dev, 0, lanes), regen=regen, totals=totals)
    params = _params(StepParams, t, dict(
        n=lanes, spp=spp, n_pix=n_pix, max_depth=max_depth, rr_reference=int(rr_reference),
        pixel_map=0 if base is None and ids is None else 1 if base is not None else 2, nee=nee, schedule=0,
        inv_spp=float(inv_spp)), None)
    _launch_step(params, 0, dev)
    fused_stream_step.launches += 1
    stats = (regen, totals[0], totals[1], totals[2])
    return stats if shadow is None else stats + (totals[3],)


def fused_stream_step(tb, st, out, head, segments, shadow=None, **kw):
    """One stream step (TPU kernel 7's contract, widened to every pixel
    map and to NEE): the kernel for CUDA tensors, the plain version for
    CPU tensors; keywords as fused_stream_step_plain's."""
    if st["slot"].is_cuda:
        return fused_stream_step_cuda(tb, st, out, head, segments, shadow, **kw)
    if st["slot"].device.type != "cpu":
        raise ValueError(f"no fused-step kernel for device {st['slot'].device}")
    return fused_stream_step_plain(tb, st, out, head, segments, shadow, **kw)


def path_step_cuda(tb, st, *, schedule: str, spp: int, max_depth: int, rr_reference: bool, nee: bool,
                   dependent: bool = False):
    """Launch the path step on CUDA tensors; path_step_plain's contract,
    with the buffers of `st` updated in place.

    The regen schedule's mask is the loop's buffer st["regen"], written in
    place and returned: an ended lane's byte is not written, and is 0 from
    the step that ended it, so the buffer must hold the last step's mask,
    zeros before the first.

    `dependent`: launch it as a programmatic dependent of the launch just
    before it on the stream (csrc/launch_order.cuh), which may then still
    be running when the kernel starts: the caller vouches that that launch
    is the bounce kernel (without NEE) or the NEE kernel (under NEE), so
    that the payload is the last thing written; the kernel reads the flags
    and the lanes' state before its wait."""
    _check_schedule(st, schedule)
    if dependent and not all(tb[k].is_contiguous() for k in TB_KEYS + (("hit", "spec_last") if nee else ())):
        raise ValueError("a dependent path step reads the payload after its wait: it must be contiguous, not copied "
                         "here just before the launch")
    dev = st["seeds"].device
    lanes = _path_lanes(st)
    if not st["seeds"].is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    regen_schedule = schedule == "regen"
    t = _payload_args(tb, st, lanes, dev)
    flag = "exhausted" if regen_schedule else "terminated"
    t.update(flag=kernel_arg(f"st[{flag!r}]", st[flag], torch.bool, (lanes,), dev, written=True),
             done=kernel_arg("st['done']", st["done"], torch.bool, (), dev, written=True),
             segments=kernel_arg("st['segments']", st["segments"], torch.int64, (), dev, written=True),
             scratch=_scratch(dev, 1, lanes))
    regen = None
    if regen_schedule:
        regen = kernel_arg("st['regen']", st["regen"], torch.bool, (lanes,), dev, written=True)
        t.update(accum=kernel_arg("st['accum']", st["accum"], torch.float32, (lanes, 3), dev, written=True),
                 sample_i=kernel_arg("st['sample_i']", st["sample_i"], torch.int32, (lanes,), dev, written=True),
                 regen=regen)
    else:
        t["result"] = kernel_arg("st['result']", st["result"], torch.float32, (lanes, 3), dev, written=True)
    nee_kind = 0
    if nee:
        nee_t, nee_kind = _nee_args(tb, st, lanes, dev)
        t.update(nee_t, shadow=kernel_arg("st['shadow']", st["shadow"], torch.int64, (), dev, written=True))
    if not lanes:  # no launch: every lane of none has ended
        st["done"].fill_(True)
        return regen
    params = _params(StepParams, t, dict(
        n=lanes, spp=spp, n_pix=0, max_depth=max_depth, rr_reference=int(rr_reference), pixel_map=0, nee=nee_kind,
        schedule=PATH_SCHEDULES.index(schedule), inv_spp=0.0), None)
    _launch_step(params, 1, dev, dependent)
    path_step.launches += 1
    return regen


def path_step(tb, st, dependent=False, **kw):
    """The path step of render_rays or render_pixels_regen (keywords as
    path_step_plain's): the kernel on a CUDA device outside
    `ops.cuda_build.plain()` (`dependent` as path_step_cuda takes it),
    else the plain version."""
    if on_card(st["seeds"].device):
        return path_step_cuda(tb, st, dependent=dependent, **kw)
    return path_step_plain(tb, st, **kw)


# Kernel launches since each count was last set to 0.
fused_stream_step.launches = 0
path_step.launches = 0
