"""The fused schedule step: the streaming schedule's post-trace tail as one
kernel launch per iteration.

Counterpart of `tpu_pathtracer/ops/fused_schedule.py` (`fused_stream_step`,
TPU kernel `_fused_step_kernel`).  After `_trace_bounce`, every lane of the
pool takes the Russian-roulette draw and estimator, adds a finished
sample into its pixel's sum, retires a finished pixel into the image,
pulls its next pixel off the work queue (a prefix sum over the lanes that
retired, in lane order) and merges its state.  Camera regeneration stays
with the caller, which runs the same `generate_camera_rays` as the unfused
schedule on the returned regen mask, as the JAX package does.

The kernel is `csrc/fused_schedule.cu`.  `fused_stream_step` launches it
for CUDA tensors and runs `fused_stream_step_plain` for CPU tensors.  The
kernel updates the lane state's tensors in place (the JAX kernel's
input/output aliases), the plain version rebinds the entries of the state
dict; both add each retired pixel's mean into `out` directly: the JAX
kernel's retire FIFO is not carried.  The plain version is also the
unfused stream's tail, on any device and with any pixel mapping, so the
two schedules share one definition of the step.  Without NEE, to which
the fused path is confined, the JAX kernel's `spec` plane is always 1 and
is dropped.

The lane state `st` is a dict of tensors over L lanes: origin, direction,
attenuation, radiance, lane_accum [L,3] f32; seeds [L] int64 holding u32;
slot, pix, sample_i, depth [L] int32.  The payload `tb` is
`_trace_bounce`'s dict: origin, direction, attenuation, radiance [L,3]
f32, seeds [L] int64, done [L] bool.
"""

from __future__ import annotations

import functools

import torch

from tpu_pathtracer_torch.ops.cuda_build import check_tensor, library
from tpu_pathtracer_torch.utils import rng

TB_KEYS = ("origin", "direction", "attenuation", "radiance", "seeds", "done")
STATE_KEYS = ("origin", "direction", "attenuation", "radiance", "seeds",
              "slot", "pix", "sample_i", "depth", "lane_accum")
# Lanes a tile of the kernel: one block, one lane a thread (kThreads in csrc/fused_schedule.cu).
TILE_LANES = 256


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


def fused_stream_step_plain(tb, st, out, head, segments, *, spp: int, n_pix: int, max_depth: int,
                            rr_reference: bool, inv_spp: float, slot_to_pixel=None):
    """One schedule step, as the JAX kernel computes it, and the unfused
    stream's tail before its camera respawn: updates the entries of `st`
    and adds each retired pixel's `lane_accum * inv_spp` into `out`
    [n_pix+1,3] (lanes that retire nothing add zeros into the sink row
    n_pix; each pixel row takes one non-zero add, so the sum is exact in
    any order).  `head` and `segments` are 0-d int64 tensors;
    `slot_to_pixel` maps queue slots to pixel ids (None: the identity, the
    kernel's only mapping).  Returns (regen [L] bool, head', segments',
    lanes live after the step), the last three 0-d int64 tensors."""
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
    next_pix = new_slot if slot_to_pixel is None else slot_to_pixel(new_slot)
    st.update(
        origin=torch.where(av, tb["origin"], st["origin"]),
        direction=torch.where(av, tb["direction"], st["direction"]),
        attenuation=torch.where(rg, 1.0, torch.where(av, att, st["attenuation"])),
        radiance=torch.where(rg, 0.0, torch.where(av, tb["radiance"], st["radiance"])),
        seeds=torch.where(live, seeds_new, st["seeds"]),
        depth=torch.where(regen, max_depth, torch.where(adv, st["depth"] - 1, st["depth"])),
        pix=torch.where(pixel_done, next_pix, st["pix"]),
        slot=new_slot,
        sample_i=torch.where(pixel_done, 0, sample_i),
        lane_accum=torch.where(pixel_done[:, None], 0.0, acc),
    )
    return regen, head + inc[-1], segments + live.sum(), live_next.sum()


# The [L] tensors of the payload and the state; the others are [L,3] f32.
_LANE_DTYPES = {"seeds": torch.int64, "done": torch.bool, "slot": torch.int32, "pix": torch.int32,
                "sample_i": torch.int32, "depth": torch.int32}


@functools.lru_cache(maxsize=None)
def _scratch(device: torch.device, tiles: int) -> torch.Tensor:
    """The kernel's scratch for launches of `tiles` tiles on `device`: a
    ticket counter, then a status word a tile.
    Zeroed once here and never again: a launch tags its status words with
    its own number, read off the ticket counter (csrc/fused_schedule.cu).
    Launches that share it run one at a time, on one stream."""
    return torch.zeros(1 + tiles, dtype=torch.int64, device=device)


def _check_step(tb, st, out, head, segments, n_pix):
    dev = st["slot"].device
    if not st["slot"].is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    lanes = st["slot"].shape[0]
    if lanes >= 2**25 or n_pix + lanes >= 2**31:
        raise ValueError(f"the kernel takes fewer than 2^25 lanes and slots below 2^31: {lanes} lanes, {n_pix} pixels")
    for what, tensors, keys in (("tb", tb, TB_KEYS), ("st", st, STATE_KEYS)):
        for key in keys:
            dtype = _LANE_DTYPES.get(key, torch.float32)
            check_tensor(f"{what}[{key!r}]", tensors[key], dtype, (lanes,) if key in _LANE_DTYPES else (lanes, 3), dev)
    check_tensor("out", out, torch.float32, (n_pix + 1, 3), dev)
    check_tensor("head", head, torch.int64, (), dev)
    check_tensor("segments", segments, torch.int64, (), dev)


def fused_stream_step_cuda(tb, st, out, head, segments, *, spp: int, n_pix: int, max_depth: int,
                           rr_reference: bool, inv_spp: float):
    """Launch the kernel on CUDA tensors; same contract as the plain
    version."""
    _check_step(tb, st, out, head, segments, n_pix)
    lanes, dev = st["slot"].shape[0], out.device
    regen = torch.empty(lanes, dtype=torch.bool, device=dev)
    result = torch.empty(3, dtype=torch.int64, device=dev)  # head', segments', live'
    err = library("fused_schedule.cu").fused_step_launch(
        *(tb[k].data_ptr() for k in TB_KEYS),
        *(st[k].data_ptr() for k in STATE_KEYS),
        out.data_ptr(), head.data_ptr(), segments.data_ptr(),
        _scratch(dev, -(-lanes // TILE_LANES)).data_ptr(), regen.data_ptr(), result.data_ptr(),
        lanes, spp, n_pix, max_depth, int(rr_reference), float(inv_spp), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fused_step_kernel launch failed: CUDA error {err}")
    fused_stream_step.launches += 1
    return regen, result[0], result[1], result[2]


def fused_stream_step(tb, st, out, head, segments, *, spp: int, n_pix: int, max_depth: int,
                      rr_reference: bool, inv_spp: float):
    """One fused schedule step (TPU kernel 7's contract): the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    kw = dict(spp=spp, n_pix=n_pix, max_depth=max_depth, rr_reference=rr_reference, inv_spp=inv_spp)
    if st["slot"].is_cuda:
        return fused_stream_step_cuda(tb, st, out, head, segments, **kw)
    if st["slot"].device.type != "cpu":
        raise ValueError(f"no fused-step kernel for device {st['slot'].device}")
    return fused_stream_step_plain(tb, st, out, head, segments, **kw)


# Kernel launches since the count was last set to 0.
fused_stream_step.launches = 0
