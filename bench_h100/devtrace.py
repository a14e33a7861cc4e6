"""Device traces: the profiler arithmetic of the repository's chip_smoke.py
(`trace`, `device_events`, `busy_seconds`, `kernel_label`), copied here so
that the yardstick does not move with the program, and the idle gaps
named by the benchmark's host spans.

A trace keeps PROFILE_MARGIN_S of host time before the first launch and
after the card is done (the profiler keeps only device events that fall
inside its window once moved onto the host's clock, and the move can be
off by milliseconds), launches a throwaway spin kernel first (a trace's
first kernel can go untraced), and is taken again, up to `retakes` times,
while some host launch after the spin has no device event."""

from __future__ import annotations

import collections
import time

import torch

# The device functions of the program's kernels (tpu_pathtracer_torch/csrc/).
DEVICE_FUNCTIONS = ("streamed_kernel", "packet_weight_kernel", "brute_kernel", "fused_step_kernel",
                    "path_step_kernel", "unit_sphere_kernel", "bounce_kernel", "shade_lanes_kernel", "nee_kernel",
                    "camera_kernel", "sort_cluster_kernel", "sort_keys_kernel", "sort_pass_kernel",
                    "packet_order_kernel")
PROFILE_MARGIN_S = 0.02


def kernel_label(key: str):
    """The program's kernel that the device function `key` belongs to, or
    None: streamed_kernel<kAnyHit, kVisit, ...> told apart by any hit or
    closest and its visit order (flat, per packet, streamed), brute_kernel
    by its first template argument."""
    name = next((k for k in DEVICE_FUNCTIONS if k in key), None)
    if name == "brute_kernel":
        any_hit = key.split("brute_kernel<", 1)[-1].split(">")[0].split(",")[0].strip()
        return f"brute_kernel ({'any' if any_hit in ('true', '(bool)1') else 'closest'} hit)"
    if name == "streamed_kernel":
        any_hit, visit = (a.strip() for a in key.split("streamed_kernel<", 1)[-1].split(",")[:2])
        route = ("flat" if visit.endswith("2") or visit.endswith("kFlat")
                 else "hier" if visit.endswith("1") or visit.endswith("kPerPacket") else "streamed")
        return f"streamed_kernel ({route}, {'any' if any_hit in ('true', '(bool)1') else 'closest'} hit)"
    return name


def trace(run, spans: list, retakes: int = 2) -> dict:
    """run() under torch.profiler, device activity only (the host's own
    recording would slow the loop it measures).  `spans` is the list that
    the harness's host spans go to during run(), as (name, start, end) in
    time.perf_counter_ns(); they are moved onto the trace's clock by the
    spin's launch call, which is timed on both.  Returns `out` (run()'s
    result), `wall` (seconds to the card done), `device` (device events but
    the spin's, as (name, start_ns, duration_ns)), `spans` (on the trace's
    clock), `launches` (host kernel and graph launch calls after the spin),
    `complete` (each has a device event) and `retakes`."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for k in range(retakes + 1):
        spans.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            h0 = time.perf_counter_ns()
            torch.cuda._sleep(1000)
            h1 = time.perf_counter_ns()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_MARGIN_S)
        events = list(prof.profiler.kineto_results.events())
        launches = sorted((e for e in events
                           if e.device_type() != cuda and e.name().startswith("cu") and "Launch" in e.name()),
                          key=lambda e: e.start_ns())
        spin = launches[0].correlation_id() if launches else None
        device = [e for e in events if e.device_type() == cuda and e.correlation_id() != spin]
        seen = {e.correlation_id() for e in device}
        complete = bool(device) and all(e.correlation_id() in seen for e in launches[1:])
        if complete or k == retakes:
            shift = launches[0].start_ns() - (h0 + h1) // 2 if launches else 0
            return dict(out=out, wall=wall, device=[(e.name(), e.start_ns(), e.duration_ns()) for e in device],
                        spans=[(name, a + shift, b + shift) for name, a, b in spans],
                        launches=len(launches) - 1, complete=complete, retakes=k)


def device_events(device) -> dict:
    """{name: [count, device seconds]} of a trace's device events."""
    table = {}
    for name, _, dur in device:
        row = table.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += dur / 1e9
    return table


def busy_intervals(device) -> list:
    """The union of the device events' intervals, in order, as (start_ns,
    end_ns): a programmatic dependent, whose traced time begins while the
    launch before it still runs, is not counted twice."""
    out = []
    for _, start, dur in sorted(device, key=lambda e: e[1]):
        end = start + dur
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def busy_seconds(device) -> float:
    return sum(end - start for start, end in busy_intervals(device)) / 1e9


def idle_gaps(device, spans, top: int = 10) -> list:
    """The longest gaps between busy intervals, each named by the innermost
    host span open at its midpoint ("other" where none is): [[name,
    seconds], ...], longest first."""
    busy = busy_intervals(device)
    gaps = []
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = (end + start) / 2
        open_ = [s for s in spans if s[1] <= mid <= s[2]]
        name = max(open_, key=lambda s: s[1])[0] if open_ else "other"
        gaps.append([name, (start - end) / 1e9])
    return sorted(gaps, key=lambda g: -g[1])[:top]


def top_kernels(device, top: int = 10) -> list:
    """Device seconds by kernel (kernel_label, else the event's name),
    largest first: [[name, seconds], ...]."""
    split = collections.Counter()
    for name, (_, sec) in device_events(device).items():
        split[kernel_label(name) or name[:120]] += sec
    return [[k, v] for k, v in split.most_common(top)]


def seconds_of(device, functions) -> float:
    """Device seconds of the events whose name holds one of `functions`."""
    return sum(sec for name, (_, sec) in device_events(device).items() if any(f in name for f in functions))
