"""The benchmark of the PyTorch and CUDA port (`tpu_pathtracer_torch`) on
one NVIDIA card: one cell of BENCHMARK.json a run, one process.

    python3 bench_h100/run.py --workload NAME --seed N --seconds S --trace 0|1

A run loads the port and the cell's configuration, makes the scene from
the benchmark's own generators, warms up (the kernels built or loaded
from the checkout's build/ directory, one launch that captures the loop's
graph), then measures for S seconds in a closed loop of one client
(traffic.py), then checks what the window rendered against the plain
reference (reference/render.py) at pixels drawn from the seed, and prints
one JSON line last: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics, read
over a slice of the window under torch.profiler), `device`, and with
--trace 1 `breakdown`.  The numbers compared are printed beside their
limits as the last lines on standard error and under `check`, the line's
last key.

It exits non-zero without a result where torch sees no CUDA card, or
fewer than the cell asks for, or where the port, JAX or the JAX package
is found loaded once the window has closed."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100 import check, devtrace, roofline, spec  # noqa: E402
from bench_h100.traffic import Traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pathtracer")
# Caches the program or torch may write: fixed directories in the checkout.
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/bench_h100/torch_extensions",
              "TRITON_CACHE_DIR": "build/bench_h100/triton", "CUDA_CACHE_PATH": "build/bench_h100/nv_cache"}


def parse(argv):
    ap = argparse.ArgumentParser(prog="bench_h100/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (tpu_pathtracer_torch is not one)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-th percentile by nearest rank over all values."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


class Cell:
    """One cell's inputs: its configuration, mix, limits and traffic."""

    def __init__(self, name: str, seed: int, bench=None, overrides=None):
        bench = bench or spec.benchmark()
        self.entry = spec.workload(bench, name)
        self.name = name
        self.config = spec.load_json("configs", self.entry["config"])
        self.mix = spec.load_json("mixes", self.entry["traffic"])
        self.limits = spec.load_json("cells", name)["limits"]
        self.end_to_end = spec.metrics_of(bench, name, "end_to_end")
        self.per_layer = spec.metrics_of(bench, name, "per_layer")
        if overrides:
            scene = dict(self.config["scene"], args=dict(self.config["scene"].get("args", {}),
                                                         **overrides.get("scene", {})))
            self.config = dict(self.config, scene=scene,
                               render=dict(self.config["render"], **overrides.get("render", {})))
            self.mix = dict(self.mix, **overrides.get("mix", {}))
        self.traffic = Traffic(self.mix, self.config, seed)

    def arrays(self):
        scene = self.config["scene"]
        env = self.config["env"]
        return (spec.generator(scene["generator"]).build(**scene.get("args", {})),
                spec.generator(env["generator"]).build(**env.get("args", {})))


def window(cell: Cell, r, program, device, seconds: float, traced: bool):
    """The measured window: launches until `seconds` have passed, each as
    the mix's kind makes it.  Returns (launch seconds, wall seconds, the
    program's pixels, the traced slice or None)."""
    tr = cell.traffic
    loop = tr.kind.Loop(tr, r, program, device)
    times, traced_slice = [], None

    def launch(k, spans=None):
        t0 = time.perf_counter()
        img = loop.launch(k, spans)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        loop.keep(img)
        return t1

    t_first = time.perf_counter()
    t_end = t_first
    while t_end - t_first < seconds:
        if traced and traced_slice is None and t_end - t_first >= tr.trace_start * seconds and times:
            count = max(1, math.ceil(tr.trace_seconds / statistics.mean(times)))
            traced_slice = profile_slice(launch, program, count, len(times))
            t_end = time.perf_counter()
            continue
        t_end = launch(len(times))
    return times, t_end - t_first, loop.values(), traced_slice


def profile_slice(launch, program, count: int, first: int):
    """`count` launches under the profiler, with host spans; retaken while
    a launch has no device event.  Returns the trace with the launches
    (their indices) and the program's counters over the final take."""
    taken = {}
    rec = program.Spans()

    def run():
        k0 = first + taken.get("n", 0)
        trav0 = program.traversal_launches()
        with rec.around_step():
            for k in range(k0, k0 + count):
                launch(k, rec)
        taken["n"] = taken.get("n", 0) + count
        return dict(launches=list(range(k0, k0 + count)), traversal=program.traversal_launches() - trav0)

    return devtrace.trace(run, rec.spans)


def per_layer(cell: Cell, t: dict, stats: list, context: dict) -> dict:
    """The cell's per-layer metrics from the traced slice (its readers in
    metrics/), each left out where its reader finds nothing."""
    from types import SimpleNamespace

    ctx = SimpleNamespace(device=t["device"], wall_s=t["wall"], busy_s=devtrace.busy_seconds(t["device"]),
                          launches=len(stats), iters=sum(s["iters"] for s in stats),
                          segments=sum(s["segments"] for s in stats),
                          shadow_segments=sum(s["shadow_segments"] for s in stats),
                          traversal_launches=t["out"]["traversal"], seconds_of=devtrace.seconds_of, **context)
    ctx.traversal_bytes = roofline.traversal_bytes(ctx.segments, ctx.shadow_segments, ctx.traversal_launches,
                                                   ctx.triangles)
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def reference_values(cell: Cell, arrays, env, launches: int, device, dtype):
    """The reference's pixels for the window's launches, folded as the
    mix's kind folds them (the accumulation of every launch, or each
    launch's own image), in float32."""
    import torch

    ref = spec.reference(cell.config)
    tr = cell.traffic
    rs = ref.Settings(tr.render)
    alias = ref.alias_table(env) if rs.env_importance_sampling else None
    sc = ref.RefScene(arrays, env, device, dtype, alias)
    cam = tr.camera
    aspect = tr.width / tr.height
    frames = [ref.camera_frame(tr.eye(k), cam["lookat"], cam["up"], cam["fov_y"], aspect) for k in range(launches)]
    vals = ref.launch_values(sc, rs, frames, tr.width, tr.height, tr.pixels, tr.spp,
                             [tr.subframe(k) for k in range(launches)])
    return tr.kind.expected(vals, tr, ref).to(torch.float32).cpu().numpy()


def run(argv=None, device=None, overrides=None) -> tuple:
    """One run.  Returns (exit code, result dict or None).  `device` and
    `overrides` (smaller images, for the tests on the CPU) skip the look
    for a card."""
    args = parse(argv)
    cell = Cell(args.workload, args.seed, overrides=overrides)
    for var, rel in CACHE_DIRS.items():
        os.environ.setdefault(var, str(ROOT / rel))
    import torch

    if device is None:
        torch.set_num_threads(1)   # one host thread drives the card: an idle intra-op pool only adds noise
        chips = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"bench_h100: the cell needs {chips} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2, None
        device = torch.device("cuda:0")
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bench_h100 import program

    tr = cell.traffic
    arrays, env = cell.arrays()
    scene, cfg = program.build(arrays, env, tr.render, cell.config.get("accel"), device)
    r = program.renderer(scene, program.camera(tr.camera, tr.eye(-1)), cfg)
    r.step()                       # warm: builds or loads the kernels, captures the loop's graph
    r.reset()
    r.subframe = tr.subframe(0)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START

    captures0 = program.captures()
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    times, wall, values, traced = window(cell, r, program, device, args.seconds, bool(args.trace))
    captures = program.captures() - captures0
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    launches = len(times)

    result = {"attempted": launches, "failed": 0}
    if args.trace:
        stats = [program.frame_stats(scene, program.camera(tr.camera, tr.eye(k)), cfg, tr.subframe(k))
                 for k in traced["out"]["launches"]]
        context = dict(triangles=int(arrays.vertices.shape[0]), captures_in_window=captures,
                       peak_mem_bytes=peak_window, peaks=roofline.peaks(torch.cuda.get_device_name(device)))
        result["metrics"] = per_layer(cell, traced, stats, context)
        result["breakdown"] = {"device_ops": devtrace.top_kernels(traced["device"]),
                               "idle_gaps": devtrace.idle_gaps(traced["device"], traced["spans"])}
        result["slice"] = {"launches": len(stats), "complete": traced["complete"], "retakes": traced["retakes"],
                           "schedule": stats[0]["schedule"], "graphed": stats[0]["graphed"]}
    else:
        pixels = tr.width * tr.height * tr.spp
        e2e = {"msamples_per_s": pixels * launches / wall / 1e6,
               "preview_ms_p95": percentile(times, 95) * 1e3 if times else None,
               "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in e2e.items() if k in units}
        thirds = [times[i * launches // 3:(i + 1) * launches // 3] for i in range(3)]
        result["window"] = {"launches": launches, "wall_s": wall, "launch_ms_median": statistics.median(times) * 1e3,
                            "launch_ms_thirds": [statistics.mean(t) * 1e3 if t else None for t in thirds],
                            "captures": captures}
    result["device"] = {"platform": "gpu" if cuda else device.type,
                        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                        "count": 1, "memory_peak_bytes": int(max(peak_setup, peak_window))}
    if args.trace:
        result["device"].update(busy_s=devtrace.busy_seconds(traced["device"]), window_s=traced["wall"])

    # The check, once the window has closed and the program's state is freed.
    del r, scene
    program.free()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    expected = reference_values(cell, arrays, env, launches, device, torch.float32)
    numbers = check.compare(values, expected)
    result["correct"] = check.judge(numbers, cell.limits)
    result["check_s"] = time.perf_counter() - t0
    result["check"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    found = forbidden_modules()
    if found:
        print(f"bench_h100: loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3, None
    for line in check.lines(numbers, cell.limits):
        print(line, file=sys.stderr)
    return 0, result


def main(argv=None) -> int:
    code, result = run(argv)
    if result is not None:
        keys = ["correct", "attempted", "failed", "metrics", "device", "breakdown", "slice", "window", "check_s",
                "check"]
        print(json.dumps({k: result[k] for k in keys if k in result}))
    return code


if __name__ == "__main__":
    sys.exit(main())
