"""The system under test, driven as a user drives it: the port
(`tpu_pathtracer_torch`) builds its scene, accel and alias table from the
benchmark's arrays, and the window calls `ProgressiveRenderer.step()`, in
an orbit after `set_camera()`.  Everything the benchmark takes from the
program goes through here: its entry, its counters and, in a traced run,
host spans around its calls."""

from __future__ import annotations

import contextlib
import functools
import time


def build(arrays, env, render: dict, accel: str, device):
    """(scene, RenderConfig) of the program: its scene from the arrays,
    the environment with its alias table where NEE draws from it, and the
    accel."""
    from tpu_pathtracer_torch.accel.build import build_accel
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.scene.scene import make_env, make_material_table, make_scene

    cfg = RenderConfig(**render)
    penv = make_env(env, device)
    if cfg.env_importance_sampling:
        penv = with_importance_sampling(penv)
    materials = make_material_table(arrays.materials, arrays.texture_quads, device=device)
    scene = make_scene(arrays.vertices, arrays.normals, arrays.uvs, arrays.mat_ids, materials, env=penv,
                       device=device)
    if accel:
        scene = build_accel(scene, kind=accel)
    return scene, cfg


def camera(spec: dict, eye):
    from tpu_pathtracer_torch.render.camera import Camera

    return Camera(eye=tuple(eye), lookat=tuple(spec["lookat"]), up=tuple(spec["up"]), fov_y=float(spec["fov_y"]))


def renderer(scene, cam, cfg):
    from tpu_pathtracer_torch.runtime.progressive import ProgressiveRenderer

    return ProgressiveRenderer(scene, cam, cfg)


def captures() -> int:
    from tpu_pathtracer_torch.render import graph_loop

    return graph_loop.stats["captures"]


def traversal_launches() -> int:
    """Launches of the traversal kernels so far, by the wrappers' counters
    (a graph replay adds its captured launches)."""
    from tpu_pathtracer_torch.ops import intersect as br
    from tpu_pathtracer_torch.ops import intersect_cluster as ic

    return sum(f.launches for f in (ic.intersect_clusters, ic.intersect_clusters_hier,
                                    ic.intersect_clusters_streamed, ic.occluded_clusters,
                                    ic.occluded_clusters_hier, ic.occluded_clusters_streamed,
                                    br.intersect_brute, br.occluded_brute))


def frame_stats(scene, cam, cfg, subframe: int) -> dict:
    """The schedule's own counts of one launch, rendered again: they are
    deterministic, so they are those of the launch the window made."""
    from tpu_pathtracer_torch.render.camera import camera_arrays
    from tpu_pathtracer_torch.render.integrator import render_frame_stats

    _, st = render_frame_stats(scene, camera_arrays(cam, cfg, scene.device), cfg, subframe)
    return dict(iters=int(st["iters"]), segments=int(st["segments"]), shadow_segments=int(st["shadow_segments"]),
                schedule=st["schedule"], graphed=bool(st["graphed"]))


def free() -> None:
    """Drop the program's cached loop plans, their graphs and pools."""
    from tpu_pathtracer_torch.render import graph_loop

    graph_loop.clear()


class Spans:
    """Host spans around the calls that `step()` makes (the launch's render,
    the accumulation, the wait for the card) and around `set_camera`, as
    (name, start, end) in time.perf_counter_ns(), for the traced slice."""

    def __init__(self):
        self.spans = []

    def span(self, name: str):
        return _Span(self.spans, name)

    @contextlib.contextmanager
    def around_step(self):
        from tpu_pathtracer_torch.runtime import progressive

        names = {"render_frame": "render_frame", "accumulate_weighted": "accumulate", "_wait": "sync"}
        saved = {attr: getattr(progressive, attr) for attr in names}
        for attr, label in names.items():
            setattr(progressive, attr, self._wrap(label, saved[attr]))
        try:
            yield
        finally:
            for attr, fn in saved.items():
                setattr(progressive, attr, fn)

    def _wrap(self, name: str, fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return wrapped


class _Span:
    def __init__(self, out: list, name: str):
        self.out, self.name = out, name

    def __enter__(self):
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.out.append((self.name, self.start, time.perf_counter_ns()))
