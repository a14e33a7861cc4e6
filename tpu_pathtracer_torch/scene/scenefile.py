"""Scene description files (TOML), as `tpu_pathtracer/scene/scenefile.py`:
the reference's hard-coded scene block as data.

    [scene]
    objects = ["suitcase.obj", "test.obj"]   # relative to this file
    scale = 0.05
    material_source = "convention"           # or "mtl"
    add_floor = true
    rng_seed = 0
    accel = "cluster"                        # cluster | none

    [environment]
    mode = "equirect"                        # equirect | sunsky | constant
    hdr = "env4.exr"                         # image file, or:
    procedural = { height = 256, width = 512, sun_intensity = 100.0 }
    constant = [0.4, 0.4, 0.6]
    importance_sampling = false

    [camera]
    eye = [0.0, 2.0, 6.0]
    lookat = [0.0, 0.5, 0.0]
    up = [0.0, 1.0, 0.0]
    fov_y = 50.0

    [render]                                 # any RenderConfig field
    width = 1600
    height = 1200
    samples_per_launch = 10
    max_depth = 20
    dof = false

`load_scene_file(path)` -> (scene, camera, cfg), the scene on the card
unless another device is named; the CLI takes `--scene-file
scenes/suitcase.toml`.  The files under `scenes/` are read as they are:
a `texture_lod` of "auto" or "off" is accepted and dropped (the port has
no mip ladder; `config.check_texture_lod`).
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Optional, Tuple

from tpu_pathtracer_torch.config import RenderConfig, check_texture_lod
from tpu_pathtracer_torch.render.camera import Camera
from tpu_pathtracer_torch.utils.device import DEFAULT_DEVICE, resolve


def _build_env(env_spec: dict, base_dir: str, device):
    """EnvironmentMap from the [environment] table (None = default)."""
    from tpu_pathtracer_torch.scene.scene import make_env

    if "hdr" in env_spec:
        from tpu_pathtracer_torch.utils.image import load_image

        env = make_env(load_image(os.path.join(base_dir, env_spec["hdr"])), device)
    elif "procedural" in env_spec:
        from tpu_pathtracer_torch.utils.image import procedural_hdr

        p = dict(env_spec["procedural"])
        env = make_env(procedural_hdr(p.pop("height", 256), p.pop("width", 512), **p), device)
    else:
        env = None

    if env is not None and env_spec.get("importance_sampling", False):
        from tpu_pathtracer_torch.render.envmap import with_importance_sampling

        env = with_importance_sampling(env)
    return env


def load_scene_file(
    path: str, overrides: Optional[dict] = None, device=DEFAULT_DEVICE, **load_kw
) -> Tuple[object, Camera, RenderConfig]:
    """Parse a scene TOML into (Scene, Camera, RenderConfig).

    `overrides` (field -> value) patches [render] after parsing: the CLI
    maps explicit flags there so that the file supplies defaults.
    `load_kw` goes to the cached loader (cache_dir, refresh, timings)."""
    device = resolve(device)
    with open(path, "rb") as f:
        spec = tomllib.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))

    scene_spec = spec.get("scene", {})
    env_spec = spec.get("environment", {})
    cam_spec = spec.get("camera", {})
    render_spec = dict(spec.get("render", {}))

    if "mode" in env_spec:
        render_spec.setdefault("env_mode", env_spec["mode"])
    if "importance_sampling" in env_spec:
        render_spec.setdefault("env_importance_sampling", env_spec["importance_sampling"])
    if "constant" in env_spec:
        render_spec.setdefault("env_constant", tuple(env_spec["constant"]))
    if overrides:
        render_spec.update(overrides)
    # NEE requires the textbook RR estimator: imply it here, where the
    # config is assembled, unless the file or an explicit override picked
    # an rr_mode (then validation raises its clear error).
    if render_spec.get("env_importance_sampling") and "rr_mode" not in render_spec:
        render_spec["rr_mode"] = "standard"
    if "texture_lod" in render_spec:
        check_texture_lod(render_spec.pop("texture_lod"))
    valid = {f.name for f in dataclasses.fields(RenderConfig)}
    unknown = set(render_spec) - valid
    if unknown:
        raise ValueError(f"{path}: unknown [render] fields: {sorted(unknown)}")
    cfg = RenderConfig(**render_spec)

    env = _build_env(env_spec, base_dir, device)
    # A CLI override (--nee) can turn NEE on where the file's
    # [environment] did not: the env still needs its alias table.
    if env is not None and cfg.env_importance_sampling and env.alias_table is None:
        from tpu_pathtracer_torch.render.envmap import with_importance_sampling

        env = with_importance_sampling(env)

    camera = Camera(
        eye=tuple(cam_spec.get("eye", (0.0, 2.0, 6.0))),
        lookat=tuple(cam_spec.get("lookat", (0.0, 0.0, 0.0))),
        up=tuple(cam_spec.get("up", (0.0, 1.0, 0.0))),
        fov_y=float(cam_spec.get("fov_y", 50.0)),
    )

    objects = scene_spec.get("objects", [])
    accel = scene_spec.get("accel", "cluster")
    accel = None if accel in ("none", "brute", "") else accel
    if objects:
        from tpu_pathtracer_torch.scene.cache import load_scene_cached

        scene = load_scene_cached(
            [os.path.join(base_dir, o) for o in objects],
            scale=float(scene_spec.get("scale", 1.0)),
            env=env,
            material_source=scene_spec.get("material_source", "convention"),
            add_floor=bool(scene_spec.get("add_floor", True)),
            floor_size=float(scene_spec.get("floor_size", 200.0)),
            skip_non_triangles=bool(scene_spec.get("skip_non_triangles", False)),
            rng_seed=scene_spec.get("rng_seed", 0),
            accel=accel,
            device=device,
            **load_kw,
        )
    else:
        # The reference's built-in spheres.
        from tpu_pathtracer_torch.scene.procedural import three_spheres_scene

        scene = three_spheres_scene(device=device)
        if env is not None:
            scene = scene.replace(env=env)
        if accel is not None:
            from tpu_pathtracer_torch.accel.build import build_accel

            scene = build_accel(scene, kind=accel)

    return scene, camera, cfg
