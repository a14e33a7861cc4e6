"""A rank of the port's sharding tests: `tests/test_torch_shard.py` starts
`world` of these as separate processes, joined into one gloo group over a
localhost port, each on the CPU (or on `--device cuda`, all ranks on one
card).

    python tests/_torch_dist_worker.py <port> <rank> <world> <out.npz> [--device cuda]

`start_group` starts the ranks of one group, `wait_group` waits for them.
Every rank renders each case of CASES with `render_frame_sharded`, and
checks that indivisible sizes raise ValueError before any collective.
Rank 0 also renders each case unsharded (`render_frame`) and writes both
images into <out.npz> as `<case>` and `<case>_single`.  It imports neither
JAX nor PIL.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

BASE = dict(width=32, height=16, samples_per_launch=8, max_depth=3, dof=False, env_mode="constant",
            intersector="brute")
NEE = dict(env_mode="equirect", env_importance_sampling=True, rr_mode="standard")
# case: (mode, config overrides)
CASES = {
    "pixels": ("pixels", {}),
    "pixels_stream": ("pixels", dict(stream_lanes=48)),
    "pixels_nee": ("pixels", NEE),
    "samples": ("samples", {}),
    "samples_nee": ("samples", NEE),
}


def start_group(world: int, out, device: str = "cpu") -> list:
    """Start the `world` ranks of a group on a free localhost port; rank 0
    writes `out`.  Returns the processes."""
    from tpu_pathtracer_torch.parallel.shard import free_port

    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH", "")) if p)
    port = free_port()
    return [subprocess.Popen([sys.executable, __file__, str(port), str(rank), str(world), str(out),
                              "--device", device],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for rank in range(world)]


def wait_group(procs: list, timeout: float = 600) -> None:
    """Wait for the ranks of `start_group` (killing any still running
    after `timeout` seconds); raise unless every one of them finished."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or f"SHARD_OK rank {rank} of {len(procs)}" not in log:
            raise RuntimeError(f"rank {rank} of {len(procs)} exited {p.returncode}:\n{log}")


def scene_for(overrides, device):
    """The JAX package's sharding tests' sphere, with a sky for NEE."""
    from tpu_pathtracer_torch.render.envmap import with_importance_sampling
    from tpu_pathtracer_torch.scene.procedural import single_sphere_scene
    from tpu_pathtracer_torch.scene.scene import make_env
    from tpu_pathtracer_torch.utils.image import procedural_hdr

    scene = single_sphere_scene(stacks=6, slices=12, device=device)
    if overrides.get("env_importance_sampling"):
        scene = scene.replace(env=with_importance_sampling(make_env(procedural_hdr(16, 32), device)))
    return scene


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("port", type=int)
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("out")
    p.add_argument("--device", default="cpu")
    a = p.parse_args()

    import torch.distributed as dist

    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.parallel.shard import initialize_distributed, make_mesh, render_frame_sharded
    from tpu_pathtracer_torch.render.camera import Camera, camera_arrays
    from tpu_pathtracer_torch.render.integrator import render_frame

    dev = initialize_distributed(a.device, backend="gloo", init_method=f"tcp://localhost:{a.port}",
                                 world_size=a.world, rank=a.rank)
    try:
        mesh = make_mesh()
        assert mesh.size == a.world and mesh.rank == a.rank
        out = {}
        for case, (mode, overrides) in CASES.items():
            cfg = RenderConfig(**{**BASE, **overrides})
            scene = scene_for(overrides, dev)
            cam = camera_arrays(Camera(), cfg, dev)
            out[case] = render_frame_sharded(scene, cam, cfg, 1, mesh, mode=mode).cpu().numpy()
            if a.rank == 0:
                out[f"{case}_single"] = render_frame(scene, cam, cfg, 1).cpu().numpy()
        # Indivisible sizes raise on every rank before any collective.
        cam = camera_arrays(Camera(), RenderConfig(**BASE), dev)
        for mode, overrides in (("pixels", dict(width=31, height=15)), ("samples", dict(samples_per_launch=3))):
            try:
                render_frame_sharded(scene_for({}, dev), cam, RenderConfig(**{**BASE, **overrides}), 1, mesh,
                                     mode=mode)
            except ValueError as e:
                out[f"refused_{mode}"] = np.array(str(e))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if a.rank == 0:
        np.savez(a.out, **out)
    print(f"SHARD_OK rank {a.rank} of {a.world}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
