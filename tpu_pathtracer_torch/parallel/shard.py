"""Multi-device rendering on torch.distributed: pixel and sample sharding.

Counterpart of `tpu_pathtracer/parallel/shard.py`.  The JAX module is one
controller driving a mesh of devices through shard_map.  Here each device
is driven by a process of its own (SPMD, as `torchrun` starts them): every
rank calls the same function with the same arguments, renders its share
on its own device, and the ranks join their shares with collectives.

* **pixels** (`mode="pixels"`): rank r renders the affine pixel range
  (r * chunk, chunk) and `all_gather` joins the slices, so every rank
  holds the whole [H,W,3] frame.  It is bit-equal to `render_frame`,
  because seeds are keyed by global pixel and sample ids.
* **samples** (`mode="samples"`): every rank renders every pixel with its
  own slice of the global sample ids (sample_offset r * spp_local), and
  the frames are averaged: `all_reduce(SUM)`, then a float32 division by
  the rank count, as JAX's pmean does (gloo has no `ReduceOp.AVG`).  The
  samples are the same, their sums are grouped differently: close to
  `render_frame`, not bit-equal.

The scene is replicated on every rank.  NCCL carries the collectives
between CUDA devices, gloo between CPU processes; gloo also takes CUDA
tensors (several processes on one card).
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.render.integrator import render_pixels
from tpu_pathtracer_torch.utils.device import resolve


def free_port() -> int:
    """A free TCP port on localhost, for the address of a group whose
    ranks all run on this machine."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(device="cuda", backend: Optional[str] = None, **kw) -> torch.device:
    """Join this process to a torch.distributed group; returns the device
    its rank renders on.

    Under `torchrun` (WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT set)
    the group comes from the environment (env://); otherwise pass
    `init_method` ("tcp://localhost:<port>"), `world_size` and `rank`,
    which go to `torch.distributed.init_process_group` with the rest of
    `kw`.  A CUDA rank renders on cuda:{LOCAL_RANK % device_count} (its
    rank when LOCAL_RANK is unset) and talks NCCL; a CPU rank talks gloo.
    `backend` overrides the choice (gloo for ranks that share one card)."""
    dev = resolve(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", kw.get("rank", os.environ.get("RANK", 0))))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend or ("nccl" if dev.type == "cuda" else "gloo"), **kw)
    return dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D mesh of ranks: the process group its collectives run on (None:
    the default group), the axis name, the number of ranks and this
    process's rank in it (-1 outside it)."""

    group: Optional[dist.ProcessGroup]
    axis: str
    size: int
    rank: int

    @property
    def shape(self) -> dict:
        """{axis: size}, as a JAX mesh's `shape`."""
        return {self.axis: self.size}


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    """1-D mesh over the first n (default: all) ranks of the group this
    process joined.  A mesh over fewer ranks makes a subgroup, which every
    rank of the group must call for."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices from a group of {world}")
    group = None if n == world else dist.new_group(ranks=list(range(n)))
    return Mesh(group=group, axis=axis, size=n, rank=rank if rank < n else -1)


def render_frame_sharded(scene, cam: dict, cfg: RenderConfig, subframe, mesh: Mesh, mode: str = "pixels",
                         axis: str = "dp") -> torch.Tensor:
    """Render one launch across the mesh; returns the [H,W,3] radiance on
    every rank.  Every rank of the mesh calls it with the same arguments
    (its scene and camera on its own device)."""
    ndev = mesh.shape[axis]
    if mesh.rank < 0:
        raise ValueError("this rank is not in the mesh")
    n_pix = cfg.width * cfg.height

    if mode == "pixels":
        if n_pix % ndev != 0:
            raise ValueError(f"width*height ({n_pix}) must divide across {ndev} devices")
        chunk = n_pix // ndev
        part = render_pixels(scene, cam, cfg, (mesh.rank * chunk, chunk), subframe)
        parts = [torch.empty_like(part) for _ in range(ndev)]
        dist.all_gather(parts, part, group=mesh.group)
        return torch.cat(parts).reshape(cfg.height, cfg.width, 3)

    if mode == "samples":
        spp = cfg.samples_per_launch
        if spp % ndev != 0:
            raise ValueError(f"samples_per_launch ({spp}) must divide across {ndev} devices")
        spp_local = spp // ndev
        img = render_pixels(scene, cam, cfg, None, subframe, sample_offset=mesh.rank * spp_local, spp=spp_local)
        dist.all_reduce(img, op=dist.ReduceOp.SUM, group=mesh.group)
        # A float32 tensor divisor: a Python scalar would be a reciprocal
        # multiply on the card, another rounding.
        img = img / torch.full((), float(ndev), dtype=torch.float32, device=img.device)
        return img.reshape(cfg.height, cfg.width, 3)

    raise ValueError(f"unknown sharding mode: {mode!r}")
