"""Render configuration for the PyTorch port.

The same frozen dataclass as `RenderConfig` of `tpu_pathtracer/config.py`, with the
same field names, defaults and validation for every field the port reads.
Fields that only steer TPU machinery (scoped-VMEM budgets, the Pallas
switch and packet size, the retire FIFO's scatter batching) and options
that were measured and refuted on the TPU (tiled pixel order, multi-queue
NEE, entry sort) are not carried; nor are the options of paths not ported
yet (texture LOD).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for one render (hashable)."""

    # ---- image / launch geometry -------------------------------------
    width: int = 1600
    height: int = 1200
    samples_per_launch: int = 10
    max_depth: int = 20

    # ---- ray parameters ----------------------------------------------
    t_min: float = 0.01
    t_max: float = 1e16

    # ---- camera / depth of field -------------------------------------
    dof: bool = True
    dof_blurriness: float = 0.01
    focus_distance: float = 1.0

    # ---- BSDF constants ------------------------------------------------
    ior: float = 1.5
    normal_map_strength: float = 0.4
    roughness_min: float = 0.015
    roughness_max: float = 0.999
    flip_v: bool = True
    glass_roughness_perturb: float = 0.8

    # ---- film / post chain ---------------------------------------------
    exposure: float = -0.5
    gamma: float = 2.2
    contrast: float = 1.25
    srgb_output: bool = True

    # ---- wavefront scheduling --------------------------------------------
    # Path regeneration: one lane consumes a pixel's samples in turn.
    regenerate: bool = True
    # Lane-pool size of the streaming work-queue renderer; 0 = auto (the
    # nearest power of two to n_pix/16, clamped to [16384, 131072]).
    stream_lanes: int = 0
    # Fused schedule step: the stream's post-trace tail (Russian roulette,
    # retire, prefix-sum work queue, state merges) as one kernel launch
    # per iteration.  "auto" = the measured rule of
    # render/integrator.py:_fused_stream_ok; "on" forces it inside its
    # envelope (no NEE, identity pixel mapping); "off" disables it.
    fused_schedule: str = "auto"    # "auto" | "on" | "off"

    # ---- estimator behaviour -------------------------------------------
    # "reference": the reference's estimator (whole-path radiance divided
    # by the last survival probability); "standard": textbook RR.
    rr_mode: str = "reference"
    seed_advance_quirk: bool = False

    # ---- environment lighting ------------------------------------------
    env_mode: str = "equirect"      # "equirect" | "sunsky" | "constant"
    env_constant: Tuple[float, float, float] = (0.4, 0.4, 0.6)
    # Next-event estimation against the environment: one alias-table light
    # draw and one shadow ray per surface hit (needs rr_mode="standard").
    env_importance_sampling: bool = False
    # Draw the NEE light direction from 0.5*alias + 0.5*cosine and divide
    # by the mixture density (balance heuristic).
    nee_defensive_mix: bool = False
    # One-sample balance-heuristic MIS between the GGX lobe and the NEE
    # light draw: env credit on spec-sampled misses is weighted
    # p_ggx/(p_ggx + p_light), and the light-sampled spec term rides the
    # same shadow ray.
    nee_mis_spec: bool = False

    # ---- intersection ----------------------------------------------------
    # Pixels per tile: a frame renders as tiles of this many pixels, one
    # after another; 0 = the whole frame at once.  Must divide width*height.
    tile_pixels: int = 0
    # Triangle-block size for the brute-force intersector.
    intersect_block: int = 256
    # "auto" = the cluster accel when the scene has one, else brute force.
    intersector: str = "auto"
    # Ray sort before the packet kernel: "auto" = spatial for every scene
    # with more than one cluster.
    sort_rays: str = "auto"         # "auto" | "off" | "octant" | "spatial"
    # Triangle test inside the packet kernel; "auto" = Baldwin-Weber.
    tri_test: str = "auto"          # "auto" | "mt" | "bw"
    # Morton bits per axis of the spatial sort key; 0 = auto (7 below 256
    # clusters, else 5).
    sort_spatial_bits: int = 0
    # Direction-magnitude bits per axis under the octant bits; 0 = auto
    # (2 below 256 clusters, else 3), -1 = off.
    sort_dir_bits: int = 0
    # Cluster count at or above which scenes route to the two-level kernel.
    hier_min_clusters: int = 96
    # Deferred (hit-compacted) shading: shade only the lanes that hit, in
    # dense chunks of lanes / deferred_chunk_div (rounded up to 1024).  The
    # image equals the dense shade's; it costs a second stream sync an
    # iteration (the count of hit lanes), so it is opt-in.
    deferred_shade: bool = False
    deferred_chunk_div: int = 4

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if self.rr_mode not in ("reference", "standard"):
            raise ValueError(f"invalid rr_mode: {self.rr_mode!r}")
        if self.env_importance_sampling and self.rr_mode == "reference":
            raise ValueError(
                "env_importance_sampling (NEE) requires rr_mode='standard': "
                "the reference RR estimator's terminal /p division would "
                "bias mid-path NEE contributions"
            )
        if self.nee_defensive_mix and not self.env_importance_sampling:
            raise ValueError(
                "nee_defensive_mix is a mode of the NEE light sample: "
                "it requires env_importance_sampling=True"
            )
        if self.nee_mis_spec and not self.env_importance_sampling:
            raise ValueError(
                "nee_mis_spec combines the spec lobe with the NEE light "
                "sample: it requires env_importance_sampling=True"
            )
        if self.env_mode not in ("equirect", "sunsky", "constant"):
            raise ValueError(f"invalid env_mode: {self.env_mode!r}")
        if self.intersector not in ("auto", "brute", "cluster"):
            raise ValueError(f"invalid intersector: {self.intersector!r}")
        if self.fused_schedule not in ("auto", "on", "off"):
            raise ValueError(
                f"invalid fused_schedule: {self.fused_schedule!r}"
            )
        if self.sort_rays not in ("auto", "off", "octant", "spatial"):
            raise ValueError(f"invalid sort_rays: {self.sort_rays!r}")
        if self.tri_test not in ("auto", "mt", "bw"):
            raise ValueError(f"invalid tri_test: {self.tri_test!r}")
        if not (0 <= self.sort_spatial_bits <= 9):
            # 3*bits + 3 octant bits must fit a 32-bit sort key.
            raise ValueError(
                f"sort_spatial_bits must be 0 (auto) to 9: {self.sort_spatial_bits}"
            )
        if not (-1 <= self.sort_dir_bits <= 4):
            raise ValueError(
                f"sort_dir_bits must be -1 (off), 0 (auto) or 1..4: "
                f"{self.sort_dir_bits}"
            )
        if self.hier_min_clusters < 2:
            raise ValueError(
                f"hier_min_clusters must be >= 2: {self.hier_min_clusters}"
            )
        if self.deferred_chunk_div < 1:
            raise ValueError(
                f"deferred_chunk_div must be >= 1: {self.deferred_chunk_div}"
            )
        if self.stream_lanes < 0:
            raise ValueError(
                f"stream_lanes must be >= 0 (0 = auto): {self.stream_lanes}"
            )


def check_texture_lod(value: str) -> None:
    """The JAX config's `texture_lod`, which the port carries no field
    for: "auto" and "off" both sample the full-resolution pool (the JAX
    package's "auto" resolves to "off"), which is all the port does.
    "mip" and "split" need the mip ladder, measured and refuted on the
    TPU and not ported (ROADMAP, do not port): refused."""
    if value in ("mip", "split"):
        raise ValueError(f"texture_lod={value!r} needs the texture mip ladder, which is not ported "
                         "(refuted on the TPU; ROADMAP, do not port): use 'auto' or 'off'")
    if value not in ("auto", "off"):
        raise ValueError(f"invalid texture_lod: {value!r}")
