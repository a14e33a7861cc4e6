"""tpu_pathtracer_torch: the path tracer ported to PyTorch and CUDA.

A second package beside the JAX one (`tpu_pathtracer`, the reference).
It mirrors that package's layout (config, utils, assets, scene, accel,
ops, render, runtime, cli, viewer) and imports PyTorch and numpy only.  Plain tensor code is PyTorch;
the packet-traversal kernel is CUDA C++ for Hopper (`csrc/`), built with
`nvcc` at first use and launched for CUDA tensors, with a plain PyTorch
version of it for CPU tensors.
"""

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.render.camera import Camera
from tpu_pathtracer_torch.scene.scene import EnvironmentMap, MaterialTable, Scene

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "Scene",
    "MaterialTable",
    "EnvironmentMap",
    "__version__",
]
