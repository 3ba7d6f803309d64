"""tsdf_tpu — a differentiable TSDF 3D-reconstruction framework in JAX.

Built from scratch with the capabilities of the CUDA reference
Scoobadood/TSDF (see SURVEY.md): TSDF depth integration, sphere-traced
raycasting, marching-cubes mesh extraction, bilateral depth filtering,
projective point-to-plane ICP tracking, non-rigid SceneFusion
deformation, TUM/.tsdf/PLY/PNG I/O — all as pure functions over pytrees,
differentiable and shardable over a device mesh of NVIDIA GPUs.
"""

import jax

# Geometry math (projection, pose chains, ICP normal equations) needs true
# f32: on NVIDIA GPUs XLA may run f32 matmuls in TF32, whose 10-bit
# mantissa costs pixels of projection error at 640x480. All matmuls here
# are tiny (Nx3 @ 3x3), so full precision is free.
jax.config.update("jax_default_matmul_precision", "highest")

from .camera import Camera
from .volume import TSDFVolume, make_volume
from .ops import (
    integrate,
    raycast,
    render_to_depth_image,
    trilinear_sample,
    scene_image,
    normals_image,
    compute_normals,
)

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "TSDFVolume",
    "make_volume",
    "integrate",
    "raycast",
    "render_to_depth_image",
    "trilinear_sample",
    "scene_image",
    "normals_image",
    "compute_normals",
]
