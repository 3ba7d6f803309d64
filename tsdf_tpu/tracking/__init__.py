"""Pose tracking: projective point-to-plane ICP.

Re-design of the vendored ICP_CUDA odometry
(ref: third_party/ICP_CUDA/, SURVEY.md §2.10): the per-pixel residual
rows + warp-shuffle block reduction become one masked dense reduction
that jit fuses (and `psum` extends across a device mesh).
"""

from .icp import (
    ICPResult,
    depth_pyramid,
    vertex_map,
    normal_map,
    icp_step,
    get_incremental_transformation,
)

__all__ = [
    "ICPResult",
    "depth_pyramid",
    "vertex_map",
    "normal_map",
    "icp_step",
    "get_incremental_transformation",
]
