"""Multi-chip sharding: device meshes, brick-sharded fusion, ray tiles.

The reference is single-process/single-GPU (SURVEY.md §0) — its only
parallelism is intra-kernel CUDA decompositions (§2.9). This package is the
distributed layer the reference lacks: a ``jax.sharding.Mesh`` with
named axes and ``shard_map``-ped ops whose collectives XLA lowers (to
NCCL on GPUs).

Mesh axes:
  * ``"b"`` (bricks) — the volume's z extent is sliced into slabs, one per
    mesh position. Integration is perfectly local (each slab projects into
    the replicated depth frame independently).
  * ``"r"`` (rays) — image rows are tiled over this axis for raycast and
    ICP residual evaluation; reductions ride ``psum``.
"""

from .mesh import make_mesh, volume_sharding, replicated
from .ops import (
    extract_surface_sharded,
    get_incremental_transformation_sharded,
    integrate_pose_sharded,
    integrate_sharded,
    merge_brick_soups,
    raycast_sharded,
    scenefusion_frame_sharded,
    shard_volume,
    track_and_fuse_frames_sharded,
    update_deformation_sharded,
)

__all__ = [
    "make_mesh",
    "volume_sharding",
    "replicated",
    "shard_volume",
    "integrate_pose_sharded",
    "integrate_sharded",
    "raycast_sharded",
    "get_incremental_transformation_sharded",
    "track_and_fuse_frames_sharded",
    "extract_surface_sharded",
    "merge_brick_soups",
    "update_deformation_sharded",
    "scenefusion_frame_sharded",
]
