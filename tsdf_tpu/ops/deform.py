"""Deformation-field warping of points (the SceneFusion mesh warp).

Re-design of ``TSDFVolume::deform_mesh`` / ``deformation_kernel``
(ref: src/TSDF/TSDFVolume.cu:215-283): for each point, trilinearly blend
the 8 surrounding deformation nodes' translations (``get_trilinear_elements``,
ref: TSDFVolume.cu:101-181), then apply the volume's global Euler rotation
and translation (ref: :249-253, rotation matrix :189-203).

Divergences from the reference, by intent:
  * the reference never sets ``is_valid`` and callers ignore it
    (SURVEY.md §2.1); here out-of-volume points are returned unwarped and
    a mask reports validity;
  * the reference indexes one voxel past the far face for boundary points
    (``lower + 1`` unclamped, an OOB read); here taps clamp to the grid.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.se3 import euler_to_matrix
from ..volume import TSDFVolume
from .trilinear import trilinear_weights_and_indices


def deform_points(vol: TSDFVolume, points) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Warp world-space points through the volume's deformation field.

    Args:
      vol: volume with a materialized ``deform`` field.
      points: (..., 3) world-space points, mm.

    Returns:
      (warped (..., 3), valid (...,) bool). Invalid (out-of-volume)
      points are passed through unchanged.
    """
    if vol.deform is None:
        raise ValueError("volume has no deformation field")
    points = jnp.asarray(points, jnp.float32)
    local = points - vol.offset

    size = jnp.array(vol.size, jnp.float32)
    max_values = size * vol.voxel_size
    valid = jnp.all((local >= 0.0) & (local <= max_values), axis=-1)

    lin, wts = trilinear_weights_and_indices(
        vol.tsdf.shape, local, vol.voxel_size
    )
    deform_flat = vol.deform.reshape(-1, 3)
    taps = jnp.take(deform_flat, lin, axis=0)  # (..., 8, 3)
    warped = jnp.sum(taps * wts[..., None], axis=-2)

    rot = euler_to_matrix(vol.global_rotation)
    warped = warped @ rot.T + vol.global_translation

    return jnp.where(valid[..., None], warped, points), valid
