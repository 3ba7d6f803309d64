"""The TSDF volume as a JAX pytree of dense arrays.

Re-design of the reference ``TSDFVolume`` class state
(ref: src/include/TSDFVolume.hpp:21-304, src/TSDF/TSDFVolume.cu:678-845).
Where the reference holds five raw CUDA device pointers and mutates them
in-place, here the volume is an immutable pytree of ``jnp`` arrays that
flows through jit/grad/shard_map; "mutation" returns a new pytree (XLA
donates buffers so this is in-place at runtime).

Array layout: all dense arrays are indexed ``[z, y, x]`` with x fastest,
so ``arr.ravel()`` order equals the reference's linear voxel index
``x + y*size_x + z*size_x*size_y`` (ref: TSDFVolume.hpp:165-167,
TSDFVolume.cu:32-35) and serialized bytes compare 1:1.

Units: millimetres (distances, physical size, offset, truncation).

The per-voxel deformation field (ref: TSDFVolume.hpp:23-26 DeformationNode
{float3 translation; float3 rotation}) is optional here: ``deform=None``
means the identity warp (every node sits at its undeformed voxel centre),
which the rigid kinfu path uses without paying 6x volume memory. The
SceneFusion path materializes it via :func:`with_identity_deformation`.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from .struct import pytree_dataclass

# ref: TSDFVolume.cu:717 — set on the volume but the integrate-kernel clamp
# is commented out (TSDFVolume.cu:378). We keep it as state for file-format
# parity; config decides whether the clamp is applied (see ops/integrate.py).
DEFAULT_MAX_WEIGHT = 15.0


@pytree_dataclass
class TSDFVolume:
    """Truncated signed distance volume + integration weights.

    Attributes:
      tsdf:    (Z, Y, X) f32 — truncated signed distance, mm.
      weight:  (Z, Y, X) f32 — accumulated integration weight.
      color:   (Z, Y, X, 3) u8 or None — per-voxel RGB. The reference
               allocates and serializes this but no kernel ever writes it
               (ref: SURVEY.md §2.1); kept optional for format parity.
      deform:  (Z, Y, X, 3) f32 or None — deformation node translations,
               i.e. the *deformed world-space centre* of each voxel
               (ref: initialise_deformation TSDFVolume.cu:768-794).
      deform_rot: (Z, Y, X, 3) f32 or None — per-node Euler rotation;
               allocated by the reference but never used by any live kernel.
      physical_size: (3,) f32 — (px, py, pz) mm extent of the grid.
      offset:  (3,) f32 — world coordinate of the grid origin corner
               (ref: TSDFVolume.hpp:144-148).
      truncation_distance: () f32 — 1.1 * ||voxel_size|| by default
               (ref: TSDFVolume.cu:693).
      max_weight: () f32.
      global_rotation / global_translation: (3,) f32 — whole-field Euler
               rotation / translation (ref: TSDFVolume.hpp:299-303), used
               by deform_mesh and tsdf_icp.
    """

    tsdf: jnp.ndarray
    weight: jnp.ndarray
    color: Optional[jnp.ndarray]
    deform: Optional[jnp.ndarray]
    deform_rot: Optional[jnp.ndarray]
    physical_size: jnp.ndarray
    offset: jnp.ndarray
    truncation_distance: jnp.ndarray
    max_weight: jnp.ndarray
    global_rotation: jnp.ndarray
    global_translation: jnp.ndarray

    # -- static geometry ---------------------------------------------------

    @property
    def size(self) -> tuple[int, int, int]:
        """(size_x, size_y, size_z) in voxels."""
        z, y, x = self.tsdf.shape
        return (x, y, z)

    @property
    def voxel_size(self) -> jnp.ndarray:
        """(3,) mm per voxel: physical_size / size (ref: TSDFVolume.cu:690)."""
        return self.physical_size / jnp.array(self.size, dtype=jnp.float32)

    @property
    def space_min(self) -> jnp.ndarray:
        """World coords of the minimal corner (== offset)."""
        return self.offset

    @property
    def space_max(self) -> jnp.ndarray:
        return self.offset + self.physical_size

    def voxel_centres(self) -> jnp.ndarray:
        """(Z, Y, X, 3) world-space voxel centres.

        centre = (idx + 0.5) * voxel_size + offset
        (ref: centre_of_voxel_at src/TSDF/TSDF_utilities.cu:10-17).
        XLA fuses the iotas into consumers, so this is free inside jit.
        """
        sz, sy, sx = self.tsdf.shape
        zs = jnp.arange(sz, dtype=jnp.float32)
        ys = jnp.arange(sy, dtype=jnp.float32)
        xs = jnp.arange(sx, dtype=jnp.float32)
        vs = self.voxel_size
        cz = (zs + 0.5) * vs[2] + self.offset[2]
        cy = (ys + 0.5) * vs[1] + self.offset[1]
        cx = (xs + 0.5) * vs[0] + self.offset[0]
        return jnp.stack(
            jnp.broadcast_arrays(
                cx[None, None, :], cy[None, :, None], cz[:, None, None]
            ),
            axis=-1,
        )

    def deformed_centres(self) -> jnp.ndarray:
        """(Z, Y, X, 3) deformed voxel centres (identity if deform is None).

        The reference integrate kernel computes the deformed centre as
        ``offset + node.translation`` (ref: TSDFVolume.cu:343) even though
        ``initialise_deformation`` already bakes the offset into the
        translation (ref: TSDFVolume.cu:785-787) — a double-offset bug that
        only cancels when offset == 0. We implement the *intended* math:
        the node translation IS the deformed world-space centre.
        """
        if self.deform is None:
            return self.voxel_centres()
        return self.deform

    # -- mutation-as-replacement ------------------------------------------

    def clear(self) -> "TSDFVolume":
        """weights -> 0, distances -> +truncation_distance, colours -> 0,
        deformation -> identity (ref: TSDFVolume::clear TSDFVolume.cu:811-845;
        the reference's colour clear is a swapped-args cudaMemset bug at
        :835 — we do the intended zero fill)."""
        return self.replace(
            tsdf=jnp.full_like(self.tsdf, self.truncation_distance),
            weight=jnp.zeros_like(self.weight),
            color=None if self.color is None else jnp.zeros_like(self.color),
            deform=None if self.deform is None else self.voxel_centres(),
            deform_rot=(
                None
                if self.deform_rot is None
                else jnp.zeros_like(self.deform_rot)
            ),
        )

    def with_identity_deformation(self) -> "TSDFVolume":
        """Materialize the deformation field at the identity warp."""
        return self.replace(
            deform=self.voxel_centres(),
            deform_rot=jnp.zeros(self.tsdf.shape + (3,), jnp.float32),
        )

    def with_color(self) -> "TSDFVolume":
        return self.replace(
            color=jnp.zeros(self.tsdf.shape + (3,), jnp.uint8)
        )

    @classmethod
    def for_geometry(
        cls, tsdf, physical_size, offset, truncation_distance
    ) -> "TSDFVolume":
        """A render-only carrier: just the distance field + grid
        geometry (weight/color/deform absent). march_rays and the
        sharded raycasts read nothing else — callers that only have a
        tsdf array use this instead of fabricating fake weights."""
        return cls(
            tsdf=tsdf,
            weight=None,
            color=None,
            deform=None,
            deform_rot=None,
            physical_size=jnp.asarray(physical_size, jnp.float32),
            offset=jnp.asarray(offset, jnp.float32),
            truncation_distance=jnp.asarray(
                truncation_distance, jnp.float32
            ),
            max_weight=jnp.asarray(DEFAULT_MAX_WEIGHT, jnp.float32),
            global_rotation=jnp.zeros(3, jnp.float32),
            global_translation=jnp.zeros(3, jnp.float32),
        )

    def astype(self, dtype) -> "TSDFVolume":
        """Recast the dense tsdf/weight storage (e.g. jnp.bfloat16 to
        halve the HBM stream of every integrate/raycast; all compute
        paths read-cast to f32). bf16 weights count integer frames
        exactly up to 256 — pair with ``cap_weight`` (the reference's
        max_weight is 15) for long sequences."""
        return self.replace(
            tsdf=self.tsdf.astype(dtype), weight=self.weight.astype(dtype)
        )


def make_volume(
    size: tuple[int, int, int],
    physical_size,
    offset=None,
    truncation_distance: float | None = None,
    max_weight: float = DEFAULT_MAX_WEIGHT,
    with_deformation: bool = False,
    with_color: bool = False,
    dtype=jnp.float32,
) -> TSDFVolume:
    """Create a cleared volume.

    Args:
      size: (size_x, size_y, size_z) voxels.
      physical_size: (3,) or scalar, mm.
      offset: world coords of grid origin; defaults to centring the volume
        on x/y and starting z at 0, matching the reference tools' usage
        (ref: kinfu.cpp:23-31, SceneFusion.cpp:49-50).
      truncation_distance: defaults to 1.1 * ||voxel_size||
        (ref: TSDFVolume.cu:693).
    """
    sx, sy, sz = size
    physical_size = jnp.broadcast_to(
        jnp.asarray(physical_size, dtype=jnp.float32), (3,)
    )
    if offset is None:
        offset = jnp.array(
            [
                -physical_size[0] / 2.0,
                -physical_size[1] / 2.0,
                0.0,
            ],
            dtype=jnp.float32,
        )
    offset = jnp.asarray(offset, dtype=jnp.float32)
    voxel_size = physical_size / jnp.array([sx, sy, sz], dtype=jnp.float32)
    if truncation_distance is None:
        truncation_distance = 1.1 * jnp.linalg.norm(voxel_size)
    trunc = jnp.asarray(truncation_distance, dtype=jnp.float32)

    vol = TSDFVolume(
        tsdf=jnp.full((sz, sy, sx), trunc, dtype=dtype),
        weight=jnp.zeros((sz, sy, sx), dtype=dtype),
        color=jnp.zeros((sz, sy, sx, 3), jnp.uint8) if with_color else None,
        deform=None,
        deform_rot=None,
        physical_size=physical_size,
        offset=offset,
        truncation_distance=trunc,
        max_weight=jnp.asarray(max_weight, dtype=jnp.float32),
        global_rotation=jnp.zeros(3, jnp.float32),
        global_translation=jnp.zeros(3, jnp.float32),
    )
    if with_deformation:
        vol = vol.with_identity_deformation()
    return vol


def voxel_for_point(points, voxel_size) -> jnp.ndarray:
    """(..., 3) grid-local point (mm) -> (..., 3) int32 voxel index.

    ref: voxel_for_point src/TSDF/TSDF_utilities.cu:44-53.
    """
    points = jnp.asarray(points, dtype=jnp.float32)
    return jnp.floor(points / voxel_size).astype(jnp.int32)
