"""Trilinear TSDF sampling — the 8-tap stencil every raycast step uses.

Re-design of ``trilinearly_interpolate``
(ref: src/RayCaster/GPURaycaster.cu:53-124) and ``tsdf_value_at``
(ref: src/TSDF/TSDF_utilities.cu:29-37). The reference samples one point
per CUDA thread; here sampling is vectorized over arbitrary point batches
and lowers to 8 XLA gathers from the flattened volume — which is also the
exact stencil that defines the 1-voxel halo needed when the volume is
brick-sharded (see parallel/sharded.py).

Border semantics are replicated exactly (they define boundary
interpolation and must match for allclose parity):
  * points past the far face are pulled back by voxel_size/10
    (ref: GPURaycaster.cu:60-71);
  * negative coords clamp to 0;
  * the lower cell index clamps to 0 (ref: :95-97) while u,v,w are computed
    against the *clamped* lower centre, so border samples linearly
    extrapolate exactly as the reference does;
  * out-of-range taps clamp to the border voxel (ref: TSDF_utilities.cu:29-37).
"""

from __future__ import annotations

import jax.numpy as jnp

from .scatter import take_flat


def trilinear_sample(values: jnp.ndarray, points, voxel_size) -> jnp.ndarray:
    """Sample ``values`` at grid-local points.

    Args:
      values: (Z, Y, X) f32 volume (z, y, x indexing, x fastest).
      points: (..., 3) f32 points in grid-local mm coords, i.e.
        world - space_min, components ordered (x, y, z).
      voxel_size: (3,) f32 mm.

    Returns:
      (...,) f32 interpolated values.
    """
    sz, sy, sx = values.shape
    size = jnp.array([sx, sy, sz], dtype=jnp.float32)
    voxel_size = jnp.asarray(voxel_size, dtype=jnp.float32)
    p = jnp.asarray(points, dtype=jnp.float32)

    max_values = size * voxel_size
    p = jnp.where(p >= max_values, max_values - voxel_size / 10.0, p)
    p = jnp.where(p < 0.0, 0.0, p)

    # Lower cell: the voxel containing p, minus one on axes where p is below
    # that voxel's centre == floor(p/voxel - 0.5) (ref: GPURaycaster.cu:88-97).
    g = p / voxel_size - 0.5
    lower = jnp.floor(g).astype(jnp.int32)
    lower = jnp.maximum(lower, 0)

    # Fractions against the clamped lower centre (ref: :100-106).
    uvw = g - lower.astype(jnp.float32)
    u, v, w = uvw[..., 0], uvw[..., 1], uvw[..., 2]

    flat = values.ravel()
    size_i = jnp.array([sx, sy, sz], dtype=jnp.int32)

    def tap(dx, dy, dz):
        # Clamp each tap into the grid (ref: TSDF_utilities.cu:29-37).
        # take_flat: identical forward to jnp.take; its adjoint into the
        # grid is the sorted-window matmul scatter (ops/scatter.py).
        idx = jnp.minimum(
            lower + jnp.array([dx, dy, dz], dtype=jnp.int32), size_i - 1
        )
        lin = (idx[..., 2] * sy + idx[..., 1]) * sx + idx[..., 0]
        # cast AFTER the gather: bf16 volumes stream half the bytes and
        # the blend still runs f32
        return take_flat(flat, lin).astype(jnp.float32)

    c000 = tap(0, 0, 0)
    c001 = tap(0, 0, 1)
    c010 = tap(0, 1, 0)
    c011 = tap(0, 1, 1)
    c100 = tap(1, 0, 0)
    c101 = tap(1, 0, 1)
    c110 = tap(1, 1, 0)
    c111 = tap(1, 1, 1)

    return (
        c000 * (1 - u) * (1 - v) * (1 - w)
        + c001 * (1 - u) * (1 - v) * w
        + c010 * (1 - u) * v * (1 - w)
        + c011 * (1 - u) * v * w
        + c100 * u * (1 - v) * (1 - w)
        + c101 * u * (1 - v) * w
        + c110 * u * v * (1 - w)
        + c111 * u * v * w
    )


def trilinear_weights_and_indices(values_shape, points, voxel_size):
    """Return the 8 tap linear indices and weights for each point.

    Used by the raycast backward pass to scatter dL/dtsdf into the grid
    (the adjoint of the gather stencil above) and by the deformation-field
    interpolation (ref: get_trilinear_elements TSDFVolume.cu:101-181).

    Returns:
      lin: (..., 8) int32 flat indices into values.ravel().
      wts: (..., 8) f32 interpolation weights (sum to 1).
    """
    sz, sy, sx = values_shape
    size = jnp.array([sx, sy, sz], dtype=jnp.float32)
    voxel_size = jnp.asarray(voxel_size, dtype=jnp.float32)
    p = jnp.asarray(points, dtype=jnp.float32)

    max_values = size * voxel_size
    p = jnp.where(p >= max_values, max_values - voxel_size / 10.0, p)
    p = jnp.where(p < 0.0, 0.0, p)

    g = p / voxel_size - 0.5
    lower = jnp.maximum(jnp.floor(g).astype(jnp.int32), 0)
    uvw = g - lower.astype(jnp.float32)
    u, v, w = uvw[..., 0], uvw[..., 1], uvw[..., 2]

    size_i = jnp.array([sx, sy, sz], dtype=jnp.int32)
    lins = []
    wts = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = jnp.minimum(
                    lower + jnp.array([dx, dy, dz], jnp.int32), size_i - 1
                )
                lin = (idx[..., 2] * sy + idx[..., 1]) * sx + idx[..., 0]
                wt = (
                    (u if dx else 1 - u)
                    * (v if dy else 1 - v)
                    * (w if dz else 1 - w)
                )
                lins.append(lin)
                wts.append(wt)
    return jnp.stack(lins, axis=-1), jnp.stack(wts, axis=-1)
