"""Depth-frame integration into the TSDF volume.

Re-design of ``integrate_kernel`` (ref: src/TSDF/TSDFVolume.cu:308-392,
host wrapper :860-902). The reference launches one CUDA thread per (y, z)
voxel column with a serial x loop; here the whole update is one fused
dense XLA computation over the (Z, Y, X) grid: project every voxel centre
into the depth image, gather the depth, form the projective TSDF and fold
it into the running weighted mean. Rigid voxel centres come from iotas
and the 3x3 transforms are written as elementwise FMAs, so nothing of
size (Z, Y, X, 3) is materialised: the depth lookup is a single gather
from a frame that stays in L2, everything else fuses into it, and the op
is bound by HBM traffic (read tsdf+weight, write tsdf+weight).

Math per voxel (identical to the reference):
  * deformed centre c (world, mm) -> pixel p = round(K @ (pose_inv @ c));
  * gate: p inside the image and depth(p) > 0
    (ref: TSDFVolume.cu:349-356);
  * projective sdf = depth(p) - cam_z(c)  — camera-z distance, not
    euclidean (ref: :359-363; pixel_to_camera's z equals the raw depth
    because K^-1's bottom row is (0,0,1));
  * discard if sdf < -trunc; clamp positive side to +trunc (ref: :365-372);
  * running mean: d' = (d*w + tsdf)/(w+1), w' = w+1 (ref: :374-384 — the
    max_weight clamp is commented out there; pass ``cap_weight=True`` to
    enable the intended clamp).

Differentiability: the op is differentiable w.r.t. the volume arrays and
the camera pose/intrinsics out of the box (round() has zero gradient, so
pose gradients flow through cam_z — the projective-SDF term — which is the
dominant, well-conditioned term).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..camera import Camera
from ..volume import TSDFVolume


def _centre_planes(vol: TSDFVolume):
    """World-space voxel centres as three broadcastable coordinate
    arrays: iota planes for a rigid volume (ref: centre_of_voxel_at
    TSDF_utilities.cu:10-17), the node translations for a deformed one
    (see TSDFVolume.deformed_centres)."""
    if vol.deform is not None:
        return vol.deform[..., 0], vol.deform[..., 1], vol.deform[..., 2]
    sz, sy, sx = vol.tsdf.shape
    vs, off = vol.voxel_size, vol.offset
    cx = (jnp.arange(sx, dtype=jnp.float32) + 0.5) * vs[0] + off[0]
    cy = (jnp.arange(sy, dtype=jnp.float32) + 0.5) * vs[1] + off[1]
    cz = (jnp.arange(sz, dtype=jnp.float32) + 0.5) * vs[2] + off[2]
    return cx[None, None, :], cy[None, :, None], cz[:, None, None]


def camera_coords(vol: TSDFVolume, pose_inv: jnp.ndarray):
    """(X, Y, Z) camera-space voxel centres, each (Z, Y, X): the rigid
    world->camera transform as elementwise FMAs (no perspective divide)."""
    wx, wy, wz = _centre_planes(vol)
    r, t = pose_inv[0:3, 0:3], pose_inv[0:3, 3]
    return tuple(
        r[i, 0] * wx + r[i, 1] * wy + r[i, 2] * wz + t[i] for i in range(3)
    )


def _project(vol: TSDFVolume, depth, k, pose_inv):
    """Per-voxel pixel lookup: (flat pixel index, update gate, sdf)."""
    h, w = depth.shape
    xc, yc, zc = camera_coords(vol, pose_inv)
    # camera -> pixel, rounded to ints (ref: world_to_pixel,
    # cuda_coordinate_transforms.cu:10-30).
    u = k[0, 0] * xc + k[0, 1] * yc + k[0, 2] * zc
    v = k[1, 0] * xc + k[1, 1] * yc + k[1, 2] * zc
    s = k[2, 0] * xc + k[2, 1] * yc + k[2, 2] * zc
    px = jnp.round(u / s).astype(jnp.int32)
    py = jnp.round(v / s).astype(jnp.int32)
    in_frustum = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    lin = jnp.clip(py, 0, h - 1) * w + jnp.clip(px, 0, w - 1)
    surface_depth = jnp.take(depth.astype(jnp.float32).ravel(), lin)
    sdf = surface_depth - zc
    # The cam-z > 0 gate is absent in the reference (world_to_pixel has
    # no z check): voxels BEHIND the camera can double-sign-flip into the
    # frame and receive spurious free-space updates whenever the camera
    # is inside the volume. Intended math includes the gate.
    update = (
        in_frustum & (zc > 0) & (surface_depth > 0)
        & (sdf >= -vol.truncation_distance)
    )
    return lin, update, sdf


def integrate(
    vol: TSDFVolume,
    depth: jnp.ndarray,
    camera: Camera,
    cap_weight: bool = False,
    rgb: jnp.ndarray | None = None,
) -> TSDFVolume:
    """Fuse one depth frame into the volume.

    Args:
      vol: the volume pytree.
      depth: (H, W) depth in mm; u16 or f32. Zero means no data.
      camera: Camera with pose = camera->world.
      cap_weight: clamp the accumulated weight at vol.max_weight (the
        reference's intended-but-disabled behaviour, TSDFVolume.cu:378).
      rgb: optional (H, W, 3) u8 colour frame. The reference allocates
        and serializes per-voxel colour but no kernel ever writes it
        (SURVEY.md §2.1); here the intended capability is real: voxels
        within the truncation band of the observed surface fold the
        pixel colour into the same running mean. Requires vol.color
        (see TSDFVolume.with_color()).

    Returns:
      Updated volume (same structure; tsdf/weight and optionally color
      change).
    """
    depth = jnp.asarray(depth)
    lin, update, sdf = _project(vol, depth, camera.k, camera.pose_inv)
    trunc = vol.truncation_distance

    # Positive-side truncation only (negative side already gated at -trunc,
    # ref: TSDFVolume.cu:365-372).
    tsdf_obs = jnp.minimum(sdf, trunc)

    # Compute in f32 regardless of the storage dtype (bf16 volumes store
    # half the HBM bytes; the update math must not run at 8-bit mantissa).
    prior_d = vol.tsdf.astype(jnp.float32)
    prior_w = vol.weight.astype(jnp.float32)
    new_w = prior_w + 1.0
    new_d = (prior_d * prior_w + tsdf_obs) / new_w
    if cap_weight:
        new_w = jnp.minimum(new_w, vol.max_weight)

    new_color = vol.color
    if rgb is not None:
        if vol.color is None:
            raise ValueError(
                "colour frame given but the volume has no colour field; "
                "use make_volume(with_color=True) / vol.with_color()"
            )
        rgb = jnp.asarray(rgb)
        if rgb.shape[:2] != depth.shape[:2]:
            raise ValueError(
                f"colour frame {rgb.shape[:2]} does not match depth "
                f"{depth.shape[:2]}; the flat pixel index would fuse "
                "wrong colours"
            )
        rgb_f = rgb.astype(jnp.float32).reshape(-1, 3)
        surf_rgb = jnp.take(rgb_f, lin, axis=0)  # (Z, Y, X, 3)
        # colour only within the truncation band (a free-space voxel
        # should not take the colour of the surface behind it). The TSDF
        # weight also counts band-less (free-space) observations, so a
        # weighted mean over it would starve late-appearing surfaces —
        # blend with a floored rate instead (converges within ~max_weight
        # colour observations regardless of prior free-space weight).
        col_update = (update & (jnp.abs(sdf) < trunc))[..., None]
        old = vol.color.astype(jnp.float32)
        rate = jnp.maximum(1.0 / new_w, 1.0 / vol.max_weight)[..., None]
        blended = old + rate * (surf_rgb - old)
        new_color = jnp.clip(
            jnp.round(jnp.where(col_update, blended, old)), 0, 255
        ).astype(jnp.uint8)

    return vol.replace(
        tsdf=jnp.where(update, new_d, prior_d).astype(vol.tsdf.dtype),
        weight=jnp.where(update, new_w, prior_w).astype(vol.weight.dtype),
        color=new_color,
    )
