"""Differentiable raycasting: gradients to the TSDF grid and the pose.

The reference has no gradients at all; this is the differentiable-render
layer this framework adds (BASELINE config 4: recover a camera pose by
descending a pixel loss through the TSDF).

Backward through the march loop without storing samples: the
implicit-function trick. The march (ops/raycast.py, non-differentiable
``while_loop``) finds t0 with f(t0) ~= 0 where
f(t) = trilinear_tsdf(o + t*d). One *differentiable* secant/Newton
correction

    t* = t0 - f(t0) / stop_grad(f'(t0))

has value ~= t0 but carries the exact implicit derivatives
dt*/dtheta = -(df/dtheta)/f' for theta in {tsdf grid, camera pose,
intrinsics}: autodiff through the correction yields the
implicit-function gradients, and the trilinear taps' adjoint is the
scatter-add into the grid (SURVEY.md §7 'hard parts' (b)).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..camera import Camera
from ..volume import TSDFVolume
from .raycast import REFERENCE_MAX_STEPS, march_image, ray_directions
from .trilinear import trilinear_sample


@partial(
    jax.jit,
    static_argnames=("width", "height", "mode", "max_steps"),
)
def raycast_diff(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Differentiable raycast.

    The forward march is the non-differentiable ``march_image`` (the
    per-tile kernel on a GPU); the gradients come entirely from the
    correction step.

    Returns:
      vertices: (H, W, 3) world-mm hit points (NaN on miss),
        differentiable w.r.t. vol.tsdf and camera pose/intrinsics.
      hit_mask: (H, W) bool (non-differentiable).
    """
    # Non-differentiable march for the hit parameter.
    frozen_vol = jax.lax.stop_gradient(vol)
    frozen_cam = jax.lax.stop_gradient(camera)
    verts0 = march_image(
        frozen_vol,
        frozen_cam.position,
        ray_directions(frozen_cam, width, height),
        mode=mode,
        max_steps=max_steps,
        step_scale=step_scale,
    ).reshape(-1, 3)
    hit_mask = jnp.isfinite(verts0).all(axis=-1)
    origin_f = frozen_cam.position
    t0 = jnp.where(
        hit_mask,
        jnp.linalg.norm(
            jnp.where(hit_mask[:, None], verts0, 0.0) - origin_f[None, :],
            axis=-1,
        ),
        0.0,
    )

    # Differentiable reconstruction around t0.
    origin = camera.position
    dirs = ray_directions(camera, width, height).reshape(-1, 3)
    space_min = vol.space_min

    def f(t):
        pts = origin[None, :] + t[:, None] * dirs - space_min[None, :]
        return trilinear_sample(vol.tsdf, pts, vol.voxel_size)

    # one evaluation yields both the primal and the directional
    # derivative along t (frozen: it is only a scale) — f is 8 gathers
    # over all rays, so a separate f(t0) would double the lookup cost
    f0, fp = jax.jvp(f, (t0,), (jnp.ones_like(t0),))
    fp = jax.lax.stop_gradient(fp)
    fp = jnp.where(jnp.abs(fp) < 1e-6, jnp.where(fp < 0, -1e-6, 1e-6), fp)

    t_star = t0 - f0 / fp
    verts = origin[None, :] + t_star[:, None] * dirs
    verts = jnp.where(hit_mask[:, None], verts, jnp.nan)
    return (
        verts.reshape(height, width, 3),
        hit_mask.reshape(height, width),
    )


def depth_image_diff(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    **kwargs,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Differentiable depth render: (H, W) camera-z in mm (0 on miss)."""
    verts, hit = raycast_diff(vol, camera, width, height, **kwargs)
    cam_pts = camera.world_to_camera(
        jnp.where(hit[..., None], verts, 0.0).reshape(-1, 3)
    ).reshape(height, width, 3)
    return jnp.where(hit, cam_pts[..., 2], 0.0), hit
