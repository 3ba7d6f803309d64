"""Differentiable fusion: the pose gradient of the integrate operator.

The integrate op itself is differentiable through XLA (the lax path in
ops/integrate.py), but its depth lookup is a rounded nearest-pixel read:
``round()`` has zero gradient, so AD sees only the projective-SDF term
(-cam_z) and is blind to the image-space term — the depth gradient under
the moving projection — which carries most of the alignment signal for
pose optimization THROUGH fusion. This module defines the analytic
6-twist gradient with both terms (semantics reference, plain jnp), and
``integrate_pose``: the integrate under a ``custom_vjp`` whose backward
(``pose_adjoint``) emits the same gradient as a raw pose_inv matrix
cotangent, plus the exact volume cotangents.

Convention: ``pose_gradient_lax`` returns the LEFT-twist gradient at the
current pose (T' = se3_exp(delta) @ T at delta = 0; (omega, v) packing
of utils/se3.py) — it equals jax.grad through ``se3_exp(delta) @ pose``
at delta = 0. The production ``integrate_pose`` emits the raw pose_inv
MATRIX cotangent instead and lets AD chain through se3_exp / the 4x4
inverse, so its jax.grad is exact at ANY delta.

Adjoint math per voxel (x_w its world centre, x_c = T^-1 x_w):
  d x_c / d v_j     = -R_wc e_j
  d x_c / d omega_j = -R_wc (e_j x x_w)
  d px = fx (dXc Zc - Xc dZc) / Zc^2,   d py analog
  d sdf = [Gx(p) d px + Gy(p) d py]  -  dZc
            (image term; Gx/Gy central differences of the depth frame)
  d new_d / d sdf = update & (sdf < trunc) / (w + 1)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..camera import Camera
from ..volume import TSDFVolume
from .integrate import _centre_planes, _project, camera_coords, integrate


def depth_image_gradients(depth: jnp.ndarray):
    """(Gx, Gy) central differences of the depth frame in mm/px.

    Pixels adjacent to a no-data (zero) sample get zero gradient — depth
    discontinuities and silhouettes carry no usable image term.
    """
    d = jnp.asarray(depth, jnp.float32)
    valid = d > 0
    left = jnp.pad(d, ((0, 0), (1, 0)))[:, :-1]
    right = jnp.pad(d, ((0, 0), (0, 1)))[:, 1:]
    up = jnp.pad(d, ((1, 0), (0, 0)))[:-1, :]
    down = jnp.pad(d, ((0, 1), (0, 0)))[1:, :]
    vl = jnp.pad(valid, ((0, 0), (1, 0)))[:, :-1]
    vr = jnp.pad(valid, ((0, 0), (0, 1)))[:, 1:]
    vu = jnp.pad(valid, ((1, 0), (0, 0)))[:-1, :]
    vd = jnp.pad(valid, ((0, 1), (0, 0)))[1:, :]
    gx = jnp.where(valid & vl & vr, (right - left) * 0.5, 0.0)
    gy = jnp.where(valid & vu & vd, (down - up) * 0.5, 0.0)
    return gx, gy


def pose_gradient_lax(
    vol: TSDFVolume,
    depth: jnp.ndarray,
    camera: Camera,
    gbar_tsdf: jnp.ndarray,
    image_term: bool = True,
) -> jnp.ndarray:
    """Analytic d<gbar_tsdf, new_tsdf>/d delta at delta = 0 — (6,) twist
    (omega, v). The lax semantics reference for the Pallas backward."""
    depth = jnp.asarray(depth, jnp.float32)
    h, w_img = depth.shape
    depth_f = depth.ravel()
    gx_img, gy_img = depth_image_gradients(depth)

    centres = vol.deformed_centres()  # (Z, Y, X, 3)
    rwc = camera.pose_inv[0:3, 0:3]
    cam = centres @ rwc.T + camera.pose_inv[0:3, 3]
    k = camera.k
    fx, fy = k[0, 0], k[1, 1]
    img = cam @ k.T
    px = jnp.round(img[..., 0] / img[..., 2]).astype(jnp.int32)
    py = jnp.round(img[..., 1] / img[..., 2]).astype(jnp.int32)
    in_frustum = (px >= 0) & (px < w_img) & (py >= 0) & (py < h)
    lin = jnp.clip(py, 0, h - 1) * w_img + jnp.clip(px, 0, w_img - 1)
    d_obs = jnp.take(depth_f, lin, axis=0)
    gxv = jnp.take(gx_img.ravel(), lin, axis=0)
    gyv = jnp.take(gy_img.ravel(), lin, axis=0)

    zc = cam[..., 2]
    sdf = d_obs - zc
    trunc = vol.truncation_distance
    update = (
        in_frustum & (zc > 0) & (d_obs > 0) & (sdf >= -trunc)
    )
    band = sdf < trunc  # the min(sdf, trunc) clamp's derivative
    coef = (
        jnp.asarray(gbar_tsdf, jnp.float32)
        * (update & band).astype(jnp.float32)
        / (vol.weight.astype(jnp.float32) + 1.0)
    )

    xc, yc = cam[..., 0], cam[..., 1]
    # Zc == 0 exactly would produce 0 * inf = NaN through the masked
    # multiply (coef is already zero there via the update gate)
    zc2 = jnp.where(zc > 0, zc * zc, 1.0)
    xw = centres[..., 0]
    yw = centres[..., 1]
    zw = centres[..., 2]
    grads = []
    for j in range(6):
        if j < 3:  # omega_j: d x_w_pert = e_j x x_w
            if j == 0:
                ex, ey, ez = jnp.zeros_like(xw), -zw, yw
            elif j == 1:
                ex, ey, ez = zw, jnp.zeros_like(xw), -xw
            else:
                ex, ey, ez = -yw, xw, jnp.zeros_like(xw)
        else:  # v_j: d x_w_pert = e_j
            ex = jnp.full_like(xw, 1.0 if j == 3 else 0.0)
            ey = jnp.full_like(xw, 1.0 if j == 4 else 0.0)
            ez = jnp.full_like(xw, 1.0 if j == 5 else 0.0)
        dxc = -(rwc[0, 0] * ex + rwc[0, 1] * ey + rwc[0, 2] * ez)
        dyc = -(rwc[1, 0] * ex + rwc[1, 1] * ey + rwc[1, 2] * ez)
        dzc = -(rwc[2, 0] * ex + rwc[2, 1] * ey + rwc[2, 2] * ez)
        dsdf = -dzc
        if image_term:
            dpx = fx * (dxc * zc - xc * dzc) / zc2
            dpy = fy * (dyc * zc - yc * dzc) / zc2
            dsdf = dsdf + gxv * dpx + gyv * dpy
        grads.append(jnp.sum(coef * dsdf))
    return jnp.stack(grads)


def integrate_pose(
    vol: TSDFVolume,
    depth: jnp.ndarray,
    camera: Camera,
    delta: jnp.ndarray,
    cap_weight: bool = False,
    image_term: bool = True,
) -> TSDFVolume:
    """Differentiable fusion w.r.t. pose.

    Forward: ``ops.integrate`` of ``depth`` at pose
    ``se3_exp(delta) @ camera.pose``. Backward: the analytic adjoint
    (``pose_adjoint``), including the image-space term AD cannot see
    through the rounded depth lookup. It emits the raw cotangent of the
    pose_inv MATRIX; ``se3_exp`` and the 4x4 inverse chain by ordinary
    AD, so ``jax.grad`` is exact at ANY delta (not just 0). Volume
    cotangents (tsdf, weight, incl. the weight-cap tie) are exact, so
    fusion steps chain under AD; ``depth`` and intrinsics are treated as
    observed data (stop-gradient).

    Returns the fused volume, differentiable in ``delta`` (and the
    volume).
    """
    from ..utils.se3 import se3_exp

    pose = se3_exp(delta) @ camera.pose
    return _integrate_core(
        vol, jnp.asarray(depth, jnp.float32), camera.k,
        jnp.linalg.inv(pose), cap_weight, image_term,
    )


def camera_from_inv(k: jnp.ndarray, pose_inv: jnp.ndarray) -> Camera:
    return Camera(
        k=k,
        k_inv=jnp.linalg.inv(k),
        pose=jnp.linalg.inv(pose_inv),
        pose_inv=pose_inv,
    )


@partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def _integrate_core(vol, depth, k, pose_inv, cap_weight, image_term):
    return integrate(
        vol, depth, camera_from_inv(k, pose_inv), cap_weight=cap_weight
    )


def _integrate_core_fwd(vol, depth, k, pose_inv, cap_weight, image_term):
    out = _integrate_core(vol, depth, k, pose_inv, cap_weight, image_term)
    return out, (vol, depth, k, pose_inv)


def _integrate_core_bwd(cap_weight, image_term, res, gvol):
    vol, depth, k, pose_inv = res
    dd, dw, dpinv = pose_adjoint(
        vol, depth, k, pose_inv, gvol.tsdf, gvol.weight,
        cap_weight=cap_weight, image_term=image_term,
    )
    # Every non-tsdf/weight field of the output volume is an identity
    # pass-through of the input, so its cotangent flows through
    # unchanged (a loss reading e.g. out.truncation_distance must not
    # silently get zero). The geometry fields' COMPUTE-path influence on
    # new_tsdf (offset/voxel size inside the projection) is treated as
    # observed data like depth/k — only the pass-through term is kept.
    vol_cot = gvol.replace(
        tsdf=dd.astype(vol.tsdf.dtype), weight=dw.astype(vol.weight.dtype)
    )
    return vol_cot, jnp.zeros_like(depth), jnp.zeros_like(k), dpinv


_integrate_core.defvjp(_integrate_core_fwd, _integrate_core_bwd)


def pose_adjoint(
    vol: TSDFVolume,
    depth: jnp.ndarray,
    k: jnp.ndarray,
    pose_inv: jnp.ndarray,
    gbar_d: jnp.ndarray,
    gbar_w: jnp.ndarray,
    cap_weight: bool = False,
    image_term: bool = True,
):
    """Backward of the integrate w.r.t. the camera pose_inv matrix
    (rows R_wc | t_wc) and the input volume.

    Returns (d tsdf_in, d weight_in, (4, 4) cotangent of pose_inv whose
    bottom row is zero). The loss reaches the pose only through
    x_c = R_wc x_w + t_wc per voxel, so dL/dR_wc[i, j] = sum dL/dx_c[i]
    * x_w[j] and dL/dt_wc[i] = sum dL/dx_c[i]; the per-voxel dL/dx_c is
    the math of ``pose_gradient_lax`` before its twist projection.
    """
    depth = jnp.asarray(depth, jnp.float32)
    lin, update, sdf = _project(vol, depth, k, pose_inv)
    xc, yc, zc = camera_coords(vol, pose_inv)
    wx, wy, wz = _centre_planes(vol)
    trunc = vol.truncation_distance
    fx, fy = k[0, 0], k[1, 1]

    d = vol.tsdf.astype(jnp.float32)
    w = vol.weight.astype(jnp.float32)
    gbar_d = jnp.asarray(gbar_d, jnp.float32)
    gbar_w = jnp.asarray(gbar_w, jnp.float32)
    upd_f = update.astype(jnp.float32)
    new_w = w + 1.0

    coef = gbar_d * upd_f * (sdf < trunc).astype(jnp.float32) / new_w
    # Zc == 0 exactly would make 0 * inf = NaN through the masked
    # multiply; the update gate already excludes Zc <= 0
    zpos = zc > 0.0
    zc1 = jnp.where(zpos, zc, 1.0)
    zc2 = jnp.where(zpos, zc * zc, 1.0)
    if image_term:
        gx_img, gy_img = depth_image_gradients(depth)
        gxv = jnp.take(gx_img.ravel(), lin)
        gyv = jnp.take(gy_img.ravel(), lin)
        dxc = coef * gxv * fx / zc1
        dyc = coef * gyv * fy / zc1
        dzc = coef * (-gxv * fx * xc / zc2 - gyv * fy * yc / zc2 - 1.0)
    else:
        dxc = jnp.zeros_like(coef)
        dyc = jnp.zeros_like(coef)
        dzc = -coef
    rows = [
        jnp.stack(
            [jnp.sum(dci * wx), jnp.sum(dci * wy), jnp.sum(dci * wz),
             jnp.sum(dci)]
        )
        for dci in (dxc, dyc, dzc)
    ]
    dpinv = jnp.concatenate(
        [jnp.stack(rows), jnp.zeros((1, 4), jnp.float32)], axis=0
    )

    dd = gbar_d * jnp.where(update, w / new_w, 1.0)
    o = jnp.minimum(sdf, trunc)
    dnewd_dw = upd_f * (d - o) / (new_w * new_w)
    if cap_weight:
        # match jnp.minimum's AD exactly: derivative 1 below the cap,
        # 0.5 at the tie (weights step by 1, so the tie is COMMON: every
        # voxel hits it on the frame it reaches the cap), 0 above
        below = (new_w < vol.max_weight).astype(jnp.float32)
        tie = (new_w == vol.max_weight).astype(jnp.float32)
        capfac = jnp.where(update, below + 0.5 * tie, 1.0)
    else:
        capfac = 1.0
    dw = gbar_d * dnewd_dw + gbar_w * capfac
    return dd, dw, dpinv
