"""Sphere-traced raycasting of the TSDF volume.

Re-design of ``GPURaycaster`` (ref: src/RayCaster/GPURaycaster.cu:24-606).
The reference marches one ray per CUDA thread with a fixed step of
0.05 * truncation_distance and an iteration cap of 4400 (ref: :324,
:369). ``march_rays`` is the plain-JAX semantics reference: ALL rays
march together in one ``lax.while_loop``, each iteration trilinearly
sampling the volume for every still-active ray as one batched 8-tap
gather, until every ray has terminated. ``raycast`` marches with the
per-tile Triton kernel (kernels/raymarch.py) on a CUDA device, where one
program loops over one tile of rays. Two stepping modes:

  * ``mode="sphere"`` (default): adaptive sphere tracing — the sampled
    TSDF value *is* a conservative distance bound near the surface, so the
    step is ``clamp(step_scale * tsdf, min_step, max_step)``. Free-space
    rays leap ~a truncation distance per iteration instead of 1/20th of
    one: ~20x fewer volume reads than the reference scheme at equal hit
    accuracy (hits are always refined by the same secant rule).
  * ``mode="fixed"``: the reference's constant step 0.05 * trunc, for
    bit-level parity testing against reference math.

Intended-math divergences from the reference (each cited):
  * ray directions are actually normalized — the reference's
    ``f3_normalise`` takes its argument by value so normalization is lost
    (ref: src/include/cuda_utilities.hpp:87-93); geometry is unchanged
    (t rescales) but our t is in true mm;
  * the two-sample secant refinement uses the real previous sample — in
    the reference an inner ``float tsdf`` shadows the outer accumulator so
    ``previous_tsdf`` is stuck at trunc_distance (ref: GPURaycaster.cu:311,
    :332-342); we implement the intended secant.

Termination semantics match the reference exactly (ref: :325-374):
stop on + -> - crossing (hit, secant-refined), on - at first sample (hit
at entry), on - -> + transition (backface miss), or on leaving the volume.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..camera import Camera
from ..volume import TSDFVolume
from .trilinear import trilinear_sample

# Reference iteration cap (ref: GPURaycaster.cu:369).
REFERENCE_MAX_STEPS = 4400

_MARCHING, _HIT, _MISS = 0, 1, 2


def ray_directions(camera: Camera, width: int, height: int) -> jnp.ndarray:
    """(H, W, 3) unit world-space ray directions: normalize(R @ K^-1 @ p).

    ref: compute_ray_direction_at_pixel GPURaycaster.cu:24-44.
    """
    ys, xs = jnp.mgrid[0:height, 0:width]
    pix = jnp.stack(
        [xs.astype(jnp.float32), ys.astype(jnp.float32)], axis=-1
    )
    homo = jnp.concatenate([pix, jnp.ones_like(pix[..., :1])], axis=-1)
    d_cam = homo @ camera.k_inv.T
    d_world = d_cam @ camera.rotation.T
    return d_world / jnp.linalg.norm(d_world, axis=-1, keepdims=True)


def slab_near_far(origin, dirs, space_min, space_max):
    """Per-ray entry/exit t of the volume AABB.

    ref: compute_near_and_far_t GPURaycaster.cu:197-251 (generalizes both
    its origin-inside and origin-outside branches: inside gives near<0
    which we clamp to 0, matching near_t = 0).

    Returns (near, far, intersects) with near clamped to >= 0.
    """
    # Where dirs == 0 the quotient is +/-inf which the min/max handle,
    # except 0/0 -> nan when the origin sits exactly on a face; nudge.
    safe = jnp.where(dirs == 0.0, 1e-20, dirs)
    t1 = (space_min - origin) / safe
    t2 = (space_max - origin) / safe
    # Rays parallel to an axis and outside the slab can never hit.
    inside = (origin >= space_min) & (origin <= space_max)
    par_miss = jnp.any((dirs == 0.0) & ~inside, axis=-1)
    near = jnp.max(jnp.minimum(t1, t2), axis=-1)
    far = jnp.min(jnp.maximum(t1, t2), axis=-1)
    intersects = (near <= far) & (far >= 0.0) & ~par_miss
    return jnp.maximum(near, 0.0), far, intersects


def march_rays(
    vol: TSDFVolume,
    origin: jnp.ndarray,
    dirs: jnp.ndarray,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
) -> jnp.ndarray:
    """March a flat batch of rays through the volume.

    The reusable core of :func:`raycast` — the sharded raycast
    (parallel/ops.py) shard_maps this over ray tiles with the volume
    replicated, so ray-tile sharding is independent of brick sharding
    (SURVEY.md §2.9 process_ray row).

    Args:
      vol: the volume (replicated or locally owned).
      origin: (3,) world-space ray origin, mm.
      dirs: (N, 3) unit world-space ray directions.

    Returns:
      (N, 3) world-space hit vertices, NaN on miss.
    """
    start, max_t, intersects, (fixed_step, min_step, max_step) = ray_setup(
        vol, origin, dirs, mode
    )
    trunc = vol.truncation_distance
    voxel_size = vol.voxel_size

    def sample(t):
        pts = start + t[:, None] * dirs
        return trilinear_sample(vol.tsdf, pts, voxel_size)

    # Derive carries from dirs so they inherit its varying-manual-axes
    # type when this runs inside shard_map (ray tiles sharded).
    zeros = jnp.zeros_like(dirs[:, 0])
    state0 = dict(
        t=zeros,
        hit_t=zeros,
        prev_tsdf=zeros + trunc,
        prev_step=zeros + fixed_step,
        status=jnp.where(intersects, _MARCHING, _MISS).astype(jnp.int32),
        count=jnp.array(0, jnp.int32),
    )

    def cond(s):
        return (s["count"] < max_steps) & jnp.any(s["status"] == _MARCHING)

    def body(s):
        active = s["status"] == _MARCHING
        tsdf = sample(s["t"])

        # Hit: current sample <= 0. Secant-refine when strictly negative
        # (ref: GPURaycaster.cu:336-350).
        frac = s["prev_tsdf"] / (s["prev_tsdf"] - tsdf)
        t_refined = s["t"] - s["prev_step"] + frac * s["prev_step"]
        hit = active & (tsdf <= 0.0)
        hit_t = jnp.where(tsdf < 0.0, t_refined, s["t"])

        # Backface: previous sample negative, current positive
        # (ref: :352-355). Only reachable when the entry sample was
        # negative (hit-at-entry handles tsdf<=0), kept for parity.
        backface = active & (tsdf > 0.0) & (s["prev_tsdf"] < 0.0)

        if mode == "fixed":
            step = jnp.full_like(tsdf, fixed_step)
        else:
            step = jnp.clip(step_scale * tsdf, min_step, max_step)

        new_t = s["t"] + step
        escaped = active & ~hit & ~backface & (new_t >= s["max_t"])

        status = s["status"]
        status = jnp.where(hit, _HIT, status)
        status = jnp.where(backface | escaped, _MISS, status)

        return dict(
            t=jnp.where(active & ~hit, new_t, s["t"]),
            hit_t=jnp.where(hit, hit_t, s["hit_t"]),
            prev_tsdf=jnp.where(active, tsdf, s["prev_tsdf"]),
            prev_step=jnp.where(active, step, s["prev_step"]),
            status=status,
            count=s["count"] + 1,
            max_t=s["max_t"],
        )

    state0["max_t"] = max_t
    final = jax.lax.while_loop(cond, body, state0)

    return hit_vertices(vol, start, dirs, final["hit_t"], final["status"])


def ray_setup(vol: TSDFVolume, origin, dirs, mode: str):
    """Per-ray march set-up shared by every ray marcher: grid-local start
    point at the AABB entry, the marchable length, the AABB hit flag and
    the (fixed, min, max) step lengths of ``mode``."""
    space_min = vol.space_min
    trunc = vol.truncation_distance
    near, far, intersects = slab_near_far(
        origin[None, :], dirs, space_min[None, :], vol.space_max[None, :]
    )
    # March in grid-local coords (ref: GPURaycaster.cu:308 start_point).
    start = origin[None, :] + near[:, None] * dirs - space_min[None, :]
    max_t = far - near

    fixed_step = trunc * 0.05  # ref: GPURaycaster.cu:324
    if mode == "fixed":
        min_step = max_step = fixed_step
    elif mode == "sphere":
        min_step = fixed_step
        max_step = trunc * 0.9
    else:
        raise ValueError(f"unknown raycast mode: {mode}")
    return start, max_t, intersects, (fixed_step, min_step, max_step)


def hit_vertices(vol: TSDFVolume, start, dirs, hit_t, status):
    """(N, 3) world-space hit points from the march result, NaN where the
    ray did not end in a hit."""
    verts = start + hit_t[:, None] * dirs + vol.space_min[None, :]
    return jnp.where((status == _HIT)[:, None], verts, jnp.nan)


@partial(
    jax.jit,
    static_argnames=("width", "height", "mode", "max_steps"),
)
def raycast(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raycast the volume from ``camera``.

    Returns:
      vertices: (H, W, 3) world-space surface points in mm; NaN on miss
        (ref: GPURaycaster.cu:302,376 NaN sentinel).
      normals: (H, W, 3) unit normals from screen-space differences; zero
        on the last row/column and on misses (ref: compute_normals
        GPURaycaster.cu:393-427).
    """
    dirs = ray_directions(camera, width, height)
    verts = march_image(
        vol, camera.position, dirs, mode=mode, max_steps=max_steps,
        step_scale=step_scale,
    )
    normals = compute_normals_from_vertices(verts)
    return verts, normals


def march_image(
    vol: TSDFVolume,
    origin: jnp.ndarray,
    dirs: jnp.ndarray,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
) -> jnp.ndarray:
    """March an (H, W, 3) image of rays: (H, W, 3) hits, NaN on miss.

    On a CUDA device the per-tile Triton kernel marches
    (kernels/raymarch.py); every other platform runs ``march_rays``, its
    semantics reference. The choice is made when the computation is
    lowered, for the platform it is lowered for.
    """
    from ..kernels.raymarch import march_image_tiled

    h, w, _ = dirs.shape
    kw = dict(mode=mode, max_steps=max_steps, step_scale=step_scale)
    return jax.lax.platform_dependent(
        vol, origin, dirs,
        cuda=lambda v, o, d: march_image_tiled(v, o, d, **kw),
        default=lambda v, o, d: march_rays(
            v, o, d.reshape(-1, 3), **kw
        ).reshape(h, w, 3),
    )


def compute_normals_from_vertices(verts: jnp.ndarray) -> jnp.ndarray:
    """Screen-space normals: normalize((below - self) x (right - self)).

    ref: compute_normals GPURaycaster.cu:393-427 — zero on the last
    row/column; we additionally zero (rather than NaN-propagate) normals
    whose stencil touches a missed ray.
    """
    v = verts
    right = jnp.roll(v, -1, axis=1) - v
    below = jnp.roll(v, -1, axis=0) - v
    n = jnp.cross(below, right)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.where(norm == 0.0, 1.0, norm)
    valid = jnp.isfinite(n).all(axis=-1, keepdims=True)
    n = jnp.where(valid, n, 0.0)
    n = n.at[-1, :, :].set(0.0)
    n = n.at[:, -1, :].set(0.0)
    return n


def render_to_depth_image(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    **kwargs,
) -> jnp.ndarray:
    """Raycast and return a (H, W) u16 depth image in mm (camera z).

    ref: GPURaycaster::render_to_depth_image GPURaycaster.cu:555-606
    (minus its hardcoded debug PNG write at :589).
    """
    verts, _ = raycast(vol, camera, width, height, **kwargs)
    cam = camera.world_to_camera(verts.reshape(-1, 3)).reshape(
        height, width, 3
    )
    z = cam[..., 2]
    z = jnp.where(jnp.isfinite(z), z, 0.0)
    return jnp.clip(jnp.round(z), 0, 65535).astype(jnp.uint16)
