"""Per-tile ray march: a Pallas kernel through Triton.

Re-design of the reference's ``process_ray`` decomposition (one ray per
CUDA thread in 32x32 pixel tiles, each with its own march loop;
ref: src/RayCaster/GPURaycaster.cu:265-377,479). ``ops/raycast.py:
march_rays`` steps every ray of the image in ONE ``lax.while_loop``, so
each iteration gathers for all rays and the slowest ray sets the trip
count of the whole image. Here each program marches one tile of rays
with its own in-kernel ``while_loop``, which ends when that tile's rays
end; the eight trilinear taps are masked gathers from the flat TSDF.

The per-ray set-up (AABB entry, start point, step lengths) and the hit
reconstruction are the same XLA code ``march_rays`` uses
(``ray_setup`` / ``hit_vertices``), and the loop body is the same
termination and secant rule in both ``sphere`` and ``fixed`` modes, so
the two agree ray for ray up to floating-point contraction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..volume import TSDFVolume

# Rays per program (a power of two, as Triton requires). Callers pass
# rays in tile-major order (march_image_tiled: 16x16 pixel tiles), so
# one program marches one compact screen tile.
BLOCK = 256

_MARCHING, _HIT, _MISS = 0, 1, 2


def _trilinear(tsdf_ref, px, py, pz, mask, vs, shape):
    """ops/trilinear.py:trilinear_sample for one block of points, with
    the taps as masked gathers (same border and clamp rules)."""
    sz, sy, sx = shape
    vsx, vsy, vsz = vs
    coords = []
    for p, v, n in ((px, vsx, sx), (py, vsy, sy), (pz, vsz, sz)):
        maxv = n * v
        p = jnp.where(p >= maxv, maxv - v / 10.0, p)
        p = jnp.where(p < 0.0, 0.0, p)
        g = p / v - 0.5
        lower = jnp.maximum(jnp.floor(g).astype(jnp.int32), 0)
        coords.append((lower, g - lower.astype(jnp.float32), n))

    def tap(dx, dy, dz):
        (lx, _, nx), (ly, _, ny), (lz, _, nz) = coords
        ix = jnp.minimum(lx + dx, nx - 1)
        iy = jnp.minimum(ly + dy, ny - 1)
        iz = jnp.minimum(lz + dz, nz - 1)
        lin = (iz * sy + iy) * sx + ix
        return plgpu.load(tsdf_ref.at[lin], mask=mask, other=0.0).astype(
            jnp.float32
        )

    u, v, w = coords[0][1], coords[1][1], coords[2][1]
    return (
        tap(0, 0, 0) * (1 - u) * (1 - v) * (1 - w)
        + tap(0, 0, 1) * (1 - u) * (1 - v) * w
        + tap(0, 1, 0) * (1 - u) * v * (1 - w)
        + tap(0, 1, 1) * (1 - u) * v * w
        + tap(1, 0, 0) * u * (1 - v) * (1 - w)
        + tap(1, 0, 1) * u * (1 - v) * w
        + tap(1, 1, 0) * u * v * (1 - w)
        + tap(1, 1, 1) * u * v * w
    )


def _march_kernel(
    params_ref,  # (8,) f32: voxel size xyz, trunc, fixed/min/max step, scale
    rays_ref,  # (8, R) f32: start xyz, dir xyz, max_t, intersects
    tsdf_ref,  # (Z*Y*X,) f32 or bf16
    hit_t_ref,  # (R,) f32
    status_ref,  # (R,) i32
    *,
    shape: tuple[int, int, int],
    mode: str,
    max_steps: int,
):
    sl = pl.ds(pl.program_id(0) * BLOCK, BLOCK)
    sx, sy, sz = rays_ref[0, sl], rays_ref[1, sl], rays_ref[2, sl]
    dx, dy, dz = rays_ref[3, sl], rays_ref[4, sl], rays_ref[5, sl]
    max_t = rays_ref[6, sl]
    vs = (params_ref[0], params_ref[1], params_ref[2])
    trunc = params_ref[3]
    fixed_step, min_step, max_step = params_ref[4], params_ref[5], params_ref[6]
    step_scale = params_ref[7]

    zeros = jnp.zeros((BLOCK,), jnp.float32)
    status0 = jnp.where(rays_ref[7, sl] > 0.5, _MARCHING, _MISS).astype(
        jnp.int32
    )

    def cond(s):
        count, status = s[0], s[5]
        live = jnp.max((status == _MARCHING).astype(jnp.int32))
        return (count < max_steps) & (live > 0)

    def body(s):
        count, t, hit_t, prev_tsdf, prev_step, status = s
        active = status == _MARCHING
        tsdf = _trilinear(
            tsdf_ref, sx + t * dx, sy + t * dy, sz + t * dz, active, vs,
            shape,
        )
        frac = prev_tsdf / (prev_tsdf - tsdf)
        t_refined = t - prev_step + frac * prev_step
        hit = active & (tsdf <= 0.0)
        backface = active & (tsdf > 0.0) & (prev_tsdf < 0.0)
        if mode == "fixed":
            step = zeros + fixed_step
        else:
            step = jnp.minimum(jnp.maximum(step_scale * tsdf, min_step),
                               max_step)
        new_t = t + step
        escaped = active & ~hit & ~backface & (new_t >= max_t)
        status = jnp.where(hit, _HIT, status)
        status = jnp.where(backface | escaped, _MISS, status)
        return (
            count + 1,
            jnp.where(active & ~hit, new_t, t),
            jnp.where(hit, jnp.where(tsdf < 0.0, t_refined, t), hit_t),
            jnp.where(active, tsdf, prev_tsdf),
            jnp.where(active, step, prev_step),
            status,
        )

    _, _, hit_t, _, _, status = jax.lax.while_loop(
        cond,
        body,
        (jnp.int32(0), zeros, zeros, zeros + trunc, zeros + fixed_step,
         status0),
    )
    hit_t_ref[sl] = hit_t
    status_ref[sl] = status


@partial(
    jax.jit,
    static_argnames=("mode", "max_steps", "interpret"),
)
def march_rays_tiled(
    vol: TSDFVolume,
    origin: jnp.ndarray,
    dirs: jnp.ndarray,
    mode: str = "sphere",
    max_steps: int = 4400,
    step_scale: float = 0.75,
    interpret: bool = False,
) -> jnp.ndarray:
    """``march_rays`` with one in-kernel loop per BLOCK of rays.

    Args:
      dirs: (N, 3) unit directions, N a multiple of BLOCK; consecutive
        BLOCK rays form one program (pass them tile-major).

    Returns:
      (N, 3) world-space hit vertices, NaN on miss.
    """
    from ..ops.raycast import hit_vertices, ray_setup

    n = dirs.shape[0]
    if n % BLOCK:
        raise ValueError(f"ray count {n} is not a multiple of {BLOCK}")
    start, max_t, intersects, (fixed, lo, hi) = ray_setup(
        vol, origin, dirs, mode
    )
    rays = jnp.concatenate(
        [start.T, dirs.T, max_t[None], intersects[None].astype(jnp.float32)]
    ).astype(jnp.float32)
    params = jnp.stack(
        [
            vol.voxel_size[0], vol.voxel_size[1], vol.voxel_size[2],
            vol.truncation_distance, fixed, lo, hi,
            jnp.asarray(step_scale, jnp.float32),
        ]
    ).astype(jnp.float32)
    hit_t, status = pl.pallas_call(
        partial(
            _march_kernel, shape=vol.tsdf.shape, mode=mode,
            max_steps=max_steps,
        ),
        out_shape=(
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
        ),
        grid=(n // BLOCK,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=interpret,
        name="ray_march_tiles",
    )(params, rays, vol.tsdf.reshape(-1))
    return hit_vertices(vol, start, dirs, hit_t, status)


TILE = (16, 16)  # (rows, cols) of one program's screen tile: BLOCK rays


def march_image_tiled(
    vol: TSDFVolume,
    origin: jnp.ndarray,
    dirs: jnp.ndarray,
    mode: str = "sphere",
    max_steps: int = 4400,
    step_scale: float = 0.75,
    interpret: bool = False,
) -> jnp.ndarray:
    """March an (H, W, 3) image of ray directions in TILE screen tiles.

    The image is padded to whole tiles by edge replication (padded rays
    duplicate real ones, so they end when those do) and reordered
    tile-major, so each program marches one compact tile.

    Returns (H, W, 3) world-space hit vertices, NaN on miss.
    """
    h, w, _ = dirs.shape
    th, tw = TILE
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    d = jnp.pad(dirs, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    d = d.reshape(hp // th, th, wp // tw, tw, 3).transpose(0, 2, 1, 3, 4)
    verts = march_rays_tiled(
        vol, origin, d.reshape(-1, 3), mode=mode, max_steps=max_steps,
        step_scale=step_scale, interpret=interpret,
    )
    verts = verts.reshape(hp // th, wp // tw, th, tw, 3)
    return verts.transpose(0, 2, 1, 3, 4).reshape(hp, wp, 3)[:h, :w]
