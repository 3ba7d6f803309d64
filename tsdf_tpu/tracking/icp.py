"""Projective point-to-plane ICP in pure JAX.

Re-design of Whelan's ICP_CUDA (the reference's pose tracker,
ref: third_party/ICP_CUDA/ICPOdometry.cpp, Cuda/estimate.cu,
Cuda/pyrdown.cu). The CUDA version builds one 7-float residual row per
pixel and reduces a 29-vector (upper-triangular 6x7 normal equations +
residual + inlier count) through a warp-shuffle tree
(ref: estimate.cu:143-214, 26-85); here the rows are a dense (H, W, 7)
computation and the normal equations are masked ``jnp.sum`` reductions —
one fused XLA reduction per level, and a ``psum`` away from running
sharded (parallel/ops.py).

Conventions (matching the reference so trajectories compare):
  * depth pyramid: 3 levels, 5-tap binomial weights {0.375, 0.25,
    0.0625} with a 3*sigma_color depth-similarity gate, sigma_color = 30
    (ref: pyrdown.cu:41-91);
  * vertex map: z * K^-1 (u, v, 1), invalid (z == 0 or >= cutoff) = NaN
    (ref: pyrdown.cu:93-133). Units here are mm (the framework
    convention); the reference converts to metres — thresholds scale;
  * normal map: normalize(cross(v(x+1,y) - v, v(x,y+1) - v))
    (ref: pyrdown.cu:135-188);
  * residual row: [n_prev | (v_curr_in_prev x n_prev)] . xi =
    n_prev . (v_prev - v_curr_in_prev), gates: projected pixel in
    image, |cross(n_curr_in_prev, n_prev)| < sin(20 deg),
    |v_prev - v_curr_in_prev| < 100 mm (ref: estimate.cu:170-198,
    thresholds src/Tools/tsdf_icp.cpp:122-123);
  * update: T_prev_curr <- exp((v, w)) * T_prev_curr, tangent ordered
    translation-first like Sophus (ref: ICPOdometry.cpp:131-133);
  * schedule: coarse-to-fine {10, 5, 4} iterations
    (ref: ICPOdometry.cpp:99-103);
  * lastError = sqrt(sum r^2 / inliers), lastInliers
    (ref: ICPOdometry.cpp:128-129) — in mm here.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.se3 import se3_exp

DIST_THRESH_MM = 100.0  # ref: tsdf_icp.cpp:122 (0.10 m)
ANGLE_THRESH = math.sin(20.0 * math.pi / 180.0)  # ref: tsdf_icp.cpp:123
SIGMA_COLOR = 30.0  # ref: pyrdown.cu:88
DEPTH_CUTOFF_MM = 20000.0


class ICPResult(NamedTuple):
    pose: jnp.ndarray  # (4, 4) T_prev_curr
    error: jnp.ndarray  # () rms point-to-plane residual, mm
    inliers: jnp.ndarray  # () inlier count at the final iteration


def pyr_down(depth: jnp.ndarray) -> jnp.ndarray:
    """One pyramid level: 5-tap binomial with depth-similarity gating.

    ref: pyrDownGaussKernel pyrdown.cu:41-78.
    """
    d = jnp.asarray(depth, jnp.float32)
    h, w = d.shape
    ch, cw = h // 2, w // 2
    weights = [0.0625, 0.25, 0.375, 0.25, 0.0625]
    # Accumulate the gated taps at FULL resolution with stride-1
    # shifted planes, then decimate num/den ONCE via an even-position
    # mask + 2x2/stride-2 reduce_window (one pooling op instead of a
    # strided gather per tap). Padded
    # zeros land only at out-of-range taps, which the in-range masks
    # exclude; adding zeros at masked-off odd positions is exact in
    # f32, so the result is bit-identical to the per-tap indexed
    # formulation. Border handling: the reference clips the window
    # (skips out-of-range taps).
    dpad = jnp.pad(d, ((2, 2), (2, 2)))
    ys = jnp.arange(h, dtype=jnp.int32)[:, None]
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    num = jnp.zeros_like(d)
    den = jnp.zeros_like(d)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            wgt = weights[dy + 2] * weights[dx + 2]
            val = dpad[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]
            ok = (
                (jnp.abs(val - d) < 3.0 * SIGMA_COLOR)
                & ((ys + dy) >= 0) & ((ys + dy) < h)
                & ((xs + dx) >= 0) & ((xs + dx) < w)
            )
            num = num + jnp.where(ok, val * wgt, 0.0)
            den = den + jnp.where(ok, wgt, 0.0)
    even = ((ys % 2) == 0) & ((xs % 2) == 0)
    num = jnp.where(even, num, 0.0)[: 2 * ch, : 2 * cw]
    den = jnp.where(even, den, 0.0)[: 2 * ch, : 2 * cw]
    pool = partial(
        jax.lax.reduce_window,
        init_value=0.0,
        computation=jax.lax.add,
        window_dimensions=(2, 2),
        window_strides=(2, 2),
        padding="VALID",
    )
    return jnp.floor(pool(num) / jnp.maximum(pool(den), 1e-12))


def depth_pyramid(depth: jnp.ndarray, levels: int = 3) -> list[jnp.ndarray]:
    """[level0 (full res), level1, ...] f32 mm."""
    pyr = [jnp.asarray(depth, jnp.float32)]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def level_intrinsics(fx, fy, cx, cy, level: int):
    """ref: ICPOdometry intr(i) — scale by 1/2^level."""
    s = 1.0 / (1 << level)
    return fx * s, fy * s, cx * s, cy * s


def vertex_map_planes(
    depth: jnp.ndarray, fx, fy, cx, cy, cutoff: float = DEPTH_CUTOFF_MM
):
    """Camera-space vertices as three (H, W) planes; NaN where invalid.

    Planar twin of ``vertex_map`` (ref: computeVmapKernel
    pyrdown.cu:93-133): the tracker's hot path stays in planes
    throughout, so no op carries a trailing 3-wide axis.
    """
    d = jnp.asarray(depth, jnp.float32)
    h, w = d.shape
    us = jnp.arange(w, dtype=jnp.float32)[None, :]
    vs = jnp.arange(h, dtype=jnp.float32)[:, None]
    z = d
    bad = ~((z > 0) & (z < cutoff))
    vx = jnp.where(bad, jnp.nan, z * (us - cx) / fx)
    vy = jnp.where(bad, jnp.nan, z * (vs - cy) / fy)
    vz = jnp.where(bad, jnp.nan, z)
    return vx, vy, vz


def vertex_map(
    depth: jnp.ndarray, fx, fy, cx, cy, cutoff: float = DEPTH_CUTOFF_MM
) -> jnp.ndarray:
    """(H, W, 3) camera-space vertices in mm; NaN where invalid.

    ref: computeVmapKernel pyrdown.cu:93-133.
    """
    return jnp.stack(
        vertex_map_planes(depth, fx, fy, cx, cy, cutoff), axis=-1
    )


def normal_map_planes(vx, vy, vz):
    """Screen-space normals as three (H, W) planes; NaN where undefined.

    Planar twin of ``normal_map`` (ref: computeNmapKernel
    pyrdown.cu:135-188; last row/col invalid). Shifts are stride-1
    pad+slice (the wrapped row/column of a roll lands only in the last
    row/col, which is overwritten with NaN exactly as the rolled
    formulation).
    """
    h, w = vx.shape

    def shift_x(p):
        return jnp.pad(p[:, 1:], ((0, 0), (0, 1)))

    def shift_y(p):
        return jnp.pad(p[1:, :], ((0, 1), (0, 0)))

    rx = shift_x(vx) - vx
    ry = shift_x(vy) - vy
    rz = shift_x(vz) - vz
    dx = shift_y(vx) - vx
    dy = shift_y(vy) - vy
    dz = shift_y(vz) - vz
    nx = ry * dz - rz * dy
    ny = rz * dx - rx * dz
    nz = rx * dy - ry * dx
    norm = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    norm = jnp.where(norm == 0, 1.0, norm)
    ys = jnp.arange(h, dtype=jnp.int32)[:, None]
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    edge = (ys == h - 1) | (xs == w - 1)
    return tuple(
        jnp.where(edge, jnp.nan, c / norm) for c in (nx, ny, nz)
    )


def normal_map(vmap: jnp.ndarray) -> jnp.ndarray:
    """normalize(cross(v(x+1) - v, v(y+1) - v)); NaN where undefined.

    ref: computeNmapKernel pyrdown.cu:135-188 (last row/col invalid).
    """
    return jnp.stack(
        normal_map_planes(vmap[..., 0], vmap[..., 1], vmap[..., 2]),
        axis=-1,
    )


def icp_step(
    rot: jnp.ndarray,  # (3, 3) R_prev_curr
    trans: jnp.ndarray,  # (3,) t_prev_curr, mm
    vmap_curr: jnp.ndarray,
    nmap_curr: jnp.ndarray,
    vmap_prev: jnp.ndarray,
    nmap_prev: jnp.ndarray,
    fx, fy, cx, cy,
    dist_thresh: float = DIST_THRESH_MM,
    angle_thresh: float = ANGLE_THRESH,
):
    """One Gauss-Newton step's normal equations.

    Returns (A (6,6), b (6,), residual_sq_sum, inlier_count).
    ref: estimate.cu:143-214.

    Image bounds and the correspondence lookup use ``vmap_prev``'s dims,
    so ``vmap_curr`` may be a row shard of the frame while the model
    maps stay whole (parallel/ops.py shards exactly this way).
    """
    h, w, _ = vmap_prev.shape
    v_curr = vmap_curr.reshape(-1, 3)
    n_curr = nmap_curr.reshape(-1, 3)

    v_in_prev = v_curr @ rot.T + trans
    n_in_prev = n_curr @ rot.T

    px = jnp.round(v_in_prev[:, 0] * fx / v_in_prev[:, 2] + cx).astype(
        jnp.int32
    )
    py = jnp.round(v_in_prev[:, 1] * fy / v_in_prev[:, 2] + cy).astype(
        jnp.int32
    )
    in_img = (
        (px >= 0)
        & (px < w)
        & (py >= 0)
        & (py < h)
        & (v_curr[:, 2] > 0)
        & (v_in_prev[:, 2] > 0)
    )
    lin = jnp.clip(py, 0, h - 1) * w + jnp.clip(px, 0, w - 1)

    v_prev = jnp.take(vmap_prev.reshape(-1, 3), lin, axis=0)
    n_prev = jnp.take(nmap_prev.reshape(-1, 3), lin, axis=0)

    diff = v_prev - v_in_prev
    dist_ok = jnp.linalg.norm(diff, axis=-1) < dist_thresh
    angle_ok = (
        jnp.linalg.norm(jnp.cross(n_in_prev, n_prev), axis=-1) < angle_thresh
    )
    finite = (
        jnp.isfinite(v_curr[:, 2])
        & jnp.isfinite(n_curr[:, 0])
        & jnp.isfinite(v_prev[:, 2])
        & jnp.isfinite(n_prev[:, 0])
    )
    mask = in_img & dist_ok & angle_ok & finite

    n_prev_s = jnp.where(mask[:, None], n_prev, 0.0)
    v_ip_s = jnp.where(mask[:, None], v_in_prev, 0.0)
    r = jnp.where(mask, jnp.sum(n_prev * diff, axis=-1), 0.0)
    r = jnp.where(jnp.isfinite(r), r, 0.0)

    rows = jnp.concatenate(
        [n_prev_s, jnp.cross(v_ip_s, n_prev_s)], axis=-1
    )  # (N, 6)
    rows = jnp.where(jnp.isfinite(rows), rows, 0.0)

    A = rows.T @ rows
    b = rows.T @ r
    res_sq = jnp.sum(r * r)
    inliers = jnp.sum(mask.astype(jnp.float32))
    return A, b, res_sq, inliers


def icp_step_banded(
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    vmap_curr: jnp.ndarray,
    nmap_curr: jnp.ndarray,
    depth_prev: jnp.ndarray,
    fx, fy, cx, cy,
    band: int = 32,
    dist_thresh: float = DIST_THRESH_MM,
    angle_thresh: float = ANGLE_THRESH,
    cutoff: float = DEPTH_CUTOFF_MM,
    row_offset=0,
    adaptive: bool = True,
):
    """icp_step with a banded correspondence lookup.

    ``vmap_curr`` may be a row shard of the frame: pass ``row_offset``
    (traced ok) as the shard's first row in the full image so the
    vertical-displacement band is measured against true pixel rows
    (parallel/ops.py passes axis_index * shard_height).

    The per-pixel model lookup is the one true 2D gather in the tracker.
    Here the lookup decomposes into row-rolls x exact-column row gathers
    (``take_along_axis``) on the model DEPTH image alone; v_prev/n_prev are reconstructed analytically from the
    fetched depths (exactly the vertex_map/normal_map formulas), so only
    one channel is gathered instead of six. Correspondences displaced
    vertically by more than ``band`` pixels are dropped (they are
    large-motion outliers; the pyramid's coarse levels absorb large
    motion first).
    """
    return icp_step_banded_planes(
        rot, trans,
        tuple(vmap_curr[..., i] for i in range(3)),
        tuple(nmap_curr[..., i] for i in range(3)),
        depth_prev, fx, fy, cx, cy,
        band=band, dist_thresh=dist_thresh, angle_thresh=angle_thresh,
        cutoff=cutoff, row_offset=row_offset, adaptive=adaptive,
    )


def icp_step_banded_planes(
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    vc_planes,  # 3x (H, W): current vertex map planes
    nc_planes,  # 3x (H, W): current normal map planes
    depth_prev: jnp.ndarray,
    fx, fy, cx, cy,
    band: int = 32,
    dist_thresh: float = DIST_THRESH_MM,
    angle_thresh: float = ANGLE_THRESH,
    cutoff: float = DEPTH_CUTOFF_MM,
    row_offset=0,
    adaptive: bool = True,
):
    """icp_step_banded on (H, W) component planes.

    Planar (H, W) layout throughout: the (N, 6) residual-row matrix a
    rows.T @ rows formulation would feed materializes ~157 MB at
    640x480. With image-shaped planes the normal-equation
    reduction becomes one (8, N) Gram matmul at the end.
    """
    h, w = depth_prev.shape
    vcx, vcy, vcz = vc_planes
    ncx, ncy, ncz = nc_planes
    hc, wc = vcx.shape

    vix = rot[0, 0] * vcx + rot[0, 1] * vcy + rot[0, 2] * vcz + trans[0]
    viy = rot[1, 0] * vcx + rot[1, 1] * vcy + rot[1, 2] * vcz + trans[1]
    viz = rot[2, 0] * vcx + rot[2, 1] * vcy + rot[2, 2] * vcz + trans[2]
    nix = rot[0, 0] * ncx + rot[0, 1] * ncy + rot[0, 2] * ncz
    niy = rot[1, 0] * ncx + rot[1, 1] * ncy + rot[1, 2] * ncz
    niz = rot[2, 0] * ncx + rot[2, 1] * ncy + rot[2, 2] * ncz

    pxf = vix * fx / viz + cx
    pyf = viy * fy / viz + cy
    pxf = jnp.where(jnp.isfinite(pxf), pxf, -1.0)
    pyf = jnp.where(jnp.isfinite(pyf), pyf, -1.0)
    px = jnp.round(jnp.clip(pxf, -1e6, 1e6)).astype(jnp.int32)
    py = jnp.round(jnp.clip(pyf, -1e6, 1e6)).astype(jnp.int32)

    in_img = (
        (px >= 0) & (px < w - 1) & (py >= 0) & (py < h - 1)
    )  # need (px+1, py+1) for the normal stencil
    yy = (
        jnp.arange(hc, dtype=jnp.int32)[:, None]
        + jnp.asarray(row_offset, jnp.int32)
    )
    dy = py - yy
    found = in_img & (jnp.abs(dy) <= band)

    px_s = jnp.clip(px, 0, w - 1)
    d00 = jnp.zeros((hc, wc), jnp.float32)
    d10 = jnp.zeros((hc, wc), jnp.float32)
    d01 = jnp.zeros((hc, wc), jnp.float32)
    dp = jnp.asarray(depth_prev, jnp.float32)

    # Sweep only the row displacements that actually occur this
    # iteration: the fixed [-band, band+1] sweep costs 2(band+1) roll +
    # gather passes regardless of motion, but real inter-frame dy spans
    # a few rows — lax.fori_loop with traced bounds makes the trip count
    # data-adaptive with bit-identical outputs (every d** select is
    # keyed on dy == k exactly as before; k_hi+2 covers the d01 tap at
    # k-1). No correspondences found -> empty range -> zero passes.
    def roll_pass(k, carry):
        d00, d10, d01 = carry
        rolled = jnp.roll(dp, -k, axis=0)  # rolled[y] = dp[y + k]
        # align the model rows to this shard's rows
        window = jax.lax.dynamic_slice_in_dim(
            rolled, jnp.asarray(row_offset, jnp.int32), hc, axis=0
        )
        # one gather call for both columns
        c01 = jnp.take_along_axis(
            window,
            jnp.concatenate([px_s, jnp.minimum(px_s + 1, w - 1)], axis=1),
            axis=1,
        )
        c0 = c01[:, :wc]
        c1 = c01[:, wc:]
        d00 = jnp.where(dy == k, c0, d00)
        d10 = jnp.where(dy == k, c1, d10)
        d01 = jnp.where(dy == k - 1, c0, d01)
        return d00, d10, d01

    if adaptive:
        k_lo = jnp.min(jnp.where(found, dy, band + 1))
        k_hi = jnp.max(jnp.where(found, dy, -band - 1))
        d00, d10, d01 = jax.lax.fori_loop(
            k_lo, k_hi + 2, roll_pass, (d00, d10, d01)
        )
    else:
        for k in range(-band, band + 2):
            d00, d10, d01 = roll_pass(k, (d00, d10, d01))

    # reconstruct v_prev / n_prev from depths (vertex_map/normal_map
    # math), all as (H, W) planes
    pxf2 = px.astype(jnp.float32)
    pyf2 = py.astype(jnp.float32)

    v00x = d00 * (pxf2 - cx) / fx
    v00y = d00 * (pyf2 - cy) / fy
    ax = d10 * (pxf2 + 1.0 - cx) / fx - v00x
    ay = d10 * (pyf2 - cy) / fy - v00y
    az = d10 - d00
    bx = d01 * (pxf2 - cx) / fx - v00x
    by = d01 * (pyf2 + 1.0 - cy) / fy - v00y
    bz = d01 - d00
    crx = ay * bz - az * by
    cry = az * bx - ax * bz
    crz = ax * by - ay * bx
    nn = jnp.sqrt(crx * crx + cry * cry + crz * crz)
    nn = jnp.where(nn == 0, 1.0, nn)
    npx = crx / nn
    npy = cry / nn
    npz = crz / nn

    dvalid = (
        (d00 > 0) & (d00 < cutoff)
        & (d10 > 0) & (d10 < cutoff)
        & (d01 > 0) & (d01 < cutoff)
    )

    dx = v00x - vix
    dyy = v00y - viy
    dz = d00 - viz
    dist_ok = jnp.sqrt(dx * dx + dyy * dyy + dz * dz) < dist_thresh
    # |cross(n_in_prev, n_prev)| gate
    gx = niy * npz - niz * npy
    gy = niz * npx - nix * npz
    gz = nix * npy - niy * npx
    angle_ok = jnp.sqrt(gx * gx + gy * gy + gz * gz) < angle_thresh
    finite = jnp.isfinite(vcz) & jnp.isfinite(ncx)
    # behind-camera gates, as icp_step's in_img mask: a point behind
    # the previous camera mirror-projects into the image and can
    # otherwise form a bogus correspondence at coarse levels with a
    # large interim pose error
    front = (vcz > 0) & (viz > 0)
    mask = found & dvalid & dist_ok & angle_ok & finite & front

    def msk(p):
        p = jnp.where(mask, p, 0.0)
        return jnp.where(jnp.isfinite(p), p, 0.0)

    # residual-row planes: [n_prev | v_in_prev x n_prev] and the
    # point-to-plane residual r = n_prev . (v_prev - v_in_prev)
    r0 = msk(npx)
    r1 = msk(npy)
    r2 = msk(npz)
    r3 = msk(viy * npz - viz * npy)
    r4 = msk(viz * npx - vix * npz)
    r5 = msk(vix * npy - viy * npx)
    r = msk(npx * dx + npy * dyy + npz * dz)
    m = mask.astype(jnp.float32)

    # normal equations as ONE (8, N) Gram matmul: A = G[:6,:6],
    # b = G[:6,6], sum r^2 = G[6,6], inliers = G[7,7] (mask is 0/1 so
    # sum m^2 == sum m, exact in f32 at image sizes)
    R = jnp.stack([r0, r1, r2, r3, r4, r5, r, m]).reshape(8, -1)
    G = jax.lax.dot_general(
        R, R, (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    return G[0:6, 0:6], G[0:6, 6], G[6, 6], G[7, 7]


def run_level(step_fn, n_iters: int, eps, pose, err, inl):
    """One pyramid level's Gauss-Newton loop with the conv_eps early
    exit — the single scaffolding shared by the single-device and
    sharded (parallel/ops.py) pyramids so their trajectories cannot
    drift apart. ``step_fn(pose) -> (A, b, res_sq, inliers)``, reduced
    however the caller needs (masked sums single-device; psum'd on the
    mesh, where the replicated solve keeps the exit branch identical on
    every device).

    The loop is ALWAYS a static-count lax.fori_loop; the early exit is
    a lax.cond inside the fixed-count body: converged iterations execute
    the identity branch, so the Gauss-Newton work (the expensive part)
    is still skipped at runtime while the trip count stays static. At a
    concrete eps == 0.0 (the default: the reference's fixed 10/5/4
    schedule, ICPOdometry.cpp:99-134) the cond is omitted entirely."""

    def body(carry):
        pose, err, inl, _score = carry
        A, b, res_sq, inliers = step_fn(pose)
        pose, score = gn_pose_update(A, b, pose)
        err = jnp.sqrt(res_sq / jnp.maximum(inliers, 1.0))
        return pose, err, inliers, score

    static_off = (
        isinstance(eps, (int, float)) and float(eps) == 0.0
    )
    init = (pose, err, inl, jnp.float32(jnp.inf))
    if static_off:
        fori_body = lambda _i, c: body(c)  # noqa: E731
    else:
        def fori_body(_i, carry):
            return jax.lax.cond(
                carry[3] >= eps, body, lambda c: c, carry
            )

    pose, err, inl, _ = jax.lax.fori_loop(0, n_iters, fori_body, init)
    return pose, err, inl


def gn_pose_update(A, b, pose):
    """One damped Gauss-Newton pose step shared by the single-device and
    sharded pyramids: 6x6 LDLT-style solve (mild damping for
    rank-deficient scenes), Sophus-ordered se3 exp, left-compose.
    Returns (new pose, update magnitude |v|_mm + 1000 |w|_rad — the
    conv_eps early-exit score)."""
    A = A + 1e-6 * jnp.eye(6, dtype=jnp.float32)
    update = jnp.linalg.solve(A, b)  # (v, w), Sophus ordering
    update = jnp.where(jnp.isfinite(update), update, 0.0)
    delta = se3_exp(jnp.concatenate([update[3:6], update[0:3]]))
    score = jnp.linalg.norm(update[0:3]) + 1000.0 * jnp.linalg.norm(
        update[3:6]
    )
    return delta @ pose, score


@partial(
    jax.jit, static_argnames=("levels", "iterations", "band", "adaptive")
)
def get_incremental_transformation(
    depth_curr: jnp.ndarray,
    depth_prev: jnp.ndarray,
    fx, fy, cx, cy,
    init_pose: jnp.ndarray | None = None,
    levels: int = 3,
    iterations: tuple[int, ...] = (10, 5, 4),
    dist_thresh: float = DIST_THRESH_MM,
    angle_thresh: float = ANGLE_THRESH,
    band: int | None = None,
    adaptive: bool = True,
    conv_eps: float = 0.0,
) -> ICPResult:
    """Full coarse-to-fine ICP between two depth frames.

    ``band``: use the banded correspondence lookup
    (icp_step_banded) with this level-0 row band; None = the exact
    reference path (icp_step).

    ``conv_eps``: early-exit threshold on the per-iteration SE3 update
    magnitude ``|v|_mm + 1000 * |w|_rad`` (a 1 m lever arm makes the
    rotation term commensurate with millimetres). Each level runs its
    scheduled iteration count but stops as soon as an update falls
    below the threshold — on slow motion the 10/5/4 schedule converges
    in a few iterations and the rest are identity updates. 0.0 (the
    default) reproduces the reference's fixed schedule exactly
    (ref: ICPOdometry.cpp:99-134 always runs all iterations).

    Returns T_prev_curr: maps current-camera points into the previous
    camera frame (ref: ICPOdometry::getIncrementalTransformation
    ICPOdometry.cpp:97-135).

    Not a gradient path: classic ICP tracking is not differentiated
    anywhere in this framework — differentiable pose estimation goes
    through ops/raycast_diff.py / ops.integrate_diff.integrate_pose.
    """
    pyr_c = depth_pyramid(depth_curr, levels)
    pyr_p = depth_pyramid(depth_prev, levels)

    maps = []
    for lvl in range(levels):
        lfx, lfy, lcx, lcy = level_intrinsics(fx, fy, cx, cy, lvl)
        vc = vertex_map_planes(pyr_c[lvl], lfx, lfy, lcx, lcy)
        nc = normal_map_planes(*vc)
        if band is None:
            # the exact path looks up the previous frame's maps; the
            # banded path reconstructs them from depth_prev and must
            # not pay for 6 unused map builds per call
            vp = vertex_map(pyr_p[lvl], lfx, lfy, lcx, lcy)
            np_ = normal_map(vp)
        else:
            vp = np_ = None
        maps.append((vc, nc, vp, np_, lfx, lfy, lcx, lcy))

    pose = (
        jnp.eye(4, dtype=jnp.float32) if init_pose is None
        else jnp.asarray(init_pose, jnp.float32)
    )
    err = jnp.array(0.0, jnp.float32)
    inl = jnp.array(0.0, jnp.float32)

    # keep a concrete 0.0 concrete: run_level picks the static-count
    # fori_loop for it (the while_loop path compiles pathologically)
    eps = (
        conv_eps
        if isinstance(conv_eps, (int, float)) and float(conv_eps) == 0.0
        else jnp.asarray(conv_eps, jnp.float32)
    )

    for lvl in range(levels - 1, -1, -1):
        vc, nc, vp, np_, lfx, lfy, lcx, lcy = maps[lvl]

        def step(pose, _lvl=lvl, _vc=vc, _nc=nc, _vp=vp, _np=np_,
                 _fx=lfx, _fy=lfy, _cx=lcx, _cy=lcy):
            if band is not None:
                return icp_step_banded_planes(
                    pose[0:3, 0:3], pose[0:3, 3], _vc, _nc, pyr_p[_lvl],
                    _fx, _fy, _cx, _cy,
                    band=max(band >> _lvl, 8),
                    dist_thresh=dist_thresh, angle_thresh=angle_thresh,
                    adaptive=adaptive,
                )
            return icp_step(
                pose[0:3, 0:3], pose[0:3, 3],
                jnp.stack(_vc, axis=-1), jnp.stack(_nc, axis=-1),
                _vp, _np,
                _fx, _fy, _cx, _cy, dist_thresh, angle_thresh,
            )

        pose, err, inl = run_level(
            step, iterations[lvl], eps, pose, err, inl
        )
    return ICPResult(pose=pose, error=err, inliers=inl)
