"""KinectFusion pipelines: GT-pose fusion and tracked fusion.

ref: src/Tools/kinfu.cpp:150-222 (GT-pose fuse + render + mesh) and the
full KinectFusion loop (bilateral -> ICP against raycast model ->
integrate) that the reference ships components for (BilateralFilter,
ICP_CUDA, TSDFVolume) but never wires together (SURVEY.md §2.8 note on
the unused filter; BASELINE config 3).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Iterable, Optional

import jax
import jax.numpy as jnp

from ..camera import Camera
from ..ops.bilateral import bilateral_filter
from ..ops.integrate import integrate
from ..ops.raycast import raycast
from ..tracking.icp import get_incremental_transformation
from ..volume import TSDFVolume, make_volume


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """The reference's scattered compile-time constants, in one place
    (SURVEY.md §5 'Config / flag system: no framework')."""

    volume_size: tuple[int, int, int] = (200, 200, 200)  # ref: kinfu.cpp:23
    physical_size_mm: float = 3000.0
    offset_mm: Optional[tuple[float, float, float]] = None
    cap_weight: bool = False
    use_bilateral_filter: bool = False  # ref default: compiled, unused
    sigma_colour: float = 20.0
    sigma_space: float = 3.0
    width: int = 640
    height: int = 480
    icp_band: int = 32  # banded ICP lookup (0 = exact association)
    # Banded ICP drops correspondences displaced vertically by more than
    # icp_band pixels (fast motion). If the final inlier count falls
    # below this fraction of the image, the frame is re-tracked with the
    # exact full-image association before accepting the pose.
    icp_min_inliers_frac: float = 0.02
    # ICP convergence early-exit: stop a pyramid level once the SE3
    # update magnitude |v|_mm + 1000*|w|_rad falls below this. 0.0 (the
    # default) runs the reference's full 10/5/4 schedule
    # (ref: ICPOdometry.cpp:99-134); ~0.01 keeps sub-0.01 mm tracking
    # while skipping the identity tail iterations on slow motion.
    icp_conv_eps: float = 0.0
    # GT-pose fusion: lax.scan this many frames per dispatch (one host
    # dispatch per chunk instead of per frame). Chunk tails are padded
    # with zero-depth frames, which the integrate's depth > 0 gate makes
    # exact no-ops.
    fuse_chunk: int = 16
    # Tracked fusion: scan this many tracked frames per dispatch (1 =
    # one dispatch per frame). Tail padding is again zero-depth frames,
    # which the lost-tracking gate makes exact no-ops; per-frame stats
    # are still returned per frame.
    track_chunk: int = 1

    def make_volume(self) -> TSDFVolume:
        return make_volume(
            self.volume_size, self.physical_size_mm, offset=self.offset_mm
        )


@partial(jax.jit, static_argnames=("config",))
def _fuse_chunk(
    vol: TSDFVolume,
    camera: Camera,
    depths: jnp.ndarray,  # (N, H, W) f32 mm; zero frames = tail padding
    poses: jnp.ndarray,  # (N, 4, 4) camera->world
    *,
    config: FusionConfig,
):
    """Scan-fuse a chunk of GT-pose frames in ONE dispatch."""

    def body(vol, inp):
        depth, pose = inp
        if config.use_bilateral_filter:
            depth = bilateral_filter(
                depth, config.sigma_colour, config.sigma_space
            )
        return (
            integrate(
                vol, depth, camera.set_pose(pose),
                cap_weight=config.cap_weight,
            ),
            None,
        )

    vol, _ = jax.lax.scan(body, vol, (depths, poses))
    return vol


def fuse_frames(
    vol: TSDFVolume,
    camera: Camera,
    frames: Iterable[tuple[jnp.ndarray, jnp.ndarray]],
    config: FusionConfig = FusionConfig(),
) -> tuple[TSDFVolume, Camera]:
    """Fuse (depth, pose) frames with ground-truth poses.

    ref: kinfu.cpp:33-56 — the reference uses TUM ground-truth poses,
    no tracking. With ``use_bilateral_filter`` the fused depth is
    pre-smoothed (opt-in denoising for raw sensor data; the tracked
    pipeline instead filters only the tracker's input and always fuses
    raw depth). Frames are fused ``config.fuse_chunk`` at a time by one
    device-side scan; at most one chunk is host-resident.

    Args:
      frames: iterable of (depth (H, W) mm, pose (4, 4) camera->world).

    Returns (volume, camera-at-last-pose).
    """
    chunk = max(config.fuse_chunk, 1)
    buf_d: list = []
    buf_p: list = []
    last_pose = None

    def flush():
        nonlocal vol
        if not buf_d:
            return
        # pad the tail to the full chunk with zero-depth frames: ONE
        # compiled scan shape for any frame count
        while len(buf_d) < chunk:
            buf_d.append(jnp.zeros_like(buf_d[0]))
            buf_p.append(buf_p[-1])
        vol = _fuse_chunk(
            vol, camera, jnp.stack(buf_d), jnp.stack(buf_p), config=config
        )
        buf_d.clear()
        buf_p.clear()

    for depth, pose in frames:
        buf_d.append(jnp.asarray(depth, jnp.float32))
        buf_p.append(jnp.asarray(pose, jnp.float32))
        last_pose = pose
        if len(buf_d) == chunk:
            flush()
    flush()
    if last_pose is not None:
        camera = camera.set_pose(last_pose)
    return vol, camera


def track_and_fuse_frames(
    vol: TSDFVolume,
    camera: Camera,
    frames: Iterable[jnp.ndarray],
    config: FusionConfig = FusionConfig(),
):
    """Full KinectFusion: bilateral -> ICP vs raycast model -> integrate.

    The first frame is integrated at the camera's current pose; each
    later frame is tracked against a model render from the previous
    pose (frame-to-model tracking) by the fused step
    ``_tracked_step_body``, ``config.track_chunk`` frames per dispatch.
    No frame reads a scalar back to the host, so the host enqueues
    frames while the device works.

    Args:
      frames: iterable of depth images (H, W) mm, or of (depth, rgb)
        pairs — rgb (H, W, 3) u8 frames fuse per-voxel colour into a
        with_color volume (tracked colour reconstruction; the tracker
        itself stays depth-only).

    Returns:
      (volume, camera at final pose, list of (4,4) per-frame poses,
       list of (error_mm, inliers) tracking stats).
    """
    if vol.deform is not None:
        # Non-rigid fusion is pipelines/scenefusion.py: the tracker's
        # model render marches the canonical TSDF, not the warped one.
        raise ValueError(
            "track_and_fuse_frames does not support deformation-enabled "
            "volumes; use the SceneFusion pipeline for non-rigid fusion"
        )
    band = config.icp_band if config.icp_band > 0 else None
    chunk = max(config.track_chunk, 1)
    poses: list = []
    stats: list = []
    buf_d: list = []
    buf_r: list = []
    has_rgb: bool | None = None

    def flush():
        nonlocal vol, camera
        if not buf_d:
            return
        n_real = len(buf_d)
        if chunk == 1:
            vol, camera, err, inl = _tracked_step(
                vol, camera, buf_d[0], buf_r[0] if has_rgb else None,
                config=config, band=band,
            )
            poses.append(camera.pose)
            stats.append((err, inl))
        else:
            # pad the tail to the full chunk with zero-depth frames (exact
            # no-ops under the lost-tracking gate): ONE scan shape
            while len(buf_d) < chunk:
                buf_d.append(jnp.zeros_like(buf_d[0]))
                if has_rgb:
                    buf_r.append(jnp.zeros_like(buf_r[0]))
            vol, camera, cposes, errs, inls = _tracked_chunk(
                vol, camera, jnp.stack(buf_d),
                jnp.stack(buf_r) if has_rgb else None,
                config=config, band=band,
            )
            for i in range(n_real):
                poses.append(cposes[i])
                stats.append((errs[i], inls[i]))
        buf_d.clear()
        buf_r.clear()

    for frame in frames:
        if isinstance(frame, tuple):
            depth, rgb = frame
            rgb = None if rgb is None else jnp.asarray(rgb)
        else:
            depth, rgb = frame, None
        depth = jnp.asarray(depth, jnp.float32)
        if has_rgb is None:
            # raw depth is fused; the filter only feeds the tracker
            # (see _tracked_step_body)
            has_rgb = rgb is not None
            stats.append((jnp.array(0.0), jnp.array(0.0)))
            vol = integrate(
                vol, depth, camera, cap_weight=config.cap_weight, rgb=rgb
            )
            poses.append(camera.pose)
            continue
        if (rgb is not None) != has_rgb:
            raise ValueError(
                "track_and_fuse_frames needs a consistent rgb presence "
                "across frames"
            )
        buf_d.append(depth)
        if has_rgb:
            buf_r.append(rgb)
        if len(buf_d) == chunk:
            flush()
    flush()
    return vol, camera, poses, stats


def _tracked_step_body(
    vol: TSDFVolume,
    camera: Camera,
    depth: jnp.ndarray,
    rgb: jnp.ndarray | None,
    config: FusionConfig,
    band: int | None,
):
    """One fused tracked-fusion frame: bilateral -> model render -> ICP
    (banded, with on-device exact fallback) -> lost-tracking gate ->
    integrate. Traced either as its own jit (_tracked_step, one dispatch
    per frame) or as the body of the chunked scan (_tracked_chunk).

    The banded lookup drops correspondences displaced vertically by
    more than ``band`` pixels (fast motion). If its inlier count falls
    below ``config.icp_min_inliers_frac`` of the image, a lax.cond
    re-runs the exact full-image association — on device, so the host
    never reads a scalar mid-loop. The integrate is then gated on the
    final inlier count: a frame whose tracking is lost even under exact
    association is not fused. A zero depth frame is an exact no-op
    under these gates (0 inliers -> lost -> identity pose, no fusion),
    which is what makes chunk tail-padding safe.
    """
    k = camera.k
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    min_inl = (
        config.icp_min_inliers_frac * config.width * config.height
    )

    # Classic KinectFusion composition: the bilateral-smoothed depth
    # feeds the TRACKER only; the raw depth is fused. Fusing the
    # filtered frame bakes smoothing bias into the model the next frame
    # tracks against, and the TSDF's weighted average is itself the
    # noise filter.
    if config.use_bilateral_filter:
        depth_icp = bilateral_filter(
            depth, config.sigma_colour, config.sigma_space
        )
    else:
        depth_icp = depth

    with jax.named_scope("model_render"):
        verts, _ = raycast(vol, camera, config.width, config.height)
    # camera-space z from row 2 of pose_inv as elementwise FMAs
    pi = camera.pose_inv
    wx = jnp.where(jnp.isfinite(verts[..., 0]), verts[..., 0], 0.0)
    wy = jnp.where(jnp.isfinite(verts[..., 1]), verts[..., 1], 0.0)
    wz = jnp.where(jnp.isfinite(verts[..., 2]), verts[..., 2], 0.0)
    camz = pi[2, 0] * wx + pi[2, 1] * wy + pi[2, 2] * wz + pi[2, 3]
    # NB: unlike camera.world_to_camera this skips the homogeneous
    # w-divide; pose_inv comes from jnp.linalg.inv so its bottom row is
    # only approximately [0,0,0,1] — using row 2 directly is the
    # (slightly more correct) intended math, not an oversight.
    model_depth = jnp.where(jnp.isfinite(verts).all(-1), camz, 0.0)

    with jax.named_scope("icp"):
        res = get_incremental_transformation(
            depth_icp, model_depth, fx, fy, cx, cy, band=band,
            conv_eps=config.icp_conv_eps,
        )
        if band is not None:

            def exact(_):
                r = get_incremental_transformation(
                    depth_icp, model_depth, fx, fy, cx, cy, band=None,
                    conv_eps=config.icp_conv_eps,
                )
                return r.pose, r.error, r.inliers

            pose_inc, err, inl = jax.lax.cond(
                res.inliers < min_inl,
                exact,
                lambda _: (res.pose, res.error, res.inliers),
                None,
            )
        else:
            pose_inc, err, inl = res.pose, res.error, res.inliers
    # Tracking lost (too few inliers even under the final association):
    # keep the previous pose — applying the garbage increment would
    # corrupt every subsequent frame's frame-to-model tracking. Select,
    # don't multiply, so a lost (or padded zero-depth) frame is EXACTLY
    # pose-preserving.
    lost = inl < min_inl
    camera = camera.set_pose(
        jnp.where(lost, camera.pose, camera.pose @ pose_inc)
    )

    def fuse(vol):
        return integrate(
            vol, depth, camera, cap_weight=config.cap_weight, rgb=rgb
        )

    # A lost frame must not be fused either (see docstring).
    with jax.named_scope("integrate"):
        vol = jax.lax.cond(jnp.logical_not(lost), fuse, lambda v: v, vol)
    return vol, camera, err, inl


@partial(jax.jit, static_argnames=("config", "band"))
def _tracked_step(
    vol: TSDFVolume,
    camera: Camera,
    depth: jnp.ndarray,
    rgb: jnp.ndarray | None = None,
    *,
    config: FusionConfig,
    band: int | None,
):
    """One tracked frame as its own dispatch (see _tracked_step_body)."""
    return _tracked_step_body(vol, camera, depth, rgb, config, band)


@partial(jax.jit, static_argnames=("config", "band"))
def _tracked_chunk(
    vol: TSDFVolume,
    camera: Camera,
    depths: jnp.ndarray,  # (K, H, W) f32 mm; zero frames = tail padding
    rgbs: jnp.ndarray | None = None,  # (K, H, W, 3) u8 or None
    *,
    config: FusionConfig,
    band: int | None,
):
    """Scan a chunk of tracked frames in ONE dispatch.

    Returns (vol, camera, poses (K,4,4) camera->world after each frame,
    errs (K,), inls (K,)).
    """

    def body(carry, inp):
        vol, camera = carry
        if rgbs is None:
            depth, rgb = inp, None
        else:
            depth, rgb = inp
        vol, camera, err, inl = _tracked_step_body(
            vol, camera, depth, rgb, config, band
        )
        return (vol, camera), (camera.pose, err, inl)

    xs = depths if rgbs is None else (depths, rgbs)
    (vol, camera), (poses, errs, inls) = jax.lax.scan(
        body, (vol, camera), xs
    )
    return vol, camera, poses, errs, inls
