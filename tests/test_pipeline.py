"""End-to-end pipelines: GT-pose fusion and the tracked KinectFusion loop.

The tracked loop is gated on trajectory error vs ground truth
(SURVEY.md §7 stage 5), on a synthetic scene rendered from moving poses.
"""

import jax.numpy as jnp
import numpy as np

from tsdf_tpu import Camera, make_volume
from tsdf_tpu.ops.bilateral import bilateral_filter
from tsdf_tpu.ops.raycast import raycast, render_to_depth_image
from tsdf_tpu.pipelines import FusionConfig, fuse_frames, track_and_fuse_frames
from tsdf_tpu.utils import fixtures

W, H = 160, 120
FX, FY, CX, CY = 591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4


def _gt_scene():
    vol = make_volume((64, 64, 64), 2000.0, offset=(-1000.0, -1000.0, 0.0))
    wall = fixtures.wall_tsdf(vol, 1500.0)
    s1 = fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    s2 = fixtures.sphere_tsdf(vol, 220.0, centre=(-420.0, 300.0, 700.0))
    return vol.replace(
        tsdf=jnp.minimum(jnp.minimum(wall.tsdf, s1.tsdf), s2.tsdf),
        weight=jnp.ones_like(vol.weight),
    )


def _trajectory(n):
    cams = []
    for i in range(n):
        t = i / max(n - 1, 1)
        cam = (
            Camera.from_intrinsics(FX, FY, CX, CY)
            .move_to([40.0 * t, -25.0 * t, -400.0 + 30.0 * t])
            .look_at([0.0, 0.0, 1000.0])
        )
        cams.append(cam)
    return cams


def test_gt_pose_fusion_reconstructs_scene():
    scene = _gt_scene()
    cams = _trajectory(5)
    frames = [
        (render_to_depth_image(scene, c, width=W, height=H), c.pose)
        for c in cams
    ]
    vol = make_volume((64, 64, 64), 2000.0, offset=(-1000.0, -1000.0, 0.0))
    cfg = FusionConfig(width=W, height=H)
    vol, cam = fuse_frames(vol, cams[0], frames, cfg)
    # raycast the fused volume from the first pose: hits should land on
    # the original scene's surface
    v_f, _ = raycast(vol, cams[0], width=W, height=H)
    v_s, _ = raycast(scene, cams[0], width=W, height=H)
    hf = np.isfinite(np.asarray(v_f)).all(-1)
    hs = np.isfinite(np.asarray(v_s)).all(-1)
    both = hf & hs
    assert both.sum() > 0.8 * hs.sum()
    err = np.linalg.norm(np.asarray(v_f)[both] - np.asarray(v_s)[both], axis=-1)
    assert np.median(err) < 15.0  # half a voxel


def test_tracked_fusion_recovers_trajectory():
    scene = _gt_scene()
    cams = _trajectory(5)
    frames = [
        render_to_depth_image(scene, c, width=W, height=H) for c in cams
    ]
    vol = make_volume((64, 64, 64), 2000.0, offset=(-1000.0, -1000.0, 0.0))
    cfg = FusionConfig(width=W, height=H)
    vol, cam, poses, stats = track_and_fuse_frames(vol, cams[0], frames, cfg)
    # absolute trajectory error vs ground truth
    for est, c in zip(poses, cams):
        terr = np.linalg.norm(np.asarray(est)[:3, 3] - np.asarray(c.pose)[:3, 3])
        assert terr < 10.0, terr
    # quality metrics surfaced (ref: lastError/lastInliers)
    err, inl = stats[-1]
    assert float(inl) > 1000
    assert float(err) < 10.0


def test_bilateral_filter_smooths_preserves_holes():
    rng = np.random.RandomState(0)
    depth = 1000.0 + rng.randn(48, 64) * 5.0
    depth[10:20, 10:20] = 0.0  # hole
    out = np.asarray(bilateral_filter(jnp.asarray(depth, jnp.float32)))
    assert (out[10:20, 10:20] == 0).all()  # holes preserved
    inner = out[30:40, 30:40]
    assert inner.std() < depth[30:40, 30:40].std()  # smoothing
    assert abs(inner.mean() - 1000.0) < 2.0


def test_bilateral_filter_preserves_edges():
    depth = np.full((48, 64), 1000.0, np.float32)
    depth[:, 32:] = 2000.0
    out = np.asarray(bilateral_filter(jnp.asarray(depth)))
    # Gaussian similarity weight: a 1000 mm edge is fully preserved
    # (exp(-1000^2/2sigma_c^2) ~ 0) — the property projective ICP needs
    assert abs(out[24, 31] - 1000.0) < 1.0
    assert abs(out[24, 32] - 2000.0) < 1.0
    # far from the edge: untouched
    assert abs(out[24, 5] - 1000.0) < 1.0
    assert abs(out[24, 60] - 2000.0) < 1.0


def test_fuse_frames_chunked_scan_matches_per_frame():
    """The chunked lax.scan GT-pose fusion (_fuse_chunk, one
    dispatch per fuse_chunk frames) == the per-frame dispatch path."""
    import dataclasses

    from tsdf_tpu.utils import fixtures

    vol0 = make_volume((48,) * 3, 1500.0, offset=(-750.0, -750.0, 0.0))
    scene = fixtures.sphere_tsdf(vol0, 300.0, centre=(0.0, 0.0, 750.0))
    cams = [
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([10.0 * i, -5.0 * i, -200.0])
        .look_at([0.0, 0.0, 750.0])
        for i in range(5)
    ]
    frames = [
        (render_to_depth_image(scene, c, width=W, height=H), c.pose)
        for c in cams
    ]
    cfg = FusionConfig(
        volume_size=(48,) * 3, physical_size_mm=1500.0,
        offset_mm=(-750.0, -750.0, 0.0),
        width=W, height=H,
    )
    chunked, cam_a = fuse_frames(
        vol0, cams[0], frames, dataclasses.replace(cfg, fuse_chunk=2)
    )
    per_frame, cam_b = fuse_frames(
        vol0, cams[0], frames, dataclasses.replace(cfg, fuse_chunk=1)
    )
    np.testing.assert_allclose(
        np.asarray(chunked.tsdf), np.asarray(per_frame.tsdf), atol=1e-3
    )
    np.testing.assert_array_equal(
        np.asarray(chunked.weight), np.asarray(per_frame.weight)
    )
    np.testing.assert_allclose(
        np.asarray(cam_a.pose), np.asarray(cam_b.pose), atol=0
    )


def test_track_and_fuse_color_frames():
    """Tracked colour reconstruction: (depth, rgb) frames fuse colour at
    the tracked poses; tracking quality matches the depth-only loop."""
    import jax.numpy as jnp
    import numpy as np

    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.pipelines import FusionConfig, track_and_fuse_frames
    from tsdf_tpu.utils import fixtures

    W_, H_ = 160, 120
    scene = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0))
    wall = fixtures.wall_tsdf(scene, 1500.0)
    sph = fixtures.sphere_tsdf(scene, 350.0, centre=(100.0, -50.0, 900.0))
    scene = scene.replace(
        tsdf=jnp.minimum(wall.tsdf, sph.tsdf),
        weight=jnp.ones_like(scene.weight),
    )
    cams = [
        Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
        .move_to([20.0 * t, -10.0 * t, -400.0])
        .look_at([0.0, 0.0, 1000.0])
        for t in (0.0, 0.5, 1.0)
    ]

    def depth_of(c):
        verts, _ = raycast(scene, c, width=W_, height=H_)
        camz = c.world_to_camera(
            jnp.where(jnp.isfinite(verts), verts, 0.0).reshape(-1, 3)
        ).reshape(H_, W_, 3)[..., 2]
        return jnp.where(jnp.isfinite(verts).all(-1), camz, 0.0)

    rgb = jnp.full((H_, W_, 3), jnp.asarray([30, 180, 90], jnp.uint8))
    frames = [(depth_of(c), rgb) for c in cams]
    vol = make_volume(
        (64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0), with_color=True
    )
    cfg = FusionConfig(width=W_, height=H_)
    out, cam_fin, poses, stats = track_and_fuse_frames(
        vol, cams[0], frames, cfg
    )
    assert len(poses) == 3
    err, inl = stats[-1]
    assert float(err) < 5.0 and int(inl) > 1000
    # colour landed on surface-band voxels
    band = np.abs(np.asarray(out.tsdf)) < float(vol.truncation_distance)
    fused = (np.asarray(out.weight) > 0) & band
    cols = np.asarray(out.color)[fused]
    assert fused.sum() > 100
    assert (np.abs(cols.astype(np.int32) - [30, 180, 90]).max(-1) <= 1).mean() > 0.8


def test_tracking_lost_frame_not_fused_or_applied():
    """A frame with no usable depth (tracking lost even under exact
    association) must neither move the camera nor be fused — on the
    exact path too (icp_band=0), not just the banded one."""
    import jax.numpy as jnp

    scene = _gt_scene()
    cams = _trajectory(2)
    good = render_to_depth_image(scene, cams[0], width=W, height=H)
    dead = jnp.zeros((H, W), jnp.float32)  # no data at all
    vol = make_volume((64, 64, 64), 2000.0, offset=(-1000.0, -1000.0, 0.0))
    cfg = FusionConfig(
        width=W, height=H, icp_band=0,  # exact path
        icp_min_inliers_frac=0.02,
    )
    vol2, cam, poses, stats = track_and_fuse_frames(
        vol, cams[0], [good, dead], cfg
    )
    # camera stayed put
    np.testing.assert_allclose(
        np.asarray(poses[1]), np.asarray(poses[0]), atol=1e-5
    )
    # the dead frame added no weight anywhere
    w_after_first, _ = None, None
    vol1, *_ = track_and_fuse_frames(vol, cams[0], [good], cfg)
    np.testing.assert_allclose(
        np.asarray(vol2.weight), np.asarray(vol1.weight)
    )


def test_deform_volume_rejected_by_pallas_tracked_loop():
    import pytest

    vol = make_volume(
        (32,) * 3, 1000.0, offset=(-500.0, -500.0, 0.0),
        with_deformation=True,
    )
    cams = _trajectory(1)
    cfg = FusionConfig(width=W, height=H)
    with pytest.raises(ValueError, match="deformation"):
        track_and_fuse_frames(
            vol, cams[0], [np.zeros((H, W), np.float32)], cfg
        )


def test_tracked_chunked_scan_matches_per_frame():
    """The chunked tracked-fusion scan (_tracked_chunk, one
    dispatch per track_chunk frames, zero-depth tail padding) == the
    per-frame dispatch path: same fused volume, same poses, same stats.
    The 4-frame sequence with track_chunk=2 exercises a full chunk AND
    a padded tail (3 tracked frames -> chunk of 2 + chunk of 1+1 pad)."""
    import dataclasses

    scene = _gt_scene()
    cams = _trajectory(4)
    frames = [
        render_to_depth_image(scene, c, width=W, height=H) for c in cams
    ]
    vol = make_volume((64, 64, 64), 2000.0, offset=(-1000.0, -1000.0, 0.0))
    cfg = FusionConfig(width=W, height=H)
    v_c, cam_c, poses_c, stats_c = track_and_fuse_frames(
        vol, cams[0], frames, dataclasses.replace(cfg, track_chunk=2)
    )
    v_p, cam_p, poses_p, stats_p = track_and_fuse_frames(
        vol, cams[0], frames, dataclasses.replace(cfg, track_chunk=1)
    )
    assert len(poses_c) == len(poses_p) == 4
    np.testing.assert_array_equal(
        np.asarray(v_c.weight), np.asarray(v_p.weight)
    )
    np.testing.assert_allclose(
        np.asarray(v_c.tsdf), np.asarray(v_p.tsdf), atol=1e-3
    )
    # poses to f32 resolution: XLA compiles the scan body and the
    # standalone step separately, so a frame tracked inside the scan can
    # round differently in the last bit (|t| ~ 400 mm: 1 ulp = 3e-5 mm)
    np.testing.assert_allclose(
        np.asarray(cam_c.pose), np.asarray(cam_p.pose), rtol=1e-6, atol=1e-5
    )
    for pc, pp in zip(poses_c, poses_p):
        np.testing.assert_allclose(
            np.asarray(pc), np.asarray(pp), rtol=1e-6, atol=1e-5
        )
    for (ec, ic), (ep, ip) in zip(stats_c, stats_p):
        np.testing.assert_allclose(float(ec), float(ep), atol=1e-3)
        assert float(ic) == float(ip)
