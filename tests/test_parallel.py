"""Sharded ops == single-device ops on a virtual 8-CPU mesh.

The moral equivalent of the reference's MockKinect replay rig applied to
the device mesh (SURVEY.md §4): sharding logic is validated without
accelerators, gating on numeric equality with the unsharded path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsdf_tpu import Camera, integrate, make_volume, raycast
from tsdf_tpu.parallel import (
    integrate_sharded,
    make_mesh,
    raycast_sharded,
    shard_volume,
)
from tsdf_tpu.utils import fixtures


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return make_mesh(n_bricks=4, n_rays=2)


def _camera():
    cam = Camera.default_depth_camera()
    return cam.move_to([0.0, 0.0, -500.0]).look_at([0.0, 0.0, 1000.0])


def test_integrate_sharded_matches_single(mesh):
    """ops.integrate per brick == the single-device integrate."""
    vol = make_volume((32, 32, 32), 2000.0, offset=(-1000, -1000, 0))
    cam = _camera()
    depth = fixtures.sphere_depth_map(64, 48, 20.0, 800.0, 1200.0)

    ref = integrate(vol, depth, cam)
    svol = shard_volume(vol, mesh)
    out = integrate_sharded(svol, depth, cam, mesh)

    np.testing.assert_allclose(
        np.asarray(out.tsdf), np.asarray(ref.tsdf), rtol=0, atol=5e-3
    )
    np.testing.assert_array_equal(
        np.asarray(out.weight), np.asarray(ref.weight)
    )


def test_integrate_sharded_lax_path_matches_single(mesh):
    vol = make_volume((32, 32, 32), 2000.0, offset=(-1000, -1000, 0))
    cam = _camera()
    depth = fixtures.sphere_depth_map(64, 48, 20.0, 800.0, 1200.0)

    ref = integrate(vol, depth, cam)
    svol = shard_volume(vol, mesh)
    out = integrate_sharded(svol, depth, cam, mesh)

    np.testing.assert_allclose(
        np.asarray(out.tsdf), np.asarray(ref.tsdf), rtol=0, atol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(out.weight), np.asarray(ref.weight)
    )


def test_integrate_sharded_with_deformation(mesh):
    vol = make_volume(
        (32, 32, 32), 2000.0, offset=(-1000, -1000, 0),
        with_deformation=True,
    )
    cam = _camera()
    depth = fixtures.sphere_depth_map(64, 48, 20.0, 800.0, 1200.0)

    ref = integrate(vol, depth, cam)
    svol = shard_volume(vol, mesh)
    out = integrate_sharded(svol, depth, cam, mesh)
    np.testing.assert_allclose(
        np.asarray(out.tsdf), np.asarray(ref.tsdf), rtol=0, atol=1e-4
    )


def test_raycast_sharded_matches_single(mesh):
    vol = make_volume((32, 32, 32), 2000.0, offset=(-1000, -1000, 0))
    vol = fixtures.sphere_tsdf(vol, 400.0)
    cam = _camera()

    verts_ref, normals_ref = raycast(vol, cam, width=64, height=48)
    svol = shard_volume(vol, mesh)
    verts, normals = raycast_sharded(
        svol, cam, mesh, width=64, height=48,
        replicate_volume_ok=True,
    )

    np.testing.assert_allclose(
        np.asarray(verts), np.asarray(verts_ref), rtol=0, atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(normals), np.asarray(normals_ref), rtol=0, atol=1e-4
    )


def test_pose_gradient_through_sharded_integrate(mesh):
    """Pose gradients flow through the sharded integrate (the dryrun's
    training-step core): grad w.r.t. a se3 twist is finite and nonzero."""
    from tsdf_tpu.utils.se3 import se3_exp

    vol = make_volume((16, 16, 16), 2000.0, offset=(-1000, -1000, 0))
    cam = _camera()
    depth = fixtures.sphere_depth_map(32, 24, 10.0, 800.0, 1200.0)
    svol = shard_volume(vol, mesh)

    def loss(xi):
        c = cam.set_pose(se3_exp(xi) @ cam.pose)
        out = integrate_sharded(svol, depth, c, mesh)
        return jnp.sum(out.tsdf**2)

    g = jax.grad(loss)(jnp.zeros(6, jnp.float32))
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.any(np.asarray(g) != 0.0)


@pytest.mark.parametrize(
    "position",
    [
        [150.0, -100.0, -600.0],  # forward, off-axis
        [0.0, 0.0, 2600.0],  # looking back along -z
        [2600.0, 100.0, 1000.0],  # -x
        [-2600.0, 0.0, 900.0],  # +x
        [100.0, 2600.0, 1000.0],  # -y
        [0.0, -2600.0, 1100.0],  # +y
    ],
)
def test_raycast_sharded_views(mesh, position):
    """Row tiles over the mesh == the single-device raycast from any
    direction (the march is per ray, so orientation does not matter)."""
    vol = make_volume((64, 64, 64), 2000.0, offset=(-1000, -1000, 0))
    vol = fixtures.sphere_tsdf(vol, 400.0, centre=(0.0, 0.0, 1000.0))
    W, H = 160, 120
    cam = (
        Camera.from_intrinsics(591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4)
        .move_to(position)
        .look_at([0.0, 0.0, 1000.0])
    )
    verts_ref, _ = raycast(vol, cam, width=W, height=H)
    verts, _ = raycast_sharded(
        shard_volume(vol, mesh), cam, mesh, width=W, height=H,
        replicate_volume_ok=True,
    )
    vr = np.asarray(verts_ref)
    vb = np.asarray(verts)
    hit_r = np.isfinite(vr).all(-1)
    assert hit_r.sum() > 500  # the scene is actually visible
    np.testing.assert_array_equal(np.isfinite(vb).all(-1), hit_r)
    np.testing.assert_allclose(vb[hit_r], vr[hit_r], rtol=0, atol=1e-2)


def test_raycast_sharded_requires_opt_in(mesh):
    """The all_gather replicates the volume: callers must say so."""
    vol = make_volume((32, 32, 32), 2000.0, offset=(-1000, -1000, 0))
    with pytest.raises(ValueError, match="replicate_volume_ok"):
        raycast_sharded(shard_volume(vol, mesh), _camera(), mesh,
                        width=64, height=48)


def test_integrate_sharded_color_matches_single(mesh):
    """Colour fusion on the mesh (ops.integrate per brick) == the
    single-device colour integrate."""
    from tsdf_tpu import Camera, integrate, make_volume
    from tsdf_tpu.parallel.ops import integrate_sharded, shard_volume
    from tsdf_tpu.utils import fixtures

    vol = make_volume(
        (32, 32, 32), 1500.0, offset=(-750.0, -750.0, 0.0),
        with_color=True,
    )
    cam = (
        Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
        .move_to([50.0, -30.0, -300.0])
        .look_at([0.0, 0.0, 750.0])
    )
    depth = jnp.asarray(
        fixtures.sphere_depth_map(160, 120, 60.0, 600.0, 1200.0)
    )
    rng = np.random.RandomState(3)
    rgb = jnp.asarray(
        rng.randint(0, 256, size=(120, 160, 3)), jnp.uint8
    )
    ref = integrate(vol, depth, cam, rgb=rgb)

    vs = shard_volume(vol, mesh)
    got = integrate_sharded(vs, depth, cam, mesh, rgb=rgb)
    np.testing.assert_allclose(
        np.asarray(got.tsdf), np.asarray(ref.tsdf), atol=5e-3
    )
    np.testing.assert_array_equal(
        np.asarray(got.weight), np.asarray(ref.weight)
    )
    dc = np.abs(
        np.asarray(got.color, np.int32) - np.asarray(ref.color, np.int32)
    )
    assert dc.max() <= 1
