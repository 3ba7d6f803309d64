"""Halo exchange + sharded ICP reductions on the 8-CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsdf_tpu.parallel import make_mesh
from tsdf_tpu.parallel.halo import halo_exchange_z
from tsdf_tpu.parallel.mesh import volume_sharding
from tsdf_tpu.parallel.ops import icp_step_sharded
from tsdf_tpu.tracking.icp import icp_step, normal_map, vertex_map


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_mesh(n_bricks=4, n_rays=2)


def test_halo_exchange_matches_neighbours(mesh):
    Z, Y, X = 16, 8, 8
    x = jnp.arange(Z * Y * X, dtype=jnp.float32).reshape(Z, Y, X)
    xs = jax.device_put(x, volume_sharding(mesh))
    out = np.asarray(halo_exchange_z(xs, mesh, halo=1))
    nb = 4
    zl = Z // nb
    xnp = np.asarray(x)
    for b in range(nb):
        blk = out[b * (zl + 2) : (b + 1) * (zl + 2)]
        # own slabs in the middle
        np.testing.assert_array_equal(blk[1:-1], xnp[b * zl : (b + 1) * zl])
        # halo from prev (or replicated edge at the bottom brick)
        prev = xnp[b * zl - 1] if b > 0 else xnp[0]
        np.testing.assert_array_equal(blk[0], prev)
        nxt = xnp[(b + 1) * zl] if b < nb - 1 else xnp[Z - 1]
        np.testing.assert_array_equal(blk[-1], nxt)


def test_icp_step_sharded_matches_single(mesh):
    rng = np.random.RandomState(0)
    H, W = 48, 64
    fx, fy, cx, cy = 60.0, 60.0, 32.0, 24.0
    depth_prev = 800.0 + rng.rand(H, W).astype(np.float32) * 200.0
    depth_curr = depth_prev + rng.randn(H, W).astype(np.float32) * 2.0

    vp = vertex_map(jnp.asarray(depth_prev), fx, fy, cx, cy)
    np_ = normal_map(vp)
    vc = vertex_map(jnp.asarray(depth_curr), fx, fy, cx, cy)
    nc = normal_map(vc)

    rot = jnp.eye(3, dtype=jnp.float32)
    trans = jnp.zeros(3, jnp.float32)

    a0, b0, r0, i0 = icp_step(rot, trans, vc, nc, vp, np_, fx, fy, cx, cy)
    a1, b1, r1, i1 = icp_step_sharded(
        rot, trans, vc, nc, vp, np_, (fx, fy, cx, cy), mesh
    )
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a0), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(b1), np.asarray(b0), rtol=1e-5, atol=1e-2
    )
    assert float(i1) == float(i0)
    np.testing.assert_allclose(float(r1), float(r0), rtol=1e-5)


def test_extract_surface_sharded_matches_single(mesh):
    from tsdf_tpu import make_volume
    from tsdf_tpu.ops.marching_cubes import extract_surface, soup_to_numpy
    from tsdf_tpu.parallel.ops import (
        extract_surface_sharded,
        merge_brick_soups,
        shard_volume,
    )
    from tsdf_tpu.utils import fixtures

    vol = make_volume((32, 32, 32), 1000.0, offset=(-500.0, -500.0, -500.0))
    vol = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 0.0))

    ref_soup = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
    ref_verts, _ = soup_to_numpy(ref_soup)

    svol = shard_volume(vol, mesh)
    bricks = extract_surface_sharded(
        svol, mesh, max_cubes_per_brick=1 << 12,
        max_vertices_per_brick=1 << 14,
    )
    verts, tris = merge_brick_soups(bricks)

    assert len(verts) == len(ref_verts)
    # same vertex multiset (brick order differs)
    a = np.sort(np.round(ref_verts, 3).view([("x", "f4"), ("y", "f4"), ("z", "f4")]), axis=0)
    b = np.sort(np.round(verts, 3).view([("x", "f4"), ("y", "f4"), ("z", "f4")]), axis=0)
    np.testing.assert_array_equal(a, b)


def test_update_deformation_sharded_matches_single(mesh):
    """Brick-parallel deformation update (masked extract per brick +
    corner-fold scatter with halo hand-off) == the single-device update,
    including the usage-count normalisation and correspondences."""
    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.ops.marching_cubes import extract_surface
    from tsdf_tpu.ops.raycast import render_to_depth_image
    from tsdf_tpu.parallel.ops import (
        shard_volume,
        update_deformation_sharded,
    )
    from tsdf_tpu.pipelines.scenefusion import update_deformation
    from tsdf_tpu.utils import fixtures

    W_, H_ = 160, 120
    vol = make_volume(
        (48, 48, 48), 1500.0, offset=(-750.0, -750.0, 0.0),
        with_deformation=True,
    )
    vol = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 750.0))
    cam = (
        Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
        .move_to([100.0, -50.0, -200.0])
        .look_at([0.0, 0.0, 750.0])
    )
    depth = render_to_depth_image(vol, cam, width=W_, height=H_)
    flow = jnp.broadcast_to(
        jnp.array([25.0, -5.0, 3.0], jnp.float32), (H_, W_, 3)
    )

    soup = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
    ref, n_ref = update_deformation(
        vol, soup, depth, cam, flow, scatter_free=False
    )

    vs = shard_volume(vol, mesh)
    got, n_got = update_deformation_sharded(
        vs, depth, cam, flow, mesh,
        max_cubes_per_brick=1 << 12, scatter_free=False,
    )
    assert int(n_got) == int(n_ref)
    np.testing.assert_allclose(
        np.asarray(got.deform), np.asarray(ref.deform), atol=1e-4
    )
    # surface voxels actually moved
    delta = np.asarray(got.deform - vol.deform)
    assert (np.abs(delta[..., 0]) > 1.0).sum() > 100


def test_scenefusion_frame_sharded_matches_single(mesh):
    """Full non-rigid frame on the mesh (deformation update + deformed
    integrate) == the single-device sequential chain."""
    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.ops.integrate import integrate
    from tsdf_tpu.ops.marching_cubes import extract_surface
    from tsdf_tpu.ops.raycast import render_to_depth_image
    from tsdf_tpu.parallel.ops import (
        scenefusion_frame_sharded,
        shard_volume,
    )
    from tsdf_tpu.pipelines.scenefusion import update_deformation
    from tsdf_tpu.utils import fixtures

    W_, H_ = 160, 120
    vol = make_volume(
        (48, 48, 48), 1500.0, offset=(-750.0, -750.0, 0.0),
        with_deformation=True,
    )
    vol = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 750.0))
    cam = (
        Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
        .move_to([0.0, 0.0, -200.0])
        .look_at([0.0, 0.0, 750.0])
    )
    depth = render_to_depth_image(vol, cam, width=W_, height=H_)
    flow = jnp.broadcast_to(
        jnp.array([8.0, 0.0, 0.0], jnp.float32), (H_, W_, 3)
    )

    soup = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
    mid, n_ref = update_deformation(
        vol, soup, depth, cam, flow, scatter_free=False
    )
    ref = integrate(mid, depth, cam)

    vs = shard_volume(vol, mesh)
    got, n_got = scenefusion_frame_sharded(
        vs, depth, cam, flow, mesh,
        max_cubes_per_brick=1 << 12, scatter_free=False,
    )
    assert int(n_got) == int(n_ref)
    np.testing.assert_allclose(
        np.asarray(got.deform), np.asarray(ref.deform), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.tsdf), np.asarray(ref.tsdf), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(got.weight), np.asarray(ref.weight), atol=1e-5
    )


def test_integrate_pose_sharded_gradient_matches_single(mesh):
    """Brick-parallel differentiable fusion: the psum'd 6-twist gradient
    and the fused volume == the single-device integrate_pose."""
    import jax

    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.ops.integrate_diff import integrate_pose
    from tsdf_tpu.parallel.ops import (
        integrate_pose_sharded,
        shard_volume,
    )
    from tsdf_tpu.utils import fixtures

    vol = make_volume((32, 32, 32), 1500.0, offset=(-750.0, -750.0, 0.0))
    vol = vol.replace(weight=jnp.full_like(vol.weight, 1.0))
    cam = (
        Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
        .move_to([40.0, -30.0, -300.0])
        .look_at([0.0, 0.0, 750.0])
    )
    depth = jnp.asarray(
        fixtures.sphere_depth_map(160, 120, 300.0, 600.0, 1200.0),
        jnp.float32,
    )
    rng = np.random.RandomState(4)
    gbar = jnp.asarray(rng.randn(32, 32, 32), jnp.float32)

    def loss_single(delta):
        out = integrate_pose(vol, depth, cam, delta)
        return jnp.sum(gbar * out.tsdf)

    vs = shard_volume(vol, mesh)

    def loss_sharded(delta):
        out = integrate_pose_sharded(vs, depth, cam, delta, mesh)
        return jnp.sum(gbar * out.tsdf)

    d0 = jnp.zeros(6)
    l1, g1 = jax.value_and_grad(loss_single)(d0)
    l2, g2 = jax.value_and_grad(loss_sharded)(d0)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(g2), np.asarray(g1), rtol=1e-4, atol=1e-4
    )
