"""Sharded checkpoint round trip on the 8-CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsdf_tpu import make_volume
from tsdf_tpu.parallel import make_mesh, shard_volume
from tsdf_tpu.utils.checkpoint import load_sharded, save_sharded
from tsdf_tpu.utils import fixtures


def test_sharded_roundtrip(tmp_path):
    mesh = make_mesh(n_bricks=4, n_rays=2)
    vol = make_volume((16, 16, 16), 1000.0, offset=(0.0, 0.0, 0.0))
    vol = fixtures.sphere_tsdf(vol, 300.0)
    svol = shard_volume(vol, mesh)

    path = tmp_path / "ckpt"
    save_sharded(svol, str(path))

    like = shard_volume(
        make_volume((16, 16, 16), 1000.0, offset=(0.0, 0.0, 0.0)), mesh
    )
    out = load_sharded(str(path), like)
    np.testing.assert_array_equal(np.asarray(out.tsdf), np.asarray(vol.tsdf))
    np.testing.assert_array_equal(
        np.asarray(out.weight), np.asarray(vol.weight)
    )
    # restored with the mesh sharding
    assert out.tsdf.sharding.spec == svol.tsdf.sharding.spec


def test_sharded_roundtrip_with_deformation_and_bf16(tmp_path):
    """Checkpoint all optional fields + non-f32 storage; restore onto a
    different mesh factorization (resharding on load)."""
    mesh = make_mesh(n_bricks=4, n_rays=2)
    vol = make_volume(
        (16, 16, 16), 1000.0, offset=(0.0, 0.0, 0.0),
        with_deformation=True, with_color=True,
    ).astype(jnp.bfloat16)
    vol = vol.replace(
        color=(jnp.ones_like(vol.color) * 7),
        deform=vol.deform + 3.0,
    )
    svol = shard_volume(vol, mesh)
    path = tmp_path / "ckpt2"
    save_sharded(svol, str(path))

    mesh2 = make_mesh(n_bricks=2, n_rays=4)
    like = shard_volume(
        make_volume(
            (16, 16, 16), 1000.0, offset=(0.0, 0.0, 0.0),
            with_deformation=True, with_color=True,
        ).astype(jnp.bfloat16),
        mesh2,
    )
    out = load_sharded(str(path), like)
    assert out.tsdf.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(out.deform), np.asarray(vol.deform)
    )
    np.testing.assert_array_equal(
        np.asarray(out.color), np.asarray(vol.color)
    )


def test_checkpoint_resume_mid_fusion(tmp_path):
    """Fuse 2 frames, checkpoint, restore, fuse 2 more == fusing 4
    straight (the fail-fast + restart story, SURVEY §5)."""
    from tsdf_tpu import Camera, integrate
    from tsdf_tpu.parallel import integrate_sharded

    mesh = make_mesh(n_bricks=4, n_rays=2)
    cam = (
        Camera.default_depth_camera()
        .move_to([0.0, 0.0, -500.0])
        .look_at([0.0, 0.0, 1000.0])
    )
    depth = fixtures.sphere_depth_map(64, 48, 20.0, 800.0, 1200.0)
    vol0 = make_volume((32, 32, 32), 2000.0, offset=(-1000, -1000, 0))

    ref = vol0
    for _ in range(4):
        ref = integrate(ref, depth, cam)

    svol = shard_volume(vol0, mesh)
    for _ in range(2):
        svol = integrate_sharded(svol, depth, cam, mesh)
    save_sharded(svol, str(tmp_path / "mid"))
    restored = load_sharded(
        str(tmp_path / "mid"), shard_volume(vol0, mesh)
    )
    for _ in range(2):
        restored = integrate_sharded(
            restored, depth, cam, mesh
        )
    np.testing.assert_allclose(
        np.asarray(restored.tsdf), np.asarray(ref.tsdf), rtol=0, atol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(restored.weight), np.asarray(ref.weight)
    )
