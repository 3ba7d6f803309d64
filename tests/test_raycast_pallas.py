"""The per-tile Triton ray march (interpret mode) vs the plain-JAX
``march_rays`` reference that ``raycast`` runs on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest

from tsdf_tpu import Camera, make_volume, raycast
from tsdf_tpu.kernels.raymarch import march_image_tiled
from tsdf_tpu.ops.raycast import compute_normals_from_vertices, ray_directions
from tsdf_tpu.utils import fixtures


def raycast_pallas(vol, cam, width, height, interpret=True):
    """(vertices, normals) from the kernel, like ops.raycast."""
    verts = march_image_tiled(
        vol, cam.position, ray_directions(cam, width, height),
        interpret=interpret,
    )
    return verts, compute_normals_from_vertices(verts)

W, H = 160, 120
FX, FY, CX, CY = 591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4


def _vol():
    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0))
    return fixtures.sphere_tsdf(vol, 400.0)


def _check(vol, cam, min_agree=0.999):
    vr, nr = raycast(vol, cam, width=W, height=H)
    vp, npm = raycast_pallas(vol, cam, width=W, height=H, interpret=True)
    vr, vp = np.asarray(vr), np.asarray(vp)
    hr = np.isfinite(vr).all(-1)
    hp = np.isfinite(vp).all(-1)
    # grazing rays at silhouettes may differ between sampling schemes
    assert (hr == hp).mean() >= min_agree
    both = hr & hp
    err = np.linalg.norm(vr[both] - vp[both], axis=-1)
    assert np.median(err) < 1.0, np.median(err)
    assert np.percentile(err, 99) < 5.0
    # normals agree away from boundaries
    dot = (np.asarray(nr)[both] * np.asarray(npm)[both]).sum(-1)
    assert np.median(dot) > 0.999


def test_forward_camera():
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([150.0, -100.0, -600.0])
        .look_at([0.0, 0.0, 1000.0])
    )
    _check(_vol(), cam)


def test_reversed_sweep():
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, 2600.0])
        .look_at([0.0, 0.0, 1000.0])
    )
    _check(_vol(), cam)


def test_camera_inside_volume():
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, 100.0])
        .look_at([0.0, 0.0, 1000.0])
    )
    _check(_vol(), cam)


def test_nonaligned_grid():
    vol = make_volume((50, 40, 30), 1500.0, offset=(-750.0, -600.0, 0.0))
    vol = fixtures.sphere_tsdf(vol, 250.0, centre=(0.0, 0.0, 700.0))
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, -300.0])
        .look_at([0.0, 0.0, 700.0])
    )
    vr, _ = raycast(vol, cam, width=W, height=H)
    vp, _ = raycast_pallas(vol, cam, width=W, height=H, interpret=True)
    hr = np.isfinite(np.asarray(vr)).all(-1)
    hp = np.isfinite(np.asarray(vp)).all(-1)
    assert (hr == hp).mean() > 0.995  # grid-boundary pixels may differ
    both = hr & hp
    err = np.linalg.norm(np.asarray(vr)[both] - np.asarray(vp)[both], axis=-1)
    assert np.median(err) < 2.0


def test_all_principal_view_axes():
    """All six axis-aligned-ish views agree with the reference."""
    vol = make_volume((64, 48, 56), 2000.0, offset=(-1000.0, -1000.0, -1000.0))
    vol = fixtures.sphere_tsdf(vol, 350.0, centre=(0.0, 0.0, 0.0))
    views = [
        [100.0, -50.0, -1600.0],
        [0.0, 80.0, 1600.0],
        [-1600.0, 50.0, 100.0],
        [1600.0, -80.0, 0.0],
        [100.0, -1600.0, 50.0],
        [0.0, 1600.0, -100.0],
    ]
    for pos in views:
        cam = (
            Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
            .move_to(pos)
            .look_at([0.0, 0.0, 0.0])
        )
        vr, _ = raycast(vol, cam, width=W, height=H)
        vp, _ = raycast_pallas(vol, cam, width=W, height=H, interpret=True)
        hr = np.isfinite(np.asarray(vr)).all(-1)
        hp = np.isfinite(np.asarray(vp)).all(-1)
        assert (hr == hp).mean() > 0.999, pos
        b = hr & hp
        e = np.linalg.norm(np.asarray(vr)[b] - np.asarray(vp)[b], axis=-1)
        assert np.median(e) < 2.0, pos


def test_raycast_pallas_bf16_volume():
    vol = _vol()
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, -500.0])
        .look_at([0.0, 0.0, 1000.0])
    )
    v32, _ = raycast_pallas(vol, cam, width=W, height=H, interpret=True)
    v16, _ = raycast_pallas(
        vol.astype(jnp.bfloat16), cam, width=W, height=H, interpret=True
    )
    hit32 = np.isfinite(np.asarray(v32)).all(-1)
    hit16 = np.isfinite(np.asarray(v16)).all(-1)
    assert (hit32 == hit16).mean() > 0.99
    both = hit32 & hit16
    err = np.linalg.norm(np.asarray(v32)[both] - np.asarray(v16)[both], axis=-1)
    assert np.median(err) < 5.0  # mm; bf16 tsdf quantization


def test_empty_volume_all_misses():
    """A cleared volume (+trunc everywhere) must report all misses."""
    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0))
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, -500.0])
        .look_at([0.0, 0.0, 1000.0])
    )
    vp, _ = raycast_pallas(vol, cam, width=W, height=H, interpret=True)
    assert not np.isfinite(np.asarray(vp)).any()


def test_crossing_at_brick_boundary():
    """Wall plane 4 voxels into the volume: the TSDF is linear in z
    inside the truncation band, so the secant lands on the plane."""
    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0))
    vs = float(vol.voxel_size[2])
    # wall plane just past the slab-3/slab-4 brick boundary (zl=4)
    depth = 0.0 + 4.0 * vs  # off_z + 4 voxels
    vol = fixtures.wall_tsdf(vol, depth)
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, -800.0])
        .look_at([0.0, 0.0, 1000.0])
    )
    vr, _ = raycast(vol, cam, width=W, height=H)
    vp, _ = raycast_pallas(vol, cam, width=W, height=H, interpret=True)
    hp = np.isfinite(np.asarray(vp)).all(-1)
    assert hp.mean() > 0.5  # the wall fills the central view
    # wall TSDF is linear in z inside the truncation band: the secant
    # lands exactly on the plane
    zhit = np.asarray(vp)[hp][:, 2]
    assert np.abs(zhit - depth).max() < 0.1, np.abs(zhit - depth).max()
    # and agrees with the lax reference path
    hr = np.isfinite(np.asarray(vr)).all(-1)
    both = hr & hp
    err = np.linalg.norm(np.asarray(vr)[both] - np.asarray(vp)[both], axis=-1)
    assert np.median(err) < 0.5


def test_geometry_behind_camera_inside_volume():
    """Camera inside the volume between two spheres, looking at the far
    one: the ray starts at the camera (near t clamped to 0), so geometry
    behind it is never sampled."""
    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0))
    centres = vol.voxel_centres()
    trunc = vol.truncation_distance
    da = jnp.linalg.norm(
        centres - jnp.array([0.0, 0.0, 400.0]), axis=-1
    ) - 250.0
    db = jnp.linalg.norm(
        centres - jnp.array([0.0, 0.0, 1500.0]), axis=-1
    ) - 250.0
    dist = jnp.clip(jnp.minimum(da, db), -trunc, trunc)
    vol = vol.replace(tsdf=dist, weight=jnp.ones_like(vol.weight))
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, 850.0])
        .look_at([0.0, 0.0, 1500.0])
    )
    vr, _ = raycast(vol, cam, width=W, height=H)
    vp, _ = raycast_pallas(vol, cam, width=W, height=H, interpret=True)
    hr = np.isfinite(np.asarray(vr)).all(-1)
    hp = np.isfinite(np.asarray(vp)).all(-1)
    assert hp.mean() > 0.1  # the far sphere is visible and hit
    assert (hr == hp).mean() > 0.999
    both = hr & hp
    err = np.linalg.norm(np.asarray(vr)[both] - np.asarray(vp)[both], axis=-1)
    assert np.median(err) < 1.0
    # every hit is on the FAR sphere (z > camera), none behind
    assert (np.asarray(vp)[hp][:, 2] > 850.0).all()


def test_empty_run_jump_sparse_scene():
    """Thin walls near both ends of the volume with a long empty run
    between them: rays through the window in the near wall must reach
    the far one, looking forward AND backward."""
    vol = make_volume((64,) * 3, 2000.0, offset=(-1000.0, -1000.0, 0.0))
    # THIN slab walls (negative only inside a bounded band) near z=150
    # and z=1900, positive everywhere else — unlike the half-space
    # wall_tsdf fixture, both sweep directions see well-posed surfaces
    tr = float(vol.truncation_distance)
    vs = float(vol.voxel_size[2])
    zc = (np.arange(64, dtype=np.float32) + 0.5) * vs
    band = 2.5 * vs

    def slab(depth):
        return np.clip(np.abs(zc - depth) - band, -tr, tr)

    t = np.minimum(slab(150.0), slab(1900.0))[:, None, None]
    t = np.broadcast_to(t, (64, 64, 64)).copy()
    t[:, 28:36, 28:36] = np.broadcast_to(
        slab(1900.0)[:, None, None], (64, 8, 8)
    )  # small window through the NEAR wall only (frustum-interior)
    sparse = vol.replace(
        tsdf=jnp.asarray(t),
        weight=jnp.ones_like(vol.weight),
    )
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, -400.0])
        .look_at([0.0, 0.0, 1000.0])
    )
    _check(sparse, cam, min_agree=0.97)
    # hits must exist on BOTH walls (window rays reach the far wall)
    vp, _ = raycast_pallas(sparse, cam, width=W, height=H, interpret=True)
    z = np.asarray(vp)[..., 2]
    finite = np.isfinite(z)
    assert (z[finite] < 500.0).any() and (z[finite] > 1500.0).any()
    # reversed sweep over the same sparse scene
    cam_r = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, 2400.0])
        .look_at([0.0, 0.0, -1000.0])
    )
    _check(sparse, cam_r, min_agree=0.97)
