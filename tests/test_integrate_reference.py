"""ops.integrate against an independent NumPy per-voxel reference.

The reference follows ``integrate_kernel``'s semantics
(ref: src/TSDF/TSDFVolume.cu:308-392) in float64: project each voxel's
(deformed) centre with round(K @ (pose_inv @ c)), gate on the image, a
positive camera z, depth > 0 and sdf >= -trunc, clamp the observation at
+trunc and fold it into the running weighted mean; colour blends at the
floored rate within the truncation band. Voxels whose float64 value sits
within rounding of a decision boundary (a half-pixel, the -trunc gate,
the colour band edge) may legitimately round the other way in float32;
they are excluded, and must be rare.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tsdf_tpu import Camera, make_volume
from tsdf_tpu.ops.integrate import integrate
from tsdf_tpu.utils import fixtures

W, H = 160, 120
FX, FY, CX, CY = 147.775, 147.525, 82.75, 58.65
_EPS_PX = 2e-4  # f32 projection error at ~160 px is ~1e-5 px
_EPS_MM = 1e-3


def reference(vol, depth, cam, cap_weight=False, rgb=None):
    """float64 per-voxel integrate. Returns (tsdf, weight, color,
    ambiguous-voxel mask)."""
    d = np.asarray(vol.tsdf, np.float64)
    w = np.asarray(vol.weight, np.float64)
    if vol.deform is not None:
        centres = np.asarray(vol.deform, np.float64)
    else:
        centres = np.asarray(vol.voxel_centres(), np.float64)
    pinv = np.asarray(cam.pose_inv, np.float64)
    k = np.asarray(cam.k, np.float64)
    trunc = float(vol.truncation_distance)
    max_w = float(vol.max_weight)
    depth = np.asarray(depth, np.float64)
    h, w_img = depth.shape

    c = centres @ pinv[:3, :3].T + pinv[:3, 3]
    img = c @ k.T
    u, v = img[..., 0] / img[..., 2], img[..., 1] / img[..., 2]
    px, py = np.rint(u).astype(np.int64), np.rint(v).astype(np.int64)
    inside = (px >= 0) & (px < w_img) & (py >= 0) & (py < h)
    lin = np.clip(py, 0, h - 1) * w_img + np.clip(px, 0, w_img - 1)
    surf = depth.ravel()[lin]
    sdf = surf - c[..., 2]
    update = inside & (c[..., 2] > 0) & (surf > 0) & (sdf >= -trunc)
    new_w = w + 1.0
    new_d = (d * w + np.minimum(sdf, trunc)) / new_w
    if cap_weight:
        new_w = np.minimum(new_w, max_w)
    out_d = np.where(update, new_d, d)
    out_w = np.where(update, new_w, w)

    ambiguous = (
        (np.abs(np.abs(u - np.floor(u)) - 0.5) < _EPS_PX)
        | (np.abs(np.abs(v - np.floor(v)) - 0.5) < _EPS_PX)
        | (np.abs(sdf + trunc) < _EPS_MM)
        | (np.abs(np.abs(sdf) - trunc) < _EPS_MM)
    )
    out_c = None
    if rgb is not None:
        old = np.asarray(vol.color, np.float64)
        surf_rgb = np.asarray(rgb, np.float64).reshape(-1, 3)[lin]
        band = (update & (np.abs(sdf) < trunc))[..., None]
        rate = np.maximum(1.0 / new_w, 1.0 / max_w)[..., None]
        blended = old + rate * (surf_rgb - old)
        out_c = np.clip(np.rint(np.where(band, blended, old)), 0, 255)
        # a blend landing within rounding of .5 may round either way
        frac = np.abs(blended - np.floor(blended) - 0.5)
        ambiguous |= (band & (frac < 1e-3)).any(-1)
    return out_d, out_w, out_c, ambiguous


def _check(vol, depth, cam, cap_weight=False, rgb=None):
    got = integrate(vol, depth, cam, cap_weight=cap_weight, rgb=rgb)
    rd, rw, rc, amb = reference(vol, depth, cam, cap_weight, rgb)
    assert amb.mean() < 5e-3, amb.mean()
    ok = ~amb
    np.testing.assert_allclose(
        np.asarray(got.tsdf, np.float64)[ok], rd[ok], rtol=0,
        atol=2e-3 if got.tsdf.dtype == jnp.float32 else 0.6,
    )
    np.testing.assert_array_equal(np.asarray(got.weight)[ok], rw[ok])
    if rgb is not None:
        dc = np.abs(np.asarray(got.color, np.float64)[ok] - rc[ok])
        assert dc.max() <= 0, dc.max()
    assert (rw > np.asarray(vol.weight)).sum() > 100  # voxels were fused
    return got


def _sphere_depth(cam, radius=300.0, centre=(0.0, 0.0, 750.0)):
    """Exact camera-z depth of a sphere (0 off the sphere)."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    d_cam = np.stack(
        [(xs - CX) / FX, (ys - CY) / FY, np.ones_like(xs)], axis=-1
    )
    pose = np.asarray(cam.pose, np.float64)
    d = d_cam @ pose[:3, :3].T
    oc = pose[:3, 3] - np.asarray(centre)
    a = (d * d).sum(-1)
    b = 2 * d @ oc
    c = oc @ oc - radius * radius
    disc = b * b - 4 * a * c
    s = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
    return np.where((disc > 0) & (s > 0), s, 0.0).astype(np.float32)


def _vol(shape=(48, 48, 48), physical=1500.0, offset=(-750.0, -750.0, 0.0),
         **kw):
    return make_volume(shape, physical, offset=offset, **kw)


def _cam(pos, target=(0.0, 0.0, 750.0), roll_deg=0.0):
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY).move_to(list(pos))
        .look_at(list(target))
    )
    if roll_deg:
        t = np.deg2rad(roll_deg)
        r = np.array([[np.cos(t), -np.sin(t), 0, 0],
                      [np.sin(t), np.cos(t), 0, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        cam = cam.set_pose(cam.pose @ jnp.asarray(r))
    return cam


def _noisy(depth, seed):
    rng = np.random.default_rng(seed)
    d = depth + np.where(depth > 0, rng.normal(0, 3.0, depth.shape), 0.0)
    return d.astype(np.float32)


def _case(name):
    if name == "forward":
        cam = _cam((0.0, 0.0, -300.0))
        return _vol(), _sphere_depth(cam), cam, {}
    if name == "off_axis":
        cam = _cam((180.0, -120.0, -250.0))
        return _vol(), _sphere_depth(cam), cam, {}
    if name == "rolled_30":
        cam = _cam((60.0, 40.0, -300.0), roll_deg=30.0)
        return _vol(), _sphere_depth(cam), cam, {}
    if name == "rolled_90":
        cam = _cam((0.0, 0.0, -300.0), roll_deg=90.0)
        return _vol(), _sphere_depth(cam), cam, {}
    if name == "side_view":
        cam = _cam((-900.0, 50.0, 700.0))
        return _vol(), _sphere_depth(cam), cam, {}
    if name == "camera_inside":
        cam = _cam((0.0, 0.0, 200.0))
        return _vol(), _sphere_depth(cam), cam, {}
    if name == "non_aligned_grid":
        cam = _cam((30.0, -20.0, -300.0), target=(0.0, 0.0, 700.0))
        vol = _vol((50, 40, 30), 1500.0, offset=(-750.0, -600.0, 0.0))
        return vol, _sphere_depth(cam, 250.0, (0.0, 0.0, 700.0)), cam, {}
    if name == "noisy_depth_with_holes":
        cam = _cam((40.0, 20.0, -300.0))
        d = _noisy(_sphere_depth(cam), 1)
        d[40:60, 60:90] = 0.0
        return _vol(), d, cam, {}
    if name == "u16_depth":
        cam = _cam((0.0, 30.0, -300.0))
        d = np.round(_sphere_depth(cam)).astype(np.uint16)
        return _vol(), d, cam, {}
    if name == "prior_weights":
        cam = _cam((20.0, -10.0, -300.0))
        rng = np.random.default_rng(2)
        vol = _vol()
        vol = vol.replace(
            weight=jnp.asarray(rng.integers(0, 5, vol.weight.shape),
                               jnp.float32),
            tsdf=jnp.asarray(rng.uniform(-10, 10, vol.tsdf.shape),
                             jnp.float32),
        )
        return vol, _sphere_depth(cam), cam, {}
    if name == "weight_cap":
        cam = _cam((0.0, 0.0, -300.0))
        vol = _vol()
        vol = vol.replace(
            weight=jnp.full_like(vol.weight, float(vol.max_weight) - 0.5)
        )
        return vol, _sphere_depth(cam), cam, {"cap_weight": True}
    if name == "bf16_storage":
        cam = _cam((10.0, 10.0, -300.0))
        vol = fixtures.sphere_tsdf(_vol(), 300.0, centre=(0.0, 0.0, 750.0))
        return vol.astype(jnp.bfloat16), _sphere_depth(cam), cam, {}
    if name in ("colour", "colour_cap"):
        cam = _cam((25.0, -15.0, -300.0))
        rng = np.random.default_rng(3)
        rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        vol = _vol(with_color=True)
        vol = vol.replace(
            color=jnp.asarray(rng.integers(0, 256, vol.color.shape),
                              jnp.uint8),
            weight=jnp.full_like(vol.weight, 3.0),
        )
        kw = {"rgb": rgb, "cap_weight": name == "colour_cap"}
        return vol, _sphere_depth(cam), cam, kw
    if name == "deformed":
        cam = _cam((0.0, 0.0, -300.0))
        vol = _vol(with_deformation=True)
        zyx = np.stack(np.meshgrid(*[np.arange(48)] * 3, indexing="ij"),
                       -1).astype(np.float32)
        warp = np.stack(
            [8.0 * np.sin(zyx[..., 0] / 6.0), 5.0 * np.cos(zyx[..., 1] / 7.0),
             np.zeros_like(zyx[..., 0])], -1,
        )
        return (vol.replace(deform=vol.deform + jnp.asarray(warp)),
                _sphere_depth(cam), cam, {})
    raise KeyError(name)


CASES = [
    "forward", "off_axis", "rolled_30", "rolled_90", "side_view",
    "camera_inside", "non_aligned_grid", "noisy_depth_with_holes",
    "u16_depth", "prior_weights", "weight_cap", "bf16_storage", "colour",
    "colour_cap", "deformed",
]


@pytest.mark.parametrize("name", CASES)
def test_integrate_matches_numpy_reference(name):
    vol, depth, cam, kw = _case(name)
    _check(vol, depth, cam, **kw)


def test_several_frames_match_numpy_reference():
    """Three frames fused in sequence, each checked against the
    reference applied to the previous output."""
    vol = _vol()
    for i, pos in enumerate(
        [(0.0, 0.0, -300.0), (40.0, -30.0, -280.0), (-50.0, 20.0, -260.0)]
    ):
        cam = _cam(pos)
        vol = _check(vol, _noisy(_sphere_depth(cam), i), cam)
    assert float(jnp.max(vol.weight)) == 3.0


def test_zero_depth_frame_is_a_no_op():
    """A frame with no data changes nothing (the chunk-padding contract
    of the scan pipelines)."""
    cam = _cam((0.0, 0.0, -300.0))
    vol = fixtures.sphere_tsdf(_vol(), 300.0, centre=(0.0, 0.0, 750.0))
    out = integrate(vol, np.zeros((H, W), np.float32), cam)
    np.testing.assert_array_equal(np.asarray(out.tsdf), np.asarray(vol.tsdf))
    np.testing.assert_array_equal(
        np.asarray(out.weight), np.asarray(vol.weight)
    )
