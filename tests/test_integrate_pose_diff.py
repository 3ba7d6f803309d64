"""Differentiable fusion w.r.t. pose: the integrate_pose custom_vjp vs
the analytic reference (pose_gradient_lax), jax.grad and finite
differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsdf_tpu import Camera, make_volume
from tsdf_tpu.ops.integrate import integrate
from tsdf_tpu.ops.integrate_diff import integrate_pose, pose_gradient_lax
from tsdf_tpu.utils import fixtures
from tsdf_tpu.utils.se3 import se3_exp

W, H = 160, 120


def _setup():
    vol = make_volume((48,) * 3, 1500.0, offset=(-750.0, -750.0, 0.0))
    vol = vol.replace(weight=jnp.full_like(vol.weight, 2.0))
    cam = (
        Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
        .move_to([40.0, -30.0, -300.0])
        .look_at([0.0, 0.0, 750.0])
    )
    depth = jnp.asarray(
        fixtures.sphere_depth_map(W, H, 300.0, 600.0, 1200.0), jnp.float32
    )
    rng = np.random.default_rng(1)
    gbar = jnp.asarray(rng.normal(size=vol.tsdf.shape), jnp.float32)
    return vol, cam, depth, gbar


def test_analytic_matches_ad_without_image_term():
    """image_term=False == jax.grad through the lax integrate (which is
    blind to the image term: round() has zero gradient)."""
    vol, cam, depth, gbar = _setup()

    def loss(delta):
        c = cam.set_pose(se3_exp(delta) @ cam.pose)
        return jnp.sum(gbar * integrate(vol, depth, c).tsdf)

    g_ad = np.asarray(jax.grad(loss)(jnp.zeros(6)))
    g_an = np.asarray(
        pose_gradient_lax(vol, depth, cam, gbar, image_term=False)
    )
    np.testing.assert_allclose(g_an, g_ad, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("image_term", [False, True])
def test_kernel_adjoint_matches_lax(image_term):
    """The integrate_pose adjoint == the analytic gradient, both terms."""
    vol, cam, depth, gbar = _setup()

    def loss(delta):
        out = integrate_pose(
            vol, depth, cam, delta, image_term=image_term
        )
        return jnp.sum(gbar * out.tsdf)

    g_k = np.asarray(jax.grad(loss)(jnp.zeros(6)))
    g_l = np.asarray(
        pose_gradient_lax(vol, depth, cam, gbar, image_term=image_term)
    )
    np.testing.assert_allclose(g_k, g_l, rtol=2e-4, atol=2e-3)


def test_volume_cotangents_match_ad():
    """d loss/d (tsdf_in, weight_in) through integrate_pose == jax.grad
    of the lax integrate (chained-fusion correctness)."""
    vol, cam, depth, gbar = _setup()
    # make the weight vary so the d/dw term is non-trivial
    rng = np.random.default_rng(2)
    vol = vol.replace(
        weight=jnp.asarray(
            rng.uniform(0.0, 5.0, size=vol.weight.shape), jnp.float32
        ),
        tsdf=jnp.asarray(
            rng.normal(size=vol.tsdf.shape), jnp.float32
        ) * 10.0,
    )

    def loss_lax(t, w):
        out = integrate(vol.replace(tsdf=t, weight=w), depth, cam)
        return jnp.sum(gbar * out.tsdf) + jnp.sum(0.3 * out.weight)

    def loss_pose(t, w):
        out = integrate_pose(
            vol.replace(tsdf=t, weight=w), depth, cam, jnp.zeros(6)
        )
        return jnp.sum(gbar * out.tsdf) + jnp.sum(0.3 * out.weight)

    gt_l, gw_l = jax.grad(loss_lax, argnums=(0, 1))(vol.tsdf, vol.weight)
    gt_k, gw_k = jax.grad(loss_pose, argnums=(0, 1))(vol.tsdf, vol.weight)
    np.testing.assert_allclose(
        np.asarray(gt_k), np.asarray(gt_l), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(gw_k), np.asarray(gw_l), rtol=1e-4, atol=1e-4
    )


def test_pose_recovery_descent():
    """Fusing at a perturbed pose vs a target fused at truth: gradient
    steps on the twist reduce the pose error (the image term supplies
    the tangential signal)."""
    vol, cam, depth, _ = _setup()
    vol = vol.replace(weight=jnp.zeros_like(vol.weight))
    target = integrate_pose(
        vol, depth, cam, jnp.zeros(6)
    )

    true_delta = jnp.asarray([0.004, -0.003, 0.002, 8.0, -6.0, 5.0])

    def loss(delta):
        out = integrate_pose(vol, depth, cam, delta)
        m = (target.weight > 0) & (out.weight > 0)
        return jnp.sum(jnp.where(m, (out.tsdf - target.tsdf) ** 2, 0.0))

    delta = true_delta
    l0 = float(loss(delta))
    g = jax.grad(loss)(delta)
    # scale-aware step per block (rotation vs translation units)
    step = jnp.concatenate(
        [
            1e-2 / (jnp.linalg.norm(g[:3]) + 1e-9) * g[:3],
            4.0 / (jnp.linalg.norm(g[3:]) + 1e-9) * g[3:],
        ]
    )
    l1 = float(loss(delta - step))
    assert l1 < l0, (l0, l1)


def test_gradient_exact_at_nonzero_delta():
    """jax.grad through integrate_pose must be exact at ANY delta (the
    pose_inv-matrix cotangent chains through se3_exp/inv by AD) — not
    just at 0 (review finding: the former twist-projection VJP was
    20-190% off at nonzero delta, with sign flips)."""
    vol, cam, depth, gbar = _setup()
    delta0 = jnp.asarray(
        [0.05, -0.04, 0.06, 12.0, -9.0, 8.0], jnp.float32
    )

    def loss_lax(delta):
        c = cam.set_pose(se3_exp(delta) @ cam.pose)
        return jnp.sum(gbar * integrate(vol, depth, c).tsdf)

    def loss_pose(delta):
        out = integrate_pose(
            vol, depth, cam, delta, image_term=False
        )
        return jnp.sum(gbar * out.tsdf)

    g_true = np.asarray(jax.grad(loss_lax)(delta0))
    g_kern = np.asarray(jax.grad(loss_pose)(delta0))
    np.testing.assert_allclose(g_kern, g_true, rtol=1e-3, atol=1e-3)


def test_weight_cotangent_at_cap_tie():
    """cap_weight=True: the weight adjoint at the new_w == max_weight
    tie must match jnp.minimum's 0.5 subgradient (weights step by 1, so
    EVERY voxel hits the tie on the frame it reaches the cap)."""
    vol, cam, depth, _ = _setup()
    vol = vol.replace(
        weight=jnp.full_like(vol.weight, float(vol.max_weight) - 1.0)
    )

    def loss_lax(w):
        out = integrate(
            vol.replace(weight=w), depth, cam, cap_weight=True
        )
        return jnp.sum(out.weight)

    def loss_pose(w):
        out = integrate_pose(
            vol.replace(weight=w), depth, cam, jnp.zeros(6),
            cap_weight=True
        )
        return jnp.sum(out.weight)

    g_l = np.asarray(jax.grad(loss_lax)(vol.weight))
    g_k = np.asarray(jax.grad(loss_pose)(vol.weight))
    np.testing.assert_allclose(g_k, g_l, atol=1e-6)
    assert (g_l == 0.5).any()  # the tie is actually exercised


def test_sharded_pose_diff_rejects_deformed():
    """integrate_pose_sharded must refuse deformed volumes (the adjoint
    is computed at lattice centres; a silent wrong gradient otherwise)."""
    import jax as _jax

    if len(_jax.devices()) < 2:
        pytest.skip("needs the CPU mesh")
    from tsdf_tpu.parallel import make_mesh
    from tsdf_tpu.parallel.ops import integrate_pose_sharded, shard_volume

    mesh = make_mesh(n_bricks=2, n_rays=1, devices=_jax.devices()[:2])
    vol = make_volume(
        (16,) * 3, 1000.0, offset=(0.0, 0.0, 0.0), with_deformation=True
    )
    vs = shard_volume(vol, mesh)
    depth = jnp.full((24, 32), 500.0, jnp.float32)
    cam = Camera.from_intrinsics(30.0, 30.0, 16.0, 12.0)
    with pytest.raises(ValueError, match="rigid"):
        integrate_pose_sharded(vs, depth, cam, jnp.zeros(6), mesh)


def test_passthrough_cotangents_flow():
    """Fields the fusion returns unchanged (offset, trunc, max_weight,
    ...) must pass their output cotangent through — a loss reading them
    off the fused volume gets the identity gradient, not silent zero."""
    vol, cam, depth, _gbar = _setup()

    def loss(v):
        out = integrate_pose(
            vol.replace(truncation_distance=v), depth, cam,
            jnp.zeros(6)
        )
        return 2.0 * out.truncation_distance

    g = jax.grad(loss)(vol.truncation_distance)
    np.testing.assert_allclose(float(g), 2.0)


def _fd_setup():
    """Smooth fixture for finite differences: a wide truncation band so
    a small pose step changes the update set of few voxels."""
    vol = make_volume(
        (32,) * 3, 1500.0, offset=(-750.0, -750.0, 0.0),
        truncation_distance=200.0,
    )
    vol = vol.replace(weight=jnp.full_like(vol.weight, 2.0))
    cam = (
        Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
        .move_to([40.0, -30.0, -300.0])
        .look_at([0.0, 0.0, 750.0])
    )
    depth = jnp.full((H, W), 900.0, jnp.float32)  # a fronto-parallel plane
    # weight only voxels whose update is smooth in the pose: inside the
    # band (|sdf| < trunc, no clamp) and away from the frustum's edges,
    # with margins no step below can cross
    from tsdf_tpu.ops.integrate import camera_coords

    xc, yc, zc = (np.asarray(a) for a in camera_coords(vol, cam.pose_inv))
    k = np.asarray(cam.k)
    px = k[0, 0] * xc / zc + k[0, 2]
    py = k[1, 1] * yc / zc + k[1, 2]
    smooth = (
        (zc > 750.0) & (zc < 1050.0)
        & (px > 10) & (px < W - 10) & (py > 10) & (py < H - 10)
    )
    rng = np.random.default_rng(7)
    gbar = jnp.asarray(
        np.where(smooth, rng.uniform(0.5, 1.5, size=smooth.shape), 0.0),
        jnp.float32,
    )
    return vol, cam, depth, gbar


@pytest.mark.parametrize("j", [2, 3, 4, 5])
def test_custom_vjp_matches_finite_differences(j):
    """jax.grad through integrate_pose (image term off: a constant-depth
    wall has no image gradient) vs central differences of the forward,
    per twist component: rotation about z and the three translations."""
    vol, cam, depth, gbar = _fd_setup()

    base = integrate_pose(vol, depth, cam, jnp.zeros(6)).tsdf

    def loss(delta):
        # minus the (constant) base: the f32 sum then resolves the step
        out = integrate_pose(vol, depth, cam, delta, image_term=False)
        return jnp.sum(gbar * (out.tsdf - base))

    g = float(jax.grad(loss)(jnp.zeros(6))[j])
    h = 2e-3 if j < 3 else 1.0  # rad / mm
    e = jnp.zeros(6).at[j].set(h)
    fd = (float(loss(e)) - float(loss(-e))) / (2 * h)
    assert abs(g) > 1.0
    np.testing.assert_allclose(g, fd, rtol=2e-2)
