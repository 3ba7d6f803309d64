"""BASELINE config 4: differentiable raycast @512^3 — pose recovery.

Perturb a ground-truth camera pose, then recover it by descending a
pixel (depth) loss through the differentiable raycast
(ops/raycast_diff.py implicit-function gradients; forward march = the
per-tile ray-march kernel on a GPU), at the full 512^3 / 640x480 size
on one card. Reports ms/grad-step and the
iterations to bring the pose translation error under 1 mm.

Run: python tools/run_config4.py [grid]
"""

import sys
import time

import sys
sys.path.insert(0, __file__.rsplit('/', 2)[0])

import jax

from tsdf_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from tsdf_tpu import Camera, make_volume
from tsdf_tpu.ops.raycast_diff import depth_image_diff
from tsdf_tpu.utils import fixtures
from tsdf_tpu.utils.se3 import se3_exp

GRID = int(sys.argv[1]) if len(sys.argv) > 1 else 512
W, H = 640, 480
ITERS = 80


def sync(x):
    return jax.block_until_ready(x)


# Several off-axis spheres + wall: a single smooth sphere before a wall
# leaves a ~2 mm depth-only pose nullspace (surfaces slide along
# themselves); the extra structure makes all 6 DoF observable.
scene = fixtures.sphere_tsdf(
    make_volume((GRID,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0)), 600.0
)
for c, r in [
    ((-700.0, -500.0, 900.0), 250.0),
    ((650.0, 400.0, 1200.0), 300.0),
    ((-300.0, 700.0, 1800.0), 350.0),
]:
    s = fixtures.sphere_tsdf(scene, r, centre=c)
    scene = scene.replace(tsdf=jnp.minimum(scene.tsdf, s.tsdf))
wall = fixtures.wall_tsdf(scene, 2500.0)
scene = scene.replace(
    tsdf=jnp.minimum(scene.tsdf, wall.tsdf),
    weight=jnp.ones_like(scene.weight),
)

cam_true = (
    Camera.default_depth_camera()
    .move_to([40.0, -30.0, -420.0])
    .look_at([0.0, 0.0, 1500.0])
)
target, _ = depth_image_diff(scene, cam_true, W, H)
sync(target)

# ~25 mm / ~0.9 deg initial offset
xi_perturb = jnp.array([0.01, -0.008, 0.005, 15.0, -12.0, 16.0])
cam0 = cam_true.set_pose(se3_exp(xi_perturb) @ cam_true.pose)


# NB: the volume and target image are jit arguments, not closure
# constants (a closed-over 512^3 grid would be embedded in the program).
# Residuals beyond the band are silhouette/disocclusion pixels whose
# depth jump is not described by the local linearization — gate them
# out (the classic TSDF-tracking residual band).
BAND_MM = 100.0


def residuals(xi, vol, target):
    c = cam0.set_pose(se3_exp(xi) @ cam0.pose)
    depth, hit = depth_image_diff(vol, c, W, H)
    m = hit & (target > 0) & (jnp.abs(depth - target) < BAND_MM)
    return jnp.where(m, depth - target, 0.0), m


@jax.jit
def gn_step(xi, lam, vol, target):
    """Levenberg-Marquardt on the banded depth residuals. jacfwd over
    the 6-dim twist costs ~one forward: the march is under
    stop_gradient, so the 6 tangent columns flow only through the
    implicit-function correction (ops/raycast_diff.py)."""
    def res_only(x):
        return residuals(x, vol, target)[0]

    r, m = residuals(xi, vol, target)
    J = jax.jacfwd(res_only)(xi)  # (H, W, 6)
    Jf = J.reshape(-1, 6)
    rf = r.reshape(-1)
    JtJ = Jf.T @ Jf
    Jtr = Jf.T @ rf
    delta = jnp.linalg.solve(
        JtJ + lam * jnp.diag(jnp.diag(JtJ)), -Jtr
    )
    n = jnp.sum(m)
    rms = jnp.sqrt(jnp.sum(rf * rf) / jnp.maximum(n, 1))
    return xi + delta, rms


xi = jnp.zeros(6, jnp.float32)
xi1, rms = gn_step(xi, jnp.float32(1e-2), scene, target)
sync(rms)  # warm compile

terr0 = float(
    np.linalg.norm(np.asarray(cam0.pose - cam_true.pose)[:3, 3])
)
print(f"[config4] initial pose offset {terr0:.1f} mm", flush=True)

recovered_at = None
lam = 1e-2
best_rms = float("inf")
t0 = time.time()
steps = 0
for i in range(ITERS):
    xi_new, rms = gn_step(xi, jnp.float32(lam), scene, target)
    steps += 1
    rms = float(rms)
    if rms <= best_rms * 1.2:  # accept (LM trust adaptation)
        xi = xi_new
        best_rms = min(best_rms, rms)
        lam = max(lam * 0.5, 1e-4)
    else:
        lam = min(lam * 8.0, 1e2)
    t_rec = se3_exp(xi) @ cam0.pose
    terr = float(np.linalg.norm(np.asarray(t_rec - cam_true.pose)[:3, 3]))
    print(
        f"[config4] iter {i}: rms {rms:.2f} mm, lam {lam:.1e}, "
        f"terr {terr:.2f} mm",
        flush=True,
    )
    if terr < 1.0 and recovered_at is None:
        recovered_at = i + 1
        break
dt = time.time() - t0
per_step = dt / steps * 1e3

print(
    f"[config4] {GRID}^3 {W}x{H}: {per_step:.0f} ms/Gauss-Newton step "
    f"(incl. per-iter host sync); pose recovered to <1 mm in "
    f"{recovered_at if recovered_at else f'>{ITERS}'} iters",
    flush=True,
)
