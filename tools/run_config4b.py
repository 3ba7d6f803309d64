#!/usr/bin/env python
"""Config-4 companion: pose recovery THROUGH the fusion operator.

run_config4.py aligns a frame by differentiating the raycast; this
runner differentiates the INTEGRATE instead (ops/integrate_diff.py:
integrate_pose — forward = ops.integrate, backward = the analytic pose
adjoint incl. the image-space term that AD cannot see through the
rounded lookup). Loss: the fused volume vs a target volume fused at the
true pose, over commonly-updated voxels.

Run: python tools/run_config4b.py
Grid via POSE_GRID (default 512).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from tsdf_tpu import Camera, make_volume
from tsdf_tpu.ops.integrate_diff import integrate_pose
from tsdf_tpu.utils import fixtures
from tsdf_tpu.utils.compile_cache import enable_compile_cache


def main():
    enable_compile_cache()
    grid = int(os.environ.get("POSE_GRID", "512"))
    W, H = 640, 480

    vol = make_volume(
        (grid,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0)
    )
    cam = (
        Camera.default_depth_camera()
        .move_to([120.0, -80.0, -500.0])
        .look_at([0.0, 0.0, 1500.0])
    )
    # 4 spheres so all 6 DoF are observable (run_config4's scene note)
    depth = np.asarray(
        fixtures.sphere_depth_map(W, H, 150.0, 1000.0, 2500.0),
        np.float32,
    )
    for cx_, cy_, r_ in ((160, 120, 90.0), (480, 120, 70.0), (480, 360, 110.0)):
        ys, xs = np.mgrid[0:H, 0:W]
        rr = (xs - cx_) ** 2 + (ys - cy_) ** 2
        bump = rr < r_ ** 2
        depth = np.where(bump, 900.0 + 0.3 * np.sqrt(rr), depth)
    depth = jnp.asarray(depth)

    target = integrate_pose(vol, depth, cam, jnp.zeros(6))

    # volumes are jit ARGUMENTS: a closed-over 512^3 grid would be
    # embedded in the program as a constant
    @jax.jit
    def _loss_and_grad(delta, vol, target, depth):
        def loss(d):
            out = integrate_pose(vol, depth, cam, d)
            m = (target.weight > 0) & (out.weight > 0)
            n = jnp.maximum(jnp.sum(m.astype(jnp.float32)), 1.0)
            return jnp.sum(
                jnp.where(m, (out.tsdf - target.tsdf) ** 2, 0.0)
            ) / n

        return jax.value_and_grad(loss)(delta)

    def loss_and_grad(delta):
        return _loss_and_grad(delta, vol, target, depth)

    true_delta = jnp.asarray(
        [0.004, -0.003, 0.002, 12.0, -9.0, 8.0], jnp.float32
    )
    delta = true_delta  # start AT the perturbation; optimize back to 0

    print(f"grid {grid}^3; initial twist |v| = "
          f"{float(jnp.linalg.norm(delta[3:])):.1f} mm, "
          f"|w| = {float(jnp.linalg.norm(delta[:3]))*1e3:.1f} mrad")
    l, g = loss_and_grad(delta)
    float(l)  # compile + sync

    # Normalized gradient steps with per-block units (mrad vs mm): the
    # gradient supplies the direction; fixed-size steps walk the bumpy
    # (discretely-masked) landscape, and the best iterate wins.
    best = (float("inf"), delta)
    for it in range(14):
        t0 = time.perf_counter()
        l, g = loss_and_grad(delta)
        lv = float(l)
        dt = time.perf_counter() - t0
        if lv < best[0]:
            best = (lv, delta)
        gw, gv = g[:3], g[3:]
        step = jnp.concatenate([
            2e-3 * gw / (jnp.linalg.norm(gw) + 1e-12),
            3.0 * gv / (jnp.linalg.norm(gv) + 1e-12),
        ])
        delta = delta - step
        print(f"iter {it}: loss {lv:9.4f}  |v| "
              f"{float(jnp.linalg.norm(delta[3:])):6.2f} mm  |w| "
              f"{float(jnp.linalg.norm(delta[:3]))*1e3:5.2f} mrad  "
              f"({dt*1e3:.0f} ms/step)")
    lv = float(loss_and_grad(delta)[0])
    if lv < best[0]:
        best = (lv, delta)
    delta = best[1]
    resid = float(jnp.linalg.norm(delta[3:]))
    print(f"best translation residual {resid:.2f} mm "
          f"(loss {best[0]:.4f}; voxel {float(vol.voxel_size[2]):.1f} mm)")


if __name__ == "__main__":
    main()
