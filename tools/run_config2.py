"""BASELINE config 2: fuse 20 frames @ 128^3 with ground-truth poses.

Synthetic stand-in for the fr1_xyz excerpt (no network egress here; see
tools/fetch_tum.sh for the real-data path): 20 depth frames of the
wall+spheres scene from a slow orbit, fused with their ground-truth
poses, then a raycast of the fused volume is compared against a raycast
of the analytic scene (image agreement = the reference's visual
acceptance, made quantitative).

Run: python tools/run_config2.py
"""

import time

import sys
sys.path.insert(0, __file__.rsplit('/', 2)[0])

import jax

from tsdf_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from tsdf_tpu import Camera, make_volume
from tsdf_tpu.ops.raycast import raycast
from tsdf_tpu.pipelines import FusionConfig, fuse_frames
from tsdf_tpu.utils import fixtures

W, H, GRID, N = 640, 480, 128, 20


def sync(x):
    return jax.block_until_ready(x)


scene = fixtures.sphere_tsdf(
    make_volume((GRID,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0)), 600.0
)
wall = fixtures.wall_tsdf(scene, 2500.0)
scene = scene.replace(
    tsdf=jnp.minimum(scene.tsdf, wall.tsdf),
    weight=jnp.ones_like(scene.weight),
)
cams = [
    Camera.default_depth_camera()
    .move_to([30.0 * t / (N - 1), -20.0 * t / (N - 1), -500.0])
    .look_at([0.0, 0.0, 1500.0])
    for t in range(N)
]


def depth_of(c):
    verts, _ = raycast(scene, c, W, H)
    camz = c.world_to_camera(
        jnp.where(jnp.isfinite(verts), verts, 0.0).reshape(-1, 3)
    ).reshape(H, W, 3)[..., 2]
    return jnp.where(jnp.isfinite(verts).all(-1), camz, 0.0).astype(
        jnp.float32
    )


frames = [depth_of(c) for c in cams]
sync(frames[-1])

vol = make_volume((GRID,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0))
cfg = FusionConfig(width=W, height=H)

pairs = list(zip(frames, [jnp.asarray(c.pose) for c in cams]))
v2, _ = fuse_frames(vol, cams[0], pairs[:2], cfg)
sync(v2.weight)  # warm compiles

t0 = time.time()
fused, _ = fuse_frames(vol, cams[0], pairs, cfg)
sync(fused.weight)
dt = time.time() - t0
upd_s = N * GRID**3 / dt

# image agreement: raycast the fused volume vs the analytic scene
ray_cam = cams[0]
v_f, _ = raycast(fused, ray_cam, W, H)
v_s, _ = raycast(scene, ray_cam, W, H)
hit_f = np.isfinite(np.asarray(v_f)).all(-1)
hit_s = np.isfinite(np.asarray(v_s)).all(-1)
agree = (hit_f == hit_s).mean()
both = hit_f & hit_s
verr = np.linalg.norm(
    np.asarray(v_f)[both] - np.asarray(v_s)[both], axis=-1
)
print(
    f"[config2] {N} frames @ {GRID}^3 GT poses: {dt*1e3:.0f} ms total = "
    f"{dt/N*1e3:.1f} ms/frame, {upd_s/1e9:.1f} G voxel-updates/s",
    flush=True,
)
print(
    f"[config2] raycast image agreement vs analytic scene: "
    f"{agree*100:.2f}% hit-mask match, mean vertex error "
    f"{verr.mean():.2f} mm (p95 {np.percentile(verr, 95):.2f})",
    flush=True,
)
