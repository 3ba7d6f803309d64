"""BASELINE config 3: full tracked KinectFusion, 500 frames @ 256^3.

The reference's config-3 acceptance workload (BASELINE.json) is 500
640x480 frames through the full loop — bilateral filter, projective ICP
against the raycast model, gated integrate — with trajectory error at
the end. No real TUM data is fetchable in this environment
(tools/fetch_tum.sh documents the real-data path), so the workload is a
synthetic wall+spheres scene observed from a smooth 500-pose orbit;
depth frames are rendered from the ground-truth scene so the tracker
sees realistic structure, then the estimated trajectory is scored with
the TUM ATE/RPE metrics (utils/trajectory.py) against the generating
poses.

``--noise`` applies the Kinect corruption model to every rendered frame
(u16/TUM x5000 quantization, depth-dependent Gaussian noise, IR edge
shadows, salt dropouts — utils/fixtures.py:kinect_noise) so the
tracking numbers are comparable to real-sensor conditions (round-3
verdict item 5; the reference's acceptance data is real TUM fr1,
ref: Test_TSDF_Integration.cpp:30-43).

Run: python tools/run_config3.py [n_frames] [--noise] [--eps]
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
from tsdf_tpu.ops.raycast import raycast
from tsdf_tpu.pipelines import FusionConfig, track_and_fuse_frames
from tsdf_tpu.utils import fixtures
from tsdf_tpu.utils.trajectory import ate, rpe

args = [a for a in sys.argv[1:] if not a.startswith("--")]
NOISE = "--noise" in sys.argv
N = int(args[0]) if args else 500
W, H = 640, 480
GRID = 256


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

# smooth orbit: slow sinusoidal sway, ~1.5 mm/frame peak inter-frame motion
ts = np.arange(N) / max(N - 1, 1)
cams = [
    Camera.default_depth_camera()
    .move_to([
        120.0 * np.sin(2 * np.pi * t),
        -80.0 * np.sin(4 * np.pi * t),
        -500.0 + 60.0 * np.cos(2 * np.pi * t),
    ])
    .look_at([0.0, 0.0, 1500.0])
    for t in ts
]
gt_poses = [np.asarray(c.pose) for c in cams]

print(f"[config3] rendering {N} ground-truth frames...", flush=True)
t0 = time.time()


@jax.jit
def depth_of_pose(pose):
    c = cams[0].set_pose(pose)
    verts, _ = raycast(scene, c, W, H)
    camz = c.world_to_camera(
        jnp.where(jnp.isfinite(verts), verts, 0.0).reshape(-1, 3)
    ).reshape(H, W, 3)[..., 2]
    return jnp.where(jnp.isfinite(verts).all(-1), camz, 0.0).astype(
        jnp.float32
    )


frames = [depth_of_pose(jnp.asarray(p)) for p in gt_poses]
if NOISE:
    from tsdf_tpu.utils.fixtures import kinect_noise

    corrupt = jax.jit(kinect_noise)
    key = jax.random.PRNGKey(42)
    frames = [
        corrupt(f, jax.random.fold_in(key, i))
        for i, f in enumerate(frames)
    ]
sync(frames[-1])
print(
    f"[config3] frames rendered in {time.time()-t0:.1f}s"
    f"{' (kinect noise applied)' if NOISE else ''}",
    flush=True,
)

kvol = make_volume((GRID,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0))
# --eps: ICP convergence early-exit (FusionConfig.icp_conv_eps); run
# here to pin its QUALITY on the full 500-frame workload (the 10/5/4 tail iterations are identity updates
# on converged frames, so ATE should match the fixed schedule)
EPS = 0.02 if "--eps" in sys.argv else 0.0
cfg = FusionConfig(
    width=W, height=H, use_bilateral_filter=True,
    icp_conv_eps=EPS,
)

# warm the compiles outside the timed run
v2, *_ = track_and_fuse_frames(kvol, cams[0], frames[:2], cfg)
sync(v2.weight)

print(f"[config3] tracking + fusing {N} frames...", flush=True)
t0 = time.time()
vol, cam_fin, poses, stats = track_and_fuse_frames(
    kvol, cams[0], frames, cfg
)
sync(vol.weight)
dt = time.time() - t0
per_frame = dt / N * 1e3

est = [np.asarray(p) for p in poses]
a = ate(est, gt_poses)
r = rpe(est, gt_poses, delta=1)
err, inl = stats[-1]
print(
    f"[config3] {N} frames @ {GRID}^3: {dt:.1f}s = {per_frame:.1f} ms/frame "
    f"({1e3/per_frame:.1f} fps)",
    flush=True,
)
print(
    f"[config3] ATE rmse {a['rmse']:.2f} mm (max {a['max']:.2f}); "
    f"RPE trans rmse {r['trans_rmse']:.2f} mm; final ICP residual "
    f"{float(err):.2f} mm, {int(float(inl))} inliers",
    flush=True,
)
