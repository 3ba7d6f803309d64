"""BASELINE config 1: raycast a bundled .tsdf -> scene + normals.

The reference's `kinfu -f file` path (ref: src/Tools/kinfu.cpp:70-81):
load a saved volume, raycast it to vertex/normal maps, shade to
scene.png + normals.png — no fusion. Here: build the wall+spheres
volume at 512^3, round-trip it through the byte-compatible .tsdf format,
then time the raycast (median of k; the per-tile ray-march kernel on a
GPU) and gate the images against ``march_rays`` on the host CPU.

Run: python tools/run_config1.py [grid]
"""

import os
import sys
import tempfile
import time

import sys
sys.path.insert(0, __file__.rsplit('/', 2)[0])

import jax

from tsdf_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from tsdf_tpu import Camera, make_volume
from tsdf_tpu.io.tsdf_file import load_tsdf, save_tsdf
from tsdf_tpu.ops.raycast import raycast
from tsdf_tpu.ops.shading import normals_image, scene_image
from tsdf_tpu.utils import fixtures

GRID = int(sys.argv[1]) if len(sys.argv) > 1 else 512
W, H, K = 640, 480, 5


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

# round-trip through the reference byte format (the "bundled .tsdf")
with tempfile.TemporaryDirectory() as td:
    path = os.path.join(td, "scene.tsdf")
    save_tsdf(scene, path)
    vol = load_tsdf(path)

cam = (
    Camera.default_depth_camera()
    .move_to([80.0, -60.0, -420.0])
    .look_at([0.0, 0.0, 1500.0])
)

verts, normals = raycast(vol, cam, W, H)
sync(verts)  # warm compile

times = []
for _ in range(K):
    t0 = time.time()
    verts, normals = raycast(vol, cam, W, H)
    sync(verts)
    times.append(time.time() - t0)
dt = float(np.median(times))
rays_s = W * H / dt

scene_png = scene_image(verts, normals, cam.position)
norm_png = normals_image(normals)
sync(scene_png.astype(jnp.float32))

# image gate vs march_rays on the host CPU
cpu = jax.devices("cpu")[0]
with jax.default_device(cpu):
    v_ref, n_ref = raycast(*jax.device_put((vol, cam), cpu), width=W, height=H)
hit_p = np.isfinite(np.asarray(verts)).all(-1)
hit_r = np.isfinite(np.asarray(v_ref)).all(-1)
agree = (hit_p == hit_r).mean()
both = hit_p & hit_r
verr = np.linalg.norm(np.asarray(verts)[both] - np.asarray(v_ref)[both], axis=-1)
s_ref = np.asarray(scene_image(v_ref, n_ref, cam.position), np.float32)
s_pal = np.asarray(scene_png, np.float32)
serr = np.abs(s_pal[both] - s_ref[both])

print(
    f"[config1] raycast {GRID}^3 -> {W}x{H} scene+normals: "
    f"{dt*1e3:.1f} ms/frame (median of {K}) = {rays_s/1e6:.1f} M rays/s",
    flush=True,
)
print(
    f"[config1] vs CPU reference: hit-mask agreement {agree*100:.2f}%, "
    f"mean vertex err {verr.mean():.2f} mm (p95 {np.percentile(verr, 95):.2f}), "
    f"scene-image |d| mean {serr.mean():.2f}/255 (p99 {np.percentile(serr, 99):.0f})",
    flush=True,
)
