"""BASELINE config 5: brick-sharded 768^3 volume + marching-cubes export.

The per-card work of one host of a brick-sharded run (the sharded paths
— integrate_sharded / extract_surface_sharded — are checked for
equality on a virtual CPU mesh in tests/test_parallel*.py and on four
cards by ``chip_smoke.py --four``), on one card:

  1. integrate a 640x480 frame into the full 768^3 volume (ops.integrate,
     what integrate_sharded runs per brick);
  2. extract the mesh brick-by-brick exactly the way
     extract_surface_sharded does on a mesh: 8 z-bricks of 96+1 halo
     slabs, each through the chunked on-device compaction with a
     voxel_index_base / n_cube_z cut, merged on host, written as PLY.

Per-brick buffers stay O(brick), so this is the memory shape of the
multi-card path, just executed sequentially on one card.

Run: python tools/run_config5.py
Env: GRID (default 768), BRICKS (default 8).
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from tsdf_tpu import Camera, make_volume
from tsdf_tpu.ops.integrate import integrate
from tsdf_tpu.ops.marching_cubes import _extract_arrays
from tsdf_tpu.utils import fixtures
from tsdf_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

W, H = 640, 480
GRID = int(os.environ.get("GRID", "768"))
BRICKS = int(os.environ.get("BRICKS", "8"))


def sync(x):
    return jax.block_until_ready(x)


# --- part 1: integrate at 768^3 (the sharded path's per-brick work) ----
vol = make_volume((GRID,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0))
camera = (
    Camera.default_depth_camera()
    .move_to([300.0, -200.0, -500.0])
    .look_at([50.0, 80.0, 1500.0])
)
depth = jnp.asarray(fixtures.sphere_depth_map(W, H, 150.0, 1000.0, 2500.0))

fuse = jax.jit(integrate)
v = fuse(vol, depth, camera)
sync(v.weight)
iters = 5
t0 = time.time()
for _ in range(iters):
    v = fuse(v, depth, camera)
sync(v.weight)
dt_int = (time.time() - t0) / iters
print(
    f"[config5] integrate {GRID}^3: {dt_int*1e3:.1f} ms/frame = "
    f"{GRID**3/dt_int/1e9:.1f} G voxel-updates/s",
    flush=True,
)

# --- part 2: brick-wise marching cubes export --------------------------
# free part 1's state (~3.6 GB of 768^3 tsdf+weight) before
# sphere_tsdf's volume-sized temporaries
del v, vol
sphere = fixtures.sphere_tsdf(
    make_volume((GRID,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0)),
    900.0,
    centre=(0.0, 0.0, 1500.0),
)

Z, Y, X = sphere.tsdf.shape
zl = Z // BRICKS
vs = sphere.voxel_size
max_cubes, max_verts = 1 << 19, 1 << 21

jit_extract = jax.jit(
    lambda t, loff, ncz, base: _extract_arrays(
        t,
        vs,
        loff,
        max_cubes=max_cubes,
        max_vertices=max_verts,
        n_cube_z=ncz,
        voxel_index_base=base,
    ),
    static_argnames=(),
)

parts = []
t0 = time.time()
n_total = 0
for b in range(BRICKS):
    z0 = b * zl
    hi = min(z0 + zl + 1, Z)  # +1 halo slab except on the last brick
    tsdf_loc = jax.lax.slice_in_dim(sphere.tsdf, z0, hi, axis=0)
    if hi - z0 < zl + 1:  # pad the last brick to the common shape
        tsdf_loc = jnp.pad(
            tsdf_loc,
            ((0, zl + 1 - (hi - z0)), (0, 0), (0, 0)),
            constant_values=sphere.truncation_distance,
        )
    loff = sphere.offset + jnp.array([0.0, 0.0, 1.0], jnp.float32) * (
        z0 * vs[2]
    )
    ncz = jnp.int32(zl if b < BRICKS - 1 else zl - 1)
    soup = jit_extract(tsdf_loc, loff, ncz, jnp.int32(z0) * (Y * X))
    n = int(soup.n_vertices)
    assert not bool(soup.overflowed), f"brick {b} overflowed"
    # slice ON DEVICE before the device-to-host copy of the 2M-slot cap
    parts.append(np.asarray(soup.vertices[:n]))
    n_total += n
dt_mc = time.time() - t0
verts = np.concatenate(parts, axis=0)
n = len(verts) - len(verts) % 3
print(
    f"[config5] brick-wise MC at {GRID}^3 ({BRICKS} z-bricks of {zl}+1 "
    f"slabs, O(brick) memory): {n_total} vertices in {dt_mc*1e3:.0f} ms "
    f"(incl. per-brick host sync)",
    flush=True,
)

out = os.path.join(tempfile.gettempdir(), "config5_mesh.ply")
from tsdf_tpu.io.ply import write_ply

write_ply(out, verts[:n], np.arange(n, dtype=np.int32).reshape(-1, 3))
print(f"[config5] mesh written: {out} ({n} vertices)", flush=True)

# sanity: vertex radius error against the analytic sphere
r = np.linalg.norm(verts[:n] - np.array([0.0, 0.0, 1500.0]), axis=-1)
print(
    f"[config5] sphere radius error: mean {np.abs(r-900.0).mean():.2f} mm "
    f"(p95 {np.percentile(np.abs(r-900.0), 95):.2f}) at "
    f"{float(vs[0]):.1f} mm voxels",
    flush=True,
)
