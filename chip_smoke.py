#!/usr/bin/env python
"""Smoke test of the system's main path on one NVIDIA GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the --devices mesh path only

One process drives the normal entry points (``tsdf_tpu.cli.main``, the
pipelines, the ops) at the published KinectFusion setting, 512^3 voxels
over 3 m and 640x480 depth:

  1. device: the default device must be a GPU (no CPU fallback);
  2. tracked KinectFusion through ``fuse --track --filter`` on a
     synthetic TUM sequence (wall + sphere, known trajectory, Kinect
     noise), checked by ATE against that trajectory and a non-empty mesh;
  3. GT-pose fusion, render and mesh export through ``fuse``;
  4. equality on the card: the GPU ray march and integrate against the
     same ops on the host CPU backend of this process;
  5. SceneFusion through ``sfusion`` at 255^3 on a fabricated RGBD +
     PD-Flow dataset;
  6. differentiable pose step: ``jax.grad`` through ``integrate_pose``
     against the analytic ``pose_gradient_lax`` at 512^3.

Any failed phase fails the run. The last line of standard output is one
JSON object naming the device; it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

GRID = 512
PHYSICAL_MM = 3000.0
W, H = 640, 480
FX, FY, CX, CY = 591.1, 590.1, 331.0, 234.6  # the CLI's default camera
N_FRAMES = 8
WALL_Z = 2400.0
SPHERE_C = np.array([100.0, -50.0, 1500.0])
SPHERE_R = 400.0
SF_GRID = 256  # the sharded SceneFusion comparison (divides four bricks)
ATE_BOUND_MM = 5.0  # synthetic noise at 1.5-2.4 m is ~3-8 mm per pixel


def _log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


# --------------------------------------------------------------- scenes --


def trajectory(n: int = N_FRAMES) -> list[np.ndarray]:
    """Camera->world poses (mm): a slow sideways pan looking at the
    sphere, 6 mm and ~0.2 degrees per frame."""
    from tsdf_tpu import Camera

    poses = []
    for i in range(n):
        cam = (
            Camera.default_depth_camera()
            .move_to([-20.0 + 6.0 * i, 10.0 - 2.0 * i, 200.0])
            .look_at([40.0 + 2.0 * i, -30.0, 1500.0])
        )
        poses.append(np.asarray(cam.pose, np.float64))
    return poses


def analytic_depth(pose: np.ndarray, wall_z: float = WALL_Z,
                   sphere_c=SPHERE_C, sphere_r: float = SPHERE_R,
                   width: int = W, height: int = H) -> np.ndarray:
    """(H, W) f32 camera-z depth in mm of a wall plane z = wall_z plus a
    sphere, by exact ray intersection (0 where nothing is hit)."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    d_cam = np.stack(
        [(xs - CX) / FX, (ys - CY) / FY, np.ones_like(xs)], axis=-1
    )
    r, o = pose[:3, :3], pose[:3, 3]
    d = d_cam @ r.T  # world direction with camera-z component 1
    with np.errstate(divide="ignore", invalid="ignore"):
        s_wall = (wall_z - o[2]) / d[..., 2]
    s_wall = np.where(np.isfinite(s_wall) & (s_wall > 0), s_wall, np.inf)
    oc = o - np.asarray(sphere_c, np.float64)
    a = (d * d).sum(-1)
    b = 2.0 * (d @ oc)
    c = oc @ oc - sphere_r * sphere_r
    disc = b * b - 4 * a * c
    s_sph = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
    s_sph = np.where((disc > 0) & (s_sph > 0), s_sph, np.inf)
    s = np.minimum(s_wall, s_sph)
    return np.where(np.isfinite(s), s, 0.0).astype(np.float32)


def _quat(r: np.ndarray):
    """Rotation matrix -> (qx, qy, qz, qw), robust for any rotation."""
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return ((r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                (r[1, 0] - r[0, 1]) / s, 0.25 * s)
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k]) * 2
    q = [0.0, 0.0, 0.0]
    q[i] = 0.25 * s
    q[j] = (r[j, i] + r[i, j]) / s
    q[k] = (r[k, i] + r[i, k]) / s
    return (q[0], q[1], q[2], (r[k, j] - r[j, k]) / s)


def write_tum_dataset(directory: str, poses, depths_mm) -> None:
    """A TUM RGB-D directory: ground_truth.txt (stamp, t in metres,
    quaternion) and depth/<stamp>.png in TUM's 1/5000 m units."""
    from tsdf_tpu.io.png import save_png

    os.makedirs(os.path.join(directory, "depth"), exist_ok=True)
    lines = []
    for i, (pose, depth) in enumerate(zip(poses, depths_mm)):
        stamp = f"{i}.000000"
        u16 = np.clip(np.round(np.asarray(depth) * 5.0), 0, 65535)
        save_png(
            os.path.join(directory, "depth", f"{stamp}.png"),
            u16.astype(np.uint16),
        )
        t = np.asarray(pose)[:3, 3] / 1000.0
        q = _quat(np.asarray(pose, np.float64)[:3, :3])
        lines.append(
            f"{stamp} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
            f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}"
        )
    with open(os.path.join(directory, "ground_truth.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def noisy_frames(poses, seed: int = 0):
    """Kinect-noised analytic depth for each pose (f32 mm)."""
    import jax

    from tsdf_tpu.utils.fixtures import kinect_noise

    key = jax.random.PRNGKey(seed)
    out = []
    for pose in poses:
        key, sub = jax.random.split(key)
        out.append(np.asarray(kinect_noise(analytic_depth(pose), sub)))
    return out


def _scene_volume(grid: int):
    """Analytic TSDF of the same wall + sphere scene."""
    import jax.numpy as jnp

    from tsdf_tpu import make_volume
    from tsdf_tpu.utils import fixtures

    vol = make_volume((grid,) * 3, PHYSICAL_MM)
    wall = fixtures.wall_tsdf(vol, WALL_Z)
    sph = fixtures.sphere_tsdf(vol, SPHERE_R, centre=tuple(SPHERE_C))
    return vol.replace(
        tsdf=jnp.minimum(wall.tsdf, sph.tsdf),
        weight=jnp.ones_like(vol.weight),
    )


def _run_cli(argv) -> str:
    """tsdf_tpu.cli.main in this process; returns what it printed."""
    from tsdf_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        _log(f"  cli: {line}")
    if rc:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return out


def _ply_vertices(path: str) -> int:
    with open(path, "rb") as f:
        head = f.read(512).decode("ascii", "replace")
    m = re.search(r"element vertex (\d+)", head)
    return int(m.group(1)) if m else 0


# --------------------------------------------------------------- phases --


def phase_tracked(work: str) -> None:
    poses = trajectory()
    write_tum_dataset(os.path.join(work, "tum"), poses, noisy_frames(poses))
    mesh = os.path.join(work, "tracked.ply")
    t0 = time.perf_counter()
    out = _run_cli([
        "fuse", "-d", os.path.join(work, "tum"), "--track", "--filter",
        "-s", str(GRID), "--physical", str(PHYSICAL_MM),
        "--mesh", mesh, "--scene", os.path.join(work, "tracked.png"),
        "--normals", os.path.join(work, "tracked_n.png"),
        "--max-cubes", str(1 << 20), "--max-vertices", str(1 << 22),
    ])
    _log(f"  tracked fuse + outputs: {time.perf_counter() - t0:.1f} s "
         "(compile included)")
    m = re.search(r"ATE rmse=([0-9.]+)mm", out)
    if not m:
        raise RuntimeError("no ATE line in the tracked run's output")
    ate = float(m.group(1))
    if not ate < ATE_BOUND_MM:
        raise RuntimeError(f"ATE {ate} mm >= {ATE_BOUND_MM} mm")
    n = _ply_vertices(mesh)
    if n < 3:
        raise RuntimeError("tracked mesh is empty")
    _log(f"  ATE rmse {ate} mm (< {ATE_BOUND_MM}), mesh {n} vertices")


def phase_gt_fusion(work: str) -> None:
    mesh = os.path.join(work, "gt.ply")
    scene = os.path.join(work, "gt.png")
    out_tsdf = os.path.join(work, "gt.tsdf")
    t0 = time.perf_counter()
    _run_cli([
        "fuse", "-d", os.path.join(work, "tum"),
        "-s", str(GRID), "--physical", str(PHYSICAL_MM), "-o", out_tsdf,
        "--mesh", mesh, "--scene", scene,
        "--normals", os.path.join(work, "gt_n.png"),
        "--max-cubes", str(1 << 20), "--max-vertices", str(1 << 22),
    ])
    _log(f"  GT fuse + outputs: {time.perf_counter() - t0:.1f} s")
    from tsdf_tpu.io.png import load_png

    img = load_png(scene)
    if img.shape[:2] != (H, W) or float(np.std(img)) < 1.0:
        raise RuntimeError("GT-pose render is blank")
    n = _ply_vertices(mesh)
    if n < 3:
        raise RuntimeError("GT-pose mesh is empty")
    _log(f"  render {img.shape}, mesh {n} vertices")


def phase_equality(work: str) -> None:
    """GPU ops vs the same ops on this process's CPU backend.

    Tolerances: f32 matmuls run at 'highest' precision (no TF32), but
    XLA:GPU and the Triton kernel contract multiply-adds into FMAs and
    order sums differently from XLA:CPU, so values agree to rounding,
    and a rounded pixel index or a march step can flip where a value
    sits within rounding of a boundary.
    """
    import jax
    import jax.numpy as jnp

    from tsdf_tpu import Camera
    from tsdf_tpu.ops.integrate import integrate
    from tsdf_tpu.ops.raycast import raycast

    cpu = jax.devices("cpu")[0]

    # ray march: 256^3 (a 512^3 march of 307k rays on the host CPU would
    # take minutes)
    vol = _scene_volume(256)
    cam = Camera.default_depth_camera().set_pose(jnp.asarray(
        trajectory()[3], jnp.float32))
    v_gpu = np.asarray(raycast(vol, cam, width=W, height=H)[0])
    with jax.default_device(cpu):
        vol_c, cam_c = jax.device_put((vol, cam), cpu)
        v_cpu = np.asarray(raycast(vol_c, cam_c, width=W, height=H)[0])
    hg, hc = np.isfinite(v_gpu).all(-1), np.isfinite(v_cpu).all(-1)
    agree = float((hg == hc).mean())
    both = hg & hc
    err = np.linalg.norm(v_gpu[both] - v_cpu[both], axis=-1)
    vox = PHYSICAL_MM / 256
    _log(f"  march 256^3: hit {hg.mean():.4f}, mask agreement {agree:.6f},"
         f" max |dp| {err.max():.4f} mm (voxel {vox:.2f} mm)")
    if agree < 0.999:
        raise RuntimeError(f"hit masks agree on {agree:.6f} < 0.999")
    if not err.max() <= 0.5 * vox:
        raise RuntimeError(f"hit points differ by {err.max()} mm")

    # integrate: 512^3, one noisy frame onto a half-fused volume
    from tsdf_tpu import make_volume

    poses = trajectory()
    frames = noisy_frames(poses[:2], seed=1)
    vol = make_volume((GRID,) * 3, PHYSICAL_MM)
    cam0 = cam.set_pose(jnp.asarray(poses[0], jnp.float32))
    cam1 = cam.set_pose(jnp.asarray(poses[1], jnp.float32))
    vol = integrate(vol, frames[0], cam0)
    out_g = integrate(vol, frames[1], cam1)
    tg, wg = np.asarray(out_g.tsdf), np.asarray(out_g.weight)
    del out_g
    with jax.default_device(cpu):
        vol_c, cam_c, d_c = jax.device_put((vol, cam1, frames[1]), cpu)
        out_c = integrate(vol_c, d_c, cam_c)
        tc, wc = np.asarray(out_c.tsdf), np.asarray(out_c.weight)
    diff = np.abs(tg - tc)
    bad = float(((diff > 1e-3) | (wg != wc)).mean())
    _log(f"  integrate {GRID}^3: voxels off by >1e-3 mm or in weight: "
         f"{bad:.2e}; max |dtsdf| {diff.max():.3e} mm")
    if bad > 1e-5:
        raise RuntimeError(f"integrate disagrees on {bad:.2e} of voxels")


def _write_pdflow(path: str, flow_xyz_m) -> None:
    """PD-Flow results text: row col dz dx dy (metres) per pixel."""
    ys, xs = np.mgrid[0:H, 0:W]
    fx, fy, fz = flow_xyz_m
    rows = np.stack(
        [ys.ravel(), xs.ravel(), np.full(H * W, fz), np.full(H * W, fx),
         np.full(H * W, fy)],
        axis=1,
    )
    np.savetxt(path, rows, fmt="%.0f %.0f %.6f %.6f %.6f")


def phase_scenefusion(work: str) -> None:
    from tsdf_tpu.io.png import save_png

    rgbd, flow = os.path.join(work, "rgbd"), os.path.join(work, "flow")
    os.makedirs(rgbd)
    os.makedirs(flow)
    # the CLI's camera sits at the origin looking along +z
    depth = analytic_depth(
        np.eye(4), wall_z=2400.0, sphere_c=(0.0, 0.0, 1300.0),
        sphere_r=500.0,
    )
    n = 3
    for i in range(n):
        save_png(os.path.join(rgbd, f"depth_{i:05d}.png"),
                 np.round(depth).astype(np.uint16))
        save_png(os.path.join(rgbd, f"colour_{i:05d}.png"),
                 np.full((H, W, 3), 128, np.uint8))
        _write_pdflow(os.path.join(flow, f"sflow_{i:05d}_results01.txt"),
                      (0.004 + 0.001 * i, 0.0, 0.0))
    mesh = os.path.join(work, "sf.ply")
    t0 = time.perf_counter()
    out = _run_cli(["sfusion", rgbd, flow, "--mesh", mesh])
    _log(f"  sfusion: {time.perf_counter() - t0:.1f} s (compile included)")
    if f"processed {n} frames" not in out:
        raise RuntimeError("sfusion did not process every frame")
    nv = _ply_vertices(mesh)
    if nv < 3:
        raise RuntimeError("SceneFusion mesh is empty")
    _log(f"  SceneFusion mesh {nv} vertices")


def phase_pose_grad(work: str) -> None:
    import jax
    import jax.numpy as jnp

    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.ops.integrate import integrate
    from tsdf_tpu.ops.integrate_diff import integrate_pose, pose_gradient_lax

    poses = trajectory()
    frames = noisy_frames(poses[:2], seed=2)
    cam = Camera.default_depth_camera()
    vol = integrate(
        make_volume((GRID,) * 3, PHYSICAL_MM), frames[0],
        cam.set_pose(jnp.asarray(poses[0], jnp.float32)),
    )
    cam1 = cam.set_pose(jnp.asarray(poses[1], jnp.float32))
    gbar = jax.random.normal(jax.random.PRNGKey(3), vol.tsdf.shape)

    @jax.jit
    def grad(vol, gbar):
        return jax.grad(
            lambda d: jnp.sum(gbar * integrate_pose(vol, frames[1], cam1,
                                                    d).tsdf)
        )(jnp.zeros(6, jnp.float32))

    g = np.asarray(grad(vol, gbar))
    g_ref = np.asarray(
        jax.jit(pose_gradient_lax)(vol, frames[1], cam1, gbar)
    )
    scale = float(np.abs(g_ref).max())
    err = float(np.abs(g - g_ref).max())
    _log(f"  pose grad {GRID}^3: |g| {scale:.4e}, max |g - lax| {err:.3e}")
    if not np.isfinite(g).all():
        raise RuntimeError("pose gradient is not finite")
    # sums over 134M voxels in different orders: relative agreement
    if err > 1e-3 * scale:
        raise RuntimeError(f"pose gradient off by {err} (scale {scale})")


def _voxels_off(a, b, wa=None, wb=None) -> float:
    """Fraction of voxels whose tsdf differs by > 1e-3 mm (or weight)."""
    off = np.abs(np.asarray(a) - np.asarray(b)) > 1e-3
    if wa is not None:
        off |= np.asarray(wa) != np.asarray(wb)
    return float(off.mean())


def phase_four(work: str) -> None:
    """The --devices path on a 4x1 brick mesh, each op against the
    single-card path on card 0. Tolerances as in phase_equality: brick
    slabs recompute voxel centres from their own offset, so a rounded
    pixel index can flip where it sits within rounding of a boundary."""
    import jax
    import jax.numpy as jnp

    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.ops.integrate import integrate
    from tsdf_tpu.ops.marching_cubes import extract_surface, soup_to_numpy
    from tsdf_tpu.ops.raycast import raycast
    from tsdf_tpu.parallel import (
        extract_surface_sharded,
        make_mesh,
        merge_brick_soups,
        raycast_sharded,
        scenefusion_frame_sharded,
        shard_volume,
        track_and_fuse_frames_sharded,
        integrate_sharded,
    )
    from tsdf_tpu.pipelines.kinfu import FusionConfig, track_and_fuse_frames
    from tsdf_tpu.pipelines.scenefusion import _sf_step
    from tsdf_tpu.utils.fixtures import sphere_tsdf

    devs = jax.devices()[:4]
    mesh = make_mesh(n_bricks=4, n_rays=1, devices=devs)
    poses = trajectory()
    frames = noisy_frames(poses)
    cam = Camera.default_depth_camera()
    cams = [cam.set_pose(jnp.asarray(p, jnp.float32)) for p in poses]

    # integrate_sharded: every frame
    ref = make_volume((GRID,) * 3, PHYSICAL_MM)
    svol = shard_volume(ref, mesh)
    for d, c in zip(frames, cams):
        ref = integrate(ref, d, c)
        svol = integrate_sharded(svol, d, c, mesh)
    on = {s.device for s in svol.tsdf.addressable_shards}
    if len(on) != 4:
        raise RuntimeError(f"volume bricks sit on {len(on)} devices")
    off = _voxels_off(svol.tsdf, ref.tsdf, svol.weight, ref.weight)
    _log(f"  integrate_sharded {GRID}^3 x{len(frames)}: bricks on "
         f"{sorted(d.id for d in on)}, voxels off {off:.2e}")
    if off > 1e-5:
        raise RuntimeError(f"integrate_sharded off on {off:.2e} of voxels")

    # raycast_sharded: rays over the mesh, volume all-gathered
    vs_, _ = raycast_sharded(svol, cams[3], mesh, width=W, height=H,
                             replicate_volume_ok=True)
    vr, _ = raycast(ref, cams[3], width=W, height=H)
    vs_, vr = np.asarray(vs_), np.asarray(vr)
    hs, hr = np.isfinite(vs_).all(-1), np.isfinite(vr).all(-1)
    agree = float((hs == hr).mean())
    both = hs & hr
    err = float(np.linalg.norm(vs_[both] - vr[both], axis=-1).max())
    _log(f"  raycast_sharded: mask agreement {agree:.6f}, max |dp| "
         f"{err:.4f} mm")
    if agree < 0.999 or err > 0.5 * PHYSICAL_MM / GRID:
        raise RuntimeError("raycast_sharded disagrees with raycast")

    # extract_surface_sharded vs extract_surface
    # the wall lies in one brick, so a brick needs the whole-volume caps
    soups = extract_surface_sharded(
        svol, mesh, max_cubes_per_brick=1 << 20,
        max_vertices_per_brick=1 << 22,
    )
    vs_m, _ = merge_brick_soups(soups)
    vr_m, _ = soup_to_numpy(extract_surface(
        ref, max_cubes=1 << 20, max_vertices=1 << 22))
    dm = float(np.abs(vs_m.mean(0) - vr_m.mean(0)).max())
    _log(f"  extract_surface_sharded: {len(vs_m)} vs {len(vr_m)} "
         f"vertices, centroid diff {dm:.4f} mm")
    if len(vs_m) != len(vr_m) or dm > 0.01:
        raise RuntimeError("extract_surface_sharded disagrees")
    del ref, svol, soups

    # track_and_fuse_frames_sharded vs track_and_fuse_frames (exact ICP
    # association, no bilateral filter and raw-depth fusion on both; the
    # unfiltered tracker is noisier, hence twice the ATE bound)
    cfg = FusionConfig(volume_size=(GRID,) * 3, physical_size_mm=PHYSICAL_MM,
                       icp_band=0)
    _, _, p1, _ = track_and_fuse_frames(
        cfg.make_volume(), cams[0], frames, cfg)
    _, _, p4, _ = track_and_fuse_frames_sharded(
        shard_volume(cfg.make_volume(), mesh), cams[0], frames, mesh)
    dt = max(float(np.abs(np.asarray(a)[:3, 3] - np.asarray(b)[:3, 3]).max())
             for a, b in zip(p1, p4))
    gt = max(float(np.abs(np.asarray(a)[:3, 3] - g[:3, 3]).max())
             for a, g in zip(p4, poses))
    _log(f"  track_and_fuse_frames_sharded: max |dt| vs single-card "
         f"{dt:.4f} mm, vs ground truth {gt:.3f} mm")
    if dt > 2.0 or gt > 2 * ATE_BOUND_MM:  # 2 mm: tests/test_parallel_icp.py
        raise RuntimeError("sharded tracking disagrees")

    # scenefusion_frame_sharded at 256^3 vs the single-card fused step
    dvol = sphere_tsdf(
        make_volume((SF_GRID,) * 3, 2560.0, offset=(-1280.0, -1280.0, 0.0),
                    with_deformation=True),
        500.0, centre=(0.0, 0.0, 1300.0),
    )
    depth = analytic_depth(np.eye(4), wall_z=2400.0,
                           sphere_c=(0.0, 0.0, 1300.0), sphere_r=500.0)
    flow = jnp.broadcast_to(jnp.array([4.0, 0.0, 0.0], jnp.float32),
                            (H, W, 3))
    ref, n_ref, _ = _sf_step(dvol, jnp.asarray(depth), flow, cam,
                             max_cubes=1 << 18, threshold_mm=10.0)
    got, n_got = scenefusion_frame_sharded(
        shard_volume(dvol, mesh), depth, cam, flow, mesh,
        max_cubes_per_brick=1 << 17,
    )
    dd = float(np.abs(np.asarray(got.deform) - np.asarray(ref.deform)).max())
    off = _voxels_off(got.tsdf, ref.tsdf, got.weight, ref.weight)
    _log(f"  scenefusion_frame_sharded {SF_GRID}^3: corr {int(n_got)} vs "
         f"{int(n_ref)}, max |ddeform| {dd:.2e} mm, voxels off {off:.2e}")
    if int(n_got) != int(n_ref) or dd > 1e-3 or off > 1e-5:
        raise RuntimeError("scenefusion_frame_sharded disagrees")


PHASES = {
    "tracked": phase_tracked,
    "gt_fusion": phase_gt_fusion,
    "equality": phase_equality,
    "scenefusion": phase_scenefusion,
    "pose_grad": phase_pose_grad,
}


def selected_phases(four: bool) -> list[str]:
    return ["four"] if four else list(PHASES)


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True,
         "device": {"platform": platform, "kind": kind, "count": count}}
    )


def gpu_name_and_power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the four-card mesh path (--devices) and what it "
        "is compared with",
    )
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (default device {dev.platform})",
              file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1

    from tsdf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(gpu_name_and_power_limit(), flush=True)
    _log(f"device {dev.device_kind} x{len(devices)}, jax {jax.__version__}")

    failed = []
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        for name in selected_phases(args.four):
            fn = phase_four if name == "four" else PHASES[name]
            _log(f"phase {name}")
            t0 = time.perf_counter()
            try:
                fn(work)
            except Exception as e:  # report every phase, then fail
                import traceback

                traceback.print_exc()
                failed.append(name)
                _log(f"phase {name} FAILED: {type(e).__name__}: {e}")
            else:
                _log(f"phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    _log(f"total {time.perf_counter() - t_all:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(result_line(dev.platform, dev.device_kind,
                      4 if args.four else 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
