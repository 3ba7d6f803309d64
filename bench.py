#!/usr/bin/env python
"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline: voxel-updates/s for TSDF depth-frame integration at 512^3 with
640x480 frames (the BASELINE.json metric). Auxiliary fields time the
other hot paths at their published sizes: the raycast, the tracked
KinectFusion frame, the SceneFusion frame at 255^3, mesh export, the
pose adjoint, colour integrate and the bilateral filter. Every section
is the median of three timed loops that each end in
``block_until_ready``; the line names the device it ran on.

Run on a GPU: ``python bench.py`` (BENCH_GRID overrides 512). A run that
finds no GPU exits non-zero without a result.
"""

import json
import os
import sys
import time

import numpy as np


def _note(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _median_ms(fn, *args, iters=10, loops=3):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / iters * 1e3)
    return float(np.median(times))


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (default device {dev.platform})",
              file=sys.stderr)
        return 1

    from tsdf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.ops.integrate import integrate
    from tsdf_tpu.ops.raycast import raycast
    from tsdf_tpu.utils import fixtures

    grid = int(os.environ.get("BENCH_GRID", "512"))
    width, height = 640, 480
    aux = {"grid": grid}
    failed = []

    vol = make_volume(
        (grid,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0)
    )
    # a generic off-axis pose, not the axis-aligned best case
    camera = (
        Camera.default_depth_camera()
        .move_to([300.0, -200.0, -500.0])
        .look_at([50.0, 80.0, 1500.0])
    )
    depth = jnp.asarray(
        fixtures.sphere_depth_map(width, height, 150.0, 1000.0, 2500.0),
        jnp.float32,
    )

    # ---- headline: chained integrate (volume fed back), the fusion
    # loop's shape
    fuse = jax.jit(integrate)

    def chained(v):
        for _ in range(10):
            v = fuse(v, depth, camera)
        return v.weight

    _note("integrate")
    int_ms = _median_ms(chained, vol, iters=1) / 10
    aux["integrate_ms"] = int_ms

    def section(name, fn):
        _note(name)
        try:
            fn()
        except Exception as e:  # report the rest, mark the failure
            _note(f"{name} failed: {type(e).__name__}: {e}")
            failed.append(name)

    scene = fixtures.sphere_tsdf(
        make_volume((grid,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0)),
        600.0,
    )
    wall = fixtures.wall_tsdf(scene, 2500.0)
    scene = scene.replace(
        tsdf=jnp.minimum(scene.tsdf, wall.tsdf),
        weight=jnp.ones_like(scene.weight),
    )
    cam2 = (
        Camera.default_depth_camera()
        .move_to([0.0, 0.0, -900.0])
        .look_at([0.0, 0.0, 1500.0])
    )

    def raycast_section():
        ray = jax.jit(lambda v, c: raycast(v, c, width, height)[0])
        aux["raycast_ms"] = _median_ms(ray, scene, cam2)
        aux["rays_per_s"] = width * height / (aux["raycast_ms"] / 1e3)

    def kinfu_section():
        from tsdf_tpu.pipelines import FusionConfig, track_and_fuse_frames

        n = 12
        cams = [
            Camera.default_depth_camera()
            .move_to([30.0 * t, -20.0 * t, -500.0])
            .look_at([0.0, 0.0, 1500.0])
            for t in np.linspace(0.0, 1.0, n)
        ]
        render = jax.jit(lambda v, c: raycast(v, c, width, height)[0])

        def depth_of(c):
            verts = render(scene, c)
            camz = c.world_to_camera(
                jnp.where(jnp.isfinite(verts), verts, 0.0).reshape(-1, 3)
            ).reshape(height, width, 3)[..., 2]
            return jnp.where(jnp.isfinite(verts).all(-1), camz, 0.0)

        frames = [depth_of(c) for c in cams]
        cfg = FusionConfig(
            volume_size=(grid,) * 3, physical_size_mm=3000.0,
            offset_mm=(-1500.0, -1500.0, 0.0), use_bilateral_filter=True,
        )

        def run(frames):
            v, *_ = track_and_fuse_frames(
                cfg.make_volume(), cams[0], frames, cfg
            )
            return v.weight

        jax.block_until_ready(run(frames[:3]))  # compile
        aux[f"kinfu_tracked_ms_{grid}"] = _median_ms(
            run, frames, iters=1
        ) / n

    def scenefusion_section():
        from tsdf_tpu.ops.raycast import render_to_depth_image
        from tsdf_tpu.pipelines.scenefusion import SceneFusionConfig, _sf_step

        cfg = SceneFusionConfig()
        v0 = fixtures.sphere_tsdf(
            cfg.make_volume(), 500.0, centre=(0.0, 0.0, 1300.0)
        )
        cam = (
            Camera.default_depth_camera()
            .move_to([0.0, 0.0, 100.0])
            .look_at([0.0, 0.0, 1300.0])
        )
        d = jnp.asarray(
            render_to_depth_image(v0, cam, width=width, height=height),
            jnp.float32,
        )
        flow = jnp.broadcast_to(
            jnp.array([4.0, 0.0, 0.0], jnp.float32), (height, width, 3)
        )

        def chained(v):
            for _ in range(4):
                v = _sf_step(
                    v, d, flow, cam,
                    max_cubes=min(cfg.max_cubes_fast, cfg.max_cubes),
                    threshold_mm=cfg.threshold_mm,
                )[0]
            return v.tsdf

        aux["scenefusion_ms_255"] = _median_ms(chained, v0, iters=1) / 4

    def mesh_section():
        from tsdf_tpu.ops.marching_cubes import extract_surface

        def export(v):
            return extract_surface(
                v, max_cubes=1 << 20, max_vertices=1 << 22
            ).vertices

        aux[f"mesh_export_ms_{grid}"] = _median_ms(export, scene, iters=3)

    def pose_section():
        from tsdf_tpu.ops.integrate_diff import integrate_pose

        gbar = jnp.ones((grid,) * 3, jnp.float32)
        grad = jax.jit(jax.grad(
            lambda d, v: jnp.sum(
                gbar * integrate_pose(v, depth, camera, d).tsdf
            )
        ))
        aux["integrate_pose_grad_ms"] = _median_ms(
            grad, jnp.zeros(6, jnp.float32), vol
        )

    def colour_section():
        volc = make_volume(
            (grid,) * 3, 3000.0, offset=(-1500.0, -1500.0, 0.0),
            with_color=True,
        )
        ys = jnp.arange(height, dtype=jnp.uint8)[:, None]
        xs = jnp.arange(width, dtype=jnp.uint8)[None, :]
        rgb = jnp.stack(
            [
                jnp.broadcast_to(ys, (height, width)),
                jnp.broadcast_to(xs, (height, width)),
                jnp.full((height, width), 128, jnp.uint8),
            ],
            axis=-1,
        )
        f = jax.jit(lambda v: integrate(v, depth, camera, rgb=rgb))
        aux["integrate_color_ms"] = _median_ms(f, volc)

    def bilateral_section():
        from tsdf_tpu.ops.bilateral import bilateral_filter

        aux["bilateral_ms"] = _median_ms(bilateral_filter, depth, iters=20)

    for name, fn in (
        ("raycast", raycast_section),
        ("kinfu", kinfu_section),
        ("scenefusion", scenefusion_section),
        ("mesh", mesh_section),
        ("pose", pose_section),
        ("colour", colour_section),
        ("bilateral", bilateral_section),
    ):
        section(name, fn)

    aux["sections_failed"] = failed
    print(json.dumps({
        "metric": f"voxel-updates/s (integrate, {grid}^3, 640x480)",
        "value": grid**3 / (int_ms / 1e3),
        "unit": "voxel-updates/s",
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "aux": aux,
    }), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
