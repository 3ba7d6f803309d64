"""CLI end-to-end: fuse a synthetic TUM dataset, render, mesh, view, icp.

Builds a miniature TUM directory (ground_truth.txt + 16-bit depth PNGs)
in a tmpdir — the reference hardcodes absolute dataset paths
(SURVEY.md §4 item 7); here fixtures are fabricated.
"""

import os

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from tsdf_tpu import Camera, make_volume
from tsdf_tpu.cli import main
from tsdf_tpu.io.png import load_png, save_png
from tsdf_tpu.io.tsdf_file import load_tsdf, save_tsdf
from tsdf_tpu.ops.raycast import render_to_depth_image
from tsdf_tpu.utils import fixtures

W, H = 160, 120
CAM_ARGS = [
    "--fx", "147.775", "--fy", "147.525",
    "--cx", "82.75", "--cy", "58.65",
    "--width", str(W), "--height", str(H),
]


def _scene_volume():
    vol = make_volume((48, 48, 48), 2000.0, offset=(-1000.0, -1000.0, 0.0))
    wall = fixtures.wall_tsdf(vol, 1500.0)
    s1 = fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    return vol.replace(
        tsdf=jnp.minimum(wall.tsdf, s1.tsdf),
        weight=jnp.ones_like(vol.weight),
    )


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tum")
    (d / "depth").mkdir()
    scene = _scene_volume()
    lines = []
    for i in range(3):
        t = i / 2.0
        cam = (
            Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
            .move_to([30.0 * t, 0.0, -400.0])
            .look_at([0.0, 0.0, 1000.0])
        )
        depth_mm = np.asarray(
            render_to_depth_image(scene, cam, width=W, height=H)
        )
        # store in TUM units (1/5000 m = 0.2mm): x5
        save_png(d / "depth" / f"{i}.0.png", (depth_mm * 5).astype(np.uint16))
        # pose -> TUM line: tx ty tz (m) + quaternion
        pose = np.asarray(cam.pose)
        tx, ty, tz = pose[:3, 3] / 1000.0
        r = pose[:3, :3]
        qw = np.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
        qx = (r[2, 1] - r[1, 2]) / (4 * qw)
        qy = (r[0, 2] - r[2, 0]) / (4 * qw)
        qz = (r[1, 0] - r[0, 1]) / (4 * qw)
        lines.append(f"{i}.0 {tx} {ty} {tz} {qx} {qy} {qz} {qw}")
    (d / "ground_truth.txt").write_text("\n".join(lines) + "\n")
    return d


def test_fuse_render_mesh(tum_dir, tmp_path):
    out_tsdf = tmp_path / "out.tsdf"
    scene_png = tmp_path / "scene.png"
    normals_png = tmp_path / "normals.png"
    mesh_ply = tmp_path / "mesh.ply"
    rc = main(
        [
            "fuse", "-d", str(tum_dir), "-m", "3", "-s", "48",
            "--physical", "2000",
            "-o", str(out_tsdf),
            "--scene", str(scene_png),
            "--normals", str(normals_png),
            "--mesh", str(mesh_ply),
            "--max-cubes", str(1 << 14),
            "--max-vertices", str(1 << 16),
        ]
        + CAM_ARGS
    )
    assert rc == 0
    assert out_tsdf.exists() and mesh_ply.exists()
    scene = load_png(scene_png)
    assert scene.shape == (H, W)
    assert scene.max() > 50  # something rendered
    normals = load_png(normals_png)
    assert normals.shape == (H, W, 3)
    # round-trip the checkpoint
    vol = load_tsdf(str(out_tsdf))
    assert vol.tsdf.shape == (48, 48, 48)
    assert float(jnp.sum(vol.weight)) > 0


def test_render_and_view_and_mesh(tmp_path):
    vol = _scene_volume()
    f = tmp_path / "scene.tsdf"
    save_tsdf(vol, str(f))

    rc = main(
        [
            "render", "-f", str(f),
            "--scene", str(tmp_path / "s.png"),
            "--normals", str(tmp_path / "n.png"),
            "--look-from", "0,0,-400", "--look-at", "0,0,1000",
        ]
        + CAM_ARGS
    )
    assert rc == 0 and (tmp_path / "s.png").exists()

    rc = main(["view", "-f", str(f), "-o", str(tmp_path / "slices")])
    assert rc == 0
    for name in ("top", "right", "front"):
        assert (tmp_path / "slices" / f"{name}.png").exists()

    rc = main(
        [
            "mesh", "-f", str(f), "-o", str(tmp_path / "m.ply"),
            "--max-cubes", str(1 << 14), "--max-vertices", str(1 << 16),
        ]
    )
    assert rc == 0
    assert (tmp_path / "m.ply").read_text().startswith("ply")


def test_icp_cli(tmp_path, capsys):
    vol = _scene_volume()
    f = tmp_path / "scene.tsdf"
    save_tsdf(vol, str(f))
    cam = Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
    depth = np.asarray(render_to_depth_image(vol, cam, width=W, height=H))
    dpng = tmp_path / "depth.png"
    save_png(dpng, depth.astype(np.uint16))
    rc = main(["icp", "-v", str(f), "-d", str(dpng)] + CAM_ARGS)
    assert rc == 0
    out = capsys.readouterr().out
    assert "lastError" in out and "lastInliers" in out


def test_fuse_tracked_pallas(tum_dir, tmp_path, capsys):
    """--track: the fused tracked step (banded ICP vs model render,
    lost-tracking gate, integrate) through the CLI, streaming frames;
    prints ATE/RPE vs the dataset ground truth (config-3 quality
    gate)."""
    out_tsdf = tmp_path / "tracked.tsdf"
    rc = main(
        [
            "fuse", "-d", str(tum_dir), "-m", "3", "-s", "48",
            "--physical", "2000", "--track", "--filter",
            "-o", str(out_tsdf),
            "--scene", str(tmp_path / "s.png"),
            "--normals", str(tmp_path / "n.png"),
            "--mesh", "",
        ]
        + CAM_ARGS
    )
    assert rc == 0
    vol = load_tsdf(str(out_tsdf))
    assert float(jnp.sum(vol.weight)) > 0
    out = capsys.readouterr().out
    assert "ATE rmse=" in out
    import re

    ate_rmse = float(re.search(r"ATE rmse=([0-9.]+)mm", out).group(1))
    # slow synthetic motion, frame-to-model tracking: a few mm at most
    assert ate_rmse < 20.0, out


def test_fuse_empty_dir_errors(tmp_path):
    d = tmp_path / "empty"
    (d / "depth").mkdir(parents=True)
    (d / "ground_truth.txt").write_text("")
    rc = main(
        ["fuse", "-d", str(d), "-m", "5", "-s", "32"] + CAM_ARGS
    )
    assert rc == 1


def test_view_cli(tmp_path):
    vol = _scene_volume()
    p = tmp_path / "v.tsdf"
    save_tsdf(vol, str(p))
    outdir = tmp_path / "slices"
    rc = main(["view", "-f", str(p), "-o", str(outdir)])
    assert rc == 0
    for name in ("top.png", "right.png", "front.png"):
        img = load_png(outdir / name)
        assert img.ndim >= 2 and img.size > 0


def test_sfusion_cli(tmp_path):
    """sfusion verb end-to-end on a tiny volume: MockKinect replay +
    PD-Flow mocks through the fused SceneFusion step, mesh written."""
    import jax.numpy as jnp

    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.io.png import save_png
    from tsdf_tpu.ops.raycast import render_to_depth_image
    from tsdf_tpu.utils import fixtures

    w, h = 160, 120
    vol = make_volume(
        (48,) * 3, 1500.0, offset=(-750.0, -750.0, 0.0),
        with_deformation=True,
    )
    vol = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 750.0))
    cam = (
        Camera.from_intrinsics(591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4)
        .move_to([0.0, 0.0, -200.0])
        .look_at([0.0, 0.0, 750.0])
    )
    depth = np.asarray(
        render_to_depth_image(vol, cam, width=w, height=h)
    ).astype(np.uint16)
    for i in range(2):
        save_png(tmp_path / f"depth_{i:05d}.png", depth)
    flow_rows = [
        f"{y} {x} 0.0 0.005 0.0" for y in range(h) for x in range(w)
    ]
    for i in range(2):
        (tmp_path / f"sflow_{i:05d}_results01.txt").write_text(
            "\n".join(flow_rows) + "\n"
        )
    from tsdf_tpu.cli import main

    rc = main([
        "sfusion", str(tmp_path), str(tmp_path),
        "-s", "48", "--physical", "1500", "--max-cubes", str(1 << 14),
        "--fx", str(591.1 / 4), "--fy", str(590.1 / 4),
        "--cx", str(331.0 / 4), "--cy", str(234.6 / 4),
        "--mesh", str(tmp_path / "warped.ply"),
    ])
    assert rc in (0, None)
    assert (tmp_path / "warped.ply").exists()


def test_fuse_color_render(tum_dir, tmp_path):
    """--fuse-color fuses rgb/<stamp>.png into per-voxel colour and
    --color renders it back out."""
    rgb_dir = tum_dir / "rgb"
    rgb_dir.mkdir(exist_ok=True)
    for i in range(3):
        img = np.zeros((H, W, 3), np.uint8)
        img[:] = [40, 160, 220]
        save_png(rgb_dir / f"{i}.0.png", img)
    out = tmp_path / "c.tsdf"
    rc = main(
        ["fuse", "-d", str(tum_dir), "-m", "3", "-s", "48",
         "--physical", "2000", "--fuse-color",
         "-o", str(out),
         "--scene", str(tmp_path / "s.png"),
         "--normals", str(tmp_path / "n.png"),
         "--color", str(tmp_path / "c.png"),
         "--mesh", str(tmp_path / "m.ply"),
         *CAM_ARGS]
    )
    assert rc in (0, None)
    img = load_png(tmp_path / "c.png")
    painted = (np.asarray(img) != 0).any(-1)
    assert painted.sum() > 100
    px = np.asarray(img)[painted]
    # majority of painted pixels carry the fused colour
    close = np.linalg.norm(
        px.astype(np.int32) - [40, 160, 220], axis=-1
    ) < 80
    assert close.mean() > 0.5
    vol = load_tsdf(str(out))
    assert vol.color is not None and (np.asarray(vol.color) != 0).any()


def test_fuse_sharded_devices(tum_dir, tmp_path):
    """--devices BxR routes fusion through the sharded pipeline on the
    8-CPU mesh; the fused volume matches the single-device fuse."""
    ref_tsdf = tmp_path / "ref.tsdf"
    rc = main(
        [
            "fuse", "-d", str(tum_dir), "-m", "3", "-s", "48",
            "--physical", "2000", "-o", str(ref_tsdf),
            "--scene", str(tmp_path / "s0.png"),
            "--normals", str(tmp_path / "n0.png"),
            "--mesh", "",
        ]
        + CAM_ARGS
    )
    assert rc == 0

    out_tsdf = tmp_path / "sharded.tsdf"
    rc = main(
        [
            "fuse", "-d", str(tum_dir), "-m", "3", "-s", "48",
            "--physical", "2000", "--devices", "4x2",
            "-o", str(out_tsdf),
            "--scene", str(tmp_path / "s1.png"),
            "--normals", str(tmp_path / "n1.png"),
            "--mesh", "",
        ]
        + CAM_ARGS
    )
    assert rc == 0
    ref = load_tsdf(str(ref_tsdf))
    got = load_tsdf(str(out_tsdf))
    np.testing.assert_allclose(
        np.asarray(got.weight), np.asarray(ref.weight), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(got.tsdf), np.asarray(ref.tsdf), atol=1e-2
    )


def test_fuse_sharded_tracked(tum_dir, tmp_path):
    """--devices with --track runs the full sharded KinectFusion loop."""
    out_tsdf = tmp_path / "tracked.tsdf"
    rc = main(
        [
            "fuse", "-d", str(tum_dir), "-m", "3", "-s", "48",
            "--physical", "2000", "--devices", "2x2", "--track",
            "-o", str(out_tsdf),
            "--scene", str(tmp_path / "s2.png"),
            "--normals", str(tmp_path / "n2.png"),
            "--mesh", "",
        ]
        + CAM_ARGS
    )
    assert rc == 0
    vol = load_tsdf(str(out_tsdf))
    assert float(jnp.sum(vol.weight)) > 0


def test_sfusion_cli_sharded(tmp_path):
    """sfusion --devices: brick-parallel non-rigid fusion end-to-end on
    the 8-CPU mesh."""
    import jax.numpy as jnp

    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.io.png import save_png
    from tsdf_tpu.ops.raycast import render_to_depth_image
    from tsdf_tpu.utils import fixtures

    w, h = 160, 120
    vol = make_volume(
        (48,) * 3, 1500.0, offset=(-750.0, -750.0, 0.0),
        with_deformation=True,
    )
    vol = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 750.0))
    cam = (
        Camera.from_intrinsics(591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4)
        .move_to([0.0, 0.0, -200.0])
        .look_at([0.0, 0.0, 750.0])
    )
    depth = np.asarray(
        render_to_depth_image(vol, cam, width=w, height=h)
    ).astype(np.uint16)
    for i in range(2):
        save_png(tmp_path / f"depth_{i:05d}.png", depth)
    flow_rows = [
        f"{y} {x} 0.0 0.005 0.0" for y in range(h) for x in range(w)
    ]
    for i in range(2):
        (tmp_path / f"sflow_{i:05d}_results01.txt").write_text(
            "\n".join(flow_rows) + "\n"
        )
    from tsdf_tpu.cli import main

    rc = main([
        "sfusion", str(tmp_path), str(tmp_path),
        "-s", "48", "--physical", "1500", "--max-cubes", str(1 << 12),
        "--devices", "4x2",
        "--fx", str(591.1 / 4), "--fy", str(590.1 / 4),
        "--cx", str(331.0 / 4), "--cy", str(234.6 / 4),
        "--mesh", str(tmp_path / "warped_sharded.ply"),
    ])
    assert rc in (0, None)
    assert (tmp_path / "warped_sharded.ply").exists()


def test_fuse_color_pallas(tum_dir, tmp_path):
    """--fuse-color through the CLI == the library colour integrate
    applied frame by frame to the same frames and poses."""
    rgb_dir = tum_dir / "rgb"
    rgb_dir.mkdir(exist_ok=True)
    for i in range(3):
        img = np.zeros((H, W, 3), np.uint8)
        img[:] = [40, 160, 220]
        save_png(rgb_dir / f"{i}.0.png", img)
    from tsdf_tpu.io.tum import TUMDataLoader
    from tsdf_tpu.ops.integrate import integrate

    out = tmp_path / "cp.tsdf"
    rc = main(
        ["fuse", "-d", str(tum_dir), "-m", "3", "-s", "48",
         "--physical", "2000", "--fuse-color",
         "-o", str(out), "--mesh", "",
         "--scene", str(tmp_path / "sp.png"),
         "--normals", str(tmp_path / "np.png"),
         *CAM_ARGS]
    )
    assert rc in (0, None)
    ref = make_volume((48,) * 3, 2000.0).with_color()
    cam = Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
    for depth_img, pose, rgb in TUMDataLoader(str(tum_dir)).iter_with_rgb():
        ref = integrate(
            ref, jnp.asarray(depth_img.data), cam.set_pose(jnp.asarray(pose)),
            rgb=jnp.asarray(rgb),
        )
    got = load_tsdf(str(out))
    np.testing.assert_array_equal(
        np.asarray(got.weight), np.asarray(ref.weight)
    )
    dc = np.abs(
        np.asarray(got.color, np.int32) - np.asarray(ref.color, np.int32)
    )
    assert dc.max() <= 1


def test_fuse_color_devices(tum_dir, tmp_path):
    """--fuse-color --devices: the sharded colour integrate, un-sharded
    for the outputs, == the single-device --fuse-color run."""
    rgb_dir = tum_dir / "rgb"
    rgb_dir.mkdir(exist_ok=True)
    for i in range(3):
        img = np.zeros((H, W, 3), np.uint8)
        img[:] = [90, 20, 250]
        save_png(rgb_dir / f"{i}.0.png", img)
    outs = {}
    for name, extra in (("single", []), ("mesh", ["--devices", "2x1"])):
        outs[name] = tmp_path / f"{name}.tsdf"
        rc = main(
            ["fuse", "-d", str(tum_dir), "-m", "3", "-s", "48",
             "--physical", "2000", "--fuse-color", *extra,
             "-o", str(outs[name]), "--mesh", str(tmp_path / f"{name}.ply"),
             "--scene", str(tmp_path / f"{name}.png"),
             "--normals", str(tmp_path / f"{name}_n.png"),
             *CAM_ARGS]
        )
        assert rc in (0, None)
    ref = load_tsdf(str(outs["single"]))
    got = load_tsdf(str(outs["mesh"]))
    np.testing.assert_array_equal(
        np.asarray(got.weight), np.asarray(ref.weight)
    )
    np.testing.assert_allclose(
        np.asarray(got.tsdf), np.asarray(ref.tsdf), atol=1e-3
    )
    dc = np.abs(
        np.asarray(got.color, np.int32) - np.asarray(ref.color, np.int32)
    )
    assert dc.max() <= 1
    assert (tmp_path / "mesh.ply").stat().st_size > 100


def test_fuse_color_tracked(tum_dir, tmp_path):
    """--fuse-color --track: tracked colour reconstruction end-to-end."""
    rgb_dir = tum_dir / "rgb"
    rgb_dir.mkdir(exist_ok=True)
    for i in range(3):
        img = np.zeros((H, W, 3), np.uint8)
        img[:] = [200, 60, 20]
        save_png(rgb_dir / f"{i}.0.png", img)
    out = tmp_path / "ct.tsdf"
    rc = main(
        ["fuse", "-d", str(tum_dir), "-m", "3", "-s", "48",
         "--physical", "2000", "--fuse-color", "--track",
         "-o", str(out), "--mesh", "",
         "--scene", str(tmp_path / "st.png"),
         "--normals", str(tmp_path / "nt.png"),
         "--color", str(tmp_path / "ct.png"),
         *CAM_ARGS]
    )
    assert rc in (0, None)
    img = load_png(tmp_path / "ct.png")
    painted = (np.asarray(img) != 0).any(-1)
    assert painted.sum() > 100
    px = np.asarray(img)[painted]
    close = np.linalg.norm(
        px.astype(np.int32) - [200, 60, 20], axis=-1
    ) < 80
    assert close.mean() > 0.5


def test_mesh_color_cli(tum_dir, tmp_path):
    """fuse --fuse-color writes a colour volume; mesh --color exports a
    PLY with per-vertex uchar RGB sampled from it."""
    rgb_dir = tum_dir / "rgb"
    rgb_dir.mkdir(exist_ok=True)
    for i in range(3):
        img = np.zeros((H, W, 3), np.uint8)
        img[:] = [40, 160, 220]
        save_png(rgb_dir / f"{i}.0.png", img)
    out = tmp_path / "c.tsdf"
    rc = main(
        ["fuse", "-d", str(tum_dir), "-m", "3", "-s", "48",
         "--physical", "2000", "--fuse-color", "-o", str(out),
         "--scene", "", "--normals", "", "--mesh", "",
         *CAM_ARGS]
    )
    assert rc in (0, None)
    ply = tmp_path / "m.ply"
    rc = main(["mesh", "-f", str(out), "-o", str(ply), "--color"])
    assert rc in (0, None)
    lines = ply.read_text().splitlines()
    assert "property uchar red" in lines
    hdr_end = lines.index("end_header")
    n_verts = int(
        next(l for l in lines if l.startswith("element vertex")).split()[2]
    )
    assert n_verts > 0
    vert_rows = np.array(
        [r.split() for r in lines[hdr_end + 1 : hdr_end + 1 + n_verts]],
        np.float64,
    )
    # fused colour reaches the exported vertices (zero-weight voxels
    # around the surface dilute the trilinear blend toward 0)
    cols = vert_rows[:, 3:6]
    assert (cols > 0).any()
    close = np.linalg.norm(cols - [40, 160, 220], axis=-1) < 120
    assert close.mean() > 0.3
