"""chip_smoke.py on the CPU: it refuses to run without a GPU, --four
selects only the mesh phase, its last line has the driver's format, and
its synthetic TUM writer round-trips through the loader."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_refuses_cpu_backend(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_four_selects_only_its_phase():
    assert chip_smoke.selected_phases(True) == ["four"]
    one = chip_smoke.selected_phases(False)
    assert "four" not in one
    assert one == [
        "tracked", "gt_fusion", "equality", "scenefusion", "pose_grad"
    ]


def test_last_line_format():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 4)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 4},
    }


def test_tum_writer_round_trips_through_loader(tmp_path):
    from tsdf_tpu.io.tum import TUMDataLoader

    poses = chip_smoke.trajectory(3)
    depths = [chip_smoke.analytic_depth(p) for p in poses]
    chip_smoke.write_tum_dataset(str(tmp_path), poses, depths)
    loader = TUMDataLoader(str(tmp_path))
    assert len(loader) == 3
    for (img, pose), p_ref, d_ref in zip(loader, poses, depths):
        np.testing.assert_allclose(pose[:3, 3], p_ref[:3, 3], atol=1e-3)
        np.testing.assert_allclose(pose[:3, :3], p_ref[:3, :3], atol=1e-6)
        # TUM stores 0.2 mm steps; the loader returns whole mm
        np.testing.assert_allclose(img.data, d_ref, atol=0.6 + 1e-3)


def test_analytic_depth_hits_wall_and_sphere():
    d = chip_smoke.analytic_depth(np.eye(4))
    h, w = d.shape
    assert (d > 0).all()  # the wall fills the view
    # the principal ray hits the sphere's near side at c_z - r
    cy, cx = int(round(chip_smoke.CY)), int(round(chip_smoke.CX))
    z = chip_smoke.SPHERE_C[2] - np.sqrt(
        chip_smoke.SPHERE_R**2 - chip_smoke.SPHERE_C[0] ** 2
        - chip_smoke.SPHERE_C[1] ** 2
    )
    assert abs(float(d[cy, cx]) - z) < 2.0
    assert float(d[0, 0]) == pytest.approx(chip_smoke.WALL_Z, rel=1e-6)
