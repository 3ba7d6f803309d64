"""Fabricate an RGBD + PD-Flow dataset and drive the sfusion CLI end to
end in this process (SceneFusion class: cap ladder + background prewarm
+ mesh export) at the reference's 255^3.

Run: python tools/run_sfusion_e2e.py        (SFUSION_E2E_FRAMES, default 4)
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import chip_smoke
from tsdf_tpu.cli import main as cli_main
from tsdf_tpu.io.png import save_png

W, H = chip_smoke.W, chip_smoke.H
N = int(os.environ.get("SFUSION_E2E_FRAMES", "4"))


def run():
    root = tempfile.mkdtemp(prefix="sfusion_e2e_")
    rgbd, flow = os.path.join(root, "rgbd"), os.path.join(root, "flow")
    os.makedirs(rgbd)
    os.makedirs(flow)
    # the CLI's camera sits at the origin looking along +z
    depth = chip_smoke.analytic_depth(
        np.eye(4), wall_z=2400.0, sphere_c=(0.0, 0.0, 1300.0),
        sphere_r=500.0,
    )
    for i in range(N):
        save_png(os.path.join(rgbd, f"depth_{i:05d}.png"),
                 np.round(depth).astype(np.uint16))
        save_png(os.path.join(rgbd, f"colour_{i:05d}.png"),
                 np.full((H, W, 3), 128, np.uint8))
        chip_smoke._write_pdflow(
            os.path.join(flow, f"sflow_{i:05d}_results01.txt"),
            (0.004 + 0.001 * i, 0.0, 0.0),
        )
    print("dataset at", root, flush=True)
    mesh = os.path.join(root, "mesh.ply")
    t0 = time.time()
    rc = cli_main(["sfusion", rgbd, flow, "--mesh", mesh])
    print(f"CLI rc: {rc} ({time.time() - t0:.0f}s)", flush=True)
    if os.path.exists(mesh):
        print("mesh.ply size:", os.path.getsize(mesh), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(run())
