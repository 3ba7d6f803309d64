"""SceneFusion: scene-flow IO, mock replay rig, deformation update."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tsdf_tpu import Camera, make_volume
from tsdf_tpu.io.mock_kinect import MockKinect
from tsdf_tpu.io.png import save_png
from tsdf_tpu.io.sceneflow import (
    PDSFMockSceneFlow,
    SRSFMockSceneFlow,
    read_pdflow,
    read_srsf_xml,
)
from tsdf_tpu.ops.marching_cubes import extract_surface
from tsdf_tpu.ops.raycast import render_to_depth_image
from tsdf_tpu.pipelines.scenefusion import (
    SceneFusion,
    SceneFusionConfig,
    update_deformation,
)
from tsdf_tpu.utils import fixtures

W, H = 160, 120
FX, FY, CX, CY = 591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4


def _write_pdflow(path, h, w, flow_mms):
    rows = []
    for y in range(h):
        for x in range(w):
            fx_, fy_, fz_ = flow_mms
            rows.append(f"{y} {x} {fz_/1000.0} {fx_/1000.0} {fy_/1000.0}")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def test_read_pdflow(tmp_path):
    p = tmp_path / "sflow_00001_results01.txt"
    _write_pdflow(p, 4, 6, (10.0, -20.0, 5.0))
    flow = read_pdflow(str(p))
    assert flow.shape == (4, 6, 3)
    np.testing.assert_allclose(flow[2, 3], [10.0, -20.0, 5.0], atol=1e-4)


def test_read_srsf_xml(tmp_path):
    xml = """<root>
      <Translation><data>1 2 3</data></Translation>
      <Rotation><data>0.1 0.2 0.3</data></Rotation>
      <SFx><rows>2</rows><cols>3</cols><data>1 2 3 4 5 6</data></SFx>
      <SFy><rows>2</rows><cols>3</cols><data>0 0 0 0 0 0</data></SFy>
      <SFz><rows>2</rows><cols>3</cols><data>9 9 9 9 9 9</data></SFz>
    </root>"""
    p = tmp_path / "sflow_00000.xml"
    p.write_text(xml)
    t, r, flow = read_srsf_xml(str(p))
    np.testing.assert_allclose(t, [1, 2, 3])
    assert flow.shape == (2, 3, 3)
    np.testing.assert_allclose(flow[1, 2], [6, 0, 9])


def test_mock_sceneflow_replay(tmp_path):
    for i in range(3):
        _write_pdflow(
            tmp_path / f"sflow_{i:05d}_results01.txt", 2, 2, (float(i), 0, 0)
        )
    sfa = PDSFMockSceneFlow(str(tmp_path))
    assert sfa.init()
    for i in range(3):
        _t, _r, flow = sfa.compute_scene_flow()
        assert flow[0, 0, 0] == pytest.approx(float(i))


def test_mock_kinect_replay(tmp_path):
    for i in range(2):
        save_png(
            tmp_path / f"depth_{i:05d}.png",
            np.full((8, 8), 1000 + i, np.uint16),
        )
        save_png(
            tmp_path / f"colour_{i:05d}.png",
            np.zeros((8, 8, 3), np.uint8),
        )
    dev = MockKinect(str(tmp_path))
    dev.initialise()
    got = []
    dev.add_observer(lambda d, c: got.append((d, c)))
    dev.start()
    assert len(got) == 2
    assert got[1][0][0, 0] == 1001
    assert got[0][1].shape == (8, 8, 3)


def _sphere_setup():
    vol = make_volume(
        (48, 48, 48), 1500.0, offset=(-750.0, -750.0, 0.0),
        with_deformation=True,
    )
    vol = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 750.0))
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, -200.0])
        .look_at([0.0, 0.0, 750.0])
    )
    depth = render_to_depth_image(vol, cam, width=W, height=H)
    return vol, cam, depth


def test_update_deformation_shifts_surface_voxels():
    vol, cam, depth = _sphere_setup()
    flow = jnp.broadcast_to(
        jnp.array([25.0, 0.0, 0.0], jnp.float32), (H, W, 3)
    )
    soup = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
    new_vol, n_corr = update_deformation(vol, soup, depth, cam, flow)
    assert int(n_corr) > 100
    delta = np.asarray(new_vol.deform - vol.deform)
    moved = np.abs(delta[..., 0]) > 1.0
    assert moved.sum() > 100  # surface voxels got the flow
    # moved voxels shifted in +x by up to the flow magnitude
    assert delta[..., 0].max() <= 25.0 + 1e-3
    assert delta[..., 0].max() > 10.0
    # y/z untouched
    assert np.abs(delta[..., 1]).max() < 1e-3


def test_scenefusion_orchestrator(tmp_path):
    vol, cam, depth = _sphere_setup()
    d = np.asarray(depth)
    for i in range(2):
        save_png(tmp_path / f"depth_{i:05d}.png", d.astype(np.uint16))
    _write_pdflow(tmp_path / "sflow_00000_results01.txt", H, W, (5.0, 0, 0))
    _write_pdflow(tmp_path / "sflow_00001_results01.txt", H, W, (5.0, 0, 0))

    sfa = PDSFMockSceneFlow(str(tmp_path))
    assert sfa.init()
    dev = MockKinect(str(tmp_path))
    dev.initialise()
    cfg = SceneFusionConfig(
        volume_size=(48, 48, 48),
        physical_size_mm=1500.0,
        offset_mm=(-750.0, -750.0, 0.0),
        max_cubes=1 << 14,
        max_vertices=1 << 16,
    )
    sf = SceneFusion(sfa, dev, cfg, camera=cam)
    dev.start()
    assert sf.frame_index == 2
    assert float(jnp.sum(sf.volume.weight)) > 0
    soup = sf.extract_mesh()
    assert int(soup.n_vertices) > 0


def test_scenefusion_periodic_dumps(tmp_path):
    vol, cam, depth = _sphere_setup()
    d = np.asarray(depth)
    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        save_png(data / f"depth_{i:05d}.png", d.astype(np.uint16))
    _write_pdflow(data / "sflow_00000_results01.txt", H, W, (5.0, 0, 0))
    _write_pdflow(data / "sflow_00001_results01.txt", H, W, (5.0, 0, 0))
    sfa = PDSFMockSceneFlow(str(data))
    sfa.init()
    dev = MockKinect(str(data))
    dev.initialise()
    cfg = SceneFusionConfig(
        volume_size=(48, 48, 48),
        physical_size_mm=1500.0,
        offset_mm=(-750.0, -750.0, 0.0),
        max_cubes=1 << 14,
        max_vertices=1 << 16,
    )
    out = tmp_path / "dumps"
    sf = SceneFusion(
        sfa, dev, cfg, camera=cam, dump_every=1, dump_dir=str(out)
    )
    dev.start()
    assert (out / "frame_000.tsdf").exists()
    assert (out / "mesh_canonical_001.ply").exists()
    assert (out / "mesh_warped_001.ply").exists()


def test_update_deformation_matmul_scatter_path():
    """The matmul-scatter accumulation (scatter_free; ops/scatter.py)
    matches XLA scatter-add exactly — counts, flow sums, corr count."""
    vol, cam, depth = _sphere_setup()
    flow = jnp.broadcast_to(
        jnp.array([25.0, -5.0, 3.0], jnp.float32), (H, W, 3)
    )
    soup = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
    ref, n_ref = update_deformation(
        vol, soup, depth, cam, flow, scatter_free=False
    )
    got, n_got = update_deformation(
        vol, soup, depth, cam, flow, scatter_free=True
    )
    assert int(n_got) == int(n_ref)
    np.testing.assert_allclose(
        np.asarray(got.deform), np.asarray(ref.deform), atol=1e-4
    )


def test_update_deformation_masked_soup():
    """Masked-layout soup produces the same deformation update as the
    dense one (same vertex multiset, different packing)."""
    from tsdf_tpu.ops.marching_cubes import _extract_arrays

    vol, cam, depth = _sphere_setup()
    flow = jnp.broadcast_to(
        jnp.array([25.0, 0.0, 0.0], jnp.float32), (H, W, 3)
    )
    dense = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
    masked = _extract_arrays(
        vol.tsdf, vol.voxel_size, vol.offset,
        max_cubes=1 << 14, max_vertices=1,
        layout="masked", scatter_free=False,
    )
    ref, n_ref = update_deformation(vol, dense, depth, cam, flow)
    got, n_got = update_deformation(vol, masked, depth, cam, flow)
    assert int(n_got) == int(n_ref)
    np.testing.assert_allclose(
        np.asarray(got.deform), np.asarray(ref.deform), atol=1e-4
    )


def test_fused_step_matches_sequential():
    """_sf_step (one jit: masked extract -> deformation update ->
    deformed integrate) == the sequential extract/update/integrate
    chain."""
    from tsdf_tpu.ops.integrate import integrate
    from tsdf_tpu.pipelines.scenefusion import _sf_step

    vol, cam, depth = _sphere_setup()
    flow = jnp.broadcast_to(
        jnp.array([5.0, 0.0, 0.0], jnp.float32), (H, W, 3)
    )
    got, n_corr, overflow = _sf_step(
        vol, depth, flow, cam,
        max_cubes=1 << 14, threshold_mm=10.0, scatter_free=False,
    )
    assert int(n_corr) > 100
    assert not bool(overflow)

    soup = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
    mid, n_ref = update_deformation(vol, soup, depth, cam, flow)
    ref = integrate(mid, depth, cam)
    assert int(n_corr) == int(n_ref)
    np.testing.assert_allclose(
        np.asarray(got.deform), np.asarray(ref.deform), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.tsdf), np.asarray(ref.tsdf), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(got.weight), np.asarray(ref.weight), atol=1e-5
    )


def test_update_deformation_cubes_matches_slot_stream():
    """The cube-corner accumulation (scatter_free path: fold slot
    contributions onto the 8 cube corners, 8 sorted per-corner
    scatters) == the slot-stream update, both counts and flow sums."""
    from tsdf_tpu.ops.marching_cubes import _extract_arrays
    from tsdf_tpu.pipelines.scenefusion import update_deformation_cubes

    vol, cam, depth = _sphere_setup()
    flow = jnp.broadcast_to(
        jnp.array([25.0, -5.0, 3.0], jnp.float32), (H, W, 3)
    )
    soup, (cid, edge_idx, cube_valid) = _extract_arrays(
        vol.tsdf, vol.voxel_size, vol.offset,
        max_cubes=1 << 14, max_vertices=1,
        layout="masked", scatter_free=True, return_cube_slots=True,
    )
    ref, n_ref = update_deformation(
        vol, soup, depth, cam, flow, scatter_free=False
    )
    got, n_got = update_deformation_cubes(
        vol, soup, cid, edge_idx, cube_valid, depth, cam, flow
    )
    assert int(n_got) == int(n_ref)
    np.testing.assert_allclose(
        np.asarray(got.deform), np.asarray(ref.deform), atol=1e-4
    )


def test_chunk_major_compaction_matches_old():
    """The chunk-major compaction (_chunked_compact_cm: batched
    per-chunk prefix sort + compare-reduce rank map + pre-sorted
    gathers + two narrow order-restoring sorts) produces EXACTLY the
    window-walk compaction's output (same ascending-cid contract), and the
    fused-step extraction + deformation update built on it matches the
    lax reference."""
    from tsdf_tpu.ops.marching_cubes import (
        _chunked_compact,
        _chunked_compact_cm,
        _extract_arrays,
    )
    from tsdf_tpu.pipelines.scenefusion import update_deformation_cubes

    vol, cam, depth = _sphere_setup()
    flow = jnp.broadcast_to(
        jnp.array([25.0, -5.0, 3.0], jnp.float32), (H, W, 3)
    )
    mc = 1 << 14
    cid1, t1, ws1, v1, of1, n1 = _chunked_compact(vol.tsdf, None, mc)
    cid2, t2, ws2, v2, of2, n2 = _chunked_compact_cm(vol.tsdf, None, mc)
    n = int(n1)
    assert n == int(n2) and bool(of1) == bool(of2)
    np.testing.assert_array_equal(np.asarray(cid1), np.asarray(cid2))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    np.testing.assert_array_equal(
        np.asarray(ws1)[:n], np.asarray(ws2)[:n]
    )

    soup_n, (cid, ei, cv, edge_verts) = _extract_arrays(
        vol.tsdf, vol.voxel_size, vol.offset,
        max_cubes=mc, max_vertices=1,
        layout="masked", scatter_free=True, return_cube_slots=True,
        chunk_major=True, return_edge_verts=True,
    )
    new, n_new = update_deformation_cubes(
        vol, soup_n, cid, ei, cv, depth, cam, flow
    )
    ref, n_ref = update_deformation(
        vol, soup_n, depth, cam, flow, scatter_free=False
    )
    assert int(n_new) == int(n_ref)
    np.testing.assert_allclose(
        np.asarray(new.deform), np.asarray(ref.deform), atol=1e-4
    )
    # per-EDGE correspondence: a slot's pixel is its edge's
    # pixel, so gathering once per edge must reproduce the per-slot
    # update exactly
    newe, n_e = update_deformation_cubes(
        vol, soup_n, cid, ei, cv, depth, cam, flow,
        edge_verts=edge_verts,
    )
    assert int(n_e) == int(n_ref)
    np.testing.assert_allclose(
        np.asarray(newe.deform), np.asarray(new.deform), atol=1e-5
    )


def test_correspondence_uses_camera_depth_not_world_z():
    """A 90-deg-yaw camera: acceptance must compare camera-space depth
    (the reference's depth-only distance in ITS identity frame), not
    world z — and a vertex behind the camera (mirror projection) must
    never correspond."""
    from tsdf_tpu.pipelines.scenefusion import _slot_correspondence

    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([0.0, 0.0, 0.0])
        .look_at([1000.0, 0.0, 0.0])  # looking along world +x
    )
    depth = jnp.full((H, W), 1000.0, jnp.float32)
    flow = jnp.ones((H, W, 3), jnp.float32)
    verts = jnp.array(
        [
            [1000.0, 0.0, 0.0],   # on the observed surface -> corr
            [1200.0, 0.0, 0.0],   # 200mm beyond it -> reject (world z
                                  # of both reproj and vertex is 0!)
            [-1000.0, 0.0, 0.0],  # behind the camera -> reject
        ],
        jnp.float32,
    )
    corr, fl = _slot_correspondence(
        verts, jnp.ones(3, bool), depth, cam, flow, 10.0
    )
    assert bool(corr[0])
    assert not bool(corr[1])
    assert not bool(corr[2])
    assert np.asarray(fl)[1:].sum() == 0.0


def test_correspondence_blocked_gather_path():
    """Slot streams beyond the 64k block size take the gather_flat
    block walk; it must agree slot-for-slot with the small-N take
    path."""
    from tsdf_tpu.pipelines.scenefusion import _slot_correspondence

    cam = Camera.from_intrinsics(FX, FY, CX, CY).move_to([0.0, 0.0, 0.0])
    rng = np.random.RandomState(5)
    depth = jnp.asarray(
        900.0 + 50.0 * rng.rand(H, W).astype(np.float32)
    )
    flow = jnp.asarray(rng.randn(H, W, 3).astype(np.float32))
    base = jnp.asarray(
        rng.randn(64, 3).astype(np.float32) * 400.0
        + np.array([0.0, 0.0, 920.0], np.float32)
    )
    corr_s, flow_s = _slot_correspondence(
        base, jnp.ones(64, bool), depth, cam, flow, 40.0
    )
    assert bool(jnp.any(corr_s)) and bool(~jnp.all(corr_s))

    N = (1 << 16) * 2 + 12345  # three blocks, ragged tail
    reps = -(-N // 64)
    verts = jnp.tile(base, (reps, 1))[:N]
    valid = jnp.asarray(rng.rand(N) < 0.7)
    corr_b, flow_b = _slot_correspondence(
        verts, valid, depth, cam, flow, 40.0
    )
    idx = np.arange(N) % 64
    np.testing.assert_array_equal(
        np.asarray(corr_b), np.asarray(corr_s)[idx] & np.asarray(valid)
    )
    np.testing.assert_array_equal(
        np.asarray(flow_b),
        np.where(
            np.asarray(corr_b)[:, None], np.asarray(flow_s)[idx], 0.0
        ),
    )


def test_update_deformation_rotated_camera():
    """Correspondences and flow application stay correct for a camera
    with a non-identity rotation (the reference only ever runs identity;
    this framework takes arbitrary tracked poses)."""
    vol, _cam0, _d0 = _sphere_setup()
    cam = (
        Camera.from_intrinsics(FX, FY, CX, CY)
        .move_to([600.0, 0.0, 150.0])
        .look_at([0.0, 0.0, 750.0])
    )
    depth = render_to_depth_image(vol, cam, width=W, height=H)
    flow = jnp.broadcast_to(
        jnp.array([25.0, 0.0, 0.0], jnp.float32), (H, W, 3)
    )
    soup = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
    new_vol, n_corr = update_deformation(vol, soup, depth, cam, flow)
    n_valid = int(jnp.sum(soup.valid.astype(jnp.int32)))
    assert 100 < int(n_corr) < n_valid  # visible side only
    delta = np.asarray(new_vol.deform - vol.deform)
    moved = np.abs(delta[..., 0]) > 1.0
    assert moved.sum() > 100
    # scatter-free path agrees
    ref, n_ref = update_deformation(
        vol, soup, depth, cam, flow, scatter_free=True
    )
    assert int(n_ref) == int(n_corr)
    np.testing.assert_allclose(
        np.asarray(ref.deform), np.asarray(new_vol.deform), atol=1e-4
    )


def test_fused_step_traces_at_512():
    """512^3 non-rigid step ABSTRACT-evaluates (no compute): the
    corner-fold scatter keeps the accumulator at 4 dense channels, so
    the step's intermediates stay within HBM reach at 512^3 (the former
    32-channel accumulator alone was ~17 GB there)."""
    import jax

    from tsdf_tpu.pipelines.scenefusion import _sf_step

    vol = make_volume(
        (512,) * 3, 5120.0, offset=(-2560.0, -2560.0, 0.0),
        with_deformation=True,
    )
    depth = jnp.zeros((480, 640), jnp.float32)
    flow = jnp.zeros((480, 640, 3), jnp.float32)
    cam = Camera.default_depth_camera()
    out = jax.eval_shape(
        lambda v, d, f: _sf_step(
            v, d, f, cam, max_cubes=1 << 18,
            threshold_mm=10.0, scatter_free=True,
        ),
        vol, depth, flow,
    )
    assert out[0].tsdf.shape == (512, 512, 512)


def test_scenefusion_prewarm_fallback(tmp_path):
    """prewarm_fallback compiles the overflow-fallback variants up front
    in a background thread; the run must behave identically."""
    vol, cam, depth = _sphere_setup()
    d = np.asarray(depth)
    for i in range(2):
        save_png(tmp_path / f"depth_{i:05d}.png", d.astype(np.uint16))
    _write_pdflow(tmp_path / "sflow_00000_results01.txt", H, W, (5.0, 0, 0))
    _write_pdflow(tmp_path / "sflow_00001_results01.txt", H, W, (5.0, 0, 0))

    sfa = PDSFMockSceneFlow(str(tmp_path))
    assert sfa.init()
    dev = MockKinect(str(tmp_path))
    dev.initialise()
    cfg = SceneFusionConfig(
        volume_size=(48, 48, 48),
        physical_size_mm=1500.0,
        offset_mm=(-750.0, -750.0, 0.0),
        max_cubes=1 << 14,
        max_vertices=1 << 16,
        prewarm_fallback=True,
    )
    sf = SceneFusion(sfa, dev, cfg, camera=cam)
    dev.start()
    assert sf.frame_index == 2
    assert sf._fallback_warmed
    assert float(jnp.sum(sf.volume.weight)) > 0


def test_cap_ladder_escalates_on_overflow():
    """A tiny max_cubes_fast overflows; the pipeline escalates to the
    max_cubes ceiling and the result matches a run without the ladder
    (overflow never truncates)."""
    import dataclasses

    import jax.numpy as jnp

    from tsdf_tpu import Camera
    from tsdf_tpu.pipelines.scenefusion import (
        SceneFusion,
        SceneFusionConfig,
    )
    from tsdf_tpu.utils import fixtures

    class _Flow:
        def init(self):
            return None

        def compute_scene_flow(self, depth, colour):
            h, w = depth.shape
            return None, None, jnp.broadcast_to(
                jnp.array([5.0, 0.0, 0.0], jnp.float32), (h, w, 3)
            )

    class _Device:
        def add_observer(self, cb):
            pass

    def run(cfg):
        vol = fixtures.sphere_tsdf(
            cfg.make_volume(), 400.0, centre=(0.0, 0.0, 1000.0)
        )
        cam = (
            Camera.from_intrinsics(147.8, 147.5, 40.0, 30.0)
            .move_to([0.0, 0.0, 100.0])
            .look_at([0.0, 0.0, 1000.0])
        )
        sf = SceneFusion(_Flow(), device=_Device(), config=cfg, camera=cam)
        sf.volume = vol
        depth = fixtures.sphere_depth_map(80, 60, 25.0, 600.0, 1400.0)
        sf.process_frames(depth)  # first frame: plain integrate
        sf.process_frames(depth)  # second: the fused step + ladder
        return sf.volume

    base = SceneFusionConfig(
        volume_size=(48,) * 3, physical_size_mm=2000.0,
        offset_mm=(-1000.0, -1000.0, 0.0),
        max_cubes=1 << 13, max_cubes_fast=1 << 13,
        prewarm_fallback=False,
    )
    ref = run(base)
    laddered = dataclasses.replace(base, max_cubes_fast=64)  # overflows
    got = run(laddered)
    np.testing.assert_allclose(
        np.asarray(got.tsdf), np.asarray(ref.tsdf), rtol=0, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.deform), np.asarray(ref.deform), rtol=0, atol=1e-4
    )
