"""Marching cubes: table derivation properties + surface extraction.

Gate per SURVEY.md §7 stage 3: vertices land on the analytic surface of
a sphere TSDF (ref: test_MC_main.cpp builds the same fixture), and —
stronger than the reference, whose canonical table can leak in ambiguous
configs — the extracted mesh is watertight.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tsdf_tpu import make_volume
from tsdf_tpu.ops.marching_cubes import extract_surface, soup_to_numpy
from tsdf_tpu.ops.mc_tables import (
    EDGE_CORNERS,
    EDGE_TABLE,
    TRI_TABLE,
    TRI_COUNTS,
)
from tsdf_tpu.utils import fixtures


def test_tables_structure():
    assert TRI_COUNTS[0] == 0 and TRI_COUNTS[255] == 0
    assert TRI_COUNTS.max() == 5  # canonical worst case
    for c in range(256):
        edges = TRI_TABLE[c][TRI_TABLE[c] >= 0]
        # every used edge is a sign-crossing edge for this config
        for e in edges:
            a, b = EDGE_CORNERS[e]
            assert ((c >> a) & 1) != ((c >> b) & 1), (c, e)
        # and the used edge set is exactly the crossing set
        crossing = {
            e
            for e in range(12)
            if ((c >> EDGE_CORNERS[e][0]) & 1)
            != ((c >> EDGE_CORNERS[e][1]) & 1)
        }
        assert set(edges.tolist()) == crossing, c


def test_complement_configs_same_edges():
    for c in range(256):
        assert EDGE_TABLE[c] == EDGE_TABLE[255 - c]


def _sphere_soup(n=32, radius=300.0):
    vol = make_volume((n, n, n), 1000.0, offset=(-500.0, -500.0, -500.0))
    vol = fixtures.sphere_tsdf(vol, radius, centre=(0.0, 0.0, 0.0))
    soup = extract_surface(vol, max_cubes=1 << 14, max_vertices=1 << 16)
    assert not bool(soup.overflowed)
    return vol, soup


def test_sphere_vertices_on_surface():
    vol, soup = _sphere_soup()
    verts, tris = soup_to_numpy(soup)
    assert len(verts) > 1000
    r = np.linalg.norm(verts, axis=-1)
    # linear interpolation of an exact SDF: vertices lie on the sphere
    # up to curvature error << voxel (31mm)
    assert np.abs(r - 300.0).max() < 4.0


def test_sphere_mesh_watertight():
    _, soup = _sphere_soup()
    verts, tris = soup_to_numpy(soup)
    # quantize vertex positions to merge duplicates
    key = np.round(verts * 1024).astype(np.int64)
    _, inv = np.unique(key, axis=0, return_inverse=True)
    fv = inv[tris]
    edges = np.concatenate(
        [fv[:, [0, 1]], fv[:, [1, 2]], fv[:, [2, 0]]], axis=0
    )
    edges = np.sort(edges, axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all(), "mesh has boundary or non-manifold edges"


def test_sphere_normals_outward():
    _, soup = _sphere_soup()
    verts, tris = soup_to_numpy(soup)
    tv = verts[tris]
    n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    centroid = tv.mean(axis=1)
    agree = (n * centroid).sum(-1) > 0
    assert agree.mean() > 0.99


def test_degenerate_empty_volume():
    vol = make_volume((8, 8, 8), 100.0)
    soup = extract_surface(vol, max_cubes=64, max_vertices=256)
    assert int(soup.n_vertices) == 0
    assert not bool(soup.overflowed)


def test_overflow_flag():
    vol, _ = _sphere_soup()
    soup = extract_surface(vol, max_cubes=16, max_vertices=32)
    assert bool(soup.overflowed)


def _force_path(
    vol, layout, scatter_free, max_cubes=1 << 14, max_vertices=1 << 16
):
    from tsdf_tpu.ops.marching_cubes import _extract_jit

    return _extract_jit(
        vol.tsdf, vol.voxel_size, vol.offset,
        max_cubes, max_vertices, layout, scatter_free, True,
    )


def _vertex_set(soup):
    """Valid (vertex, voxel-pair) rows, sorted by the exact integer
    voxel pair (which determines the edge, hence the position)."""
    v = np.asarray(soup.vertices)[np.asarray(soup.valid)]
    x = np.asarray(soup.vertex_voxels)[np.asarray(soup.valid)]
    order = np.lexsort((x[:, 1], x[:, 0]))
    return v[order], x[order]


def test_scatter_free_path_matches_xla_path():
    """The sort-compaction + matmul-scatter graph is equivalent to the
    plain XLA graph (voxel pairs exact; positions to
    f32 fusion tolerance)."""
    vol, ref = _sphere_soup()
    got = _force_path(vol, "dense", True)
    assert int(got.n_vertices) == int(ref.n_vertices)
    rv, rx = _vertex_set(ref)
    gv, gx = _vertex_set(got)
    np.testing.assert_array_equal(gx, rx)
    np.testing.assert_allclose(gv, rv, atol=1e-3)
    # dense layout: live slots are exactly the compacted prefix
    assert np.asarray(got.valid)[: int(got.n_vertices)].all()


@pytest.mark.parametrize("scatter_free", [False, True])
def test_masked_layout_matches_dense(scatter_free):
    """Masked (slot-position) soup holds the same vertex multiset as the
    dense one — only the packing differs."""
    vol, ref = _sphere_soup()
    got = _force_path(vol, "masked", scatter_free)
    assert int(got.n_vertices) == int(ref.n_vertices)
    assert int(np.asarray(got.valid).sum()) == int(ref.n_vertices)
    rv, rx = _vertex_set(ref)
    gv, gx = _vertex_set(got)
    np.testing.assert_array_equal(gx, rx)
    np.testing.assert_allclose(gv, rv, atol=1e-3)
    # soup_to_numpy compacts masked soups preserving emission order
    dv, _ = soup_to_numpy(ref)
    mv, _ = soup_to_numpy(got)
    np.testing.assert_allclose(mv, dv, atol=1e-3)


def test_scatter_free_large_voxel_indices():
    """Voxel indices beyond f32's 2^24 integer range survive the
    two-half f32 gather/scatter encoding (512^3 -> indices to 2^27)."""
    from tsdf_tpu.ops.marching_cubes import _extract_arrays

    n = 24
    vol = make_volume((n, n, n), 1000.0, offset=(-500.0, -500.0, -500.0))
    vol = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 0.0))
    base = (1 << 26) + 12345
    ref = _extract_arrays(
        vol.tsdf, vol.voxel_size, vol.offset,
        max_cubes=1 << 12, max_vertices=1 << 14,
        voxel_index_base=base, scatter_free=False,
    )
    got = _extract_arrays(
        vol.tsdf, vol.voxel_size, vol.offset,
        max_cubes=1 << 12, max_vertices=1 << 14,
        voxel_index_base=base, scatter_free=True,
    )
    rv, rx = _vertex_set(ref)
    gv, gx = _vertex_set(got)
    np.testing.assert_array_equal(gx, rx)
    np.testing.assert_allclose(gv, rv, atol=1e-3)
    assert rx.min() >= base


def test_scatter_free_n_cube_z_matches_xla_path():
    """The sharded path's n_cube_z row mask (a brick's halo cube row
    must not emit duplicates) agrees between the chunked scatter-free
    compaction and the plain XLA path — including when the cut falls
    inside a chunk (chunk z-extent is 4; cut at 9)."""
    from tsdf_tpu.ops.marching_cubes import _extract_arrays

    n = 24
    vol = make_volume((n, n, n), 1000.0, offset=(-500.0, -500.0, -500.0))
    vol = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 0.0))
    kw = dict(max_cubes=1 << 12, max_vertices=1 << 14, n_cube_z=9)
    ref = _extract_arrays(
        vol.tsdf, vol.voxel_size, vol.offset, scatter_free=False, **kw
    )
    got = _extract_arrays(
        vol.tsdf, vol.voxel_size, vol.offset, scatter_free=True, **kw
    )
    assert int(got.n_vertices) == int(ref.n_vertices) > 0
    rv, rx = _vertex_set(ref)
    gv, gx = _vertex_set(got)
    np.testing.assert_array_equal(gx, rx)
    np.testing.assert_allclose(gv, rv, atol=1e-3)


def test_scatter_free_chunk_boundary_wall():
    """A wall whose sign change sits exactly on a chunk face plane
    (z = 4k, the chunk z-extent) is captured by the chunked occupancy
    pooling; equality vs the XLA path."""
    from tsdf_tpu.ops.marching_cubes import _CHUNK, _extract_arrays

    n = 17
    vol = make_volume((n, n, n), 1000.0, offset=(0.0, 0.0, 0.0))
    vs = float(np.asarray(vol.voxel_size)[2])
    # zero crossing between voxel z=3 and z=4 (first chunk's far face)
    zc = (_CHUNK[0] - 0.5) * vs
    zcent = (np.arange(n, dtype=np.float32) + 0.5) * vs
    plane = np.clip(
        zcent - zc,
        -float(vol.truncation_distance),
        float(vol.truncation_distance),
    )
    d = np.broadcast_to(plane[:, None, None], (n, n, n)).copy()
    vol = vol.replace(tsdf=jnp.asarray(d))
    kw = dict(max_cubes=1 << 12, max_vertices=1 << 14)
    ref = _extract_arrays(
        vol.tsdf, vol.voxel_size, vol.offset, scatter_free=False, **kw
    )
    got = _extract_arrays(
        vol.tsdf, vol.voxel_size, vol.offset, scatter_free=True, **kw
    )
    assert int(got.n_vertices) == int(ref.n_vertices) > 0
    rv, rx = _vertex_set(ref)
    gv, gx = _vertex_set(got)
    np.testing.assert_array_equal(gx, rx)
    np.testing.assert_allclose(gv, rv, atol=1e-3)


def test_chunk_overflow_flag_and_unchunked_fallback():
    """A tiny max_chunks forces the chunked compaction to overflow; the
    flag must be set, and the use_chunked=False fallback must agree with
    the XLA path (its only cap is max_cubes)."""
    from tsdf_tpu.ops.marching_cubes import _chunked_compact, _extract_arrays

    vol = make_volume((48,) * 3, 1500.0, offset=(-750.0, -750.0, 0.0))
    vol = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 750.0))
    *_rest, chunk_overflow, _n = _chunked_compact(
        vol.tsdf, None, 1 << 14, max_chunks=4
    )
    assert bool(chunk_overflow)

    kw = dict(max_cubes=1 << 14, max_vertices=1 << 16, layout="masked")
    ref = _extract_arrays(
        vol.tsdf, vol.voxel_size, vol.offset, scatter_free=False, **kw
    )
    got = _extract_arrays(
        vol.tsdf, vol.voxel_size, vol.offset, scatter_free=True,
        use_chunked=False, **kw
    )
    assert not bool(got.overflowed)
    assert int(got.n_vertices) == int(ref.n_vertices)
    np.testing.assert_array_equal(
        np.asarray(got.valid), np.asarray(ref.valid)
    )
    gv, rv = np.asarray(got.vertices), np.asarray(ref.vertices)
    m = np.asarray(got.valid)
    np.testing.assert_allclose(gv[m], rv[m], atol=1e-4)


def test_sample_color_at_linear_field():
    """Trilinear colour sampling reproduces a linear colour ramp exactly
    (trilinear interpolation is exact on linear functions), and lookups
    clamp at the lattice border."""
    from tsdf_tpu.ops.marching_cubes import sample_color_at

    vol = fixtures.sphere_tsdf(
        make_volume((32,) * 3, 640.0, with_color=True), 200.0
    )
    # colour ramp: R tracks x, G tracks y, B tracks z (4 units / voxel)
    idx = np.arange(32, dtype=np.uint8) * 4
    col = np.zeros((32, 32, 32, 3), np.uint8)
    col[..., 0] = idx[None, None, :]
    col[..., 1] = idx[None, :, None]
    col[..., 2] = idx[:, None, None]
    vol = vol.replace(color=jnp.asarray(col))

    soup = extract_surface(vol, on_cpu=True)
    verts, _tris = soup_to_numpy(soup)
    assert len(verts) > 0
    got = sample_color_at(vol, verts)

    offset = np.asarray(vol.offset)
    vs = np.asarray(vol.voxel_size)
    cf = (verts - offset) / vs - 0.5  # continuous voxel coords (x,y,z)
    expect = np.clip(np.round(np.clip(cf, 0.0, 31.0) * 4.0), 0, 255)
    np.testing.assert_allclose(got.astype(np.float64), expect, atol=1.0)

    # border clamp: a far-outside point gets the corner colour
    far = np.array([[1e6, 1e6, 1e6]], np.float32)
    np.testing.assert_array_equal(
        sample_color_at(vol, far)[0], [124, 124, 124]
    )


def test_sample_color_requires_color_volume():
    from tsdf_tpu.ops.marching_cubes import sample_color_at

    vol = fixtures.sphere_tsdf(make_volume((16,) * 3, 320.0), 100.0)
    with pytest.raises(ValueError, match="colour"):
        sample_color_at(vol, np.zeros((1, 3), np.float32))


def test_write_ply_with_colors(tmp_path):
    from tsdf_tpu.io.ply import write_ply

    verts = np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32
    )
    tris = np.array([[0, 1, 2]], np.int64)
    cols = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    path = tmp_path / "c.ply"
    write_ply(path, verts, tris, colors=cols)
    lines = path.read_text().splitlines()
    assert "property uchar red" in lines
    hdr_end = lines.index("end_header")
    first_v = lines[hdr_end + 1].split()
    assert len(first_v) == 6 and first_v[3:] == ["255", "0", "0"]
    assert lines[hdr_end + 1 + 3] == "3 0 1 2"

    with pytest.raises(ValueError, match="colours"):
        write_ply(tmp_path / "bad.ply", verts, tris, colors=cols[:2])


def test_chunk_major_overflow_and_ncubez():
    """_chunked_compact_cm edge cases: (a) max_cubes < n_occ flags
    overflow and still yields a valid ascending prefix; (b) n_cube_z
    masking (the sharded brick contract) matches the round-4
    compaction exactly."""
    from tsdf_tpu.ops.marching_cubes import (
        _chunked_compact,
        _chunked_compact_cm,
    )
    from tsdf_tpu.utils import fixtures
    from tsdf_tpu.volume import make_volume

    vol = make_volume((48, 48, 48), 960.0, offset=(-480.0, -480.0, 0.0))
    vol = fixtures.sphere_tsdf(vol, 240.0, centre=(0.0, 0.0, 480.0))

    # (a) overflow: cap below the live count
    cid, types, ws, valid, ovf, n_occ = _chunked_compact_cm(
        vol.tsdf, None, 256
    )
    assert bool(ovf) and int(n_occ) > 256
    c = np.asarray(cid)[np.asarray(valid)]
    assert len(c) == 256 and np.all(np.diff(c) > 0)

    # (b) n_cube_z masking == old compaction
    for ncz in (7, 20):
        old = _chunked_compact(vol.tsdf, jnp.int32(ncz), 1 << 13)
        new = _chunked_compact_cm(vol.tsdf, jnp.int32(ncz), 1 << 13)
        assert int(old[5]) == int(new[5])
        n = int(old[5])
        np.testing.assert_array_equal(
            np.asarray(old[0])[:n], np.asarray(new[0])[:n]
        )
        np.testing.assert_array_equal(
            np.asarray(old[1])[:n], np.asarray(new[1])[:n]
        )
        np.testing.assert_array_equal(
            np.asarray(old[2])[:n], np.asarray(new[2])[:n]
        )
