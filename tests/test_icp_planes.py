"""Regression tests pinning the planar-layout ICP rewrites to the
straightforward reference formulations.

The production paths in tracking/icp.py use planar (H, W) layouts and a
pooled decimation (pyr_down) instead of the natural formulations (ref
for the math being pinned:
third_party/ICP_CUDA/Cuda/pyrdown.cu:41-188). These tests assert the
rewrites are numerically identical to the direct formulations on random
depth with zeros/NaNs, at even AND odd shapes (round-3 advisor finding:
the equivalence was only verified manually).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tsdf_tpu.tracking.icp import (
    SIGMA_COLOR,
    normal_map,
    normal_map_planes,
    pyr_down,
    vertex_map,
    vertex_map_planes,
)


def _pyr_down_naive(depth: np.ndarray) -> np.ndarray:
    """Direct per-output-pixel formulation of pyrDownGaussKernel
    (ref: pyrdown.cu:41-78): clipped 5x5 binomial window around
    (2y, 2x), taps gated by |val - center| < 3*sigma_color, floor of
    the weighted mean."""
    d = depth.astype(np.float32)
    h, w = d.shape
    ch, cw = h // 2, w // 2
    weights = np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32)
    out = np.zeros((ch, cw), np.float32)
    for y in range(ch):
        for x in range(cw):
            cy, cx = 2 * y, 2 * x
            centre = d[cy, cx]
            num = np.float32(0.0)
            den = np.float32(0.0)
            for dy in range(-2, 3):
                for dx in range(-2, 3):
                    yy, xx = cy + dy, cx + dx
                    if not (0 <= yy < h and 0 <= xx < w):
                        continue
                    val = d[yy, xx]
                    if not abs(val - centre) < 3.0 * SIGMA_COLOR:
                        continue
                    wgt = np.float32(weights[dy + 2] * weights[dx + 2])
                    num += np.float32(val * wgt)
                    den += wgt
            out[y, x] = np.floor(num / max(den, np.float32(1e-12)))
    return out


@pytest.mark.parametrize("shape", [(16, 24), (15, 23), (17, 22), (8, 9)])
def test_pyr_down_matches_naive(shape):
    rng = np.random.default_rng(7)
    d = (rng.uniform(400.0, 4000.0, size=shape)).astype(np.float32)
    # invalid-depth zeros, plus one sharp edge so the similarity gate
    # actually rejects taps
    d[rng.uniform(size=shape) < 0.15] = 0.0
    d[:, shape[1] // 2 :] += 500.0
    got = np.asarray(pyr_down(jnp.asarray(d)))
    want = _pyr_down_naive(d)
    np.testing.assert_array_equal(got, want)


def _depth_fixture(shape, with_nan=False):
    rng = np.random.default_rng(11)
    d = rng.uniform(100.0, 25000.0, size=shape).astype(np.float32)
    d[rng.uniform(size=shape) < 0.1] = 0.0
    if with_nan:
        d[rng.uniform(size=shape) < 0.05] = np.nan
    return d


@pytest.mark.parametrize("shape", [(12, 16), (13, 17)])
@pytest.mark.parametrize("with_nan", [False, True])
def test_vertex_map_planes_match_stacked(shape, with_nan):
    d = _depth_fixture(shape, with_nan)
    fx, fy, cx, cy = 591.1, 590.1, 331.0, 234.6
    planes = vertex_map_planes(jnp.asarray(d), fx, fy, cx, cy)
    stacked = vertex_map(jnp.asarray(d), fx, fy, cx, cy)
    for i, p in enumerate(planes):
        np.testing.assert_array_equal(
            np.asarray(p), np.asarray(stacked[..., i])
        )
    # direct formulation: z * K^-1 (u, v, 1), NaN where invalid
    us, vs = np.meshgrid(np.arange(shape[1]), np.arange(shape[0]))
    valid = (d > 0) & (d < 20000.0)
    want_x = np.where(valid, d * (us - cx) / fx, np.nan)
    np.testing.assert_allclose(
        np.asarray(planes[0]), want_x.astype(np.float32),
        rtol=1e-6, atol=0, equal_nan=True,
    )


def _normal_map_naive(vmap: np.ndarray) -> np.ndarray:
    """Direct rolled formulation (ref: computeNmapKernel
    pyrdown.cu:135-188): normalize(cross(v(x+1,y)-v, v(x,y+1)-v)),
    last row/col invalid."""
    right = np.roll(vmap, -1, axis=1) - vmap
    down = np.roll(vmap, -1, axis=0) - vmap
    n = np.cross(right, down)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.where(norm == 0, 1.0, norm)
    n[-1, :, :] = np.nan
    n[:, -1, :] = np.nan
    return n


@pytest.mark.parametrize("shape", [(10, 14), (11, 13)])
def test_normal_map_planes_match_naive(shape):
    d = _depth_fixture(shape)
    fx, fy, cx, cy = 591.1, 590.1, 331.0, 234.6
    vx, vy, vz = vertex_map_planes(jnp.asarray(d), fx, fy, cx, cy)
    got = np.stack(
        [np.asarray(p) for p in normal_map_planes(vx, vy, vz)], axis=-1
    )
    # naive stays in f32: near-degenerate cross products normalize to
    # arbitrary directions, so a float64 reference diverges there while
    # the same-precision formulation matches exactly
    want = _normal_map_naive(
        np.stack([np.asarray(vx), np.asarray(vy), np.asarray(vz)], -1)
    )
    both = np.isfinite(got) & np.isfinite(want)
    # NaN structure identical (invalid verts poison the same taps)
    np.testing.assert_array_equal(
        np.isfinite(got), np.isfinite(want)
    )
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5, atol=1e-6)
    # and the stacked wrapper is exactly the planes
    stacked = normal_map(
        jnp.stack([vx, vy, vz], axis=-1)
    )
    np.testing.assert_array_equal(np.asarray(stacked), got)


def test_kinect_noise_model():
    """The noise fixture corrupts plausibly: quantized to 0.2mm, zeros
    preserved, shadows at edges, bounded axial noise."""
    import jax

    from tsdf_tpu.utils.fixtures import kinect_noise, sphere_depth_map

    clean = jnp.asarray(
        sphere_depth_map(64, 48, 20.0, 800.0, 1200.0), jnp.float32
    )
    noisy = np.asarray(kinect_noise(clean, jax.random.PRNGKey(7)))
    clean_np = np.asarray(clean)
    # quantization grid
    assert np.allclose(noisy * 5.0, np.round(noisy * 5.0), atol=1e-3)
    # invalid stays invalid
    assert (noisy[clean_np == 0] == 0).all()
    # some shadow/salt dropouts appeared
    assert (noisy[clean_np > 0] == 0).any()
    # axial noise bounded: 8 sigma at the far plane
    live = (clean_np > 0) & (noisy > 0)
    sigma_far = 1.425e-6 * 1200.0**2
    assert np.abs(noisy[live] - clean_np[live]).max() < 8 * sigma_far + 0.3
