"""ops.bilateral against a NumPy double-loop reference.

The reference visits every pixel and every tap of its window in plain
Python: spatial weight exp(-(dx^2 + dy^2) / sigma_space^2) over radius
ceil(1.5 sigma_space), similarity weight exp(-dv^2 / (2 sigma_colour^2)),
taps outside the image or without data (depth 0) skipped, pixels without
data left 0 (see ops/bilateral.py for why the similarity weight is the
Gaussian one).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from tsdf_tpu.ops.bilateral import bilateral_filter


def reference(depth, sigma_colour=20.0, sigma_space=3.0):
    d = np.asarray(depth, np.float64)
    h, w = d.shape
    r = math.ceil(1.5 * sigma_space)
    out = np.zeros_like(d)
    for y in range(h):
        for x in range(w):
            if d[y, x] <= 0:
                continue
            num = den = 0.0
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    yy, xx = y + dy, x + dx
                    if not (0 <= yy < h and 0 <= xx < w) or d[yy, xx] <= 0:
                        continue
                    dv = d[yy, xx] - d[y, x]
                    wt = math.exp(
                        -(dx * dx + dy * dy) / sigma_space**2
                    ) * math.exp(-dv * dv / (2 * sigma_colour**2))
                    num += wt * d[yy, xx]
                    den += wt
            out[y, x] = num / den
    return out


def _image(kind, h=18, w=22):
    rng = np.random.default_rng({"noise": 0, "holes": 1, "step": 2}.get(
        kind, 3))
    if kind == "constant":
        return np.full((h, w), 1234.0, np.float32)
    if kind == "empty":
        return np.zeros((h, w), np.float32)
    d = 1000.0 + rng.normal(0, 8.0, (h, w))
    if kind == "holes":
        d[4:9, 5:11] = 0.0
        d[rng.random((h, w)) < 0.05] = 0.0
    if kind == "step":
        d[:, w // 2 :] += 600.0
    if kind == "ramp":
        d += np.arange(w)[None, :] * 15.0
    return d.astype(np.float32)


@pytest.mark.parametrize(
    "kind,sigma_colour,sigma_space,dtype",
    [
        ("noise", 20.0, 3.0, np.float32),
        ("holes", 20.0, 3.0, np.float32),
        ("step", 20.0, 3.0, np.float32),
        ("ramp", 20.0, 3.0, np.float32),
        ("noise", 10.0, 1.5, np.float32),
        ("noise", 40.0, 4.0, np.float32),
        ("holes", 20.0, 3.0, np.uint16),
        ("constant", 20.0, 3.0, np.float32),
        ("empty", 20.0, 3.0, np.float32),
    ],
)
def test_bilateral_matches_double_loop(kind, sigma_colour, sigma_space,
                                       dtype):
    img = _image(kind)
    if dtype == np.uint16:
        img = np.round(img).astype(np.uint16)
    got = np.asarray(
        bilateral_filter(jnp.asarray(img), sigma_colour, sigma_space)
    )
    ref = reference(img, sigma_colour, sigma_space)
    assert got.dtype == img.dtype
    if dtype == np.uint16:
        # rounded output: a float sum within rounding of .5 may go
        # either way
        assert np.abs(got.astype(np.float64) - ref).max() <= 0.5 + 1e-3
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    np.testing.assert_array_equal(got == 0, img == 0)
