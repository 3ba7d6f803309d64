"""Native C++ PNG codec + prefetcher vs the numpy codec (io/png.py)."""

import numpy as np
import pytest

from tsdf_tpu import native
from tsdf_tpu.io.png import load_png, save_png

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"no native io: {native.build_error()}"
)


def _img(seed=0, h=48, w=64):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 65535, (h, w)).astype(np.uint16)


def test_roundtrip_native(tmp_path):
    img = _img()
    p = str(tmp_path / "d.png")
    native.save_png16(p, img)
    np.testing.assert_array_equal(native.load_png16(p), img)


def test_native_matches_pil(tmp_path):
    """The native codec and io/png.py read each other's files."""
    img = _img(1)
    p1 = str(tmp_path / "a.png")
    p2 = str(tmp_path / "b.png")
    save_png(p1, img)  # numpy codec writes
    np.testing.assert_array_equal(native.load_png16(p1), img)
    native.save_png16(p2, img)  # native writes
    np.testing.assert_array_equal(load_png(p2), img)


def test_batch_decode(tmp_path):
    paths = []
    imgs = []
    for i in range(6):
        img = _img(i)
        p = str(tmp_path / f"f{i}.png")
        native.save_png16(p, img)
        paths.append(p)
        imgs.append(img)
    out = native.load_png16_batch(paths, threads=3)
    np.testing.assert_array_equal(out, np.stack(imgs))


def test_prefetcher(tmp_path):
    paths = []
    imgs = []
    for i in range(5):
        img = _img(10 + i)
        p = str(tmp_path / f"f{i}.png")
        native.save_png16(p, img)
        paths.append(p)
        imgs.append(img)
    pf = native.PNGPrefetcher(paths, threads=2)
    got = list(pf)
    pf.close()
    assert len(got) == 5
    for a, b in zip(got, imgs):
        np.testing.assert_array_equal(a, b)


def test_prefetcher_retake_errors(tmp_path):
    # tsdf_prefetch_take clears the frame after the first copy; a second
    # take of the same index must error, not read the emptied vector.
    p = str(tmp_path / "f.png")
    native.save_png16(p, _img(3))
    pf = native.PNGPrefetcher([p, p], threads=1)
    _ = pf.get(0)
    try:
        import pytest

        with pytest.raises(IOError):
            pf.get(0)
    finally:
        pf.close()


def test_prefetcher_rejects_non_grey16(tmp_path):
    # strict mode: an 8-bit PNG must error per-frame (the TUM loader
    # falls back to io/png.py so both loaders agree).
    p8 = str(tmp_path / "f8.png")
    save_png(p8, np.full((4, 4), 7, np.uint8))
    pf = native.PNGPrefetcher([p8, p8], threads=1)
    try:
        with pytest.raises(IOError):
            pf.get(0)
    finally:
        pf.close()
