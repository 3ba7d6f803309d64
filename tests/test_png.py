"""The numpy + zlib PNG codec: round trips in every written mode, all
five row filters on decode, and agreement with PIL while it is
installed."""

import struct
import zlib

import numpy as np
import pytest

from tsdf_tpu.io.png import load_png, save_png


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "grey16": rng.integers(0, 65536, (37, 53)).astype(np.uint16),
        "grey8": rng.integers(0, 256, (37, 53)).astype(np.uint8),
        "rgb8": rng.integers(0, 256, (37, 53, 3)).astype(np.uint8),
    }


@pytest.mark.parametrize("mode", ["grey16", "grey8", "rgb8"])
def test_round_trip(mode, tmp_path):
    a = _arrays()[mode]
    p = tmp_path / f"{mode}.png"
    save_png(p, a)
    b = load_png(p)
    assert b.dtype == a.dtype and b.shape == a.shape
    np.testing.assert_array_equal(b, a)


def _filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Encode each row with filter type (row index % 5)."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prev
        elif kind == 3:
            f = row - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            f = row - pred
        out.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


@pytest.mark.parametrize("mode", ["grey16", "grey8", "rgb8"])
def test_decodes_all_filter_types(mode, tmp_path):
    a = _arrays()[mode]
    if mode == "grey16":
        rows, depth, ctype, bpp = (
            a.astype(">u2").view(np.uint8).reshape(a.shape[0], -1), 16, 0, 2)
    elif mode == "grey8":
        rows, depth, ctype, bpp = a, 8, 0, 1
    else:
        rows, depth, ctype, bpp = a.reshape(a.shape[0], -1), 8, 2, 3
    h, w = a.shape[:2]
    p = tmp_path / "f.png"
    p.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(_filter_rows(rows, bpp)))
        + _chunk(b"IEND", b"")
    )
    np.testing.assert_array_equal(load_png(p), a)


@pytest.mark.parametrize("mode", ["grey16", "grey8", "rgb8"])
def test_matches_pil(mode, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    a = _arrays()[mode]
    p = tmp_path / "pil.png"
    Image.fromarray(a).save(p)  # PIL picks its own filters
    np.testing.assert_array_equal(load_png(p), np.asarray(Image.open(p)))
    q = tmp_path / "ours.png"
    save_png(q, a)
    np.testing.assert_array_equal(np.asarray(Image.open(q)), a)


def test_rejects_non_png(tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        load_png(p)
