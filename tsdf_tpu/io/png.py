"""PNG I/O for depth (16-bit grey), greyscale and RGB images.

Host-side replacement for the reference's libpng wrappers
(ref: src/Utilities/PngUtilities.cpp:13-355, PngWrapper.cpp): a small
codec on numpy and the standard library's ``zlib``. It writes
non-interlaced 8-bit grey, 16-bit grey and 8-bit RGB images, and reads
those (plus grey+alpha and RGBA, whose alpha is dropped) with all five
row filters. The TUM loader's threaded decode-ahead uses the native
libpng codec (tsdf_tpu/native) whenever it builds.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def save_png(path, array) -> None:
    """Save u8 grey / u8 RGB / u16 grey arrays
    (ref: save_png_to_file PngUtilities.hpp:18-20)."""
    array = np.asarray(array)
    if array.dtype == np.uint16:
        if array.ndim != 2:
            raise ValueError("16-bit PNGs are greyscale (H, W)")
        depth, ctype = 16, 0
        rows = array.astype(">u2").reshape(array.shape[0], -1).view(np.uint8)
    else:
        array = array.astype(np.uint8)
        if array.ndim == 2:
            depth, ctype = 8, 0
        elif array.ndim == 3 and array.shape[2] == 3:
            depth, ctype = 8, 2
        else:
            raise ValueError(f"unsupported image shape {array.shape}")
        rows = array.reshape(array.shape[0], -1)
    h, w = array.shape[:2]
    # filter type 0 (None) on every row
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rows], axis=1
    ).tobytes()
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                            ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    """Undo the Paeth filter in place (the left neighbour is sequential,
    so this runs per byte on plain ints)."""
    for x in range(len(line)):
        a = line[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[x] = (line[x] + pred) & 0xFF


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for x in range(len(line)):
        left = line[x - bpp] if x >= bpp else 0
        line[x] = (line[x] + ((left + prev[x]) >> 1)) & 0xFF


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = buf[y, 0], buf[y, 1:].astype(np.uint8).copy()
        if kind == 1:  # Sub: running sum per channel
            lanes = np.pad(line, (0, (-stride) % bpp)).reshape(-1, bpp)
            line = (np.cumsum(lanes, axis=0, dtype=np.uint64) & 0xFF)
            line = line.astype(np.uint8).reshape(-1)[:stride]
        elif kind == 2:  # Up
            line = line + prev
        elif kind in (3, 4):
            ba = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(
                ba, prev.tobytes(), bpp
            )
            line = np.frombuffer(bytes(ba), np.uint8)
        elif kind != 0:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = line
        prev = line
    return out


def load_png(path) -> np.ndarray:
    """Load a PNG. 16-bit greyscale comes back as u16 (H, W)
    (ref: load_png_from_file PngUtilities.cpp:13-90), 8-bit grey as u8
    (H, W), colour as u8 (H, W, 3)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (colour type {ctype}, depth {depth}, "
            f"interlace {interlace})"
        )
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = rows.reshape(h, w, ch)
    if ch in (2, 4):  # drop alpha
        img = img[..., : ch - 1]
    return img[..., 0] if img.shape[-1] == 1 else img
