"""8-bit PNG writer and reader on the standard library (``zlib``, ``struct``).

The port's machines list no Pillow, so this replaces the PIL calls of the
reference's render/metrics CLIs and dataset readers. Scope: 8-bit samples,
no interlacing; grayscale, gray+alpha, RGB and RGBA. The writer emits filter
type 0 rows; the reader undoes all five filter types (0-4), so it reads what
other encoders wrote.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (8-bit samples)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Write a uint8 image [H, W] or [H, W, C] with C in {1, 2, 3, 4}."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"unsupported image shape {arr.shape}")
    h, w, c = arr.shape
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0  # filter type 0 (None) on every row
    rows[:, 1:] = np.ascontiguousarray(arr).reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ft = int(data[y, 0])
        line = data[y, 1:].astype(np.int64)
        if ft == 0:
            cur = line
        elif ft == 1:  # Sub: running sum per channel along the row
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 255
        elif ft == 2:  # Up
            cur = (line + prev) & 255
        elif ft in (3, 4):  # Average / Paeth: byte-serial along the row
            ln, up = line.tolist(), prev.tolist()
            rec = [0] * stride
            for x in range(stride):
                left = rec[x - bpp] if x >= bpp else 0
                if ft == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
                rec[x] = (ln[x] + pred) & 255
            cur = np.asarray(rec, np.int64)
        else:
            raise ValueError(f"unknown PNG filter type {ft}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced PNG -> uint8 [H, W, C] (C = 1, 2, 3, 4)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", blob[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: CRC mismatch in {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: missing IHDR")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs are supported "
            f"(depth {depth}, color type {color_type}, interlace {interlace})"
        )
    c = _CHANNELS[color_type]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, c)
    return pixels.reshape(h, w, c)


def to_rgba(image: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] -> [H, W, 4] (PIL's ``convert("RGBA")`` for 8-bit modes)."""
    c = image.shape[2]
    if c == 4:
        return image
    opaque = np.full(image.shape[:2] + (1,), 255, np.uint8)
    if c == 3:
        return np.concatenate([image, opaque], axis=2)
    gray = np.repeat(image[:, :, :1], 3, axis=2)
    alpha = image[:, :, 1:2] if c == 2 else opaque
    return np.concatenate([gray, alpha], axis=2)
