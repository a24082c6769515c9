"""PNG writer and reader on the standard library (``zlib``, ``struct``) and numpy.

The port's machines list no Pillow, so this replaces the PIL calls of the
reference's render/metrics CLIs and dataset readers, and it is the plain
reader beside the native tier's own decoder (``native/png.cpp``), which a
scene load uses wherever a C++ compiler is found. It reads every PNG:
each colour type at each legal bit depth (gray 1/2/4/8/16, RGB 8/16,
palette 1/2/4/8, gray+alpha 8/16, RGBA 8/16), all five filters, Adam7
interlacing, PLTE and tRNS. Ancillary chunks are skipped (neither reference
applies gAMA, sRGB or iCCP); a critical chunk's CRC is checked, as libpng
checks it. Three views of a file:

* ``read_png``: its channels as stored, in 8 bits, as libpng's
  ``png_set_expand`` and ``png_set_strip_16`` give them (palette to RGB,
  gray below 8 bits scaled up, tRNS to an alpha channel, 16 bits to the
  high byte);
* ``read_png_rgb``: the JAX native tier's libpng path, RGB (the above with
  the alpha stripped and gray replicated);
* ``read_png_rgba``: Pillow's ``Image.open(p).convert("RGBA")``, which
  differs from libpng where Pillow reads 16-bit gray as ``I;16`` (clipped
  to 255, not cut to its high byte) and where it matches a tRNS key (on
  the 8-bit samples: see ``_pillow_key_alpha``).

The writer emits every mode Pillow saves (gray at 1, 8 and 16 bits,
gray+alpha, RGB, RGBA, palette with PLTE and tRNS) in filter type 0 rows.
Unfiltering is vectorised in numpy but for the Average and Paeth rows,
whose bytes depend on their left neighbour and run serially.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> color type, for the writer
# Adam7: (x0, y0, dx, dy) of each pass.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PngError(ValueError):
    """A PNG this reader cannot read: names the file and the fault."""


class Png(NamedTuple):
    color_type: int
    depth: int
    samples: np.ndarray  # [H, W, C] sample values at the file's depth (uint16)
    palette: Optional[np.ndarray]  # [N, 3] uint8
    trns: Optional[bytes]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def _pack(rows: np.ndarray, depth: int) -> np.ndarray:
    """[h, w * c] sample values -> [h, stride] bytes at ``depth``, big-endian
    and most significant bits first, the last byte of a row zero-padded."""
    h, n = rows.shape
    if depth == 16:
        return rows.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return rows.astype(np.uint8)
    per = 8 // depth
    vals = np.zeros((h, -(-n // per) * per), np.uint8)
    vals[:, :n] = rows
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(vals.reshape(h, -1, per) << shifts, axis=2).astype(np.uint8)


def write_png(path: str, image: np.ndarray, level: int = 6, **header) -> None:
    """Write ``encode_png(image, level, **header)`` to ``path``."""
    data = encode_png(image, level, **header)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(image: np.ndarray, level: int = 6, *, depth: int = 8, palette: Optional[bytes] = None,
               trns: Optional[bytes] = None, icc: Optional[bytes] = None) -> bytes:
    """The PNG file of an image [H, W] or [H, W, C] with C in {1, 2, 3, 4}: gray,
    gray+alpha, RGB, RGBA at ``depth`` 8 (uint8) or 16 (uint16); gray also
    at 1, 2 and 4 (uint8 values below 2 ** depth). With ``palette`` (the
    PLTE's bytes) C is 1 and the samples are indices (colour type 3, depth
    1, 2, 4 or 8). ``trns`` is the tRNS chunk's bytes; ``icc`` a profile,
    written as Pillow writes it (iCCP "ICC Profile", zlib's default level).
    Chunks come in Pillow's order: IHDR, iCCP, PLTE, tRNS, IDAT, IEND; rows
    take filter type 0."""
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOR_TYPE or (palette is not None and arr.shape[2] != 1):
        raise ValueError(f"unsupported image shape {arr.shape}")
    h, w, c = arr.shape
    color_type = 3 if palette is not None else _COLOR_TYPE[c]
    if depth not in _DEPTHS[color_type]:
        raise ValueError(f"bit depth {depth} is not allowed for colour type {color_type}")
    if arr.dtype != (np.uint16 if depth == 16 else np.uint8):
        raise ValueError(f"write_png takes {'uint16' if depth == 16 else 'uint8'} samples at depth {depth}, "
                         f"got {arr.dtype}")
    if depth < 8 and arr.size and int(arr.max()) >= 1 << depth:
        raise ValueError(f"a sample of {int(arr.max())} does not fit in {depth} bits")
    packed = _pack(np.ascontiguousarray(arr).reshape(h, w * c), depth)
    rows = np.zeros((h, 1 + packed.shape[1]), np.uint8)  # filter type 0 (None) on every row
    rows[:, 1:] = packed
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    parts = [_SIGNATURE, _chunk(b"IHDR", ihdr)]
    if icc:
        parts.append(_chunk(b"iCCP", b"ICC Profile\0\0" + zlib.compress(icc)))
    if palette is not None:
        parts.append(_chunk(b"PLTE", bytes(palette)))
    if trns is not None:
        parts.append(_chunk(b"tRNS", bytes(trns)))
    parts += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)), _chunk(b"IEND", b"")]
    return b"".join(parts)


def _paeth_row(line: list, up: list, bpp: int) -> list:
    rec = [0] * len(line)
    for x in range(len(line)):
        if x >= bpp:
            a, c = rec[x - bpp], up[x - bpp]
        else:
            a = c = 0
        b = up[x]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        rec[x] = (line[x] + pred) & 255
    return rec


def _average_row(line: list, up: list, bpp: int) -> list:
    rec = [0] * len(line)
    for x in range(len(line)):
        left = rec[x - bpp] if x >= bpp else 0
        rec[x] = (line[x] + ((left + up[x]) >> 1)) & 255
    return rec


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """[h, 1 + stride] filtered rows -> [h, stride] bytes."""
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ft = int(data[y, 0])
        line = data[y, 1:].astype(np.int64)
        if ft == 0:
            cur = line
        elif ft == 1:  # Sub: a running sum per byte of a pixel along the row
            pad = (-stride) % bpp
            cur = np.cumsum(np.concatenate([line, np.zeros(pad, np.int64)]).reshape(-1, bpp), axis=0)
            cur = cur.reshape(-1)[:stride] & 255
        elif ft == 2:  # Up
            cur = (line + prev) & 255
        elif ft == 3:
            cur = np.asarray(_average_row(line.tolist(), prev.tolist(), bpp), np.int64)
        elif ft == 4:
            cur = np.asarray(_paeth_row(line.tolist(), prev.tolist(), bpp), np.int64)
        else:
            raise PngError(f"{name}: bad filter type {ft} in row {y}")
        out[y] = cur
        prev = cur
    return out


def _samples(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """[h, stride] unfiltered bytes -> [h, w, c] sample values (uint16)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, -1)[:, : w * c].astype(np.uint16).reshape(h, w, c)
    if depth == 8:
        return rows[:, : w * c].astype(np.uint16).reshape(h, w, c)
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, : w * c].astype(np.uint16).reshape(h, w, c)


def decode_png(blob: bytes, name: str = "<bytes>") -> Png:
    """The file's samples at its own depth, its palette and its tRNS."""
    if blob[:8] != _SIGNATURE:
        raise PngError(f"{name}: not a PNG file (bad signature)")
    pos, header, idat, palette, trns = 8, None, [], None, None
    while True:
        if pos + 8 > len(blob):
            raise PngError(f"{name}: the file ends before IEND")
        (length,) = struct.unpack(">I", blob[pos: pos + 4])
        kind = blob[pos + 4: pos + 8]
        if length > 0x7FFFFFFF or pos + 12 + length > len(blob):
            raise PngError(f"{name}: the file ends inside a {kind!r} chunk")
        data = blob[pos + 8: pos + 8 + length]
        critical = not (kind[0] & 0x20)
        if critical:
            (crc,) = struct.unpack(">I", blob[pos + 8 + length: pos + 12 + length])
            if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
                raise PngError(f"{name}: CRC error in the {kind.decode('latin-1')} chunk")
        pos += 12 + length
        if header is None and kind != b"IHDR":
            raise PngError(f"{name}: the first chunk is not IHDR")
        if kind == b"IHDR":
            if header is not None or length != 13:
                raise PngError(f"{name}: bad IHDR")
            header = struct.unpack(">IIBBBBB", data)
            w, h, depth, color_type, comp, filt, interlace = header
            if not (0 < w < 2**31 and 0 < h < 2**31):
                raise PngError(f"{name}: bad image size {w}x{h}")
            if color_type not in _DEPTHS or depth not in _DEPTHS[color_type]:
                raise PngError(f"{name}: bad bit depth {depth} for color type {color_type}")
            if comp != 0 or filt != 0 or interlace > 1:
                raise PngError(f"{name}: bad compression, filter or interlace method")
        elif kind == b"PLTE":
            if length % 3 or length == 0 or length > 768:
                raise PngError(f"{name}: bad PLTE length {length}")
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = data
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        elif critical:
            raise PngError(f"{name}: unknown critical chunk {kind!r}")
    w, h, depth, color_type, _, _, interlace = header
    if color_type == 3 and palette is None:
        raise PngError(f"{name}: a palette image without PLTE")
    if not idat:
        raise PngError(f"{name}: no IDAT chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"{name}: corrupt image data (zlib: {e})") from None
    c = _CHANNELS[color_type]
    bpp = max(1, c * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((h, w, c), np.uint16)
    at = 0
    for x0, y0, dx, dy in passes:
        pw, ph = (w - x0 + dx - 1) // dx if w > x0 else 0, (h - y0 + dy - 1) // dy if h > y0 else 0
        if pw == 0 or ph == 0:
            continue
        stride = (pw * c * depth + 7) // 8
        size = ph * (stride + 1)
        if at + size > len(raw):
            raise PngError(f"{name}: the image data is too short")
        rows = np.frombuffer(raw, np.uint8, size, at).reshape(ph, stride + 1)
        at += size
        out[y0::dy, x0::dx] = _samples(_unfilter(rows, ph, stride, bpp, name), pw, c, depth)
    return Png(color_type, depth, out, palette, trns)


def _to8(png: Png, values: np.ndarray) -> np.ndarray:
    """Gray samples below 8 bits scaled to 8 (libpng's expand), 16 cut to
    the high byte (``strip_16``)."""
    d = png.depth
    if d == 16:
        return (values >> 8).astype(np.uint8)
    if d < 8:
        return (values * (255 // ((1 << d) - 1))).astype(np.uint8)
    return values.astype(np.uint8)


def _key(png: Png) -> Optional[np.ndarray]:
    """A gray or RGB tRNS key ([1] or [3] uint16), or None."""
    if png.trns is None or png.color_type not in (0, 2):
        return None
    n = 1 if png.color_type == 0 else 3
    if len(png.trns) < 2 * n:
        return None
    return np.array(struct.unpack(f">{n}H", png.trns[: 2 * n]), np.int64)


def _key_alpha(png: Png) -> Optional[np.ndarray]:
    """libpng's tRNS expansion: an alpha plane, 0 where a pixel's samples
    are the key's."""
    key = _key(png)
    if key is None:
        return None
    return np.where((png.samples == key).all(-1), 0, 255).astype(np.uint8)[..., None]


def _pillow_key_alpha(png: Png, img8: np.ndarray) -> Optional[np.ndarray]:
    """Pillow's tRNS key as an alpha plane, held to what its RGBA
    conversion compares (``img8``: the 8-bit samples it converts): a gray
    key below 2 ** depth against the 8-bit gray (1-bit: the key times
    255), a 16-bit one's low byte against the clipped gray; an RGB key
    against the samples, a 16-bit one's low bytes against the high bytes."""
    key = _key(png)
    if key is None:
        return None
    if png.depth == 16:
        target = key & 0xFF
    elif png.color_type == 0:
        if key[0] >= 1 << png.depth:
            return None
        target = key * 255 if png.depth == 1 else key
    else:
        target = key
    return np.where((img8.astype(np.int64) == target).all(-1), 0, 255).astype(np.uint8)[..., None]


def _palette_rgba(png: Png) -> np.ndarray:
    pal = np.zeros((256, 4), np.uint8)
    pal[:, 3] = 255
    pal[: len(png.palette), :3] = png.palette
    if png.trns is not None:  # Pillow takes entries past PLTE's too (libpng drops such a tRNS)
        pal[: len(png.trns), 3] = np.frombuffer(png.trns[:256], np.uint8)
    return pal[png.samples[..., 0]]


def expand(png: Png) -> np.ndarray:
    """libpng's ``png_set_expand`` + ``png_set_strip_16``: uint8 [H, W, C]."""
    if png.color_type == 3:
        rgba = _palette_rgba(png)
        return rgba if png.trns is not None else rgba[..., :3]
    img = _to8(png, png.samples)
    alpha = _key_alpha(png)
    return img if alpha is None else np.concatenate([img, alpha], -1)


def to_rgb(png: Png) -> np.ndarray:
    """The JAX tier's libpng path (expand, strip_16, strip_alpha,
    gray_to_rgb): uint8 [H, W, 3]."""
    img = expand(png)
    if png.color_type == 3:
        return np.ascontiguousarray(img[..., :3])
    colour = img[..., :1] if png.color_type in (0, 4) else img[..., :3]
    return np.ascontiguousarray(np.repeat(colour, 3, -1) if colour.shape[-1] == 1 else colour)


def to_rgba(png: Png) -> np.ndarray:
    """Pillow's ``Image.open(p).convert("RGBA")``: uint8 [H, W, 4]."""
    ct, s = png.color_type, png.samples
    opaque = np.full(s.shape[:2] + (1,), 255, np.uint8)
    if ct == 3:
        return _palette_rgba(png)
    if ct == 0 and png.depth == 16:  # "I;16", clipped
        gray = np.minimum(s, 255).astype(np.uint8)
    else:
        gray = None
    img = _to8(png, s) if gray is None else gray
    alpha = _pillow_key_alpha(png, img)
    if ct in (0, 4):
        img = np.concatenate([np.repeat(img[..., :1], 3, -1), img[..., 1:]], -1)
    if ct in (4, 6):
        return np.ascontiguousarray(img)
    return np.concatenate([img, opaque if alpha is None else alpha], -1)


def _read(path: str) -> Png:
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


def read_png(path: str) -> np.ndarray:
    """A PNG -> uint8 [H, W, C], its channels as stored in 8 bits
    (``expand``): C = 1 gray, 2 gray+alpha, 3 RGB, 4 RGBA."""
    return expand(_read(path))


def read_png_rgb(path: str) -> np.ndarray:
    """A PNG -> uint8 [H, W, 3], as the JAX native tier's libpng reads it."""
    return to_rgb(_read(path))


def read_png_rgba(path: str) -> np.ndarray:
    """A PNG -> uint8 [H, W, 4], as Pillow's ``convert("RGBA")`` reads it."""
    return to_rgba(_read(path))
