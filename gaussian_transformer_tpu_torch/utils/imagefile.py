"""``Image.open(src).resize(size).save(dst)`` for JPEG and PNG, as Pillow
12.1.0 does it, without Pillow.

The COLMAP converter (``cli/convert.py``) writes its ``images_2/4/8``
pyramid with it where ImageMagick is missing (the card's machine has
neither ImageMagick nor Pillow). Each step is Pillow's:

* ``open_image``: the samples in the mode Pillow opens the file in, the
  format told by the file's content (the native tier's
  ``image_samples``), and the ``info`` Pillow reads before the image data
  that ``save`` writes back: a JPEG's last COM before its first SOS
  (``comment``); a PNG's ``transparency`` (tRNS, as ``chunk_tRNS`` turns
  it into an index, a key, 0 or 255 for a 1-bit key, or palette alphas)
  and ``icc_profile`` (iCCP).
  PNG modes as ``PngImagePlugin._MODES`` maps them: gray 1-bit "1"
  (values 0/1 here), 2/4/8-bit "L" (scaled to 8 bits), 16-bit "I;16";
  RGB at 8 or 16 bits "RGB" (the high bytes); palette "P" (indices, the
  PLTE's bytes); gray+alpha "LA", or "RGBA" at 16 bits; RGBA "RGBA".
* ``resize_image``: ``utils/resample.py``: BICUBIC, or NEAREST for "1"
  and "P", which keep their palette and info.
* ``save_image``: the format the extension names. A JPEG through the
  tier's encoder (``encode_jpeg``: "L", "RGB", "1" as "L"); a PNG through
  ``utils/png.py encode_png`` as ``PngImagePlugin._save`` lays it out: the
  mode's depth and colour type, a palette's PLTE cut to its entries and
  its depth the least that holds them, tRNS from ``transparency``, iCCP
  from ``icc_profile``. The IDAT is zlib's, not Pillow's filters, so a PNG
  equals Pillow's in IHDR, PLTE, tRNS and samples, not byte for byte.

What Pillow refuses to write (RGBA as JPEG, say) raises ``OSError`` as it
does; a format other than JPEG and PNG raises ``ValueError``.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from gaussian_transformer_tpu_torch import native
from gaussian_transformer_tpu_torch.utils import resample
from gaussian_transformer_tpu_torch.utils.png import encode_png

JPEG_EXTENSIONS = (".jfif", ".jpe", ".jpg", ".jpeg")
PNG_EXTENSIONS = (".png", ".apng")
_SIMPLE_PALETTE = re.compile(b"^\xff*\x00\xff*$")  # PngImagePlugin._simple_palette


class Image(NamedTuple):
    mode: str  # "1", "L", "LA", "I;16", "P", "RGB" or "RGBA"
    samples: np.ndarray  # [H, W, C]: uint8 ("1": 0/1, "P": indices), uint16 for "I;16"
    palette: Optional[bytes]  # "P": the PLTE's bytes
    info: Dict[str, object]  # "comment", "transparency", "icc_profile" as Pillow opens them

    @property
    def size(self) -> Tuple[int, int]:
        return self.samples.shape[1], self.samples.shape[0]


def _jpeg_comment(blob: bytes) -> Optional[bytes]:
    """The last COM segment before the first SOS, as ``JpegImageFile._open``
    reads the markers."""
    comment, pos = None, 2
    while pos + 1 < len(blob):
        if blob[pos] != 0xFF:
            pos += 1
            continue
        m = blob[pos + 1]
        if m == 0xFF or m == 0x00:
            pos += 1
        elif m == 0xDA or pos + 4 > len(blob):
            break
        elif m == 0x01 or 0xD0 <= m <= 0xD8:
            pos += 2
        else:
            (length,) = struct.unpack(">H", blob[pos + 2: pos + 4])
            if m == 0xFE:
                comment = blob[pos + 4: pos + 2 + length]
            pos += 2 + length
    return comment


def _png_chunks(blob: bytes) -> Dict[bytes, bytes]:
    """IHDR, PLTE, tRNS and iCCP up to the first IDAT (the last of each),
    the chunks Pillow's ``_open`` reads before the image data."""
    out, pos = {}, 8
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos: pos + 4])
        kind = blob[pos + 4: pos + 8]
        if kind == b"IDAT":
            break
        if kind in (b"IHDR", b"PLTE", b"tRNS", b"iCCP"):
            out[kind] = blob[pos + 8: pos + 8 + length]
        pos += 12 + length
    return out


def _icc(data: bytes) -> Optional[bytes]:
    """``chunk_iCCP``: the profile, or None where it does not inflate."""
    i = data.find(b"\0")
    if data[i + 1] != 0:
        raise ValueError(f"Unknown compression method {data[i + 1]} in iCCP chunk")
    try:
        return zlib.decompress(data[i + 2:])
    except zlib.error:
        return None


def _png_transparency(mode: str, trns: bytes):
    """``chunk_tRNS``: a palette's index or alphas, a gray key, an RGB key."""
    if mode == "P":
        if _SIMPLE_PALETTE.match(trns):
            return trns.find(b"\0")
        return trns
    key = struct.unpack(">H", trns[:2])[0] if mode in ("1", "L", "I;16") else None
    if mode == "1":  # a 1-bit key is kept as 0 or 255
        return 255 if key else 0
    if mode in ("L", "I;16"):
        return key
    if mode == "RGB":
        return struct.unpack(">HHH", trns[:6])
    return None


def open_image(path: str) -> Image:
    """A JPEG or PNG in the mode Pillow opens it in (see the module's doc)."""
    fmt, s = native.image_samples(path)
    with open(path, "rb") as f:
        blob = f.read()
    if fmt == "JPEG":
        comment = _jpeg_comment(blob)
        return Image("L" if s.shape[2] == 1 else "RGB", s, None, {} if comment is None else {"comment": comment})
    chunks = _png_chunks(blob)
    depth, color_type = chunks[b"IHDR"][8], chunks[b"IHDR"][9]
    palette = None
    if color_type == 0:
        mode = {1: "1", 16: "I;16"}.get(depth, "L")
        if depth in (2, 4):  # unpackL2 / unpackL4
            s = s * (255 // ((1 << depth) - 1))
    elif color_type == 3:
        mode, palette = "P", chunks[b"PLTE"]
    else:
        mode = {2: "RGB", 4: "LA" if depth == 8 else "RGBA", 6: "RGBA"}[color_type]
        if depth == 16:  # RGB;16B, LA;16B (to RGBA), RGBA;16B: the high bytes
            s = (s >> 8).astype(np.uint8)
            if color_type == 4:
                s = s[..., [0, 0, 0, 1]]
    info = {}
    if b"tRNS" in chunks:
        t = _png_transparency(mode, chunks[b"tRNS"])
        if t is not None:
            info["transparency"] = t
    if b"iCCP" in chunks:
        info["icc_profile"] = _icc(chunks[b"iCCP"])
    return Image(mode, np.ascontiguousarray(s), palette, info)


def resize_image(img: Image, size: Tuple[int, int]) -> Image:
    """``Image.resize(size)``: BICUBIC, NEAREST for "1" and "P"; the mode,
    the palette and a copy of the info kept."""
    if img.mode in ("1", "P"):
        samples = resample.resize_nearest(img.samples, size)
    else:
        samples = resample.resize(img.samples, size)
    return Image(img.mode, samples, img.palette, dict(img.info))


def _png_trns(img: Image, colors: int) -> Optional[bytes]:
    """``PngImagePlugin._save``'s tRNS chunk from ``transparency``."""
    t = img.info.get("transparency")
    if not (t or t == 0):
        return None
    if img.mode == "P":
        if isinstance(t, bytes):
            return t[:colors]
        t = max(0, min(255, t))
        return (b"\xff" * t + b"\0")[:colors]
    if img.mode in ("1", "L", "I;16"):
        return struct.pack(">H", max(0, min(65535, t)))
    if img.mode == "RGB":
        return struct.pack(">HHH", *t)
    return None


def save_image(img: Image, path: str) -> None:
    """``Image.save(path)`` with no options, in the format the extension
    names; what cannot be encoded raises before the file is opened."""
    data = encode_image(img, path)
    with open(path, "wb") as f:
        f.write(data)


def encode_image(img: Image, path: str) -> bytes:
    """The bytes ``save_image(img, path)`` writes (the format from the
    extension of ``path``, which is not opened)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in JPEG_EXTENSIONS:
        if img.mode not in ("1", "L", "RGB"):
            raise OSError(f"cannot write mode {img.mode} as JPEG")
        samples = img.samples * np.uint8(255) if img.mode == "1" else img.samples
        return native.encode_jpeg(samples, img.info.get("comment") or b"")
    if ext not in PNG_EXTENSIONS:
        raise ValueError(f"unknown file extension: {ext}")
    kw = {"icc": img.info.get("icc_profile")}
    if img.mode == "P":
        colors = max(min(len(img.palette) // 3, 256), 1)
        bits = 1 if colors <= 2 else 2 if colors <= 4 else 4 if colors <= 16 else 8
        palette = img.palette[: colors * 3].ljust(colors * 3, b"\0")
        samples = img.samples & np.uint8((1 << bits) - 1)
        return encode_png(samples, depth=bits, palette=palette, trns=_png_trns(img, colors), **kw)
    depth = {"1": 1, "I;16": 16}.get(img.mode, 8)
    return encode_png(img.samples, depth=depth, trns=_png_trns(img, 0), **kw)
