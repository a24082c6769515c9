"""The native tier's JPEG encoder (``native/jpeg_encode.cpp``) against
Pillow 12.1.0's ``save`` (libjpeg-turbo 3.1.3), byte for byte.

Pillow saves an "L" or "RGB" image with no options as libjpeg-turbo's
baseline path: quality 75, 4:2:0 for colour, the islow DCT, Annex K's
Huffman tables, JFIF 1.01 and the opened image's comment. Cases: hypothesis
sizes 1-257 on each axis, "L" and "RGB", flat, saturated, gradient and
random content; the edge sizes 1x1, 15x17, 17x15; the committed 960x540
views; a COM segment; "1" written as "L". The tier's decoder
(``native/jpeg.cpp``) reads each file as Pillow reads it. Tolerance: 0.
"""

from __future__ import annotations

import io
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gaussian_transformer_tpu_torch import native  # noqa: E402
from gaussian_transformer_tpu_torch.cli import convert as cli_convert  # noqa: E402
from gaussian_transformer_tpu_torch.utils import imagefile  # noqa: E402

JPEG_DIR = ROOT / "gaussian_transformer_tpu_torch" / "native" / "testdata" / "jpeg"
CONTENT = ("flat", "saturated", "gradient", "random")


def content(kind: str, h: int, w: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    shape = (h, w) if channels == 1 else (h, w, channels)
    if kind == "flat":
        return np.full(shape, rng.randint(0, 256), np.uint8)
    if kind == "saturated":
        return (rng.randint(0, 2, shape) * 255).astype(np.uint8)
    if kind == "gradient":
        g = np.add.outer(np.arange(h) * 255 // max(h - 1, 1), np.arange(w) * 255 // max(w - 1, 1)) // 2
        planes = [g, g[::-1, ::-1], 255 - g][:channels]
        return np.ascontiguousarray(np.stack(planes, -1).astype(np.uint8).reshape(shape))
    return rng.randint(0, 256, shape).astype(np.uint8)


def pillow_jpeg(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def decodes_alike(blob: bytes, tmp: Path) -> None:
    """The tier's decoder reads the file as Pillow reads it."""
    path = tmp / "x.jpg"
    path.write_bytes(blob)
    fmt, got = native.image_samples(str(path))
    want = np.asarray(Image.open(io.BytesIO(blob)))
    assert fmt == "JPEG" and np.array_equal(got.reshape(want.shape), want)


@settings(max_examples=60, deadline=None)
@given(w=st.integers(1, 257), h=st.integers(1, 257), channels=st.sampled_from([1, 3]),
       kind=st.sampled_from(CONTENT), seed=st.integers(0, 2**16))
def test_encoder_equals_pillow(tmp_path_factory, w, h, channels, kind, seed):
    arr = content(kind, h, w, channels, seed)
    blob = native.encode_jpeg(arr)
    assert blob == pillow_jpeg(arr)
    decodes_alike(blob, tmp_path_factory.mktemp("jpeg"))


@pytest.mark.parametrize("h,w", [(1, 1), (15, 17), (17, 15), (16, 16), (8, 9), (257, 1), (1, 257)])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("kind", CONTENT)
def test_edge_sizes(tmp_path, h, w, channels, kind):
    arr = content(kind, h, w, channels, h * 1000 + w)
    blob = native.encode_jpeg(arr)
    assert blob == pillow_jpeg(arr)
    decodes_alike(blob, tmp_path)


@pytest.mark.parametrize("view", ["000.jpg", "003.jpg", "007.jpg", "1080p.jpg"])
def test_committed_views(tmp_path, view):
    """The committed views as Pillow decodes them, re-encoded (colour and
    gray)."""
    rgb = np.asarray(Image.open(JPEG_DIR / view))
    assert native.encode_jpeg(rgb) == pillow_jpeg(rgb)
    gray = np.asarray(Image.open(JPEG_DIR / view).convert("L"))
    assert native.encode_jpeg(gray) == pillow_jpeg(gray)
    decodes_alike(native.encode_jpeg(rgb), tmp_path)


def test_markers_and_comment(tmp_path):
    """SOI, APP0 JFIF 1.01, COM (Pillow writes an opened image's comment
    back), DQT x2, SOF0, DHT x4, SOS; an empty comment writes none."""
    arr = content("random", 40, 56, 3, 7)
    blob = native.encode_jpeg(arr, b"a comment")
    assert blob == pillow_jpeg(arr, comment=b"a comment")
    segments, pos = [], 2
    while blob[pos + 1] != 0xDA:
        n = int.from_bytes(blob[pos + 2: pos + 4], "big")
        segments.append((blob[pos + 1], n))
        pos += 2 + n
    assert segments == [(0xE0, 16), (0xFE, 11), (0xDB, 67), (0xDB, 67), (0xC0, 17), (0xC4, 31), (0xC4, 181),
                        (0xC4, 31), (0xC4, 181)]
    assert native.encode_jpeg(arr, b"") == pillow_jpeg(arr)
    # Through the converter's path: the comment read on open is written back.
    src, dst = tmp_path / "c.jpg", tmp_path / "d.jpg"
    src.write_bytes(pillow_jpeg(arr, comment=b"kept"))
    done, error = cli_convert.shrink(str(src), [(str(dst), 0.5)])
    ref = io.BytesIO()
    with Image.open(src) as im:
        im.resize((28, 20)).save(ref, "JPEG")
    assert error is None and done == [(str(dst), ref.getvalue())] and b"kept" in ref.getvalue()


def test_one_bit_image_as_jpeg(tmp_path):
    """A "1" image saves as an "L" JPEG of 0 and 255."""
    bits = content("saturated", 19, 23, 1, 3) > 0
    img = imagefile.Image("1", bits.astype(np.uint8)[..., None], None, {})
    imagefile.save_image(img, str(tmp_path / "one.jpg"))
    buf = io.BytesIO()
    Image.fromarray(bits).save(buf, "JPEG")
    assert (tmp_path / "one.jpg").read_bytes() == buf.getvalue()


def test_what_it_refuses(tmp_path):
    with pytest.raises(ValueError):
        native.encode_jpeg(np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError):
        native.encode_jpeg(np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError):
        native.encode_jpeg(np.zeros((0, 4), np.uint8))
    with pytest.raises(OSError, match="cannot write mode RGBA as JPEG"):
        imagefile.save_image(imagefile.Image("RGBA", np.zeros((2, 2, 4), np.uint8), None, {}),
                             str(tmp_path / "x.jpg"))
    with pytest.raises(ValueError, match="unknown file extension"):
        imagefile.save_image(imagefile.Image("L", np.zeros((2, 2, 1), np.uint8), None, {}), str(tmp_path / "x.bmp"))


def test_a_cut_file_is_refused_as_pillow_refuses_it(tmp_path):
    """Pillow's load raises "image file is truncated" for a JPEG whose data
    ends before EOI; the mode-keeping decode does too (the RGB loader keeps
    libjpeg's warning-only reading)."""
    blob = pillow_jpeg(content("random", 40, 40, 3, 1))
    for cut in (1, 2, 50):
        p = tmp_path / f"cut{cut}.jpg"
        p.write_bytes(blob[:-cut])
        with pytest.raises(OSError, match="truncated"):
            Image.open(p).load()
        with pytest.raises(IOError, match="image file is truncated"):
            native.image_samples(str(p))
        assert native.load_images([str(p)], 40, 40).shape == (1, 40, 40, 3)
