"""Pillow's open -> resize -> save of a PNG, mode by mode, without Pillow
(``utils/imagefile.py``, ``utils/resample.py``, ``utils/png.py write_png``).

* ``open_image`` against ``Image.open`` on every committed PNG mode file:
  the mode, the samples, the palette and the info ``save`` writes back.
* The resize of every mode Pillow keeps against ``Image.resize``: BICUBIC
  for "L", "LA", "RGB", "RGBA" and "I;16" (float64 taps, per-byte clip),
  NEAREST for "1" and "P" (hypothesis sizes 1-97 each way).
* ``save_image`` against ``Image.save`` over the mode matrix ("1", "L",
  "LA", "I;16", "RGB", "RGBA", "P" at 1/2/4/8 bits, with tRNS as an index,
  palette alphas, a gray key, an RGB key; iCCP): IHDR, PLTE, tRNS and iCCP
  equal, the decoded samples equal, and Pillow reads both files alike. The
  IDAT need not match (deflate differs across zlib builds).

Tolerance: 0 everywhere.
"""

from __future__ import annotations

import io
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gaussian_transformer_tpu_torch.utils import imagefile  # noqa: E402
from gaussian_transformer_tpu_torch.utils import png as pypng  # noqa: E402
from gaussian_transformer_tpu_torch.utils import resample  # noqa: E402

PNG_DIR = ROOT / "gaussian_transformer_tpu_torch" / "native" / "testdata" / "png"
MODE_FILES = sorted((PNG_DIR / "modes").glob("*.png")) + [PNG_DIR / "1080p.png"]
MODES = ("1", "L", "LA", "I;16", "P", "RGB", "RGBA")


def chunks(blob: bytes) -> dict:
    out, pos = {}, 8
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos: pos + 4])
        kind = blob[pos + 4: pos + 8]
        if kind != b"IDAT":
            out.setdefault(kind, blob[pos + 8: pos + 8 + n])
        pos += 12 + n
    return out


def pillow_array(im) -> np.ndarray:
    """Pillow's samples in ``imagefile.Image``'s layout."""
    a = np.asarray(im)
    if im.mode == "1":
        a = a.astype(np.uint8)
    return a.reshape(a.shape[0], a.shape[1], -1)


def pillow_image(mode: str, rng, h: int, w: int, colors: int = 16):
    if mode == "I;16":
        return Image.frombytes("I;16", (w, h), rng.randint(0, 65536, (h, w)).astype("<u2").tobytes())
    if mode == "1":
        return Image.fromarray(rng.randint(0, 2, (h, w)).astype(bool))
    if mode == "P":
        im = Image.frombytes("P", (w, h), rng.randint(0, colors, (h, w)).astype(np.uint8).tobytes())
        im.putpalette(rng.randint(0, 256, 3 * colors).astype(np.uint8).tobytes())
        return im
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    return Image.frombytes(mode, (w, h), rng.randint(0, 256, (h, w, c)).astype(np.uint8).tobytes())


def ours_of(im) -> imagefile.Image:
    palette = bytes(im.palette.getdata()[1]) if im.mode == "P" else None
    info = {k: v for k, v in im.info.items() if k in ("transparency", "icc_profile", "comment")}
    return imagefile.Image(im.mode, pillow_array(im), palette, info)


@pytest.mark.parametrize("path", MODE_FILES, ids=lambda p: p.name)
def test_open_image_as_pillow_opens_it(path):
    ours = imagefile.open_image(str(path))
    with Image.open(path) as im:
        assert ours.mode == im.mode
        assert ours.samples.dtype == (np.uint16 if im.mode == "I;16" else np.uint8)
        assert np.array_equal(ours.samples, pillow_array(im))
        assert ours.info.get("transparency") == im.info.get("transparency")
        if im.mode == "P":
            assert ours.palette == bytes(im.palette.getdata()[1])


@settings(max_examples=120, deadline=None)
@given(mode=st.sampled_from(MODES), w=st.integers(1, 97), h=st.integers(1, 97), ow=st.integers(1, 97),
       oh=st.integers(1, 97), seed=st.integers(0, 2**16))
def test_resize_as_pillow_resizes(mode, w, h, ow, oh, seed):
    im = pillow_image(mode, np.random.RandomState(seed), h, w)
    got = imagefile.resize_image(ours_of(im), (ow, oh))
    want = im.resize((ow, oh))
    assert want.mode == got.mode == mode
    assert np.array_equal(got.samples, pillow_array(want))


@pytest.mark.parametrize("size", [(1, 1), (5, 3), (16, 9), (33, 17), (80, 45)])
def test_i16_overshoot(size):
    """A 0/65535 checkerboard: the bicubic overshoot's high and low bytes
    each clipped, as Pillow's I;16 resample clips them."""
    a = (np.indices((40, 70)).sum(0) % 2 * 65535).astype(np.uint16)
    im = Image.frombytes("I;16", (70, 40), a.astype("<u2").tobytes())
    got = resample.resize(a[..., None], size)[..., 0]
    assert np.array_equal(got, np.asarray(im.resize(size)))


def test_nearest_index_is_accumulated():
    """Pillow's ScaleAffine adds the scale output by output: the index of a
    long axis follows the float64 sum, not (x + 0.5) * scale."""
    for n_in, n_out in ((1920, 240), (1000, 333), (257, 129), (3, 7)):
        a = np.arange(n_in, dtype=np.uint8 if n_in < 256 else np.uint16)
        im = Image.frombytes("P", (n_in, 1), (np.arange(n_in) % 256).astype(np.uint8).tobytes())
        want = np.asarray(im.resize((n_out, 1)))[0]
        assert np.array_equal(resample.nearest_index(n_in, n_out) % 256, want)
        assert len(resample.resize_nearest(a[None, :, None], (n_out, 1))[0]) == n_out


def same_png(ours: Path, theirs: Path) -> None:
    a, b = ours.read_bytes(), theirs.read_bytes()
    ca, cb = chunks(a), chunks(b)
    assert list(ca) == list(cb), (list(ca), list(cb))
    for k in (b"IHDR", b"PLTE", b"tRNS"):
        assert ca.get(k) == cb.get(k), k
    if b"iCCP" in cb:
        name_a, name_b = ca[b"iCCP"].split(b"\0", 1)[0], cb[b"iCCP"].split(b"\0", 1)[0]
        assert name_a == name_b and zlib.decompress(ca[b"iCCP"][len(name_a) + 2:]) == zlib.decompress(
            cb[b"iCCP"][len(name_b) + 2:])
    pa, pb = pypng.decode_png(a), pypng.decode_png(b)
    assert (pa.color_type, pa.depth) == (pb.color_type, pb.depth)
    assert np.array_equal(pa.samples, pb.samples)
    with Image.open(ours) as ia, Image.open(theirs) as ib:
        assert ia.mode == ib.mode and ia.info.get("transparency") == ib.info.get("transparency")
        assert np.array_equal(np.asarray(ia), np.asarray(ib))


CASES = {
    "1": ("1", {}), "1_key": ("1", {"transparency": 1}), "L": ("L", {}), "L_key": ("L", {"transparency": 77}),
    "LA": ("LA", {}), "I16": ("I;16", {}), "I16_key": ("I;16", {"transparency": 4000}), "RGB": ("RGB", {}),
    "RGB_key": ("RGB", {"transparency": (1, 300, 65535)}), "RGBA": ("RGBA", {}),
    "RGB_icc": ("RGB", {"icc_profile": bytes(range(256)) * 3}),
    "P2": ("P", {"colors": 2}), "P3_index": ("P", {"colors": 3, "transparency": 1}),
    "P4_alphas": ("P", {"colors": 4, "transparency": b"\x00\x80\xff\x10"}),
    "P12_index": ("P", {"colors": 12, "transparency": 11}),
    "P16_long_alphas": ("P", {"colors": 16, "transparency": bytes(range(0, 250, 10))}),
    "P200": ("P", {"colors": 200}), "P256_alphas": ("P", {"colors": 256, "transparency": bytes(range(256))}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_save_as_pillow_saves(tmp_path, case):
    mode, info = CASES[case]
    info = dict(info)
    colors = info.pop("colors", 16)
    im = pillow_image(mode, np.random.RandomState(len(case)), 23, 37, colors)
    im.info.update(info)
    theirs, ours = tmp_path / "theirs.png", tmp_path / "ours.png"
    im.save(theirs)
    imagefile.save_image(ours_of(im), str(ours))
    same_png(ours, theirs)
    # And through the converter's path: open, resize, save.
    resized_theirs, resized_ours = tmp_path / "rt.png", tmp_path / "ro.png"
    with Image.open(theirs) as back:
        back.resize((12, 19)).save(resized_theirs)
    img = imagefile.open_image(str(theirs))
    imagefile.save_image(imagefile.resize_image(img, (12, 19)), str(resized_ours))
    same_png(resized_ours, resized_theirs)


def test_write_png_checks_its_input(tmp_path):
    p = str(tmp_path / "x.png")
    with pytest.raises(ValueError, match="bit depth 2 is not allowed for colour type 2"):
        pypng.write_png(p, np.zeros((2, 2, 3), np.uint8), depth=2)
    with pytest.raises(ValueError, match="uint16"):
        pypng.write_png(p, np.zeros((2, 2), np.uint8), depth=16)
    with pytest.raises(ValueError, match="does not fit in 1 bits"):
        pypng.write_png(p, np.full((2, 2), 2, np.uint8), depth=1)
    with pytest.raises(ValueError, match="unsupported image shape"):
        pypng.write_png(p, np.zeros((2, 2, 3), np.uint8), palette=b"\0" * 3)
    # Packed rows: 1-bit gray and 4-bit palette read back.
    bits = np.random.RandomState(0).randint(0, 2, (5, 13)).astype(np.uint8)
    pypng.write_png(p, bits, depth=1)
    assert np.array_equal(np.asarray(Image.open(p)), bits.astype(bool))
    idx = np.random.RandomState(1).randint(0, 16, (3, 7)).astype(np.uint8)
    pypng.write_png(p, idx, depth=4, palette=bytes(range(48)), trns=b"\x00\x10")
    with Image.open(p) as im:
        assert im.mode == "P" and np.array_equal(np.asarray(im), idx) and im.info["transparency"] == b"\x00\x10"
    buf = io.BytesIO()
    Image.open(p).save(buf, "PNG")
