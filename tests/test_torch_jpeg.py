"""The port's own JPEG decoder (gaussian_transformer_tpu_torch/native/jpeg.cpp)
against libjpeg-turbo 2.1.5, through the JAX package's native tier, and
against Pillow's libjpeg-turbo, bit for bit: baseline, progressive,
optimised tables and restart markers (progressive ones too) at 4:4:4,
4:2:2 and 4:2:0 over qualities 1-100 and sizes from 1x1, 16-bit
quantisation tables, grayscale, Adobe RGB, random sizes, a file cut short,
the resize path and the header reader; and the modes PR 16's decoder
refused: files without DHT (Annex K's tables), every sampling libjpeg
decodes (4:4:0, 4:1:1, 3x1, mixed chroma ...), arithmetic coding
(sequential and progressive, with restarts) and the block smoothing of a
progressive file cut short, at every cut. What libjpeg-turbo 2.1.5
refuses (12-bit, lossless, hierarchical, CMYK, fractional sampling) still
raises ``IOError`` naming the feature; Pillow's libjpeg-turbo 3 decodes an
8-bit lossless file, a difference recorded here. The committed JPEG scene
(``native/testdata/jpeg``) and mode files (``native/testdata/jpeg_modes``)
decode to their recorded digests in both tiers. (A valid encoder ends its
EOB run at each restart marker, so the decoder's reset of it is held only
by following libjpeg's code.)

Pillow writes the JPEGs of PR 16's cases; libjpeg writes the others
(``tests/torch_image_writer.c``, through ``tests/torch_image_files.py``).
The committed files are made again by ``python -m tests.test_torch_jpeg
--write-fixtures`` (the scene) and ``--write-mode-fixtures`` (the modes;
the port renders the views on the CPU)."""

import argparse
import hashlib
import itertools
import json
import math
import random
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from gaussian_transformer_tpu import native as jax_native
from gaussian_transformer_tpu_torch import native
from tests.torch_image_files import strip_dht, write_jpeg

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "gaussian_transformer_tpu_torch" / "native" / "testdata"
JPEGS = TESTDATA / "jpeg"
MODES = TESTDATA / "jpeg_modes"

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
OPTIONS = {
    "baseline": {},
    "progressive": {"progressive": True},
    "optimize": {"optimize": True},
    "restart_blocks_1": {"restart_marker_blocks": 1},
    "restart_blocks_3": {"restart_marker_blocks": 3},
    "restart_rows_1": {"restart_marker_rows": 1},
}
QUALITIES = (1, 30, 75, 95, 100)
SIZES = [(1, 1), (8, 8), (7, 5), (16, 16), (17, 33), (61, 83)]  # (width, height)
MATRIX = [(s, o, {"quality": q}) for s, o, q in itertools.product(SUBSAMPLING, OPTIONS, QUALITIES)]
# Pillow writes 16-bit DQT tables only for entries above 255 (its qualities
# force baseline tables).
MATRIX.append(("4:2:0", "baseline", {"qtables": [[300] * 64, [400] * 64]}))

if not jax_native.available():
    jax_native.build()


@pytest.fixture(autouse=True)
def _tiers_built():
    assert native.available(), native.unavailable_reason()
    assert "jpeg" in native.codecs(), native.missing()
    assert jax_native.available()


def _image(w, h, seed, gray=False):
    """A gradient under strong noise (every block busy, chroma included)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1)
    img = np.clip(base + rng.randint(-60, 61, (h, w, 3)), 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def _write(path, img, **opts) -> str:
    Image.fromarray(img).save(path, **opts)
    return str(path)


def _libjpeg(path):
    return jax_native.load_images([path], *jax_native.image_size(path))[0]


def _assert_as_libjpeg_and_pil(path, w, h):
    """The port's decode equals the JAX tier's libjpeg decode and Pillow's,
    bit for bit, at the file's size; both tiers read the same size."""
    got = native.load_images([path], w, h)[0]
    assert native.image_size(path) == jax_native.image_size(path) == (w, h)
    np.testing.assert_array_equal(got, _libjpeg(path))
    np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("sub,opt,save", MATRIX,
                         ids=[f"{s}-{o}-{'q%d' % v['quality'] if 'quality' in v else 'qtables16'}"
                              for s, o, v in MATRIX])
def test_decode_equals_libjpeg_and_pil(tmp_path, sub, opt, save):
    for i, (w, h) in enumerate(SIZES):
        path = _write(tmp_path / f"{w}x{h}.jpg", _image(w, h, i), subsampling=SUBSAMPLING[sub],
                      **OPTIONS[opt], **save)
        _assert_as_libjpeg_and_pil(path, w, h)


@pytest.mark.parametrize("sub,rst", list(itertools.product(SUBSAMPLING, [o for o in OPTIONS if "restart" in o])))
def test_progressive_with_restart_markers(tmp_path, sub, rst):
    """Restart markers in a progressive file: each resets the DC predictors
    and ends the EOB run in flight."""
    for i, (w, h) in enumerate(SIZES):
        for q in (75, 95):
            path = _write(tmp_path / f"{w}x{h}.jpg", _image(w, h, i), quality=q, subsampling=SUBSAMPLING[sub],
                          progressive=True, **OPTIONS[rst])
            _assert_as_libjpeg_and_pil(path, w, h)


@pytest.mark.parametrize("opt", ["baseline", "progressive"])
def test_grayscale_decodes_to_three_equal_channels(tmp_path, opt):
    for i, (w, h) in enumerate(SIZES + [(97, 97)]):
        path = _write(tmp_path / f"{w}x{h}.jpg", _image(w, h, i, gray=True), quality=80, **OPTIONS[opt])
        _assert_as_libjpeg_and_pil(path, w, h)
        got = native.load_images([path], w, h)[0]
        assert (got == got[..., :1]).all()


def test_adobe_rgb_is_not_converted(tmp_path):
    """``keep_rgb`` writes RGB components under an Adobe marker with
    transform 0: no YCbCr conversion, as libjpeg guesses."""
    path = _write(tmp_path / "rgb.jpg", _image(61, 83, 3), quality=90, keep_rgb=True, subsampling=0)
    assert b"Adobe" in Path(path).read_bytes()
    _assert_as_libjpeg_and_pil(path, 61, 83)


@settings(max_examples=50, deadline=None)
@given(w=st.integers(1, 97), h=st.integers(1, 97), sub=st.sampled_from(sorted(SUBSAMPLING)),
       opt=st.sampled_from(sorted(OPTIONS)), quality=st.sampled_from(QUALITIES), seed=st.integers(0, 2**16))
def test_random_sizes_decode_as_libjpeg_and_pil(tmp_path_factory, w, h, sub, opt, quality, seed):
    path = _write(tmp_path_factory.mktemp("hyp") / "x.jpg", _image(w, h, seed), quality=quality,
                  subsampling=SUBSAMPLING[sub], **OPTIONS[opt])
    _assert_as_libjpeg_and_pil(path, w, h)


@pytest.mark.parametrize("opt", ["baseline", "restart_blocks_3"])
def test_a_file_cut_at_60_percent_decodes_as_libjpeg(tmp_path, opt):
    """libjpeg warns ("Premature end of JPEG file") and returns the image:
    the data ends in zero bits, and every block after it stays zero (128)."""
    data = Path(_write(tmp_path / "full.jpg", _image(96, 64, 7), quality=90, **OPTIONS[opt])).read_bytes()
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[:int(len(data) * 0.6)])
    got = native.load_images([str(cut)], 96, 64)[0]
    np.testing.assert_array_equal(got, _libjpeg(str(cut)))
    assert (got[-8:] == 128).all() and not (got[:8] == 128).all()


def test_a_progressive_file_cut_in_its_last_scan_decodes_as_libjpeg(tmp_path):
    """Cut inside the last scan, every coefficient's scan has begun, so
    libjpeg does not smooth: the decode is libjpeg's."""
    data = Path(_write(tmp_path / "full.jpg", _image(96, 64, 8), quality=90, progressive=True)).read_bytes()
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[:int(len(data) * 0.97)])
    np.testing.assert_array_equal(native.load_images([str(cut)], 96, 64)[0], _libjpeg(str(cut)))


def test_block_smoothing_is_refused_not_skipped(tmp_path):
    """A complete progressive file needs no block smoothing (its decode is
    libjpeg's, which has smoothing on). Cut before its AC scans end,
    libjpeg smooths it (libjpeg-turbo 2.1's 5x5 estimate, with the DC
    interpolated while no AC scan has begun): the decoder smooths it alike,
    bit for bit, at every cut, rather than skip it or refuse it."""
    img = _image(96, 64, 9)
    data = Path(_write(tmp_path / "full.jpg", img, quality=90, progressive=True)).read_bytes()
    _assert_as_libjpeg_and_pil(str(tmp_path / "full.jpg"), 96, 64)
    cut = tmp_path / "cut.jpg"
    decoded = 0
    for frac in np.linspace(0.08, 0.98, 31):
        cut.write_bytes(data[:int(len(data) * frac)])
        try:
            ref = _libjpeg(str(cut))
        except IOError:  # cut inside a table that then reads as garbage: both refuse
            with pytest.raises(IOError):
                native.load_images([str(cut)], 96, 64)
            continue
        np.testing.assert_array_equal(native.load_images([str(cut)], 96, 64)[0], ref, err_msg=f"cut at {frac:.3f}")
        decoded += 1
    assert decoded >= 20


@pytest.mark.parametrize("sub", [("2x2", "1x1", "1x1"), ("1x1", "1x1", "1x1"), ("2x1", "1x1", "1x1"),
                                 ("1x2", "1x1", "1x1"), ("1x1",)], ids=["420", "444", "422", "440", "gray"])
def test_block_smoothing_of_cut_files_matches_libjpeg_at_every_scan(tmp_path, sub):
    """libjpeg-written progressive files cut inside every scan and between
    scans (where a marker segment cut short reads libjpeg's fake EOI bytes):
    each iMCU row is smoothed with the coefficient bits of the scan that
    last reached it."""
    for i, (w, h) in enumerate([(61, 83), (200, 150), (9, 9)]):
        src = write_jpeg(tmp_path / f"p{i}.jpg", _image(w, h, 40 + i, gray=len(sub) == 1), 90, sub,
                         progressive=True)
        data = Path(src).read_bytes()
        for frac in np.linspace(0.05, 0.99, 24):
            cut = tmp_path / f"cut{i}.jpg"
            cut.write_bytes(data[:int(len(data) * frac)])
            try:
                ref = _libjpeg(str(cut))
            except IOError:  # a header cut short: libjpeg refuses, and so does the decoder
                with pytest.raises(IOError):
                    native.load_images([str(cut)], w, h)
                continue
            np.testing.assert_array_equal(native.load_images([str(cut)], w, h)[0], ref,
                                          err_msg=f"{sub} {w}x{h} cut at {frac:.3f}")


def test_block_smoothing_follows_the_jax_tier_where_pillow_differs(tmp_path, monkeypatch):
    """libjpeg-turbo 2.1.5 (the JAX tier) and Pillow's 3.1.3 (reading a
    truncated file when told to) smooth a cut 4:2:0 progressive file
    differently, by a level or a few, while they agree on 4:4:4 and gray:
    the decoder follows 2.1.5."""
    from PIL import ImageFile

    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:88, 0:120]
    img = np.clip(np.stack([xx * 2, yy * 2, xx + yy], -1) + rng.randint(-40, 41, (88, 120, 3)), 0, 255)
    differ = {}
    for name, sub in (("420", ("2x2", "1x1", "1x1")), ("444", ("1x1", "1x1", "1x1"))):
        data = Path(write_jpeg(tmp_path / "p.jpg", img.astype(np.uint8), 90, sub, progressive=True)).read_bytes()
        cut = tmp_path / "cut.jpg"
        differ[name] = []
        for frac in np.linspace(0.1, 0.6, 11):
            cut.write_bytes(data[:int(len(data) * frac)])
            got = native.load_images([str(cut)], 120, 88)[0]
            np.testing.assert_array_equal(got, _libjpeg(str(cut)))
            with Image.open(cut) as im:
                differ[name].append(int(np.abs(np.asarray(im.convert("RGB")).astype(int) - got).max()))
    assert max(differ["444"]) == 0
    assert 1 <= max(differ["420"]) <= 8, differ


def test_cmyk_raises_naming_4_components(tmp_path):
    path = str(tmp_path / "cmyk.jpg")
    Image.fromarray(_image(16, 16, 4)).convert("CMYK").save(path, quality=90)
    with pytest.raises(IOError, match=r"cmyk\.jpg: 4 components \(CMYK/YCCK\)"):
        native.load_images([path], 16, 16)
    with pytest.raises(IOError):  # the JAX tier's libjpeg refuses CMYK -> RGB too
        jax_native.load_images([path], 16, 16)


def _patched(tmp_path, name, edit) -> str:
    """A baseline 4:2:0 JPEG with its SOF0 segment edited by ``edit(bytearray, sof offset)``."""
    data = bytearray(Path(_write(tmp_path / "src.jpg", _image(24, 16, 5), quality=90, subsampling=2)).read_bytes())
    edit(data, data.index(b"\xff\xc0"))
    (tmp_path / name).write_bytes(bytes(data))
    return str(tmp_path / name)


FEATURES = [
    ("arith.jpg", lambda d, i: d.__setitem__(i + 1, 0xC9), r"arith\.jpg: arithmetic coding \(SOF9\)"),
    ("lossless.jpg", lambda d, i: d.__setitem__(i + 1, 0xC3), r"lossless JPEG \(SOF3\)"),
    ("hier.jpg", lambda d, i: d.__setitem__(i + 1, 0xC5), r"hierarchical JPEG \(SOF5\)"),
    ("12bit.jpg", lambda d, i: d.__setitem__(i + 4, 12), r"12-bit samples"),
    # 4:4:0 (luma 1x2) and 4:1:1 (luma 4x1): Pillow writes neither.
    ("h1v2.jpg", lambda d, i: d.__setitem__(i + 11, 0x12), r"sampling factors 1x2,1x1,1x1"),
    ("h4v1.jpg", lambda d, i: d.__setitem__(i + 11, 0x41), r"sampling factors 4x1,1x1,1x1"),
]
# The features PR 16's decoder refused that libjpeg decodes: each patched
# file (Huffman data under an arithmetic SOF, or 4:2:0 data under other
# sampling factors, which libjpeg reads as garbage without an error) now
# decodes as libjpeg and Pillow decode it.
DECODED_NOW = {"arith.jpg", "h1v2.jpg", "h4v1.jpg"}


@pytest.mark.parametrize("name,edit,match", FEATURES,
                         ids=[f"{n}-<lambda>-{m}" for n, _, m in FEATURES])
def test_unsupported_features_raise_naming_them(tmp_path, name, edit, match):
    path = _patched(tmp_path, name, edit)
    if name in DECODED_NOW:
        _assert_as_libjpeg_and_pil(path, 24, 16)
    else:
        with pytest.raises(IOError, match=match):
            native.load_images([path], 24, 16)
        with pytest.raises(IOError):  # as the JAX tier's libjpeg-turbo 2.1.5 refuses it
            _libjpeg(path)
    assert native.image_size(path) == (24, 16)  # the header reads


def test_fractional_sampling_is_refused_as_libjpeg_refuses(tmp_path):
    """Luma 3x1 over chroma 2x1: an upsampling ratio of 3/2, which
    libjpeg's jdsample.c refuses (JERR_FRACT_SAMPLE_NOTIMPL)."""
    def edit(d, i):
        d[i + 11], d[i + 14], d[i + 17] = 0x31, 0x21, 0x21
    path = _patched(tmp_path, "frac.jpg", edit)
    with pytest.raises(IOError):
        _libjpeg(path)
    with pytest.raises(IOError, match=r"frac\.jpg: sampling factors 3x1,2x1,2x1 \(a fractional upsampling ratio"):
        native.load_images([path], 24, 16)


SAMPLINGS = [(y, c) for y in ("1x1", "2x1", "1x2", "2x2", "3x1", "1x3", "4x1", "1x4", "4x2", "2x4", "3x2", "3x3",
                              "4x4") for c in ("1x1", "2x1", "1x2", "2x2")
             if eval(y.replace("x", "*")) + 2 * eval(c.replace("x", "*")) <= 10
             and int(y[0]) % int(c[0]) == 0 and int(y[2]) % int(c[2]) == 0]


@pytest.mark.parametrize("luma,chroma", SAMPLINGS, ids=[f"{y}-{c}" for y, c in SAMPLINGS])
def test_every_sampling_libjpeg_decodes(tmp_path, luma, chroma):
    """Each luma/chroma sampling whose ratios are integral and whose MCU
    holds at most 10 blocks, baseline and progressive, written by libjpeg:
    h2v1/h2v2 triangles, h1v2_fancy_upsample, replication otherwise."""
    for i, (w, h) in enumerate([(1, 1), (17, 33), (61, 83)]):
        for prog in (False, True):
            p = write_jpeg(tmp_path / f"{i}{int(prog)}.jpg", _image(w, h, i), 90, (luma, chroma, chroma),
                           progressive=prog)
            _assert_as_libjpeg_and_pil(p, w, h)


def test_mixed_chroma_sampling_and_upsampled_luma(tmp_path):
    """Chroma planes at different rates, and luma below the largest factor."""
    for i, sub in enumerate([("2x2", "1x1", "2x2"), ("1x1", "2x2", "2x2"), ("2x1", "1x2", "1x1"),
                             ("4x1", "2x1", "1x1"), ("1x2", "2x1", "1x1")]):
        for w, h in ((17, 33), (61, 83)):
            p = write_jpeg(tmp_path / f"{i}_{w}.jpg", _image(w, h, i), 85, sub)
            _assert_as_libjpeg_and_pil(p, w, h)


@pytest.mark.parametrize("prog", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("sub", [("1x1", "1x1", "1x1"), ("2x1", "1x1", "1x1"), ("2x2", "1x1", "1x1"),
                                 ("1x2", "1x1", "1x1")], ids=["444", "422", "420", "440"])
def test_arithmetic_coding_decodes_as_libjpeg(tmp_path, sub, prog):
    """SOF9/SOF10 written by libjpeg (jdarith.c's counterpart): qualities
    10-100, restarts by rows and by MCUs, sizes from 1x1."""
    n = 0
    for (rows, mcus), q in itertools.product(((0, 0), (1, 0), (0, 3)), (10, 75, 100)):
        for w, h in ((1, 1), (17, 33), (61, 83)):
            p = write_jpeg(tmp_path / f"{n}.jpg", _image(w, h, n), q, sub, progressive=prog, arith=True,
                           restart_rows=rows, restart_blocks=mcus)
            assert Path(p).read_bytes()[2:].find(b"\xff\xc9" if not prog else b"\xff\xca") >= 0
            _assert_as_libjpeg_and_pil(p, w, h)
            n += 1
    for gray_prog in (False, True):
        p = write_jpeg(tmp_path / f"g{int(gray_prog)}.jpg", _image(40, 30, 3, gray=True), 80, ("1x1",),
                       progressive=gray_prog, arith=True)
        _assert_as_libjpeg_and_pil(p, 40, 30)


def _scan_script(rng, nc):
    """A random valid progressive script: DC first (interleaved or one
    component a scan, Al 0-2), each component's AC split into up to three
    bands with their own Al, then the refinements."""
    dc_al = rng.randint(0, 3)
    scans = ([(list(range(nc)), 0, 0, 0, dc_al)] if nc == 1 or rng.rand() < 0.5
             else [([c], 0, 0, 0, dc_al) for c in range(nc)])
    bands = []
    for c in range(nc):
        cuts = sorted({int(x) for x in rng.randint(2, 63, rng.randint(0, 3))})
        for ss, se in zip([1] + cuts, [x - 1 for x in cuts] + [63]):
            al = rng.randint(0, 3)
            bands.append([([c], ss, se, 0, al)] + [([c], ss, se, a + 1, a) for a in range(al - 1, -1, -1)])
    firsts = [b[0] for b in bands]
    rng.shuffle(firsts)
    refinements = [(list(range(nc)), 0, 0, a + 1, a) for a in range(dc_al - 1, -1, -1)]
    return scans + firsts + refinements + [s for b in bands for s in b[1:]]


@pytest.mark.parametrize("seed", range(6))
def test_scan_scripts_and_cuts_decode_as_libjpeg(tmp_path, seed):
    """libjpeg-written files with random scan scripts: progressive (Huffman
    or arithmetic; spectral bands and successive approximation in any
    order a script allows) and sequential with components split across
    scans, each whole and cut at 12 points (block smoothing with each iMCU
    row's scan, components no scan reached, files that end in their
    headers): the decoder's pixels are libjpeg's, or both refuse."""
    rng = np.random.RandomState(seed)
    decoded = 0
    for trial in range(4):
        gray = trial == 0 and seed % 2 == 0
        sub = ("1x1",) if gray else [("2x2", "1x1", "1x1"), ("2x1", "1x1", "1x1"), ("1x2", "1x1", "1x1"),
                                      ("1x1", "1x1", "1x1")][rng.randint(4)]
        w, h = int(rng.randint(1, 120)), int(rng.randint(1, 120))
        img = _image(w, h, seed * 10 + trial, gray=gray)
        if trial < 3:
            script = _scan_script(rng, 1 if gray else 3)
        else:
            script = [[([0], 0, 63, 0, 0), ([1, 2], 0, 63, 0, 0)], [([2], 0, 63, 0, 0), ([0, 1], 0, 63, 0, 0)],
                      [([0], 0, 63, 0, 0), ([1], 0, 63, 0, 0), ([2], 0, 63, 0, 0)]][seed % 3]
        src = write_jpeg(tmp_path / "s.jpg", img, int(rng.choice([30, 75, 95])), sub, progressive=trial < 3,
                         arith=bool(rng.rand() < 0.35), scans=script, restart_blocks=int(rng.choice([0, 0, 2])))
        data = Path(src).read_bytes()
        for frac in np.linspace(0.05, 1.0, 12):
            cut = tmp_path / "cut.jpg"
            cut.write_bytes(data[:max(4, int(len(data) * frac))])
            try:
                ref = _libjpeg(str(cut))
            except IOError:
                with pytest.raises(IOError):
                    native.load_images([str(cut)], w, h)
                continue
            np.testing.assert_array_equal(native.load_images([str(cut)], w, h)[0], ref,
                                          err_msg=f"{sub} {w}x{h} {script} cut at {frac:.3f}")
            decoded += 1
    assert decoded >= 24, decoded


def test_arithmetic_file_cut_short_decodes_as_libjpeg(tmp_path):
    """An arithmetic-coded file reads zeros past its end (no
    insufficient-data state), sequential and progressive (smoothed)."""
    for prog in (False, True):
        data = Path(write_jpeg(tmp_path / "a.jpg", _image(96, 64, 12), 90, ("2x2", "1x1", "1x1"),
                               progressive=prog, arith=True)).read_bytes()
        for frac in (0.3, 0.55, 0.8, 0.97):
            cut = tmp_path / "cut.jpg"
            cut.write_bytes(data[:int(len(data) * frac)])
            np.testing.assert_array_equal(native.load_images([str(cut)], 96, 64)[0], _libjpeg(str(cut)))


@pytest.mark.parametrize("sub", [("2x2", "1x1", "1x1"), ("1x1", "1x1", "1x1"), ("1x1",)],
                         ids=["420", "444", "gray"])
def test_a_file_without_dht_takes_annex_k_tables(tmp_path, sub):
    """A sequential file whose standard DHT segments are cut out (a
    Motion-JPEG frame): libjpeg takes Annex K's tables, and so does the
    decoder. A progressive file cut so keeps no usable table: libjpeg's
    progressive decoder installs none, and both refuse it."""
    for i, (w, h) in enumerate([(17, 33), (61, 83), (160, 120)]):
        src = write_jpeg(tmp_path / f"s{i}.jpg", _image(w, h, i, gray=len(sub) == 1), 85, sub, restart_blocks=i)
        p = strip_dht(src, tmp_path / f"n{i}.jpg")
        assert b"\xff\xc4" not in Path(p).read_bytes()[:Path(p).read_bytes().index(b"\xff\xda")]
        _assert_as_libjpeg_and_pil(p, w, h)
    src = write_jpeg(tmp_path / "prog.jpg", _image(61, 83, 4), 85, sub, progressive=True)
    p = strip_dht(src, tmp_path / "prog_nodht.jpg")
    with pytest.raises(IOError):
        _libjpeg(p)
    with pytest.raises(IOError, match=r"prog_nodht\.jpg: .*Huffman table .* is not defined"):
        native.load_images([p], 61, 83)


def _lossless_jpeg(img: np.ndarray) -> bytes:
    """An 8-bit lossless (SOF3) grayscale JPEG of ``img``, predictor 1:
    written here, as no encoder on this machine writes one."""
    h, w = img.shape
    bits = [0] * 17
    bits[4] = 9  # categories 0-8, four-bit codes
    codes = {s: s for s in range(9)}
    out, acc, n = bytearray(), 0, 0

    def put(v, k):
        nonlocal acc, n
        acc, n = (acc << k) | (v & ((1 << k) - 1)), n + k
        while n >= 8:
            byte = (acc >> (n - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            n -= 8

    x = img.astype(np.int64)
    for yy in range(h):
        for xx in range(w):
            pred = 128 if yy == 0 and xx == 0 else (x[yy, xx - 1] if xx else x[yy - 1, xx])
            diff = int(x[yy, xx] - pred)
            cat = abs(diff).bit_length()
            put(codes[cat], 4)
            if cat:
                put(diff if diff > 0 else diff - 1, cat)
    if n:
        put((1 << (8 - n)) - 1, 8 - n)
    seg = lambda m, body: b"\xff" + bytes([m]) + (len(body) + 2).to_bytes(2, "big") + body
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([1, 1, 0x11, 0])
    dht = bytes([0x00]) + bytes(bits[1:]) + bytes(range(9))
    sos = bytes([1, 1, 0x00, 1, 0, 0])
    return b"\xff\xd8" + seg(0xC3, sof) + seg(0xC4, dht) + seg(0xDA, sos) + bytes(out) + b"\xff\xd9"


def test_lossless_is_refused_as_the_jax_tier_refuses_it(tmp_path):
    """An 8-bit lossless file: libjpeg-turbo 2.1.5 (the JAX tier) refuses
    it, and so does the decoder, naming it; Pillow's libjpeg-turbo 3
    decodes it (exactly, being lossless). The port follows the JAX tier."""
    img = _image(23, 17, 6, gray=True)
    p = tmp_path / "lossless.jpg"
    p.write_bytes(_lossless_jpeg(img))
    with pytest.raises(IOError):
        _libjpeg(str(p))
    with pytest.raises(IOError, match=r"lossless\.jpg: lossless JPEG \(SOF3\)"):
        native.load_images([str(p)], 23, 17)
    with Image.open(p) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("L")), img)


def test_image_size_reads_sof0_and_sof2_as_libjpeg(tmp_path):
    for opt in ("baseline", "progressive"):
        path = _write(tmp_path / f"{opt}.jpg", _image(83, 61, 2), quality=75, **OPTIONS[opt])
        marker = b"\xff\xc2" if opt == "progressive" else b"\xff\xc0"
        assert marker in Path(path).read_bytes()
        assert native.image_size(path) == jax_native.image_size(path) == (83, 61)


def test_resize_path_equals_the_jax_tier(tmp_path):
    paths = [_write(tmp_path / f"{i}.jpg", _image(83, 61, i), quality=90, subsampling=2) for i in range(3)]
    for w, h in ((40, 30), (100, 70)):
        np.testing.assert_array_equal(native.load_images(paths, w, h), jax_native.load_images(paths, w, h))


# ------------------------------------------------------ the committed scene ---


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, np.uint8).tobytes()).hexdigest()


def test_committed_jpegs_decode_to_their_digests():
    """Both tiers decode every committed JPEG (and PR 15's fixture) to the
    digest recorded from the JAX tier; the files stay under 1.5 MB."""
    digests = json.loads((JPEGS / "digests.json").read_text())
    files = {name: (TESTDATA / name if name == "fixture.jpg" else JPEGS / name) for name in digests}
    assert len(files) == 10 and sum(p.stat().st_size for p in JPEGS.iterdir()) < 1_500_000
    got = native.decode_folder([str(p) for p in files.values()])
    for name, p in files.items():
        assert _digest(got[str(p)]) == digests[name] == _digest(_libjpeg(str(p))), name
    np.testing.assert_array_equal(got[str(files["fixture.jpg"])], np.load(TESTDATA / "fixture_rgb.npy"))


def test_committed_jpeg_modes_decode_to_their_digests():
    """Every committed mode file decodes to the digest recorded from the
    JAX tier's libjpeg, in both tiers, and as Pillow decodes it where
    Pillow reads it whole."""
    digests = json.loads((MODES / "digests.json").read_text())
    assert sorted(digests) == sorted(MODE_FILES) == sorted(p.name for p in MODES.glob("*.jpg"))
    got = native.decode_folder([str(MODES / n) for n in digests])
    for name, want in digests.items():
        path = str(MODES / name)
        assert _digest(got[path]) == want == _digest(_libjpeg(path)), name
        if MODE_FILES[name][1] is None or MODE_FILES[name][1] == "strip_dht":
            np.testing.assert_array_equal(got[path], np.asarray(Image.open(path).convert("RGB")))


def test_committed_jpeg_scene_loads_through_scene_as_in_jax(tmp_path):
    """A COLMAP model written at run time around the committed views: the
    port's ``Scene`` holds the JAX ``Scene``'s images bit for bit."""
    from gaussian_transformer_tpu.scene import Scene as JaxScene
    from gaussian_transformer_tpu_torch.scene import Scene
    from gaussian_transformer_tpu_torch.tools.synthetic import write_colmap_binary

    views = json.loads((JPEGS / "views.json").read_text())
    shots = [(v["c2w"], JPEGS / v["file"]) for v in views["views"]]
    w, h = views["width"], views["height"]
    rng = np.random.RandomState(0)
    names = write_colmap_binary(tmp_path / "data", shots, w, h, views["fovx"], rng.randn(200, 3),
                                rng.randint(0, 256, (200, 3)))
    assert names == [v["file"] for v in views["views"]]
    ns = dict(sh_degree=1, source_path=str(tmp_path / "data"), images="images", resolution=1,
              white_background=False, eval=False)
    random.seed(0)
    cams = Scene(types.SimpleNamespace(model_path=str(tmp_path / "m1"), **ns), sh_degree=1, shuffle=False,
                 device="cpu").get_train_cameras()
    random.seed(0)
    jcams = JaxScene(types.SimpleNamespace(model_path=str(tmp_path / "m2"), data_device="cpu", **ns), sh_degree=1,
                     shuffle=False).get_train_cameras()
    assert [c.image_name for c in cams] == [c.image_name for c in jcams] == [Path(n).stem for n in names]
    for c, jc in zip(cams, jcams):
        np.testing.assert_array_equal(c.original_image.numpy(), np.asarray(jc.original_image))


# ---------------------------------------------------------------- fixtures ---


FIXTURE_SCENE = {"gaussians": 100_000, "seed": 16}
FIXTURE_SIZE = (960, 540)
# name: (Pillow's options, orbit angle); the 1080p view is the timing file.
FIXTURE_VIEWS = {
    **{f"{i:03d}.jpg": ({"quality": 95, "subsampling": 2}, i) for i in range(4)},
    **{f"{i:03d}.jpg": ({"quality": 95, "subsampling": 2, "progressive": True}, i) for i in (4, 5)},
    "006.jpg": ({"quality": 95, "subsampling": 2, "restart_marker_rows": 1}, 6),
    "007.jpg": ({"quality": 95, "subsampling": 0, "optimize": True}, 7),
}
TIMING_FILE = "1080p.jpg"


def write_fixtures(out: Path) -> None:
    """The committed JPEG scene: 8 orbit views of the seeded synthetic scene
    at 960x540 and one at 1920x1080, rendered by the port on the CPU and
    written by Pillow; ``views.json`` (each view's file, options and
    camera-to-world) and ``digests.json`` (the sha256 of the JAX tier's RGB
    decode of each file and of PR 15's ``fixture.jpg``)."""
    import torch

    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.render import render
    from gaussian_transformer_tpu_torch.tools.synthetic import camera_from_c2w, orbit_c2w, synthetic_scene

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    scene = scene_from_numpy(synthetic_scene(FIXTURE_SCENE["gaussians"], FIXTURE_SCENE["seed"]), 3, "cpu")
    fovx = math.radians(50.0)

    def shot(name, c2w, size, opts):
        with torch.no_grad():
            img = render(camera_from_c2w(c2w, fovx, *size, "cpu"), scene)["render"]
        arr = (torch.clamp(img, 0, 1).numpy().transpose(1, 2, 0) * 255).astype(np.uint8)
        Image.fromarray(arr).save(out / name, **opts)
        return {"file": name, "options": opts, "c2w": c2w}

    views = [shot(name, orbit_c2w(2 * math.pi * k / 8), FIXTURE_SIZE, opts)
             for name, (opts, k) in FIXTURE_VIEWS.items()]
    timing = shot(TIMING_FILE, orbit_c2w(math.pi / 8), (1920, 1080), {"quality": 95, "subsampling": 2})
    (out / "views.json").write_text(json.dumps({
        "scene": FIXTURE_SCENE, "fovx": fovx, "width": FIXTURE_SIZE[0], "height": FIXTURE_SIZE[1],
        "views": views, "timing": timing}, indent=1))
    names = [v["file"] for v in views] + [TIMING_FILE]
    digests = {n: _digest(_libjpeg(str(out / n))) for n in names}
    digests["fixture.jpg"] = _digest(_libjpeg(str(TESTDATA / "fixture.jpg")))
    (out / "digests.json").write_text(json.dumps(digests, indent=1))


# name: (the writer's options, what is done to the file after: its DHTs cut
# out, or the file cut in the middle of the data of its n-th scan)
MODE_FILES = {
    "arith_420.jpg": ({"sampling": ("2x2", "1x1", "1x1"), "arith": True}, None),
    "arith_progressive_422_restarts.jpg": (
        {"sampling": ("2x1", "1x1", "1x1"), "arith": True, "progressive": True, "restart_rows": 1}, None),
    "h1v2_440.jpg": ({"sampling": ("1x2", "1x1", "1x1")}, None),
    "h4v1_411.jpg": ({"sampling": ("4x1", "1x1", "1x1"), "progressive": True}, None),
    "h3v1_int_upsample.jpg": ({"sampling": ("3x1", "1x1", "1x1")}, None),
    "no_dht.jpg": ({"sampling": ("2x2", "1x1", "1x1"), "restart_blocks": 8}, "strip_dht"),
    "progressive_cut_smoothed.jpg": ({"sampling": ("2x2", "1x1", "1x1"), "progressive": True}, 2),
    "progressive_cut_dc_only.jpg": ({"sampling": ("2x2", "1x1", "1x1"), "progressive": True}, 1),
}
MODE_SIZE = (320, 240)


def write_mode_fixtures(out: Path) -> None:
    """The committed mode files: one 320x240 view of the seeded synthetic
    scene (rendered by the port on the CPU) written by libjpeg in each mode
    of ``MODE_FILES`` at quality 90, and ``digests.json``, the sha256 of
    the JAX tier's RGB decode of each."""
    import torch

    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.render import render
    from gaussian_transformer_tpu_torch.tools.synthetic import camera_from_c2w, orbit_c2w, synthetic_scene

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    scene = scene_from_numpy(synthetic_scene(FIXTURE_SCENE["gaussians"], FIXTURE_SCENE["seed"]), 3, "cpu")
    with torch.no_grad():
        img = render(camera_from_c2w(orbit_c2w(0.7), math.radians(50.0), *MODE_SIZE, "cpu"), scene)["render"]
    arr = (torch.clamp(img, 0, 1).numpy().transpose(1, 2, 0) * 255).astype(np.uint8)
    for name, (opts, then) in MODE_FILES.items():
        path = out / name
        write_jpeg(path, arr, 90, **opts)
        if then == "strip_dht":
            strip_dht(path, path)
        elif then is not None:
            data = path.read_bytes()
            sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA][then - 1]
            start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
            end = next(i for i in range(start, len(data) - 1) if data[i] == 0xFF and data[i + 1] not in (0, 0xFF)
                       and not 0xD0 <= data[i + 1] <= 0xD7)
            path.write_bytes(data[:(start + end) // 2])
    digests = {n: _digest(_libjpeg(str(out / n))) for n in MODE_FILES}
    (out / "digests.json").write_text(json.dumps(digests, indent=1))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--write-fixtures", action="store_true")
    parser.add_argument("--write-mode-fixtures", action="store_true")
    args = parser.parse_args()
    if args.write_fixtures:
        write_fixtures(JPEGS)
        print(f"wrote {JPEGS}: " + ", ".join(f"{p.name} {p.stat().st_size}" for p in sorted(JPEGS.iterdir())))
    if args.write_mode_fixtures:
        write_mode_fixtures(MODES)
        print(f"wrote {MODES}: " + ", ".join(f"{p.name} {p.stat().st_size}" for p in sorted(MODES.iterdir())))
