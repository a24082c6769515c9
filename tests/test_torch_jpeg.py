"""The port's own JPEG decoder (gaussian_transformer_tpu_torch/native/jpeg.cpp)
against libjpeg-turbo, through the JAX package's native tier, and against
Pillow, bit for bit: baseline, progressive, optimised tables and restart
markers (progressive ones too) at 4:4:4, 4:2:2 and 4:2:0 over qualities
1-100 and sizes from 1x1, 16-bit quantisation tables, grayscale, Adobe
RGB, random sizes, a file cut short, the resize path
and the header reader. Features the decoder does not take raise
``IOError`` naming them. The committed JPEG scene (``native/testdata/jpeg``)
decodes to its recorded digests in both tiers. (A valid encoder ends its
EOB run at each restart marker, so the decoder's reset of it is held only
by following libjpeg's code.)

Pillow writes every JPEG here (it is used in the tests only). The
committed files are made again by ``python -m tests.test_torch_jpeg
--write-fixtures`` (the port renders the views on the CPU)."""

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

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "gaussian_transformer_tpu_torch" / "native" / "testdata"
JPEGS = TESTDATA / "jpeg"

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
    libjpeg would smooth it: the decoder raises, naming that, rather than
    return other pixels."""
    img = _image(96, 64, 9)
    data = Path(_write(tmp_path / "full.jpg", img, quality=90, progressive=True)).read_bytes()
    _assert_as_libjpeg_and_pil(str(tmp_path / "full.jpg"), 96, 64)
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[:int(len(data) * 0.6)])
    _libjpeg(str(cut))  # libjpeg decodes it (smoothed)
    with pytest.raises(IOError, match=r"cut\.jpg: a progressive JPEG .*block smoothing is not implemented"):
        native.load_images([str(cut)], 96, 64)


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


@pytest.mark.parametrize("name,edit,match", [
    ("arith.jpg", lambda d, i: d.__setitem__(i + 1, 0xC9), r"arith\.jpg: arithmetic coding \(SOF9\)"),
    ("lossless.jpg", lambda d, i: d.__setitem__(i + 1, 0xC3), r"lossless JPEG \(SOF3\)"),
    ("hier.jpg", lambda d, i: d.__setitem__(i + 1, 0xC5), r"hierarchical JPEG \(SOF5\)"),
    ("12bit.jpg", lambda d, i: d.__setitem__(i + 4, 12), r"12-bit samples"),
    # 4:4:0 (luma 1x2) and 4:1:1 (luma 4x1): Pillow writes neither.
    ("h1v2.jpg", lambda d, i: d.__setitem__(i + 11, 0x12), r"sampling factors 1x2,1x1,1x1"),
    ("h4v1.jpg", lambda d, i: d.__setitem__(i + 11, 0x41), r"sampling factors 4x1,1x1,1x1"),
])
def test_unsupported_features_raise_naming_them(tmp_path, name, edit, match):
    path = _patched(tmp_path, name, edit)
    with pytest.raises(IOError, match=match):
        native.load_images([path], 24, 16)
    assert native.image_size(path) == (24, 16)  # the header still reads


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


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--write-fixtures", action="store_true")
    if parser.parse_args().write_fixtures:
        write_fixtures(JPEGS)
        print(f"wrote {JPEGS}: " + ", ".join(f"{p.name} {p.stat().st_size}" for p in sorted(JPEGS.iterdir())))
