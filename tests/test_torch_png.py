"""The port's PNG readers against the references, bit for bit: the native
tier's own decoder (``native/png.cpp``, with its own inflate) and the plain
reader beside it (``utils/png.py``), each held to the JAX tier's libpng
path (RGB: expand, strip_16, strip_alpha, gray_to_rgb) and to Pillow's
``convert("RGBA")`` (the JAX Blender reader's). The matrix covers every
colour type at every legal bit depth, Adam7, every filter, zlib's
strategies and levels, tRNS (palette alphas, gray and RGB keys) and sizes
from 1x1; the one place the references disagree, 16-bit gray, is a named
case. Corrupt and truncated files raise, naming the file. The committed
PNGs (``native/testdata/png``) decode to their recorded digests.

libpng writes every PNG here (``tests/torch_image_writer.c``, through
``tests/torch_image_files.py``). The committed files are made again by
``python -m tests.test_torch_png --write-fixtures`` (the port renders the
views on the CPU)."""

import argparse
import hashlib
import itertools
import json
import math
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from gaussian_transformer_tpu import native as jax_native
from gaussian_transformer_tpu_torch import native
from gaussian_transformer_tpu_torch.utils import png as pypng
from tests.torch_image_files import DEPTHS, FILTER_MASKS, STRATEGIES, samples, write_png

ROOT = Path(__file__).resolve().parent.parent
PNGS = ROOT / "gaussian_transformer_tpu_torch" / "native" / "testdata" / "png"
SIZES = [(1, 1), (7, 5), (17, 33), (61, 83)]  # (width, height)

if not jax_native.available():
    jax_native.build()


@pytest.fixture(autouse=True)
def _tiers_built():
    assert native.available(), native.unavailable_reason()
    assert native.codecs() == ("jpeg", "png")
    assert jax_native.available()


# The two readers under test: (RGB, RGBA) of a path.
READERS = {
    "tier": (lambda p: native.decode_folder([p])[p], lambda p: native.decode_folder([p], rgba=True)[p]),
    "python": (pypng.read_png_rgb, pypng.read_png_rgba),
}


def libpng_rgb(path):
    return jax_native.load_images([path], *jax_native.image_size(path))[0]


def pillow_rgba(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _palette(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 3)).astype(np.uint8).tobytes()


def _case(tmp, ct, depth, interlace, trns, w, h, seed, **kw) -> str:
    """A libpng file of seeded samples; ``trns``: None, or "key" (gray/RGB:
    the first pixel's value; palette: an alpha for half the entries)."""
    n_pal = min(256, 1 << depth) if ct == 3 else 0
    s = samples(h, w, ct, depth, seed, n_pal)
    plte = _palette(n_pal, seed) if ct == 3 else None
    key = None
    if trns and ct == 3:
        key = np.random.RandomState(seed + 1).randint(0, 256, max(1, n_pal // 2)).astype(np.uint8).tobytes()
    elif trns:
        key = b"".join(struct.pack(">H", int(v)) for v in s[0, 0])
    return write_png(tmp / f"c{ct}d{depth}i{int(interlace)}t{int(bool(trns))}_{w}x{h}_{seed}.png", s, ct, depth,
                     interlace, plte=plte, trns=key, **kw)


MATRIX = [(ct, d, il, t) for ct, depths in DEPTHS.items() for d in depths for il in (False, True)
          for t in ((False, True) if ct in (0, 2, 3) else (False,))]


@pytest.mark.parametrize("reader", sorted(READERS))
@pytest.mark.parametrize("ct,depth,interlace,trns", MATRIX,
                         ids=[f"ct{c}-{d}bit-{'adam7' if i else 'plain'}{'-trns' if t else ''}" for c, d, i, t in MATRIX])
def test_png_matrix_equals_libpng_rgb_and_pillow_rgba(tmp_path, reader, ct, depth, interlace, trns):
    rgb_of, rgba_of = READERS[reader]
    for i, (w, h) in enumerate(SIZES):
        p = _case(tmp_path, ct, depth, interlace, trns, w, h, seed=100 * ct + depth + i)
        np.testing.assert_array_equal(rgb_of(p), libpng_rgb(p), err_msg=f"{p} RGB")
        np.testing.assert_array_equal(rgba_of(p), pillow_rgba(p), err_msg=f"{p} RGBA")


@pytest.mark.parametrize("reader", sorted(READERS))
def test_sixteen_bit_gray_follows_each_reference(tmp_path, reader):
    """The references disagree on 16-bit gray: libpng's strip_16 keeps the
    high byte, while Pillow reads the file as I;16 and its RGBA conversion
    clips the value to 255. Each output follows the path it replaces."""
    rgb_of, rgba_of = READERS[reader]
    s = np.array([[[0], [255], [256], [4660], [65535]]], np.int64)
    p = write_png(tmp_path / "gray16.png", s, 0, 16)
    rgb, rgba = rgb_of(p), rgba_of(p)
    np.testing.assert_array_equal(rgb[0, :, 0], [0, 0, 1, 0x12, 255])  # high bytes
    np.testing.assert_array_equal(rgba[0, :, 0], [0, 255, 255, 255, 255])  # clipped
    np.testing.assert_array_equal(rgb, libpng_rgb(p))
    np.testing.assert_array_equal(rgba, pillow_rgba(p))


@pytest.mark.parametrize("reader", sorted(READERS))
@pytest.mark.parametrize("filt", sorted(FILTER_MASKS))
def test_every_filter_strategy_and_level(tmp_path, reader, filt):
    rgb_of, rgba_of = READERS[reader]
    for (name, strategy), level in itertools.product(STRATEGIES.items(), (0, 1, 6, 9)):
        for ct, depth in ((6, 8), (2, 16), (0, 4)):
            s = samples(29, 37, ct, depth, level + ct)
            p = write_png(tmp_path / f"{name}{level}{ct}.png", s, ct, depth, level % 2 == 1,
                          filters=FILTER_MASKS[filt], level=level, strategy=strategy)
            np.testing.assert_array_equal(rgba_of(p), pillow_rgba(p), err_msg=f"{filt} {name} level {level}")
            np.testing.assert_array_equal(rgb_of(p), libpng_rgb(p), err_msg=f"{filt} {name} level {level}")


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 70), h=st.integers(1, 70), case=st.sampled_from(MATRIX), seed=st.integers(0, 2**16))
def test_random_sizes_in_both_readers(tmp_path_factory, w, h, case, seed):
    ct, depth, interlace, trns = case
    p = _case(tmp_path_factory.mktemp("hyp"), ct, depth, interlace, trns, w, h, seed)
    for rgb_of, rgba_of in READERS.values():
        np.testing.assert_array_equal(rgb_of(p), libpng_rgb(p))
        np.testing.assert_array_equal(rgba_of(p), pillow_rgba(p))


def _gray_png(payload: bytes, compressor) -> bytes:
    """A one-row 8-bit gray PNG whose pixels are ``payload``: its IDAT is
    the stream ``compressor`` makes of the filter byte and the payload."""
    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", len(payload), 1, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", compressor(b"\x00" + payload))
            + chunk(b"IEND", b""))


@settings(max_examples=60, deadline=None)
@given(data=st.binary(min_size=1, max_size=3000), repeats=st.integers(1, 40),
       strategy=st.sampled_from(sorted(STRATEGIES)), level=st.sampled_from([0, 1, 3, 6, 9]),
       wbits=st.sampled_from([9, 12, 15]))
def test_inflate_equals_zlib(tmp_path_factory, data, repeats, strategy, level, wbits):
    """The tier's inflate against Python's zlib, through a one-row PNG:
    stored, fixed and dynamic blocks from every strategy and level, window
    sizes from 512 B, matches reaching back across the whole window."""
    payload = (data * repeats)[:60000]

    def compress(raw):
        c = zlib.compressobj(level, zlib.DEFLATED, wbits, 8, STRATEGIES[strategy])
        return c.compress(raw) + c.flush()

    p = tmp_path_factory.mktemp("inflate") / "x.png"
    blob = _gray_png(payload, compress)
    p.write_bytes(blob)
    got = native.decode_folder([str(p)])[str(p)]
    assert got[0, :, 0].tobytes() == zlib.decompress(compress(b"\x00" + payload))[1:] == payload


def _corrupt(blob: bytes, how: str) -> bytes:
    idat = blob.index(b"IDAT")
    if how == "idat_crc":
        return blob[:idat + 10] + bytes([blob[idat + 10] ^ 0xFF]) + blob[idat + 11:]
    if how == "truncated":
        return blob[: len(blob) // 2]
    if how == "adler":
        n = struct.unpack(">I", blob[idat - 4:idat])[0]
        data = bytearray(blob[idat + 4:idat + 4 + n])
        data[-1] ^= 0x55
        crc = struct.pack(">I", zlib.crc32(b"IDAT" + bytes(data)))
        return blob[:idat + 4] + bytes(data) + crc + blob[idat + 8 + n:]
    if how == "signature":
        return b"\x89PNX" + blob[4:]
    if how == "critical_chunk":
        extra = b"\x00\x00\x00\x00ABCD" + struct.pack(">I", zlib.crc32(b"ABCD"))
        return blob[:idat - 4] + extra + blob[idat - 4:]
    raise ValueError(how)


@pytest.mark.parametrize("how", ["idat_crc", "truncated", "adler", "signature", "critical_chunk"])
def test_corrupt_and_truncated_files_raise_naming_the_file(tmp_path, how):
    good = write_png(tmp_path / "good.png", samples(20, 30, 2, 8, 1), 2, 8, level=1)
    bad = tmp_path / f"bad_{how}.png"
    bad.write_bytes(_corrupt(Path(good).read_bytes(), how))
    with pytest.raises(IOError, match=rf"bad_{how}\.png: "):
        native.decode_folder([str(bad)])
    with pytest.raises(ValueError, match=rf"bad_{how}\.png: "):
        pypng.read_png_rgba(str(bad))
    assert native.decode_error(str(bad)) and native.decode_error(good) == ""


def test_ancillary_chunks_are_skipped_even_with_a_bad_crc(tmp_path):
    """gAMA, iCCP and tEXt change nothing in either reference; a broken
    ancillary chunk is skipped, as libpng skips it."""
    good = Path(write_png(tmp_path / "good.png", samples(9, 11, 6, 8, 2), 6, 8))
    blob = good.read_bytes()
    idat = blob.index(b"IDAT") - 4
    gama = struct.pack(">I", 4) + b"gAMA" + struct.pack(">I", 45455) + struct.pack(">I", 0xDEADBEEF)
    text = struct.pack(">I", 5) + b"tEXt" + b"a\x00bcd" + struct.pack(">I", zlib.crc32(b"tEXta\x00bcd"))
    p = tmp_path / "anc.png"
    p.write_bytes(blob[:idat] + gama + text + blob[idat:])
    for rgb_of, rgba_of in READERS.values():
        np.testing.assert_array_equal(rgba_of(str(p)), pillow_rgba(str(good)))
        np.testing.assert_array_equal(rgb_of(str(p)), libpng_rgb(str(good)))


def test_png_chunks_split_across_many_idats(tmp_path):
    """IDAT data split into many chunks (here 7 bytes each) reads as one stream."""
    good = Path(write_png(tmp_path / "good.png", samples(31, 23, 2, 16, 3), 2, 16))
    blob = good.read_bytes()
    start = blob.index(b"IDAT") - 4
    n = struct.unpack(">I", blob[start:start + 4])[0]
    data = blob[start + 8:start + 8 + n]
    chunks = b"".join(struct.pack(">I", len(data[i:i + 7])) + b"IDAT" + data[i:i + 7]
                      + struct.pack(">I", zlib.crc32(b"IDAT" + data[i:i + 7])) for i in range(0, n, 7))
    p = tmp_path / "split.png"
    p.write_bytes(blob[:start] + chunks + blob[start + 12 + n:])
    for rgb_of, rgba_of in READERS.values():
        np.testing.assert_array_equal(rgb_of(str(p)), libpng_rgb(str(good)))
        np.testing.assert_array_equal(rgba_of(str(p)), pillow_rgba(str(p)))


@pytest.mark.parametrize("reader", sorted(READERS))
def test_trns_keys_as_pillow_compares_them(tmp_path, reader):
    """Every gray key at depths 1-8 (and past 2 ** depth), 16-bit gray and
    RGB keys over 255, in Pillow's RGBA: Pillow compares a key with the
    8-bit samples it converts, so a 2- or 4-bit key matches only 0, a 16-bit
    key's low byte meets the clipped gray or the high bytes."""
    _, rgba_of = READERS[reader]
    for depth in (1, 2, 4, 8):
        s = np.arange(1 << depth).reshape(1, -1, 1)
        for key in list(range(min(1 << depth, 256))) + [1 << depth, 255, 300, 65535]:
            p = write_png(tmp_path / "g.png", s, 0, depth, trns=struct.pack(">H", key))
            np.testing.assert_array_equal(rgba_of(p), pillow_rgba(p), err_msg=f"gray {depth}-bit key {key}")
    vals = np.array([0, 44, 77, 255, 256, 300, 44 * 256, 77 * 256 + 5, 65535, 255 * 256 + 7]).reshape(1, -1, 1)
    for key in (77, 255, 256, 300, 44, 65535, 11264):
        p = write_png(tmp_path / "g16.png", vals, 0, 16, trns=struct.pack(">H", key))
        np.testing.assert_array_equal(rgba_of(p), pillow_rgba(p), err_msg=f"gray 16-bit key {key}")
    rgb = np.array([(0, 0, 0), (300, 77, 0), (44, 77, 0), (44 * 256, 77 * 256, 0), (255, 77, 0), (65535, 77, 0),
                    (300 + 256 * 3, 77, 0)]).reshape(1, -1, 3)
    for depth, keys in ((16, [(300, 77, 0), (44, 77, 0), (65535, 77, 0), (0, 0, 0)]),
                        (8, [(44, 77, 0), (300, 77, 0), (44, 77, 256), (255, 77, 0)])):
        s = rgb if depth == 16 else np.minimum(rgb, 255)
        for key in keys:
            p = write_png(tmp_path / "rgb.png", s, 2, depth, trns=struct.pack(">HHH", *key))
            np.testing.assert_array_equal(rgba_of(p), pillow_rgba(p), err_msg=f"RGB {depth}-bit key {key}")


def test_palette_indices_and_trns_past_plte(tmp_path):
    """Hand-made palette files no libpng writes: indices past PLTE's
    entries read black (both references), and a tRNS longer than PLTE
    gives those indices its alphas in Pillow's RGBA (libpng drops such a
    tRNS, which its RGB output never shows)."""
    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    for i, trns in enumerate((None, bytes([0, 128]), bytes([10, 20, 30, 40, 50, 60, 70]))):
        blob = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 12, 2, 8, 3, 0, 0, 0))
                + chunk(b"PLTE", bytes(range(100, 112))) + (chunk(b"tRNS", trns) if trns else b"")
                + chunk(b"IDAT", zlib.compress(b"\x00" + bytes(range(12)) + b"\x00" + bytes(range(11, -1, -1))))
                + chunk(b"IEND", b""))
        p = tmp_path / f"pal{i}.png"
        p.write_bytes(blob)
        for rgb_of, rgba_of in READERS.values():
            np.testing.assert_array_equal(rgb_of(str(p)), libpng_rgb(str(p)))
            np.testing.assert_array_equal(rgba_of(str(p)), pillow_rgba(str(p)))


# ------------------------------------------------------ the committed PNGs ---


def committed_pngs():
    return sorted(p for p in PNGS.rglob("*.png"))


@pytest.mark.parametrize("reader", sorted(READERS))
def test_committed_pngs_decode_to_their_digests(reader):
    """Every committed PNG, in both outputs, against the digests recorded
    from libpng (RGB) and Pillow (RGBA); the fixtures stay under 3 MB with
    the JPEG modes' files."""
    digests = json.loads((PNGS / "digests.json").read_text())["files"]
    files = committed_pngs()
    assert sorted(str(p.relative_to(PNGS)) for p in files) == sorted(digests)
    total = sum(p.stat().st_size for p in PNGS.rglob("*") if p.is_file())
    total += sum(p.stat().st_size for p in (PNGS.parent / "jpeg_modes").iterdir())
    assert total < 3_000_000, total
    rgb_of, rgba_of = READERS[reader]
    for p in files:
        if reader == "python" and p.name == "1080p.png":
            continue  # the timing file: seconds in the plain reader; chip_smoke.py times it there
        d = digests[str(p.relative_to(PNGS))]
        assert _digest(rgb_of(str(p))) == d["rgb"], p
        assert _digest(rgba_of(str(p))) == d["rgba"], p


def test_committed_digests_are_the_references():
    digests = json.loads((PNGS / "digests.json").read_text())["files"]
    for p in committed_pngs():
        d = digests[str(p.relative_to(PNGS))]
        assert _digest(libpng_rgb(str(p))) == d["rgb"] and _digest(pillow_rgba(str(p))) == d["rgba"], p


# ---------------------------------------------------------------- fixtures ---


FIXTURE_SCENE = {"gaussians": 100_000, "seed": 16}
BLENDER_SIZE = 800  # NeRF-synthetic's
# split/name: (how it is written, orbit angle in eighths of a turn)
BLENDER_VIEWS = {
    "train/r_0": ("rgba", 0),
    "train/r_1": ("rgba-adam7", 2),
    "train/r_2": ("palette-trns", 4),
    "train/r_3": ("rgba", 6),
    "test/r_0": ("rgba", 1),
}
TIMING_FILE = "1080p.png"
ORBIT_RADIUS, ORBIT_HEIGHT = 7.0, 2.5  # the whole object in view, on a transparent ground


def _modes(out: Path) -> None:
    """Small files of every colour type, bit depth and interlacing, with
    tRNS where the type takes it."""
    for ct, depth, interlace, trns in MATRIX:
        _case(out, ct, depth, interlace, trns, 33, 17, seed=7 * ct + depth)


def _quantize_rgba(rgba: np.ndarray):
    """A palette of at most 256 RGBA entries for a uint8 RGBA image (4 alpha
    levels x 4x4x4 colours): (indices [H, W, 1], PLTE bytes, tRNS bytes)."""
    lv = (rgba.astype(np.int64) * 4) // 256  # 0..3 per channel
    idx = lv[..., 3] * 64 + lv[..., 0] * 16 + lv[..., 1] * 4 + lv[..., 2]
    grid = np.arange(256)
    colour = ((np.stack([(grid // 16) % 4, (grid // 4) % 4, grid % 4], -1) * 255) // 3).astype(np.uint8)
    alpha = ((grid // 64) * 255 // 3).astype(np.uint8)
    return idx[..., None], colour.tobytes(), alpha.tobytes()


def write_fixtures(out: Path) -> None:
    """The committed PNGs: a Blender-format scene of 800x800 RGBA views of
    the seeded synthetic scene (rendered by the port on the CPU, alpha = 1 -
    the final transmittance, written by libpng with all filters; one Adam7,
    one palette + tRNS), a 1920x1080 RGB view for the timings, and small
    files of every PNG mode; ``digests.json`` holds the sha256 of each
    file's libpng RGB and Pillow RGBA decode, and of each Blender view as
    the JAX reader loads it (Pillow's RGBA composited over black, then
    ``pil_to_array`` at full size and at ``-r 2``)."""
    import torch

    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.render import render
    from gaussian_transformer_tpu_torch.tools.synthetic import camera_from_c2w, orbit_c2w, synthetic_scene

    shutil.rmtree(out, ignore_errors=True)
    (out / "modes").mkdir(parents=True)
    scene = scene_from_numpy(synthetic_scene(FIXTURE_SCENE["gaussians"], FIXTURE_SCENE["seed"]), 3, "cpu")
    fovx = math.radians(60.0)  # the object in the middle, a transparent border (as in NeRF-synthetic)

    def shot(c2w, w, h):
        with torch.no_grad():
            r = render(camera_from_c2w(c2w, fovx, w, h, "cpu"), scene)
        rgb = torch.clamp(r["render"], 0, 1).numpy().transpose(1, 2, 0)
        alpha = np.clip(1.0 - r["final_T"].numpy(), 0, 1)[..., None]
        straight = np.where(alpha > 1 / 255, np.clip(rgb / np.maximum(alpha, 1e-6), 0, 1), 0.0)
        return np.concatenate([straight, alpha], -1)

    frames = {"train": [], "test": []}
    for name, (how, k) in BLENDER_VIEWS.items():
        split = name.split("/")[0]
        (out / "blender" / split).mkdir(parents=True, exist_ok=True)
        c2w = orbit_c2w(2 * math.pi * k / 8, ORBIT_RADIUS, ORBIT_HEIGHT)
        rgba = np.round(shot(c2w, BLENDER_SIZE, BLENDER_SIZE) * 255).astype(np.int64)
        path = out / "blender" / f"{name}.png"
        if how == "palette-trns":
            idx, plte, trns = _quantize_rgba(rgba)
            write_png(path, idx, 3, 8, plte=plte, trns=trns)
        else:
            write_png(path, rgba, 6, 8, interlace=how == "rgba-adam7")
        frames[split].append({"file_path": f"./{name}", "transform_matrix": c2w, "written": how})
    for split, fr in frames.items():
        (out / "blender" / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": fovx, "frames": fr}, indent=1))
    big = np.round(shot(orbit_c2w(math.pi / 8, ORBIT_RADIUS, ORBIT_HEIGHT), 1920, 1080)[..., :3] * 255).astype(np.int64)
    write_png(out / TIMING_FILE, big, 2, 8)
    _modes(out / "modes")

    files = {str(p.relative_to(out)): {"rgb": _digest(libpng_rgb(str(p))), "rgba": _digest(pillow_rgba(str(p)))}
             for p in sorted(out.rglob("*.png"))}
    scene_digests = {}
    for name in BLENDER_VIEWS:  # the JAX Blender reader's composite, then pil_to_array
        norm = pillow_rgba(str(out / "blender" / f"{name}.png")) / 255.0
        arr = norm[:, :, :3] * norm[:, :, 3:4] + np.array([0, 0, 0]) * (1 - norm[:, :, 3:4])
        image = Image.fromarray(np.array(arr * 255.0, dtype=np.uint8), "RGB")
        for r in (1, 2):
            size = (round(BLENDER_SIZE / r), round(BLENDER_SIZE / r))
            chw = np.transpose(np.asarray(image.resize(size), dtype=np.float32) / 255.0, (2, 0, 1))
            scene_digests.setdefault(f"r{r}", {})[name] = _digest(chw)
    (out / "digests.json").write_text(json.dumps({"files": files, "scene": scene_digests}, indent=1))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--write-fixtures", action="store_true")
    if parser.parse_args().write_fixtures:
        write_fixtures(PNGS)
        print(f"wrote {PNGS}: {sum(p.stat().st_size for p in PNGS.rglob('*') if p.is_file())} B")
