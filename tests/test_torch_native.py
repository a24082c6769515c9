"""The port's native IO tier (gaussian_transformer_tpu_torch/native/) against
the JAX package's native tier and the port's own Python readers, bit for
bit: COLMAP images.bin and points3D.bin, float32 PLY reads and writes (the
files byte for byte), PNG and JPEG decodes (JPEGs written here with PIL,
in the tests only). Also: which channels of an RGBA PNG reach ``Camera``,
the named error for a JPEG when the tier cannot be built, a build on a
machine without libjpeg, libpng or zlib (images decode all the same: the
tier has its own decoders, ``native/jpeg.cpp`` and ``native/png.cpp``;
``tests/test_torch_jpeg.py`` and ``tests/test_torch_png.py`` hold them to
libjpeg, libpng and Pillow in depth), a concurrent first build from two
processes, and a COLMAP folder of JPEGs loaded through ``Scene`` as the
JAX package loads it.

The committed JPEG fixture (``native/testdata/fixture.jpg`` and the RGB
array the JAX native tier decodes from it, ``fixture_rgb.npy``) is
written by ``python -m tests.test_torch_native --write-fixture``; the
tier's decode is held to the array bit for bit here."""

import argparse
import math
import os
import random
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussian_transformer_tpu import native as jax_native
from gaussian_transformer_tpu_torch import native
from gaussian_transformer_tpu_torch.scene import Scene
from gaussian_transformer_tpu_torch.scene import colmap, dataset_readers, ply
from gaussian_transformer_tpu_torch.tools.synthetic import orbit_c2w, write_colmap_binary
from gaussian_transformer_tpu_torch.utils.png import read_png, write_png

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "gaussian_transformer_tpu_torch" / "native" / "testdata"

if not jax_native.available():
    jax_native.build()


@pytest.fixture(autouse=True)
def _tiers_built():
    assert native.available(), native.unavailable_reason()
    assert native.codecs() == ("jpeg", "png"), native.missing()
    assert jax_native.available()


def _views(n, h, w, seed, channels=3):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        base = np.stack([(xx * 255 // w + 40 * i) % 256, (yy * 255 // h) % 256, (xx + yy + 17 * i) % 256], -1)
        img = np.clip(base + rng.randint(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
        if channels == 4:
            img = np.concatenate([img, rng.randint(0, 256, (h, w, 1)).astype(np.uint8)], -1)
        out.append((orbit_c2w(2 * math.pi * i / n), img))
    return out


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("colmap")
    rng = np.random.RandomState(5)
    xyz, rgb = rng.randn(777, 3), rng.randint(0, 256, (777, 3))
    names = write_colmap_binary(root, _views(5, 24, 40, 0), 40, 24, math.radians(50), xyz, rgb)
    return types.SimpleNamespace(root=root, xyz=xyz, rgb=rgb, names=names)


# --------------------------------------------------------------- COLMAP ---


def test_points3d_bin_native_python_and_jax_agree(colmap_dir):
    path = str(colmap_dir.root / "sparse/0/points3D.bin")
    got = colmap.read_points3D_binary(path)
    py = colmap.read_points3D_binary(path, native_io=False)
    jx, jr, je = jax_native.read_points3d_bin(path)
    for a, b in zip(got, py):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], jx)
    np.testing.assert_array_equal(got[1], jr)
    np.testing.assert_array_equal(got[2][:, 0], je)
    np.testing.assert_array_equal(got[0], colmap_dir.xyz)
    np.testing.assert_array_equal(got[1], colmap_dir.rgb)


def test_images_bin_native_python_and_jax_agree(colmap_dir):
    path = str(colmap_dir.root / "sparse/0/images.bin")
    got = colmap.read_extrinsics_binary(path)
    py = colmap.read_extrinsics_binary(path, native_io=False)
    ids, qvecs, tvecs, cam_ids, names = jax_native.read_images_bin(path)
    assert sorted(got) == sorted(py) == sorted(int(i) for i in ids)
    assert [got[k].name for k in sorted(got)] == colmap_dir.names == names
    for k, i in zip(sorted(got), range(len(ids))):
        a, b = got[k], py[k]
        assert (a.id, a.camera_id, a.name) == (b.id, b.camera_id, b.name)
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
        np.testing.assert_array_equal(a.qvec, qvecs[i])
        np.testing.assert_array_equal(a.tvec, tvecs[i])
        assert a.xys.shape == (0, 2)  # the native parser skips the observations


def test_a_broken_bin_falls_to_the_python_parser_which_raises(tmp_path):
    path = tmp_path / "points3D.bin"
    path.write_bytes((5).to_bytes(8, "little") + b"\x00" * 20)
    with pytest.raises(Exception):
        colmap.read_points3D_binary(str(path))


# ------------------------------------------------------------------ PLY ---


def test_ply_round_trips_bit_for_bit(tmp_path):
    """The native and Python writers write the same bytes; the native, the
    Python and the JAX native readers read the same arrays; a point-cloud
    PLY (uchar colours) still reads through the Python path."""
    rng = np.random.RandomState(1)
    names = ["x", "y", "z", "f_dc_0", "opacity", "scale_0", "rot_0"]
    data = rng.randn(1001, len(names)).astype(np.float32)
    data[0, 0] = np.float32(np.nextafter(1, 2))
    a, b = tmp_path / "native.ply", tmp_path / "python.ply"
    ply.write_ply_vertex_table(str(a), names, data)
    ply.write_ply_vertex_table(str(b), names, data, native_io=False)
    assert a.read_bytes() == b.read_bytes()
    got = ply.read_ply_vertex_table(str(a))
    py = ply.read_ply_vertex_table(str(a), native_io=False)
    jd, jn = jax_native.read_ply_f32(str(a))
    assert list(got) == list(py) == jn == names
    for i, k in enumerate(names):
        assert got[k].dtype == py[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], py[k])
        np.testing.assert_array_equal(got[k], jd[:, i])
        np.testing.assert_array_equal(got[k], data[:, i])

    pc = tmp_path / "pc.ply"
    ply.store_point_cloud(str(pc), rng.randn(50, 3), rng.randint(0, 256, (50, 3)))
    table = ply.read_ply_vertex_table(str(pc))
    assert table["red"].dtype == np.uint8 and len(table["x"]) == 50


def test_gaussian_scene_ply_round_trip(tmp_path):
    import chip_smoke
    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene

    scene = scene_from_numpy(chip_smoke.synthetic_scene(3000, 2), 3, "cpu")
    scene.save_ply(str(tmp_path / "a.ply"))
    back = GaussianScene.load_ply(str(tmp_path / "a.ply"), 3, device="cpu")
    for k in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        torch.testing.assert_close(getattr(back, k)[:3000], getattr(scene, k)[:3000], rtol=0, atol=0)


# --------------------------------------------------------------- images ---


def test_png_decode_native_python_and_jax_agree(tmp_path):
    paths = []
    for i, (_, img) in enumerate(_views(4, 21, 33, 3)):
        p = str(tmp_path / f"{i}.png")
        write_png(p, img)
        paths.append(p)
    p = str(tmp_path / "big.png")
    write_png(p, _views(1, 30, 50, 4)[0][1])
    paths.append(p)
    got = native.decode_folder(paths)
    for p in paths:
        ref = read_png(p)
        w, h = jax_native.image_size(p)
        np.testing.assert_array_equal(got[p], ref)
        np.testing.assert_array_equal(got[p], jax_native.load_images([p], w, h)[0])


def test_jpeg_decode_matches_the_jax_tier_and_pil(tmp_path):
    from PIL import Image

    paths = []
    for i, (_, img) in enumerate(_views(3, 40, 56, 5)):
        p = str(tmp_path / f"{i}.JPG")
        Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    got = native.decode_folder(paths)
    for p in paths:
        w, h = jax_native.image_size(p)
        assert native.image_size(p) == (w, h) == (56, 40)
        np.testing.assert_array_equal(got[p], jax_native.load_images([p], w, h)[0])
        np.testing.assert_array_equal(got[p], np.asarray(Image.open(p).convert("RGB")))
    # The resize path (a target size other than the file's) is the JAX tier's too.
    np.testing.assert_array_equal(native.load_images(paths, 30, 20), jax_native.load_images(paths, 30, 20))


def test_committed_jpeg_fixture_decodes_to_its_array():
    got = native.decode_folder([str(FIXTURE / "fixture.jpg")])[str(FIXTURE / "fixture.jpg")]
    ref = np.load(FIXTURE / "fixture_rgb.npy")
    assert (FIXTURE / "fixture.jpg").stat().st_size < 200_000
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------- the channel rule ---


def _colmap_scene(root, ext, channels, seed=0):
    """A COLMAP binary scene of 3 views whose images are written as PNG (RGB
    or RGBA) or JPEG (with PIL)."""
    views = _views(3, 24, 40, seed, channels)
    write_colmap_binary(root, [(c, img[..., :3]) for c, img in views], 40, 24, math.radians(50),
                        np.random.RandomState(seed).randn(300, 3), np.full((300, 3), 128))
    if ext == ".jpg" or channels == 4:
        from PIL import Image

        # Rewrite the image folder and the names in images.bin.
        for i, (_, img) in enumerate(views):
            os.remove(root / "images" / f"{i:03d}.png")
            Image.fromarray(img).save(root / "images" / f"{i:03d}{ext}", quality=90)
        data = (root / "sparse/0/images.bin").read_bytes()
        (root / "sparse/0/images.bin").write_bytes(data.replace(b".png\x00", ext.encode() + b"\x00"))
    return views


def _port_scene(src, model):
    random.seed(0)
    ns = types.SimpleNamespace(sh_degree=1, source_path=str(src), model_path=str(model), images="images",
                               resolution=1, white_background=False, eval=False)
    return Scene(ns, sh_degree=1, shuffle=False, device="cpu")


def _jax_scene(src, model):
    from gaussian_transformer_tpu.scene import Scene as JaxScene

    random.seed(0)
    ns = types.SimpleNamespace(sh_degree=1, source_path=str(src), model_path=str(model), images="images",
                               resolution=1, white_background=False, eval=False, data_device="cpu")
    return JaxScene(ns, sh_degree=1, shuffle=False)


def test_rgba_png_reaches_camera_as_rgb_with_the_tier_built(tmp_path):
    """With the tier built (the JAX package's native behaviour), an RGBA
    PNG's alpha is dropped: ``Camera`` holds its RGB / 255, unmasked, as the
    JAX ``Scene`` does. ``utils/png.py``'s ``read_png`` (the reader where no
    compiler builds the tier) keeps the alpha, as Pillow's path does."""
    views = _colmap_scene(tmp_path / "data", ".png", channels=4)
    cams = _port_scene(tmp_path / "data", tmp_path / "m1").get_train_cameras()
    jcams = _jax_scene(tmp_path / "data", tmp_path / "m2").get_train_cameras()
    by_name = {c.image_name: c for c in cams}
    for i, (_, img) in enumerate(views):
        cam = by_name[f"{i:03d}"]
        rgb = img[..., :3].transpose(2, 0, 1).astype(np.float32) / 255.0
        np.testing.assert_array_equal(cam.original_image.numpy(), rgb)
    for jc in jcams:
        np.testing.assert_array_equal(by_name[jc.image_name].original_image.numpy(), np.asarray(jc.original_image))

    decoded = dataset_readers.decode_images([str(tmp_path / "data/images/000.png")])
    assert decoded[str(tmp_path / "data/images/000.png")].shape[-1] == 3
    assert read_png(str(tmp_path / "data/images/000.png")).shape[-1] == 4


def test_colmap_jpeg_folder_loads_through_scene_as_in_jax(tmp_path):
    """A COLMAP folder of JPEGs: the port's Scene holds the JAX Scene's
    images bit for bit (the tier's own decoder against libjpeg), its
    cameras and its point cloud."""
    _colmap_scene(tmp_path / "data", ".jpg", channels=3, seed=1)
    scene = _port_scene(tmp_path / "data", tmp_path / "m1")
    jscene = _jax_scene(tmp_path / "data", tmp_path / "m2")
    cams, jcams = scene.get_train_cameras(), jscene.get_train_cameras()
    assert [c.image_name for c in cams] == [c.image_name for c in jcams] == ["000", "001", "002"]
    for c, jc in zip(cams, jcams):
        np.testing.assert_array_equal(c.original_image.numpy(), np.asarray(jc.original_image))
        np.testing.assert_allclose(c.world_view_transform.numpy(), np.asarray(jc.world_view_transform),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(scene.gaussians.xyz.detach().numpy()[:300], np.asarray(jscene.gaussians.xyz)[:300])


# ------------------- a machine without libjpeg, libpng or zlib, or without g++ ---


@pytest.fixture
def fresh_tier(tmp_path, monkeypatch):
    """The module's state reset onto an empty build directory (restored after)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_why", None)
    return monkeypatch


def test_no_compiler_names_the_missing_tier_and_pngs_still_load(tmp_path, fresh_tier):
    fresh_tier.setenv("CXX", str(tmp_path / "no-such-g++"))
    _colmap_scene(tmp_path / "jpg", ".jpg", channels=3)
    assert not native.available() and "no-such-g++" in native.unavailable_reason()
    with pytest.raises(native.CodecUnavailable,
                       match=r"JPEG needs the native IO tier's JPEG decoder .*native IO tier unavailable: "
                             r"no C\+\+ compiler \(.*no-such-g\+\+ not found\)"):
        _port_scene(tmp_path / "jpg", tmp_path / "m1")
    # PNGs load through utils/png.py, and the bins through the Python parsers.
    views = _colmap_scene(tmp_path / "png", ".png", channels=3)
    cams = _port_scene(tmp_path / "png", tmp_path / "m2").get_train_cameras()
    np.testing.assert_array_equal(cams[0].original_image.numpy(),
                                  views[0][1].transpose(2, 0, 1).astype(np.float32) / 255.0)


def test_build_without_libjpeg_keeps_the_parsers_and_names_the_header(tmp_path, fresh_tier):
    """A machine without libjpeg, libpng or zlib (a compiler that fails on
    jpeglib.h, png.h or zlib.h and on -ljpeg, -lpng or -lz, as the card's
    machine has no jpeglib.h and no png.h): the tier builds, with none of
    those flags in any command and no header of them named, and decodes
    JPEGs and PNGs with its own decoders, bit for bit with the JAX tier's
    libjpeg and libpng; its RGBA output keeps a PNG's alpha."""
    log = tmp_path / "cxx.log"
    cxx = tmp_path / "g++"
    cxx.write_text("#!/bin/bash\n"
                   f"echo \"$*\" >> {log}\n"
                   "stdin=''; src=''\n"
                   "for a in \"$@\"; do\n"
                   "  if [ \"$a\" = - ]; then stdin=$(cat); src+=$stdin;\n"
                   "  elif [ -f \"$a\" ]; then src+=$(cat \"$a\"); fi\n"
                   "done\n"
                   "for lib in jpeg png z; do\n"
                   "  if [[ \" $* \" == *\" -l$lib \"* ]]; then echo \"ld: cannot find -l$lib\" >&2; exit 1; fi\n"
                   "done\n"
                   "for h in jpeglib.h png.h zlib.h; do\n"
                   "  if [[ $src == *\"include <$h>\"* ]]; then\n"
                   "    echo \"fatal error: $h: No such file or directory\" >&2; exit 1; fi\n"
                   "done\n"
                   f"exec {native.compiler()} \"$@\" <<< \"$stdin\"\n")
    cxx.chmod(0o755)
    fresh_tier.setenv("CXX", str(cxx))
    assert native.available(), native.unavailable_reason()
    assert native.codecs() == ("jpeg", "png") and native.missing() == {}
    commands = log.read_text().splitlines()
    assert any("jpeg.cpp" in c and "png.cpp" in c for c in commands), commands
    assert not any(flag in c.split() for c in commands for flag in ("-ljpeg", "-lpng", "-lz")), commands
    _colmap_scene(tmp_path / "jpg", ".jpg", channels=3)
    p = str(tmp_path / "jpg/images/000.jpg")
    np.testing.assert_array_equal(dataset_readers.decode_images([p])[p],
                                  jax_native.load_images([p], *jax_native.image_size(p))[0])
    path = str(tmp_path / "jpg/sparse/0/points3D.bin")
    np.testing.assert_array_equal(colmap.read_points3D_binary(path)[0],
                                  colmap.read_points3D_binary(path, native_io=False)[0])

    views = _colmap_scene(tmp_path / "rgba", ".png", channels=4)
    p = str(tmp_path / "rgba/images/000.png")
    np.testing.assert_array_equal(dataset_readers.decode_images([p])[p],
                                  jax_native.load_images([p], *jax_native.image_size(p))[0])  # RGB, as libpng
    np.testing.assert_array_equal(dataset_readers.decode_images([p], rgba=True)[p], views[0][1])  # RGBA kept


def test_concurrent_first_build_from_two_processes(tmp_path):
    """Two processes build into one empty directory at once: both load a
    working library, and only the finished one stays (no temporary file)."""
    code = ("import sys; from pathlib import Path; from gaussian_transformer_tpu_torch import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); assert native.available(), native.unavailable_reason(); "
            "print(native.codecs(), native.read_ply_f32 is not None)")
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all("('jpeg', 'png') True" in o for o, _ in outs), outs
    assert sorted(f.name for f in build.iterdir()) == [native.library_path().name]


# --------------------------------------------------------------- fixture ---


def write_fixture(out: Path) -> None:
    """The committed JPEG fixture: a 96x64 gradient with noise written by
    Pillow at quality 90, and the RGB array the JAX native tier decodes."""
    from PIL import Image

    out.mkdir(parents=True, exist_ok=True)
    img = _views(1, 64, 96, 11)[0][1]
    Image.fromarray(img).save(out / "fixture.jpg", quality=90)
    np.save(out / "fixture_rgb.npy", jax_native.load_images([str(out / "fixture.jpg")], 96, 64)[0])


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--write-fixture", action="store_true")
    if parser.parse_args().write_fixture:
        write_fixture(FIXTURE)
        print(f"wrote {FIXTURE}")
