"""``scene/camera_utils.py image_to_array`` and ``utils/resample.py`` against
Pillow's ``Image.resize(size)`` (BICUBIC, the JAX package's
``utils/general.py pil_to_array``), bit for bit: L, LA, RGB and RGBA (the
last two through premultiplied alpha, as Pillow resizes them), down- and
upscales, one axis at a time, and hypothesis sizes to 257x257. Then whole
scenes at ``-r 2``: a COLMAP folder (PNG and JPEG) and the committed
Blender scene (``native/testdata/png/blender``) hold the JAX ``Scene``'s
images bit for bit, and the Blender views match their recorded digests."""

import hashlib
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

from gaussian_transformer_tpu.utils.general import pil_to_array
from gaussian_transformer_tpu_torch.scene import Scene
from gaussian_transformer_tpu_torch.scene.camera_utils import image_to_array
from gaussian_transformer_tpu_torch.tools.synthetic import orbit_c2w, write_colmap_binary
from gaussian_transformer_tpu_torch.utils.resample import coefficients, resize

ROOT = Path(__file__).resolve().parent.parent
BLENDER = ROOT / "gaussian_transformer_tpu_torch" / "native" / "testdata" / "png" / "blender"
MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _image(h, w, c, seed, alpha_kind="random"):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 5 + yy * 3)[..., None] * (np.arange(c) + 1) % 256
    img = np.clip(base + rng.randint(-40, 41, (h, w, c)), 0, 255).astype(np.uint8)
    if c in (2, 4) and alpha_kind == "edges":  # 0 and 255, where Pillow keeps the colour
        img[..., -1] = rng.choice([0, 255, 1, 128, 254], (h, w))
    return img


def _pillow(img, size):
    c = img.shape[2]
    out = np.asarray(Image.fromarray(img[..., 0] if c == 1 else img, MODES[c]).resize(size))
    return out[..., None] if c == 1 else out


@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("src,dst", [((960, 540), (480, 270)), ((960, 540), (800, 450)), ((61, 83), (200, 97)),
                                     ((83, 61), (83, 30)), ((40, 30), (17, 30)), ((1, 1), (5, 3)),
                                     ((300, 7), (1, 1)), ((800, 800), (400, 400))],
                         ids=["960x540-2x", "960x540-1600rule", "up", "rows-only", "cols-only", "from-1x1",
                              "to-1x1", "blender-r2"])
def test_resize_equals_pillow(channels, src, dst):
    for kind in ("random", "edges"):
        img = _image(src[1], src[0], channels, seed=channels, alpha_kind=kind)
        np.testing.assert_array_equal(resize(img, dst), _pillow(img, dst))


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 257), w=st.integers(1, 257), oh=st.integers(1, 257), ow=st.integers(1, 257),
       channels=st.sampled_from([1, 3, 4]), seed=st.integers(0, 2**16))
def test_random_sizes_equal_pillow(h, w, oh, ow, channels, seed):
    img = _image(h, w, channels, seed, "edges" if seed % 2 else "random")
    np.testing.assert_array_equal(resize(img, (ow, oh)), _pillow(img, (ow, oh)))


def test_image_to_array_is_pil_to_array():
    """The port's ``image_to_array`` and the JAX package's ``pil_to_array``
    give the same float32 CHW array, for RGB and RGBA, resized or not."""
    for c, size in ((3, (480, 270)), (3, (960, 540)), (4, (300, 169)), (1, (100, 60))):
        img = _image(540, 960, c, seed=c)
        pil = Image.fromarray(img[..., 0] if c == 1 else img, MODES[c])
        got, ref = image_to_array(img, size), pil_to_array(pil, size)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def _torch_antialias_bicubic(img, size):
    """The port's resize before it matched Pillow's: torch's antialiased
    bicubic, rounded."""
    import torch
    import torch.nn.functional as F

    arr = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1).float()[None]
    out = F.interpolate(arr, size=(size[1], size[0]), mode="bicubic", align_corners=False, antialias=True)
    return out[0].round().clamp(0, 255).numpy().transpose(1, 2, 0).astype(np.uint8)


def off_pillow(size):
    """Share of pixels off Pillow's resize of the committed 960x540 JPEG view
    ``native/testdata/jpeg/000.jpg``, for the former resize and for
    ``utils/resample.py``, and the former's largest gap."""
    from gaussian_transformer_tpu_torch import native

    view = str(BLENDER.parent.parent / "jpeg" / "000.jpg")
    img = native.decode_folder([view])[view]
    ref = _pillow(img, size)
    old = np.abs(_torch_antialias_bicubic(img, size).astype(int) - ref)
    new = np.abs(resize(img, size).astype(int) - ref)
    return float((old.max(-1) > 0).mean()), int(old.max()), float((new.max(-1) > 0).mean())


@pytest.mark.parametrize("size", [(480, 270), (800, 450)])
def test_the_former_torch_resize_was_not_pillows(size):
    """The fault this module repairs: torch's antialiased bicubic differs
    from Pillow's by a level on a share of the pixels; ``resize`` on none."""
    old_share, old_max, new_share = off_pillow(size)
    assert old_share > 0.01 and old_max >= 1 and new_share == 0.0


def test_weights_sum_to_one_in_fixed_point():
    """Each output's weights sum to 2^22 within the taps' rounding."""
    for n_in, n_out in ((960, 480), (960, 800), (61, 200), (7, 1)):
        _, taps, k = coefficients(n_in, n_out)
        assert (np.abs(k.sum(1) - (1 << 22)) <= taps).all()


# ----------------------------------------------------------- whole scenes ---


def _args(src, model, resolution, eval_, **kw):
    return types.SimpleNamespace(sh_degree=1, source_path=str(src), model_path=str(model), images="images",
                                 resolution=resolution, white_background=False, eval=eval_, **kw)


def _both_scenes(src, tmp_path, resolution, eval_=False):
    """(port train, port test, JAX train, JAX test) cameras of one source."""
    from gaussian_transformer_tpu.scene import Scene as JaxScene

    random.seed(0)
    port = Scene(_args(src, tmp_path / "m1", resolution, eval_), sh_degree=1, shuffle=False, device="cpu")
    random.seed(0)
    jax = JaxScene(_args(src, tmp_path / "m2", resolution, eval_, data_device="cpu"), sh_degree=1, shuffle=False)
    return port.get_train_cameras(), port.get_test_cameras(), jax.get_train_cameras(), jax.get_test_cameras()


def _assert_same_images(cams, jcams):
    assert [c.image_name for c in cams] == [c.image_name for c in jcams]
    for c, jc in zip(cams, jcams):
        np.testing.assert_array_equal(c.original_image.numpy(), np.asarray(jc.original_image), err_msg=c.image_name)


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_colmap_scene_at_r2_holds_the_jax_images(tmp_path, ext):
    """A COLMAP folder of 96x64 views (PNG through the tier's PNG decoder,
    JPEG through its JPEG decoder) at ``-r 2``: the port's Scene holds the
    JAX Scene's 48x32 images bit for bit."""
    rng = np.random.RandomState(3)
    views = []
    for i in range(3):
        img = _image(64, 96, 3, seed=10 + i)
        if ext == ".jpg":
            path = tmp_path / f"{i:03d}.jpg"
            Image.fromarray(img).save(path, quality=90)
            img = path
        views.append((orbit_c2w(2 * math.pi * i / 3), img))
    write_colmap_binary(tmp_path / "data", views, 96, 64, math.radians(50), rng.randn(200, 3),
                        rng.randint(0, 256, (200, 3)))
    cams, _, jcams, _ = _both_scenes(tmp_path / "data", tmp_path, 2)
    assert tuple(cams[0].original_image.shape) == (3, 32, 48)
    _assert_same_images(cams, jcams)


@pytest.fixture(scope="module")
def blender_copy(tmp_path_factory):
    """The committed Blender scene copied out, with a small seeded
    points3d.ply (without one, each Scene load would write 100k random
    points beside the transforms; the images do not depend on them)."""
    from gaussian_transformer_tpu_torch.scene.ply import store_point_cloud

    dst = tmp_path_factory.mktemp("blender") / "scene"
    shutil.copytree(BLENDER, dst)
    rng = np.random.RandomState(0)
    store_point_cloud(str(dst / "points3d.ply"), rng.rand(2000, 3) * 2.6 - 1.3, rng.randint(0, 256, (2000, 3)))
    return dst


@pytest.mark.parametrize("resolution", [1, 2])
def test_committed_blender_scene_holds_the_jax_images_and_digests(tmp_path, blender_copy, resolution):
    """The committed 800x800 RGBA scene (libpng, all filters; one Adam7,
    one palette + tRNS) through both Scenes, at full size and at ``-r 2``:
    the same images bit for bit, each at the digest of the JAX reader's
    composite and ``pil_to_array`` recorded with the files."""
    digests = json.loads((BLENDER.parent / "digests.json").read_text())["scene"][f"r{resolution}"]
    train, test, jtrain, jtest = _both_scenes(blender_copy, tmp_path, resolution, eval_=True)
    _assert_same_images(train, jtrain)
    _assert_same_images(test, jtest)
    side = 800 // resolution
    for split, cams in (("train", train), ("test", test)):
        for c in cams:
            assert tuple(c.original_image.shape) == (3, side, side)
            arr = np.ascontiguousarray(c.original_image.numpy())
            assert hashlib.sha256(arr.tobytes()).hexdigest() == digests[f"{split}/{c.image_name}"], c.image_name
    assert len(train) + len(test) == len(digests) == 5


if __name__ == "__main__":
    for size in ((480, 270), (800, 450)):
        old_share, old_max, new_share = off_pillow(size)
        print(f"960x540 -> {size[0]}x{size[1]}: the former torch resize off Pillow's on {old_share:.1%} of the "
              f"pixels (max {old_max} levels); utils/resample.py on {new_share:.1%}")
