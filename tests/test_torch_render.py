"""Port parity for the slice as a whole: ``render()`` end to end against the
JAX ``render()`` (atol 2e-5), the scene/camera carry-over, PLY and PNG IO,
and the port's render and metrics CLIs on a tiny Blender-layout model dir
(run with ``--device cpu``), scored against the JAX SSIM/PSNR."""

import json
import math
import os
from argparse import Namespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from gaussian_transformer_tpu.ops.losses import ssim as jax_ssim
from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.scene.gaussians import GaussianScene as JaxGaussianScene
from gaussian_transformer_tpu.utils.image import psnr as jax_psnr
from gaussian_transformer_tpu_torch import resolve_device
from gaussian_transformer_tpu_torch.config import save_cfg_args
from gaussian_transformer_tpu_torch.render import render
from gaussian_transformer_tpu_torch.scene import Scene
from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
from gaussian_transformer_tpu_torch.scene.ply import store_point_cloud
from gaussian_transformer_tpu_torch.utils.png import read_png, write_png

from tests.test_render import make_camera, make_scene
from tests.torch_port_support import SCENE_FIELDS, torch_camera, torch_scene


@pytest.mark.parametrize("degree,width,height", [(3, 80, 48), (1, 72, 40)])
def test_render_matches_reference(degree, width, height):
    cam = make_camera(width=width, height=height)
    scene = make_scene(180, seed=degree + 10, capacity=190, max_sh_degree=3).replace(
        active_sh_degree=degree
    )
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    ref = jax_render(cam, scene, JaxRenderConfig(), bg_color=jnp.asarray(bg))
    with torch.no_grad():
        out = render(torch_camera(cam), torch_scene(scene), bg_color=torch.from_numpy(bg))
    assert out["render"].shape == (3, height, width)
    np.testing.assert_allclose(out["render"].numpy(), np.asarray(ref["render"]), atol=2e-5)
    np.testing.assert_allclose(out["final_T"].numpy(), np.asarray(ref["final_T"]), atol=2e-5)
    np.testing.assert_array_equal(out["radii"].numpy(), np.asarray(ref["radii"]))
    for key in ("overflow", "n_instances", "n_padded", "n_tiles"):
        assert int(out[key]) == int(ref[key]), key


@pytest.mark.parametrize("probe,headroom", [
    (5000, 0.0),
    ({"n_instances": 40_000, "n_padded": 52_000, "n_tiles": 300}, 0.0),
    ({"n_instances": 9_500_000, "n_padded": 12_400_000, "n_tiles": 8160}, 0.0),
    ({"n_instances": 700_000, "n_padded": 0, "n_tiles": 8160}, 1.1),
])
def test_tune_config_matches_reference(probe, headroom):
    from gaussian_transformer_tpu.render import tune_config as jax_tune_config
    from gaussian_transformer_tpu_torch.render import RenderConfig, tune_config

    ref = jax_tune_config(JaxRenderConfig(), probe, headroom)
    out = tune_config(RenderConfig(), probe, headroom)
    assert (out.max_instances, out.max_stream) == (ref.max_instances, ref.max_stream)


def test_convert_round_trip():
    scene = make_scene(40, seed=4, capacity=48, max_sh_degree=3).replace(active_sh_degree=2)
    ts = torch_scene(scene)
    assert ts.capacity == 48 and ts.max_sh_degree == 3 and ts.active_sh_degree == 2
    for name in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).detach().numpy(), np.asarray(getattr(scene, name)))
    for name in ("get_scaling", "get_rotation", "get_opacity", "get_features"):
        np.testing.assert_allclose(
            getattr(ts, name).detach().numpy(), np.asarray(getattr(scene, name)), rtol=1e-6, atol=1e-7
        )
    cam = make_camera(width=40, height=24)
    tc = torch_camera(cam)
    assert (tc.image_width, tc.image_height, tc.fovx, tc.fovy) == (40, 24, cam.fovx, cam.fovy)
    np.testing.assert_array_equal(tc.full_proj_transform.numpy(), np.asarray(cam.full_proj_transform))


def test_ply_interop_both_ways(tmp_path):
    scene = make_scene(30, seed=5, capacity=34, max_sh_degree=3)
    scene.save_ply(str(tmp_path / "jax.ply"))
    loaded = GaussianScene.load_ply(str(tmp_path / "jax.ply"), max_sh_degree=3, capacity=40, device="cpu")
    assert loaded.num_alive == 30 and loaded.active_sh_degree == 3
    for name in SCENE_FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(loaded, name).detach().numpy()[:30], np.asarray(getattr(scene, name))[:30])
    loaded.save_ply(str(tmp_path / "port.ply"))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    back = JaxGaussianScene.load_ply(str(tmp_path / "port.ply"), max_sh_degree=3)
    np.testing.assert_array_equal(np.asarray(back.features_rest), np.asarray(scene.features_rest)[:30])


def _filtered_png(path, img, filters):
    """A PNG whose rows use the given filter types (0-4), as other encoders
    write them; decoded by PIL as the reference."""
    import struct
    import zlib

    h, w, c = img.shape
    data = img.astype(np.int64).reshape(h, w * c)
    raw = bytearray()
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = data[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([ft]) + ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = cur
    chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_codec_against_pil(tmp_path, channels):
    rng = np.random.RandomState(channels)
    img = rng.randint(0, 256, (13, 17, channels)).astype(np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    pil = np.asarray(Image.open(tmp_path / "a.png"))
    np.testing.assert_array_equal(pil.reshape(img.shape), img)
    _filtered_png(str(tmp_path / "f.png"), img, filters=[0, 1, 2, 3, 4])
    pil = np.asarray(Image.open(tmp_path / "f.png")).reshape(img.shape)
    np.testing.assert_array_equal(pil, img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "f.png")), img)
    Image.fromarray(img.squeeze(-1) if channels == 1 else img).save(tmp_path / "p.png")
    np.testing.assert_array_equal(read_png(str(tmp_path / "p.png")), img)


def _blender_model_dir(root, scene, width=64, height=48, fov=60.0):
    """Tiny Blender-layout dataset + trained model dir (1 train, 2 test views)."""
    src, model = root / "data", root / "model"
    rng = np.random.RandomState(0)
    frames = {}
    for split, zs in (("train", [5.0]), ("test", [5.0, 5.5])):
        os.makedirs(src / split)
        frames[split] = []
        for i, z in enumerate(zs):
            # Blender/OpenGL camera-to-world of a camera at (0, 0, -z) looking at +z.
            c2w = [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, -z], [0, 0, 0, 1]]
            frames[split].append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w})
            rgba = rng.randint(0, 256, (height, width, 4)).astype(np.uint8)
            rgba[..., 3] = 255
            write_png(str(src / split / f"r_{i}.png"), rgba)
        with open(src / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": math.radians(fov), "frames": frames[split]}, f)
    store_point_cloud(str(src / "points3d.ply"), np.zeros((4, 3)), np.zeros((4, 3)))
    scene.save_ply(str(model / "point_cloud" / "iteration_7" / "point_cloud.ply"))
    save_cfg_args(str(model), Namespace(
        sh_degree=1, source_path=str(src), model_path=str(model), images="images",
        resolution=-1, white_background=False, data_device="cpu", eval=True,
    ))
    return model


def test_cli_render_and_metrics(tmp_path):
    from gaussian_transformer_tpu_torch.cli import metrics as cli_metrics
    from gaussian_transformer_tpu_torch.cli import render as cli_render

    scene = make_scene(150, seed=8, spread=1.0)
    model = _blender_model_dir(tmp_path, scene)
    stats = cli_render.main(["-m", str(model), "--device", "cpu", "--skip_train", "--quiet"])
    assert [s["view"] for s in stats] == [0, 1] and all(s["overflow"] == 0 for s in stats)
    out_dir = model / "test" / "ours_7"
    assert sorted(os.listdir(out_dir)) == ["gt", "renders"]
    assert sorted(os.listdir(out_dir / "renders")) == ["00000.png", "00001.png"]
    assert not (model / "train").exists()

    # The CLI's render of view 0 is the port's render() of that camera.
    from gaussian_transformer_tpu_torch.scene.cameras import Camera
    from gaussian_transformer_tpu_torch.utils.graphics import focal2fov, fov2focal

    fovx = math.radians(60.0)
    cam = Camera.create(0, np.eye(3), np.array([0.0, 0.0, 5.0]), fovx,
                        focal2fov(fov2focal(fovx, 64), 48), None, None, "r_0", 0,
                        width=64, height=48, device="cpu")
    with torch.no_grad():
        img = render(cam, torch_scene(scene))["render"].clamp(0, 1).numpy()
    png = np.asarray(Image.open(out_dir / "renders" / "00000.png"))
    np.testing.assert_array_equal(png, (img.transpose(1, 2, 0) * 255).astype(np.uint8))

    results = cli_metrics.main(["-m", str(model), "--device", "cpu"])
    with open(model / "results.json") as f:
        on_disk = json.load(f)
    assert on_disk == results[str(model)] and set(on_disk) == {"ours_7"}
    assert set(on_disk["ours_7"]) == {"SSIM", "PSNR", "LPIPS"} and on_disk["ours_7"]["LPIPS"] is None
    with open(model / "per_view.json") as f:
        per_view = json.load(f)["ours_7"]
    assert sorted(per_view["PSNR"]) == ["00000.png", "00001.png"]
    ssims, psnrs = [], []
    for name in ("00000.png", "00001.png"):
        r = np.asarray(Image.open(out_dir / "renders" / name), np.float32).transpose(2, 0, 1) / 255.0
        g = np.asarray(Image.open(out_dir / "gt" / name), np.float32).transpose(2, 0, 1) / 255.0
        ssims.append(float(jax_ssim(jnp.asarray(r), jnp.asarray(g))))
        psnrs.append(float(jnp.mean(jax_psnr(jnp.asarray(r), jnp.asarray(g)))))
    assert abs(on_disk["ours_7"]["SSIM"] - np.mean(ssims)) < 1e-6
    assert abs(on_disk["ours_7"]["PSNR"] - np.mean(psnrs)) < 1e-4


def test_device_policy_and_unported_paths(tmp_path):
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GaussianScene(4, 1)
    assert resolve_device("cpu") == torch.device("cpu")
    args = Namespace(model_path=str(tmp_path), source_path=str(tmp_path), images="images",
                     eval=False, white_background=False, resolution=-1)
    with pytest.raises(NotImplementedError, match="training slice"):
        Scene(args, load_iteration=None, device="cpu")
