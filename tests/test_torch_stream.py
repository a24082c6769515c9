"""Port parity: the stream compositor (render/stream.py). The port's plain
version (what CPU tensors take) against the JAX ``stream_image``, which runs
the Pallas kernel K1 in interpret mode, on the same binned stream: image and
transmittance to atol 2e-5. Also the brute-force golden, saturation, the
empty scene and the options not ported yet. Kernel K1 itself is checked on
the card by tests/test_torch_kernels.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.render import render_naive as jax_render_naive
from gaussian_transformer_tpu.render.stream import stream_image as jax_stream_image
from gaussian_transformer_tpu.render.tiles import bin_stream as jax_bin_stream, num_tiles
from gaussian_transformer_tpu.utils.general import inverse_sigmoid
from gaussian_transformer_tpu_torch.render import RenderConfig, render, render_naive
from gaussian_transformer_tpu_torch.render import stream
from gaussian_transformer_tpu_torch.render.tiles import StreamBinned

from tests.test_render import make_camera, make_scene
from tests.torch_port_support import torch_camera, torch_scene

ATOL = 2e-5


def _jax_stream_inputs(seed, n, width, height, chunk):
    """A JAX-projected, JAX-binned stream (numpy fields) of a random scene."""
    import math

    from gaussian_transformer_tpu.render.project import project_gaussians

    cam = make_camera(width=width, height=height)
    scene = make_scene(n, seed=seed, capacity=n + 5)
    p = project_gaussians(
        scene.get_xyz, scene.get_scaling, scene.get_rotation, scene.get_opacity[:, 0],
        scene.get_features, None,
        world_view_transform=cam.world_view_transform,
        full_proj_transform=cam.full_proj_transform, camera_center=cam.camera_center,
        image_width=width, image_height=height, tan_fovx=math.tan(cam.fovx * 0.5),
        tan_fovy=math.tan(cam.fovy * 0.5), active_sh_degree=1,
    )
    gw, gh = num_tiles(width), num_tiles(height)
    include = (p.radii > 0) & (p.opacities >= 1.0 / 255.0)
    binned = jax_bin_stream(p.means2d, p.depths, p.rect_bin, include, p.conics, p.opacities,
                            grid_w=gw, grid_h=gh, max_tiles_per_gaussian=1024, chunk=chunk)
    return p, binned, gw, gh


@pytest.mark.parametrize("seed,n,chunk", [(0, 64, 32), (1, 256, 64)])
def test_plain_compositor_matches_pallas_interpret(seed, n, chunk):
    p, binned, gw, gh = _jax_stream_inputs(seed, n, 80, 48, chunk)
    bg = np.array([0.15, 0.25, 0.35], np.float32)
    ref_img, ref_t = jax_stream_image(binned, p.means2d, p.conics, p.rgbs, p.opacities,
                                      jnp.asarray(bg), grid_w=gw, grid_h=gh)
    tb = StreamBinned(**{k: torch.from_numpy(np.array(getattr(binned, k))) for k in StreamBinned._fields})
    t = lambda a: torch.from_numpy(np.array(a))
    img, t_map = stream.stream_image(tb, t(p.means2d), t(p.conics), t(p.rgbs), t(p.opacities),
                                     torch.from_numpy(bg), grid_w=gw, grid_h=gh)
    assert img.shape == (3, gh * 16, gw * 16)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), atol=ATOL)
    np.testing.assert_allclose(t_map.numpy(), np.asarray(ref_t), atol=ATOL)


def test_render_matches_naive_goldens():
    """The port's tiled render against its own brute-force golden and the
    reference's golden."""
    cam = make_camera(width=64, height=32)
    scene = make_scene(128, seed=2)
    tc, ts = torch_camera(cam), torch_scene(scene)
    with torch.no_grad():
        out = render(tc, ts, bg_color=torch.zeros(3))
        golden = render_naive(tc, ts, bg_color=torch.zeros(3))
    ref = jax_render_naive(cam, scene, bg_color=jnp.zeros(3))
    np.testing.assert_allclose(out["render"].numpy(), golden["render"].numpy(), atol=ATOL)
    np.testing.assert_allclose(golden["render"].numpy(), np.asarray(ref["render"]), atol=ATOL)
    np.testing.assert_allclose(golden["final_T"].numpy(), np.asarray(ref["final_T"]), atol=ATOL)


def test_saturation_matches_reference():
    """Opaque, overlapping splats: most pixels terminate (T < 1e-3)."""
    cam = make_camera(width=32, height=32)
    scene = make_scene(96, seed=3, spread=0.2)
    scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(0.97))))
    ref = jax_render(cam, scene, JaxRenderConfig(), bg_color=jnp.ones(3))
    with torch.no_grad():
        out = render(torch_camera(cam), torch_scene(scene), bg_color=torch.ones(3))
    np.testing.assert_allclose(out["render"].numpy(), np.asarray(ref["render"]), atol=ATOL)
    np.testing.assert_allclose(out["final_T"].numpy(), np.asarray(ref["final_T"]), atol=ATOL)
    assert float(out["final_T"].min()) < 1e-3


def test_empty_scene_is_background():
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene

    cam = torch_camera(make_camera(width=64, height=48))
    bg = torch.tensor([0.2, 0.4, 0.6])
    with torch.no_grad():
        out = render(cam, GaussianScene.empty(8, 1, device="cpu"), bg_color=bg)
    img = out["render"].numpy()
    assert img.shape == (3, 48, 64) and int(out["overflow"]) == 0
    np.testing.assert_allclose(img, np.broadcast_to(bg.numpy()[:, None, None], img.shape), atol=1e-6)
    np.testing.assert_allclose(out["final_T"].numpy(), 1.0)


def test_unported_options_raise():
    cam = torch_camera(make_camera(width=32, height=32))
    scene = torch_scene(make_scene(16, seed=0))
    for cfg in (RenderConfig(precision="bf16"), RenderConfig(use_stream=False),
                RenderConfig(use_pallas=False)):
        with pytest.raises(NotImplementedError):
            render(cam, scene, cfg)

