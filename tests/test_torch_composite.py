"""Port parity: the non-Pallas compositor (render/composite.py), the
renderer's ``use_pallas=False`` path, against the JAX package's
``render/composite.py`` on the CPU: image and final_T to 2e-5, gradients
(autograd there, ``jax.grad`` here) to 2e-4 of the largest. Also the table
path's ``precision``, which neither package reads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.render.composite import composite_image as jax_composite_image
from gaussian_transformer_tpu.render.project import project_gaussians
from gaussian_transformer_tpu.render.tiles import bin_gaussians as jax_bin_gaussians, num_tiles
from gaussian_transformer_tpu.utils.general import inverse_sigmoid
from gaussian_transformer_tpu_torch.render import RenderConfig, render
from gaussian_transformer_tpu_torch.render.composite import composite_image

from tests.test_render import make_camera, make_scene
from tests.torch_port_support import torch_camera, torch_scene

ATOL = 2e-5
NAMES = ("xyz", "opacity", "scaling", "features_dc", "offset")


@pytest.mark.parametrize("seed,n,tile_block", [(0, 96, 64), (1, 200, 5)])
def test_composite_image_matches_reference(seed, n, tile_block):
    """On one JAX-binned table: blocks of 64 (one block, padded) and of 5
    (several blocks, the last one padded)."""
    import math

    cam = make_camera(width=80, height=48)
    scene = make_scene(n, seed=seed, capacity=n + 4)
    p = project_gaussians(
        scene.get_xyz, scene.get_scaling, scene.get_rotation, scene.get_opacity[:, 0], scene.get_features,
        None, world_view_transform=cam.world_view_transform, full_proj_transform=cam.full_proj_transform,
        camera_center=cam.camera_center, image_width=80, image_height=48, tan_fovx=math.tan(cam.fovx * 0.5),
        tan_fovy=math.tan(cam.fovy * 0.5), active_sh_degree=1,
    )
    gw, gh = num_tiles(80), num_tiles(48)
    include = (p.radii > 0) & (p.opacities >= 1.0 / 255.0)
    b = jax_bin_gaussians(p.means2d, p.depths, p.radii, include, grid_w=gw, grid_h=gh, max_per_tile=64)
    o = b.order
    sorted_props = [p.means2d[o], p.conics[o], p.rgbs[o], p.opacities[o]]
    bg = np.array([0.15, 0.25, 0.35], np.float32)
    ref = jax_composite_image(b.tile_lists, *sorted_props, jnp.asarray(bg), grid_w=gw, grid_h=gh,
                              tile_block=tile_block)
    got = composite_image(torch.from_numpy(np.array(b.tile_lists)), *(torch.from_numpy(np.array(v)) for v in sorted_props),
                          torch.from_numpy(bg), grid_w=gw, grid_h=gh, tile_block=tile_block)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=0)


def _jax_grads(scene, cam, bg, cfg):
    def loss_fn(xyz, opacity, scaling, fdc, offset):
        s = scene.replace(xyz=xyz, opacity=opacity, scaling=scaling, features_dc=fdc)
        out = jax_render(cam, s, cfg, bg_color=bg, screenspace_offset=offset)
        return jnp.sum(out["render"] ** 2) + 0.1 * jnp.sum(out["final_T"]), out

    args = (scene.xyz, scene.opacity, scene.scaling, scene.features_dc, jnp.zeros((scene.capacity, 2)))
    grads, out = jax.grad(loss_fn, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
    return [np.asarray(g) for g in grads], out


def _port_grads(scene, cam, bg, cfg):
    ts = torch_scene(scene)
    offset = torch.zeros(ts.capacity, 2, requires_grad=True)
    out = render(torch_camera(cam), ts, cfg, bg_color=torch.from_numpy(bg), screenspace_offset=offset)
    loss = torch.sum(out["render"] ** 2) + 0.1 * torch.sum(out["final_T"])
    leaves = [ts.xyz, ts.opacity, ts.scaling, ts.features_dc, offset]
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)], out


@pytest.mark.parametrize("use_stream", [True, False])
@pytest.mark.parametrize("seed,opacity", [(0, None), (4, 0.95)], ids=["dense", "saturated"])
def test_render_without_pallas_matches_reference(use_stream, seed, opacity):
    """``use_pallas=False`` takes the table binning and composite.py whatever
    ``use_stream`` says, in both packages; the saturated case stops pixels."""
    cam = make_camera(width=48, height=32)
    scene = make_scene(96, seed=seed, spread=0.2 if opacity else 1.5)
    if opacity:
        scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(opacity))))
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    ref_g, ref = _jax_grads(scene, cam, jnp.asarray(bg),
                            JaxRenderConfig(use_pallas=False, use_stream=use_stream, tile_block=4))
    got_g, out = _port_grads(scene, cam, bg, RenderConfig(use_pallas=False, use_stream=use_stream, tile_block=4))
    assert "n_padded" not in out and int(out["overflow"]) == int(ref["overflow"])
    np.testing.assert_allclose(out["render"].detach().numpy(), np.asarray(ref["render"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["final_T"].detach().numpy(), np.asarray(ref["final_T"]), atol=ATOL, rtol=0)
    if opacity:
        assert float(out["final_T"].detach().min()) < 1e-3
    for name, a, b in zip(NAMES, ref_g, got_g):
        assert np.all(np.isfinite(b)), name
        np.testing.assert_allclose(b, a, atol=2e-4 * (np.abs(a).max() + 1e-8), rtol=0, err_msg=name)


def test_render_without_pallas_matches_table_kernel_path():
    """composite.py and the table compositor (plain K5 on the CPU) render
    the same lists alike."""
    cam = torch_camera(make_camera(width=64, height=48))
    scene = torch_scene(make_scene(160, seed=5))
    with torch.no_grad():
        a = render(cam, scene, RenderConfig(use_pallas=False))
        b = render(cam, scene, RenderConfig(use_stream=False))
    np.testing.assert_allclose(a["render"].numpy(), b["render"].numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(a["final_T"].numpy(), b["final_T"].numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_table_paths_ignore_precision(use_pallas):
    """``RenderConfig(precision="bf16", use_stream=False)``: the table paths
    never read ``precision`` (the reference's ``render`` :303-327), so they
    render what the reference renders and what their float32 config
    renders, bit for bit."""
    cam = make_camera(width=64, height=32)
    scene = make_scene(128, seed=6)
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    ref = jax_render(cam, scene, JaxRenderConfig(precision="bf16", use_stream=False, use_pallas=use_pallas),
                     bg_color=jnp.asarray(bg))
    tc, ts = torch_camera(cam), torch_scene(scene)
    with torch.no_grad():
        out = render(tc, ts, RenderConfig(precision="bf16", use_stream=False, use_pallas=use_pallas),
                     bg_color=torch.from_numpy(bg))
        fp32 = render(tc, ts, RenderConfig(use_stream=False, use_pallas=use_pallas), bg_color=torch.from_numpy(bg))
    np.testing.assert_allclose(out["render"].numpy(), np.asarray(ref["render"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["final_T"].numpy(), np.asarray(ref["final_T"]), atol=ATOL, rtol=0)
    assert torch.equal(out["render"], fp32["render"]) and torch.equal(out["final_T"], fp32["final_T"])
