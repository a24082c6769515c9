"""Port parity: the stream compositor backward (render/stream.py). The port's
``render`` on CPU tensors runs the plain version of kernel K2 and the
``stream_gather`` pullback; its gradients w.r.t. xyz, opacity, scaling,
features_dc and the screen-space offset are held against ``jax.grad``
through the JAX ``render`` (Pallas K2 in interpret mode) at the reference's
own tolerance for its stream backward (``tests/test_stream.py``: 2e-4 of the
largest gradient, 5e-4 under saturation). The plain K2 is also checked
against autograd through the plain forward. K2 itself is checked on the card
by tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.utils.general import inverse_sigmoid
from gaussian_transformer_tpu_torch.render import RenderConfig, prepare_stream, render
from gaussian_transformer_tpu_torch.render import stream

from tests.test_render import make_camera, make_scene
from tests.torch_port_support import torch_camera, torch_scene

NAMES = ("xyz", "opacity", "scaling", "features_dc", "offset")


def _jax_grads(scene, cam, bg, chunk):
    def loss_fn(xyz, opacity, scaling, fdc, offset):
        s = scene.replace(xyz=xyz, opacity=opacity, scaling=scaling, features_dc=fdc)
        out = jax_render(cam, s, JaxRenderConfig(chunk=chunk), bg_color=bg, screenspace_offset=offset)
        return jnp.sum(out["render"] ** 2) + 0.1 * jnp.sum(out["final_T"])

    args = (scene.xyz, scene.opacity, scene.scaling, scene.features_dc, jnp.zeros((scene.capacity, 2)))
    return [np.asarray(g) for g in jax.grad(loss_fn, argnums=(0, 1, 2, 3, 4))(*args)]


def _port_grads(scene, cam, bg, chunk):
    ts = torch_scene(scene)
    offset = torch.zeros(ts.capacity, 2, requires_grad=True)
    out = render(torch_camera(cam), ts, RenderConfig(chunk=chunk), bg_color=torch.from_numpy(bg),
                 screenspace_offset=offset)
    loss = torch.sum(out["render"] ** 2) + 0.1 * torch.sum(out["final_T"])
    leaves = [ts.xyz, ts.opacity, ts.scaling, ts.features_dc, offset]
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _check(ref, got, rel):
    for name, a, b in zip(NAMES, ref, got):
        assert np.all(np.isfinite(b)), name
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b, a, atol=rel * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("seed,chunk", [(0, 32), (1, 64)])
def test_render_grads_match_reference(seed, chunk):
    cam = make_camera(width=48, height=32)
    scene = make_scene(96, seed=seed)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    _check(_jax_grads(scene, cam, jnp.asarray(bg), chunk), _port_grads(scene, cam, bg, chunk), 2e-4)


def test_render_grads_under_saturation():
    cam = make_camera(width=32, height=32)
    scene = make_scene(64, seed=4, spread=0.2)
    scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(0.95))))
    bg = np.zeros(3, np.float32)
    _check(_jax_grads(scene, cam, jnp.asarray(bg), 0), _port_grads(scene, cam, bg, 0), 5e-4)


@pytest.mark.parametrize("seed,opacity", [(2, None), (3, 0.97)])
def test_plain_backward_matches_autograd_of_plain_forward(seed, opacity):
    """At a test size, autograd through the plain forward is a second check of
    the plain K2 (and of the forward it replays)."""
    scene = make_scene(80, seed=seed, spread=0.4 if opacity else 1.5)
    if opacity:
        scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(opacity))))
    with torch.no_grad():
        s = prepare_stream(torch_camera(make_camera(width=40, height=24)), torch_scene(scene))
        props0 = s.props()
    ct = s.chunk_tile
    rng = np.random.RandomState(seed)
    T = s.grid_w * s.grid_h
    g_color = torch.from_numpy(rng.randn(T, 3, stream.P).astype(np.float32))
    g_t = torch.from_numpy(rng.randn(T, 1, stream.P).astype(np.float32))

    props = props0.clone().requires_grad_()
    color, final_t = stream.composite_stream_tiles_plain(props, ct, s.grid_w, s.grid_h)
    (ref,) = torch.autograd.grad((color * g_color).sum() + (final_t * g_t).sum(), props)
    with torch.no_grad():
        got = stream.composite_stream_tiles_bwd_plain(props0, ct, s.grid_w, s.grid_h, color, final_t,
                                                      g_color, g_t)
    assert got.shape == props0.shape and torch.all(got[:, stream.GRAD_F:] == 0)
    scale = float(ref.abs().max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4 * scale, rtol=0)

    props = props0.clone().requires_grad_()
    color2, t2 = stream.composite_stream_tiles(props, ct, s.binned.tile_counts, s.grid_w, s.grid_h)
    (via_node,) = torch.autograd.grad((color2 * g_color).sum() + (t2 * g_t).sum(), props)
    np.testing.assert_array_equal(via_node.numpy(), got.numpy())
