"""Port parity: the transposed-layout stream compositor
(``gaussian_transformer_tpu_torch/attic/stream_t.py``, kernels K7 and K8).

The port's ``stream_image_t`` on CPU tensors (the plain versions of K7 and
K8 and the ``stream_gather`` pullback) against the JAX package's
``attic/stream_t.py stream_image_t``, which runs its Pallas kernels in
interpret mode, on the same JAX-binned stream: image and transmittance to
atol 2e-5, gradients on the screen-space properties to 2e-4 of the largest.
The reference is run with ``block_rows=chunk``: at its default of 2048 rows
the interpreted kernel body is unrolled ``2048 / chunk`` times in Python and
a case takes minutes. Also the plain K7/K8 against the plain K1/K2 on the
same stream, the work counts the bounds use, and the layout switch that
both packages refuse. K7 and K8 themselves are checked on the card by
tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attic.stream_t import stream_image_t as jax_stream_image_t
from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.utils.general import inverse_sigmoid
from gaussian_transformer_tpu_torch.attic import stream_t
from gaussian_transformer_tpu_torch.render import RenderConfig, prepare_stream, render
from gaussian_transformer_tpu_torch.render import stream
from gaussian_transformer_tpu_torch.render.tiles import StreamBinned

from tests.test_render import make_camera, make_scene
from tests.test_torch_stream import _jax_stream_inputs
from tests.torch_port_support import sequential_work, torch_camera, torch_scene

ATOL = 2e-5
GRAD_REL = 2e-4
W, H = 80, 48
CASES = [(0, 64, 32, None), (1, 256, 64, None), (3, 96, 32, 0.97)]
IDS = ["n64-chunk32", "n256-chunk64", "saturated"]


def _inputs(seed, n, chunk, opacity):
    """The JAX-projected, JAX-binned stream of a random scene; with
    ``opacity`` every splat has it and the scene is packed into 0.2."""
    if opacity is None:
        return _jax_stream_inputs(seed, n, W, H, chunk)
    import math

    from gaussian_transformer_tpu.render.project import project_gaussians
    from gaussian_transformer_tpu.render.tiles import bin_stream, num_tiles

    cam = make_camera(width=W, height=H)
    scene = make_scene(n, seed=seed, spread=0.2)
    scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(opacity))))
    p = project_gaussians(
        scene.get_xyz, scene.get_scaling, scene.get_rotation, scene.get_opacity[:, 0],
        scene.get_features, None,
        world_view_transform=cam.world_view_transform,
        full_proj_transform=cam.full_proj_transform, camera_center=cam.camera_center,
        image_width=W, image_height=H, tan_fovx=math.tan(cam.fovx * 0.5),
        tan_fovy=math.tan(cam.fovy * 0.5), active_sh_degree=1,
    )
    gw, gh = num_tiles(W), num_tiles(H)
    include = (p.radii > 0) & (p.opacities >= 1.0 / 255.0)
    binned = bin_stream(p.means2d, p.depths, p.rect_bin, include, p.conics, p.opacities,
                        grid_w=gw, grid_h=gh, max_tiles_per_gaussian=1024, chunk=chunk)
    return p, binned, gw, gh


def _fields(p):
    return [np.array(a) for a in (p.means2d, p.conics, p.rgbs, p.opacities)]


def _torch_binned(binned):
    return StreamBinned(**{k: torch.from_numpy(np.array(getattr(binned, k))) for k in StreamBinned._fields})


@pytest.mark.parametrize("seed,n,chunk,opacity", CASES, ids=IDS)
def test_plain_transposed_compositor_matches_attic_interpret(seed, n, chunk, opacity):
    p, binned, gw, gh = _inputs(seed, n, chunk, opacity)
    bg = np.array([0.15, 0.25, 0.35], np.float32)
    fields = _fields(p)
    ref_img, ref_t = jax_stream_image_t(binned, *map(jnp.asarray, fields), jnp.asarray(bg),
                                        grid_w=gw, grid_h=gh, block_rows=chunk)
    with torch.no_grad():
        img, t_map = stream_t.stream_image_t(_torch_binned(binned), *map(torch.from_numpy, fields),
                                             torch.from_numpy(bg), grid_w=gw, grid_h=gh)
    assert img.shape == (3, gh * 16, gw * 16)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), atol=ATOL)
    np.testing.assert_allclose(t_map.numpy(), np.asarray(ref_t), atol=ATOL)
    if opacity is not None:
        assert float(t_map.min()) < 1e-3  # saturated: pixels terminate


@pytest.mark.parametrize("seed,n,chunk,opacity", CASES, ids=IDS)
def test_transposed_render_grads_match_jax_grad(seed, n, chunk, opacity):
    """d/d(means2d, conics, rgbs, opacities) of a seeded weighted sum of the
    image plus 0.3 sum(T): the port's plain K8 and pullback against
    ``jax.grad`` through the interpreted reference."""
    p, binned, gw, gh = _inputs(seed, n, chunk, opacity)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    wts = np.random.RandomState(seed + 10).rand(3, gh * 16, gw * 16).astype(np.float32)
    fields = _fields(p)

    def jax_loss(*args):
        img, t_map = jax_stream_image_t(binned, *args, jnp.asarray(bg), grid_w=gw, grid_h=gh, block_rows=chunk)
        return jnp.sum(jnp.asarray(wts) * img) + 0.3 * jnp.sum(t_map)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, fields))
    leaves = [torch.from_numpy(a).requires_grad_() for a in fields]
    img, t_map = stream_t.stream_image_t(_torch_binned(binned), *leaves, torch.from_numpy(bg), grid_w=gw, grid_h=gh)
    got = torch.autograd.grad(torch.sum(torch.from_numpy(wts) * img) + 0.3 * torch.sum(t_map), leaves)
    for name, a, b in zip(("means2d", "conics", "rgbs", "opacities"), ref, got):
        a, b = np.asarray(a), b.numpy()
        assert np.all(np.isfinite(b)), name
        scale = np.abs(a).max()
        assert scale > 0, name
        np.testing.assert_allclose(b, a, atol=GRAD_REL * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("seed,opacity", [(2, None), (3, 0.97)], ids=["dense", "saturated"])
def test_plain_k7_k8_match_plain_k1_k2(seed, opacity):
    """The two layouts on one stream: the plain K7 against the plain K1
    (absolute against tile-local coordinates), the plain K8 against the
    plain K2 (per-pixel terms against moments) and against the autograd
    node's backward."""
    scene = make_scene(160, seed=seed, spread=0.3 if opacity else 1.5)
    if opacity:
        scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(opacity))))
    with torch.no_grad():
        s = prepare_stream(torch_camera(make_camera(width=64, height=48)), torch_scene(scene), RenderConfig(chunk=32))
        props = s.props()
    ct, gw, gh = s.chunk_tile, s.grid_w, s.grid_h
    props_t = props.t().contiguous()
    c1, t1 = stream.composite_stream_tiles_plain(props, ct, gw, gh)
    c7, t7 = stream_t.composite_stream_tiles_t_plain(props_t, ct, gw, gh)
    np.testing.assert_allclose(c7.numpy(), c1.numpy(), atol=ATOL)
    np.testing.assert_allclose(t7.numpy(), t1.numpy(), atol=ATOL)

    rng = np.random.RandomState(seed)
    g_color = torch.from_numpy(rng.randn(*c1.shape).astype(np.float32))
    g_t = torch.from_numpy(rng.randn(*t1.shape).astype(np.float32))
    d2 = stream.composite_stream_tiles_bwd_plain(props, ct, gw, gh, c1, t1, g_color, g_t)
    d8 = stream_t.composite_stream_tiles_t_bwd_plain(props_t, ct, gw, gh, c7, t7, g_color, g_t)
    assert d8.shape == props_t.shape and torch.all(d8[stream.GRAD_F:] == 0)
    scale = float(d2.abs().max())
    assert scale > 0
    np.testing.assert_allclose(d8.t().numpy(), d2.numpy(), atol=GRAD_REL * scale, rtol=0)

    leaf = props_t.clone().requires_grad_()
    color, final_t = stream_t.composite_stream_tiles_t(leaf, ct, s.binned.tile_counts, gw, gh)
    (via_node,) = torch.autograd.grad((color * g_color).sum() + (final_t * g_t).sum(), leaf)
    np.testing.assert_array_equal(via_node.numpy(), d8.numpy())


@pytest.mark.parametrize("seed,n,opacity", [(1, 256, None), (3, 96, 0.97)], ids=["dense", "saturated"])
def test_plain_k7_work_counts_match_a_sequential_walk(seed, n, opacity):
    """The pairs K7's bound is computed from, against a row-by-row walk of
    each tile's run in absolute screen coordinates."""
    scene = make_scene(n, seed=seed, spread=0.2 if opacity else 1.5)
    if opacity:
        scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(opacity))))
    with torch.no_grad():
        s = prepare_stream(torch_camera(make_camera(width=64, height=48)), torch_scene(scene), RenderConfig(chunk=32))
        props_t, ct = s.props().t().contiguous(), s.chunk_tile
        work = stream_t.composite_stream_tiles_t_plain(props_t, ct, s.grid_w, s.grid_h, count_work=True)[2]
    chunks = props_t.t().numpy().reshape(ct.shape[0], -1, 16)
    p = np.arange(256)
    want = np.zeros(2, np.int64)
    for t in range(s.grid_w * s.grid_h):
        rows = chunks[ct.numpy() == t].reshape(-1, 16)
        px = ((t % s.grid_w) * 16 + p % 16).astype(np.float32)
        py = ((t // s.grid_w) * 16 + p // 16).astype(np.float32)
        want += sequential_work(rows, px, py)
    assert work == tuple(int(v) for v in want)
    assert 0 < work[1] < work[0]


def test_transposed_layout_raises_in_both_packages():
    cam = make_camera(width=32, height=32)
    scene = make_scene(16, seed=0)
    with pytest.raises(NotImplementedError):
        jax_render(cam, scene, JaxRenderConfig(layout="transposed"))
    with pytest.raises(NotImplementedError):
        render(torch_camera(cam), torch_scene(scene), RenderConfig(layout="transposed"))
    assert RenderConfig().layout == JaxRenderConfig().layout == "rows"


def test_wrappers_reject_bad_planes():
    ct = torch.zeros(2, dtype=torch.int32)
    for bad in (torch.zeros(9, 64), torch.zeros(16, 63), torch.zeros(16, 64, dtype=torch.float64)):
        with pytest.raises(ValueError):
            stream_t._checked_planes(bad, ct)
    props_t = torch.zeros(16, 64, requires_grad=True)
    color, t = stream_t.composite_stream_tiles_t(props_t, ct, torch.tensor([64], dtype=torch.int32), 1, 1)
    (color.sum() + t.sum()).backward()
    assert float(t.detach().min()) == 1.0 and float(props_t.grad.abs().max()) == 0.0


def test_wrapper_rejects_bad_tile_counts():
    """The tile counts as ``stream._check_counts`` takes them for K1: integer
    [T] on the planes' device; anything else raises before a launch."""
    props_t = torch.zeros(16, 64)
    ct = torch.tensor([0, 1], dtype=torch.int32)
    counts = torch.tensor([20, 0], dtype=torch.int32)
    assert stream_t.composite_stream_tiles_t(props_t, ct, counts, 2, 1)[0].shape == (2, 3, 256)
    for bad in (counts[:1], torch.cat([counts, counts]), counts.float(),
                torch.zeros(2, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError):
            stream_t.composite_stream_tiles_t(props_t, ct, bad, 2, 1)


@pytest.mark.parametrize("seed,opacity", [(4, None), (5, 0.97)], ids=["dense", "saturated"])
def test_plain_k8_is_zero_past_each_real_count(seed, opacity):
    """The plain K8 walks each run to its padded end; the rows past a
    tile's real count (its run's sentinel padding) and the trash chunks get
    exactly zero gradients, which is what K8 writes there without walking
    them."""
    scene = make_scene(200, seed=seed, spread=0.3 if opacity else 1.5)
    if opacity:
        scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(opacity))))
    with torch.no_grad():
        s = prepare_stream(torch_camera(make_camera(width=64, height=48)), torch_scene(scene), RenderConfig(chunk=32))
        props_t = s.props().t().contiguous()
    ct, gw, gh, counts = s.chunk_tile, s.grid_w, s.grid_h, s.binned.tile_counts
    color, final_t = stream_t.composite_stream_tiles_t_plain(props_t, ct, gw, gh)
    rng = np.random.RandomState(seed)
    g_color = torch.from_numpy(rng.randn(*color.shape).astype(np.float32))
    g_t = torch.from_numpy(rng.randn(*final_t.shape).astype(np.float32))
    d8 = stream_t.composite_stream_tiles_t_bwd_plain(props_t, ct, gw, gh, color, final_t, g_color, g_t)
    row_start, row_end = stream.real_row_ranges(ct, counts, gw * gh, props_t.shape[1] // ct.shape[0])
    real = torch.zeros(props_t.shape[1], dtype=torch.bool)
    for a, b in zip(row_start.tolist(), row_end.tolist()):
        real[a:b] = True
    padded = ~real
    assert int(padded.sum()) > 0 and int((row_end > row_start).sum()) > 0
    assert torch.all(props_t[8, padded] == 0)  # sentinel rows: opacity 0
    assert torch.all(d8[:, padded] == 0)
    assert float(d8[:, real].abs().max()) > 0
