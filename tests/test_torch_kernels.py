"""The port's hand-written CUDA kernels (K1-K9) against their plain PyTorch
versions, on the card only (marker ``gpu``; each test skips without a CUDA
device).

This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from gaussian_transformer_tpu_torch.attic import stream_t
from gaussian_transformer_tpu_torch.convert import scene_from_numpy
from gaussian_transformer_tpu_torch.ops import fused_ssim
from gaussian_transformer_tpu_torch.ops.losses import ssim
from gaussian_transformer_tpu_torch.render import RenderConfig, prepare_stream, prepare_table, render
from gaussian_transformer_tpu_torch.render import stream, table_composite
from gaussian_transformer_tpu_torch.scene.cameras import Camera
from gaussian_transformer_tpu_torch.tools import layout_probe

K1_ATOL = 2e-5


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: these tests run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _scene(n, seed, device, opacity=None, spread=1.0):
    rng = np.random.RandomState(seed)
    op = rng.uniform(0.05, 0.95, (n, 1)) if opacity is None else np.full((n, 1), opacity)
    fields = {
        "xyz": rng.uniform(-spread, spread, (n, 3)).astype(np.float32),
        "features_dc": (0.3 * rng.randn(n, 1, 3)).astype(np.float32),
        "features_rest": (0.05 * rng.randn(n, 15, 3)).astype(np.float32),
        "scaling": rng.uniform(-4.0, -2.0, (n, 3)).astype(np.float32),
        "rotation": rng.randn(n, 4).astype(np.float32),
        "opacity": np.log(op / (1 - op)).astype(np.float32),
        "alive": np.ones(n, bool),
    }
    return scene_from_numpy(fields, 3, device)


def _camera(width, height, device, z=4.0, fov=60.0):
    return Camera.create(0, np.eye(3), np.array([0.0, 0.0, z]), math.radians(fov),
                         math.radians(fov * height / width), None, None, "k", 0,
                         width=width, height=height, device=device)


def _check_k1(s):
    """K1 against its plain version on the covered tiles. A pixel whose T
    lands near 1e-4 may stop one contribution apart (sequential product vs
    cumprod rounding): that moves it by < 1e-4, so the share beyond atol is
    bounded rather than zero."""
    props = s.props()
    ct = s.chunk_tile
    before = stream.STREAM_FWD.launches
    color, t = stream.composite_stream_tiles(props, ct, s.grid_w, s.grid_h)
    torch.cuda.synchronize()
    assert stream.STREAM_FWD.launches == before + 1
    p_color, p_t = stream.composite_stream_tiles_plain(props, ct, s.grid_w, s.grid_h)
    cov = s.binned.covered
    err = torch.cat([(color - p_color)[cov].flatten(), (t - p_t)[cov].flatten()]).abs()
    assert float(err.max()) <= 1e-3
    assert float((err > K1_ATOL).float().mean()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("width,height,chunk", [(160, 112, 0), (1920, 1080, 64), (200, 90, 128)])
def test_stream_kernel_matches_plain(cuda, width, height, chunk):
    with torch.no_grad():
        s = prepare_stream(_camera(width, height, cuda), _scene(4000, 1, cuda), RenderConfig(chunk=chunk))
        assert int(s.binned.n_instances) > 0
        _check_k1(s)


@pytest.mark.gpu
def test_stream_kernel_saturated_and_empty(cuda):
    with torch.no_grad():
        s = prepare_stream(_camera(96, 64, cuda), _scene(3000, 2, cuda, opacity=0.97, spread=0.3))
        _check_k1(s)
        out = render(_camera(96, 64, cuda), _scene(3000, 2, cuda, opacity=0.97, spread=0.3))
        assert float(out["final_T"].min()) < 1e-3
        empty = _scene(8, 3, cuda)
        empty.alive.zero_()
        out = render(_camera(64, 48, cuda), empty, bg_color=torch.tensor([0.2, 0.4, 0.6]))
        assert torch.allclose(out["render"][:, 0, 0].cpu(), torch.tensor([0.2, 0.4, 0.6]))
        assert float(out["final_T"].min()) == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 1080, 1920), (2, 3, 70, 129), (1, 5, 7)])
def test_ssim_kernel_matches_plain(cuda, shape):
    rng = np.random.RandomState(4)
    a, b = (torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda) for _ in range(2))
    before = fused_ssim.SSIM_FWD.launches
    out = float(ssim(a, b))
    torch.cuda.synchronize()
    assert fused_ssim.SSIM_FWD.launches == before + 1
    assert abs(out - float(fused_ssim.ssim_plain(a, b))) < 1e-5


def _check_k2(s, seed):
    """K2 against its plain version on random cotangents: the same bounded
    share of termination flips as K1 (relative to the largest gradient)."""
    props, ct = s.props(), s.chunk_tile
    color, t = stream.composite_stream_tiles(props, ct, s.grid_w, s.grid_h)
    gen = torch.Generator(props.device).manual_seed(seed)
    g_color = torch.randn(color.shape, generator=gen, device=props.device)
    g_t = torch.randn(t.shape, generator=gen, device=props.device)
    before = stream.STREAM_BWD.launches
    got = stream._launch_stream_bwd(props, ct, s.grid_w, s.grid_h, color, t, g_color, g_t)
    torch.cuda.synchronize()
    assert stream.STREAM_BWD.launches == before + 1
    ref = stream.composite_stream_tiles_bwd_plain(props, ct, s.grid_w, s.grid_h, color, t, g_color, g_t)
    scale = float(ref.abs().max())
    assert scale > 0
    err = (got - ref).abs()
    assert float(err.max()) <= 1e-3 * scale
    assert float((err > 2e-4 * scale).float().mean()) <= 1e-4
    assert torch.all(got[:, stream.GRAD_F:] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("width,height,chunk", [(160, 112, 0), (1920, 1080, 64), (200, 90, 128)])
def test_stream_backward_kernel_matches_plain(cuda, width, height, chunk):
    with torch.no_grad():
        s = prepare_stream(_camera(width, height, cuda), _scene(4000, 1, cuda), RenderConfig(chunk=chunk))
        _check_k2(s, seed=width)


@pytest.mark.gpu
def test_stream_backward_kernel_saturated(cuda):
    with torch.no_grad():
        s = prepare_stream(_camera(96, 64, cuda), _scene(3000, 2, cuda, opacity=0.97, spread=0.3))
        _check_k2(s, seed=5)


@pytest.mark.gpu
def test_render_gradients_on_card_match_cpu(cuda):
    """The whole render backward (K2 and the gather pullback on the card)
    against the CPU path (plain K2), at the reference's 2e-4 of the largest
    gradient."""
    grads = []
    for dev in (cuda, torch.device("cpu")):
        scene = _scene(600, 6, dev)
        offset = torch.zeros(scene.capacity, 2, device=dev, requires_grad=True)
        out = render(_camera(96, 64, dev), scene, bg_color=torch.tensor([0.2, 0.1, 0.4], device=dev),
                     screenspace_offset=offset)
        loss = torch.sum(out["render"] ** 2) + 0.1 * torch.sum(out["final_T"])
        leaves = [scene.xyz, scene.opacity, scene.scaling, scene.features_dc, offset]
        grads.append([g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for a, b in zip(*grads):
        assert torch.all(torch.isfinite(a))
        assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 1080, 1920), (2, 3, 70, 129), (1, 5, 7)])
def test_ssim_backward_kernel_matches_plain(cuda, shape):
    """Through autograd, on cropped (non-contiguous) images as the renderer's
    output is."""
    rng = np.random.RandomState(5)
    pad = shape[:-1] + (shape[-1] + 3,)
    a, b = (torch.from_numpy(rng.rand(*pad).astype(np.float32)).to(cuda)[..., : shape[-1]].requires_grad_()
            for _ in range(2))
    assert not a.is_contiguous()
    before = fused_ssim.SSIM_BWD.launches
    d1, d2 = torch.autograd.grad(-3.0 * ssim(a, b), (a, b))
    torch.cuda.synchronize()
    assert fused_ssim.SSIM_BWD.launches == before + 1
    flat = lambda x: x.detach().reshape(-1, *x.shape[-2:])
    r1, r2 = fused_ssim.ssim_bwd_plain(flat(a), flat(b), torch.tensor(-3.0, device=cuda))
    for got, ref in ((d1, r1), (d2, r2)):
        assert got.shape == a.shape
        assert float((got.reshape(ref.shape) - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    k1, k2 = fused_ssim._launch_ssim_bwd(flat(a), flat(b), torch.tensor(-3.0, device=cuda))
    assert float((k1 - r1).abs().max()) <= 1e-4 * float(r1.abs().max())


@pytest.mark.gpu
def test_kernels_reject_bad_inputs_and_gradients(cuda):
    a = torch.rand(3, 16, 16, device=cuda)
    with pytest.raises(ValueError):
        fused_ssim.fused_ssim(a, a.double())
    # Gradients flow through both kernels' autograd nodes.
    x = a.clone().requires_grad_()
    fused_ssim.fused_ssim(x, torch.rand_like(a)).backward()
    assert x.grad is not None and torch.all(torch.isfinite(x.grad))
    props = torch.zeros(64, 16, device=cuda, requires_grad=True)
    ct = torch.zeros(2, dtype=torch.int32, device=cuda)
    color, t = stream.composite_stream_tiles(props, ct, 1, 1)
    (color.sum() + t.sum()).backward()
    assert props.grad is not None and float(props.grad.abs().max()) == 0.0  # empty rows: no gradient


def _check_k5_k6(s, seed):
    """K5 and K6 against their plain versions on one view's table, under
    K1's and K2's rules; K6 leaves every row its walk does not reach zero."""
    props, counts, gw = s.props(), s.binned.tile_counts, s.grid_w
    before = (table_composite.TABLE_FWD.launches, table_composite.TABLE_BWD.launches)
    color, t = table_composite.composite_table_tiles(props, counts, gw)
    p_color, p_t = table_composite.composite_table_tiles_plain(props, counts, gw)
    err = torch.cat([(color - p_color).flatten(), (t - p_t).flatten()]).abs()
    assert float(err.max()) <= 1e-3
    assert float((err > K1_ATOL).float().mean()) <= 1e-4
    gen = torch.Generator(props.device).manual_seed(seed)
    g_color = torch.randn(color.shape, generator=gen, device=props.device)
    g_t = torch.randn(t.shape, generator=gen, device=props.device)
    got = table_composite._launch_table_bwd(props, counts, gw, color, t, g_color, g_t)
    torch.cuda.synchronize()
    assert (table_composite.TABLE_FWD.launches, table_composite.TABLE_BWD.launches) == (before[0] + 1, before[1] + 1)
    ref = table_composite.composite_table_tiles_bwd_plain(props, counts, gw, color, t, g_color, g_t)
    scale = float(ref.abs().max())
    assert scale > 0
    err = (got - ref).abs()
    assert float(err.max()) <= 1e-3 * scale
    assert float((err > 2e-4 * scale).float().mean()) <= 1e-4
    assert torch.all(got[..., stream.GRAD_F:] == 0)
    past = torch.arange(props.shape[1], device=props.device)[None, :] >= table_composite.walked_rows(counts, props.shape[1])[:, None]
    assert torch.all(got[past] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("width,height,K", [(160, 112, 256), (1920, 1080, 512)])
def test_table_kernels_match_plain(cuda, width, height, K):
    with torch.no_grad():
        s = prepare_table(_camera(width, height, cuda), _scene(4000, 1, cuda),
                          RenderConfig(use_stream=False, max_per_tile=K))
        counts = s.binned.tile_counts
        assert int(counts.max()) > 0 and int((counts == 0).sum()) > 0  # busy and empty tiles
        _check_k5_k6(s, seed=width)


@pytest.mark.gpu
def test_table_kernels_saturated_and_empty(cuda):
    cfg = RenderConfig(use_stream=False, max_per_tile=800)
    with torch.no_grad():
        s = prepare_table(_camera(96, 64, cuda), _scene(3000, 2, cuda, opacity=0.97, spread=0.3), cfg)
        _check_k5_k6(s, seed=5)
        out = render(_camera(96, 64, cuda), _scene(3000, 2, cuda, opacity=0.97, spread=0.3), cfg)
        assert float(out["final_T"].min()) < 1e-3
        empty = _scene(8, 3, cuda)
        empty.alive.zero_()
        out = render(_camera(64, 48, cuda), empty, cfg, bg_color=torch.tensor([0.2, 0.4, 0.6]))
        assert torch.allclose(out["render"][:, 0, 0].cpu(), torch.tensor([0.2, 0.4, 0.6]))
        assert float(out["final_T"].min()) == 1.0


@pytest.mark.gpu
def test_table_render_gradients_on_card_match_cpu(cuda):
    """The table path's render backward (K6 and the table pullback on the
    card) against the CPU path (plain K6), at 2e-4 of the largest gradient."""
    grads = []
    cfg = RenderConfig(use_stream=False, max_per_tile=128)
    for dev in (cuda, torch.device("cpu")):
        scene = _scene(600, 6, dev)
        offset = torch.zeros(scene.capacity, 2, device=dev, requires_grad=True)
        out = render(_camera(96, 64, dev), scene, cfg, bg_color=torch.tensor([0.2, 0.1, 0.4], device=dev),
                     screenspace_offset=offset)
        loss = torch.sum(out["render"] ** 2) + 0.1 * torch.sum(out["final_T"])
        leaves = [scene.xyz, scene.opacity, scene.scaling, scene.features_dc, offset]
        grads.append([g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for a, b in zip(*grads):
        assert torch.all(torch.isfinite(a))
        assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max())


@pytest.mark.gpu
def test_table_kernels_reject_bad_inputs(cuda):
    counts = torch.zeros(2, dtype=torch.int32, device=cuda)
    for bad in (torch.zeros(2, 40, 16, device=cuda), torch.zeros(2, 32, 9, device=cuda),
                torch.zeros(2, 32, 16, dtype=torch.float64, device=cuda)):
        with pytest.raises(ValueError):
            table_composite.composite_table_tiles(bad, counts, 2)
    props = torch.zeros(2, 32, 16, device=cuda, requires_grad=True)
    for bad_counts in (counts.float(), counts.cpu(), counts[:1]):
        with pytest.raises(ValueError):
            table_composite.composite_table_tiles(props, bad_counts, 2)
    with pytest.raises(ValueError):
        table_composite._launch_table_bwd(props.detach(), counts, 2, *(torch.zeros(2, c, 256, device=cuda)
                                                                        for c in (3, 1, 3, 3)))
    # Empty tiles: background, no gradient.
    color, t = table_composite.composite_table_tiles(props, counts, 2)
    (color.sum() + t.sum()).backward()
    assert float(color.detach().abs().max()) == 0.0 and float(t.detach().min()) == 1.0
    assert props.grad is not None and float(props.grad.abs().max()) == 0.0


def _check_k7_k8(s, seed):
    """K7 and K8 against their plain versions (and K7 against K1) on one
    view's stream as planes, under K1's and K2's rules; K8 writes zero
    planes 9-15."""
    props = s.props()
    props_t, ct, gw, gh = props.t().contiguous(), s.chunk_tile, s.grid_w, s.grid_h
    before = (stream_t.STREAM_T_FWD.launches, stream_t.STREAM_T_BWD.launches)
    color, t = stream_t.composite_stream_tiles_t(props_t, ct, gw, gh)
    cov = s.binned.covered
    for ref_color, ref_t in (stream_t.composite_stream_tiles_t_plain(props_t, ct, gw, gh),
                             stream.composite_stream_tiles(props, ct, gw, gh)):
        err = torch.cat([(color - ref_color)[cov].flatten(), (t - ref_t)[cov].flatten()]).abs()
        assert float(err.max()) <= 1e-3
        assert float((err > K1_ATOL).float().mean()) <= 1e-4
    gen = torch.Generator(props.device).manual_seed(seed)
    g_color = torch.randn(color.shape, generator=gen, device=props.device)
    g_t = torch.randn(t.shape, generator=gen, device=props.device)
    got = stream_t._launch_stream_t_bwd(props_t, ct, gw, gh, color, t, g_color, g_t)
    torch.cuda.synchronize()
    assert (stream_t.STREAM_T_FWD.launches, stream_t.STREAM_T_BWD.launches) == (before[0] + 1, before[1] + 1)
    ref = stream_t.composite_stream_tiles_t_bwd_plain(props_t, ct, gw, gh, color, t, g_color, g_t)
    scale = float(ref.abs().max())
    assert scale > 0
    err = (got - ref).abs()
    assert float(err.max()) <= 1e-3 * scale
    assert float((err > 2e-4 * scale).float().mean()) <= 1e-4
    assert torch.all(got[stream.GRAD_F:] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("width,height,chunk", [(160, 112, 0), (1920, 1080, 64), (200, 90, 128)])
def test_transposed_stream_kernels_match_plain(cuda, width, height, chunk):
    with torch.no_grad():
        s = prepare_stream(_camera(width, height, cuda), _scene(4000, 1, cuda), RenderConfig(chunk=chunk))
        assert int(s.binned.n_instances) > 0
        _check_k7_k8(s, seed=width)


@pytest.mark.gpu
def test_transposed_stream_kernels_saturated(cuda):
    with torch.no_grad():
        s = prepare_stream(_camera(96, 64, cuda), _scene(3000, 2, cuda, opacity=0.97, spread=0.3))
        _check_k7_k8(s, seed=5)


@pytest.mark.gpu
def test_transposed_render_gradients_on_card_match_cpu(cuda):
    """stream_image_t's backward (K8 and the gather pullback on the card)
    against the CPU path (plain K8), at 2e-4 of the largest gradient."""
    grads = []
    for dev in (cuda, torch.device("cpu")):
        with torch.no_grad():
            s = prepare_stream(_camera(96, 64, dev), _scene(600, 6, dev))
        p = s.proj
        leaves = [v.detach().clone().requires_grad_() for v in (s.means2d, p.conics, p.rgbs, p.opacities)]
        img, t_map = stream_t.stream_image_t(s.binned, *leaves, torch.tensor([0.2, 0.1, 0.4], device=dev),
                                             grid_w=s.grid_w, grid_h=s.grid_h)
        loss = torch.sum(img ** 2) + 0.1 * torch.sum(t_map)
        grads.append([g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for a, b in zip(*grads):
        assert torch.all(torch.isfinite(a))
        assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [name for name, *_ in layout_probe.LAYOUTS])
def test_layout_probe_kernel_matches_plain(cuda, layout):
    """K9 at the probe's size (N = 3,232,768, a partial last block) against
    its plain version: f32 sums of positive data to 1e-6 relative."""
    block = next(b for name, _, _, b in layout_probe.LAYOUTS if name == layout)
    x = layout_probe.make_layout(layout, layout_probe.ROWS, cuda, seed=3)
    before = layout_probe.LAYOUT_PROBE.launches
    got = layout_probe.block_sums(x, block)
    torch.cuda.synchronize()
    assert layout_probe.LAYOUT_PROBE.launches == before + 1
    ref = layout_probe.block_sums_plain(x, block)
    assert got.shape == ref.shape == (layout_probe.ROWS // 2048,)
    assert float(((got - ref).abs() / ref).max()) <= 1e-6
    assert torch.equal(got, layout_probe.block_sums(x, block))  # deterministic


@pytest.mark.gpu
def test_layout_probe_kernel_rejects_unaligned(cuda):
    with pytest.raises(ValueError):
        layout_probe.block_sums(torch.zeros(16, 2050, device=cuda), (16, 2048))
    with pytest.raises(ValueError):
        layout_probe.block_sums(torch.zeros(4096, 16, dtype=torch.float64, device=cuda), (2048, 16))
