"""The port's hand-written CUDA kernels (K1-K9, and K1/K2's bf16 entry
points) against their plain PyTorch versions, on the card only (marker ``gpu``; each test skips without a CUDA
device), and on the CPU the plain replay backwards on the kernels' edge cases
and the plain forwards on the skip-floor sweep.

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
    color, t = stream.composite_stream_tiles(props, ct, s.binned.tile_counts, s.grid_w, s.grid_h)
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


def _bf16_stream(s):
    """(float32 rows, bf16 tile-local rows, chunk_tile) of a stream."""
    props = s.props()
    return props, stream.kernel_props(props, s.chunk_tile, s.grid_w, "bf16"), s.chunk_tile


@pytest.mark.gpu
@pytest.mark.parametrize("width,height,chunk", [(160, 112, 0), (1920, 1080, 64), (200, 90, 128)])
def test_bf16_stream_kernels_match_plain(cuda, width, height, chunk):
    """``stream_fwd_bf16`` and ``stream_bwd_bf16`` against their plain
    versions on the same bf16 rows, at K1's and K2's rules; each launch
    counts on its own counter, never on the float32 kernels'."""
    with torch.no_grad():
        s = prepare_stream(_camera(width, height, cuda), _scene(4000, 1, cuda), RenderConfig(chunk=chunk))
        _, rows, ct = _bf16_stream(s)
        counts = s.binned.tile_counts
        before = (stream.STREAM_FWD.launches, stream.STREAM_BWD.launches, stream.STREAM_FWD_BF16.launches,
                  stream.STREAM_BWD_BF16.launches)
        color, t = stream._launch_stream_fwd(rows, ct, counts, s.grid_w, s.grid_h, "bf16")
        gen = torch.Generator(cuda).manual_seed(width)
        g_color = torch.randn(color.shape, generator=gen, device=cuda)
        g_t = torch.randn(t.shape, generator=gen, device=cuda)
        got = stream._launch_stream_bwd(rows, ct, s.grid_w, s.grid_h, color, t, g_color, g_t, "bf16")
        torch.cuda.synchronize()
        after = (stream.STREAM_FWD.launches, stream.STREAM_BWD.launches, stream.STREAM_FWD_BF16.launches,
                 stream.STREAM_BWD_BF16.launches)
        assert after == (before[0], before[1], before[2] + 1, before[3] + 1)
        p_color, p_t = stream.composite_stream_tiles_plain(rows, ct, s.grid_w, s.grid_h)
        cov = s.binned.covered
        err = torch.cat([(color - p_color)[cov].flatten(), (t - p_t)[cov].flatten()]).abs()
        assert float(err.max()) <= 1e-3
        assert float((err > K1_ATOL).float().mean()) <= 1e-4
        ref = stream.composite_stream_tiles_bwd_plain(rows, ct, s.grid_w, s.grid_h, color, t, g_color, g_t)
        assert got.dtype == torch.float32 and ref.dtype == torch.float32
        scale = float(ref.abs().max())
        assert scale > 0
        err = (got - ref).abs()
        assert float(err.max()) <= 1e-3 * scale
        assert float((err > 2e-4 * scale).float().mean()) <= 1e-4
        assert torch.all(got[:, stream.GRAD_F:] == 0)


@pytest.mark.gpu
def test_bf16_render_close_to_fp32_on_card(cuda):
    """The bf16 render on the card: the reference's bf16 image rule (PSNR
    > 40 dB) against the float32 render; with ``-s`` it prints the largest
    difference (the reference's 0.03 at its 80x48 size) and each gradient's
    largest difference of the largest (its 0.12 rule), and the share within
    5%. The gradient goes through ``stream_bwd_bf16``, the float32 kernels
    run only for the float32 render."""
    cam = _camera(640, 360, cuda)
    scene = _scene(8000, 7, cuda)
    out, grads = {}, {}
    for prec in ("fp32", "bf16"):
        offset = torch.zeros(scene.capacity, 2, device=cuda, requires_grad=True)
        before = stream.STREAM_BWD_BF16.launches
        r = render(cam, scene, RenderConfig(precision=prec), bg_color=torch.tensor([0.2, 0.1, 0.3], device=cuda),
                   screenspace_offset=offset)
        loss = torch.sum(r["render"] ** 2) + 0.1 * torch.sum(r["final_T"])
        leaves = [scene.xyz, scene.opacity, scene.scaling, scene.features_dc, offset]
        grads[prec] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        assert stream.STREAM_BWD_BF16.launches == before + (prec == "bf16")
        out[prec] = torch.clamp(r["render"].detach(), 0, 1)
    mse = ((out["bf16"] - out["fp32"]) ** 2).mean(dim=(1, 2))
    psnr = float((20 * torch.log10(1.0 / torch.sqrt(mse))).mean())
    diff = float((out["bf16"] - out["fp32"]).abs().max())
    print(f"bf16 vs fp32 render, 640x360, 8000 Gaussians: PSNR {psnr:.2f} dB, max abs diff {diff:.4f}")
    assert psnr > 40.0
    for name, a, b in zip(["xyz", "opacity", "scaling", "features_dc", "offset"], grads["fp32"], grads["bf16"]):
        assert torch.all(torch.isfinite(b)), name
        scale = float(a.abs().max())
        rel = float((b - a).abs().max()) / scale
        tight = float(((b - a).abs() <= 0.05 * scale).float().mean())
        print(f"  {name}: max diff {rel:.4f} of the largest, {tight:.4f} within 5%")


@pytest.mark.gpu
def test_bf16_kernels_reject_bad_inputs(cuda):
    """Float32 rows in bf16 mode (and bf16 rows in float32 mode), rows not
    16-byte aligned, rows that do not split into chunks: each raises before
    a launch."""
    ct = torch.zeros(2, dtype=torch.int32, device=cuda)
    counts = torch.full((1,), 64, dtype=torch.int32, device=cuda)
    rows32 = torch.zeros(64, 16, device=cuda)
    rows16 = rows32.to(torch.bfloat16)
    flat = torch.zeros(64 * 16 + 4, dtype=torch.bfloat16, device=cuda)
    misaligned = flat[4:].view(64, 16)  # 8 bytes past a 16-byte boundary
    assert misaligned.data_ptr() % 16 == 8
    t = torch.zeros(1, 1, 256, device=cuda)
    c = torch.zeros(1, 3, 256, device=cuda)
    before = (stream.STREAM_FWD_BF16.launches, stream.STREAM_BWD_BF16.launches)
    for rows, prec in ((rows32, "bf16"), (rows16, "fp32"), (misaligned, "bf16"), (rows16[:63], "bf16")):
        with pytest.raises(ValueError):
            stream._launch_stream_fwd(rows, ct, counts, 1, 1, prec)
        with pytest.raises(ValueError):
            stream._launch_stream_bwd(rows, ct, 1, 1, c, t, c, t, prec)
    assert (stream.STREAM_FWD_BF16.launches, stream.STREAM_BWD_BF16.launches) == before
    with pytest.raises(ValueError):  # the public entry takes the float32 rows and rounds them itself
        stream.composite_stream_tiles(rows16, ct, counts, 1, 1, "bf16")
    color, final_t = stream.composite_stream_tiles(rows32, ct, counts, 1, 1, "bf16")  # zero rows: background
    assert float(final_t.min()) == 1.0 and float(color.abs().max()) == 0.0


# K3/K4's tile is 32 rows x 64 columns: one below, at and one above a tile
# side in each axis (and at two tiles), sides under the window, a single
# column, a batch of 4 x 3 channels.
SSIM_EDGE_SHAPES = [(3, 31, 63), (3, 32, 64), (3, 33, 65), (3, 63, 127), (3, 64, 128),
                    (3, 65, 129), (1, 7, 70), (1, 40, 9), (1, 20, 1), (4, 3, 33, 65)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 1080, 1920), (2, 3, 70, 129), (1, 5, 7)] + SSIM_EDGE_SHAPES)
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
    color, t = stream.composite_stream_tiles(props, ct, s.binned.tile_counts, s.grid_w, s.grid_h)
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
@pytest.mark.parametrize("shape", [(3, 1080, 1920), (2, 3, 70, 129), (1, 5, 7)] + SSIM_EDGE_SHAPES)
def test_ssim_backward_kernel_matches_plain(cuda, shape):
    """Through autograd, on cropped (non-contiguous) images as the renderer's
    output is."""
    rng = np.random.RandomState(5)
    pad = shape[:-1] + (shape[-1] + 3,)
    a, b = (torch.from_numpy(rng.rand(*pad).astype(np.float32)).to(cuda)[..., : shape[-1]].requires_grad_()
            for _ in range(2))
    assert not a.is_contiguous()
    before = fused_ssim.SSIM_BWD.launches
    out = ssim(a, b)
    d1, d2 = torch.autograd.grad(-3.0 * out, (a, b))
    torch.cuda.synchronize()
    assert fused_ssim.SSIM_BWD.launches == before + 1
    flat = lambda x: x.detach().reshape(-1, *x.shape[-2:])
    assert abs(float(out) - float(fused_ssim.ssim_plain(flat(a), flat(b)))) < 1e-5  # K3 on the crop
    r1, r2 = fused_ssim.ssim_bwd_plain(flat(a), flat(b), torch.tensor(-3.0, device=cuda))
    for got, ref in ((d1, r1), (d2, r2)):
        assert got.shape == a.shape
        assert float((got.reshape(ref.shape) - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    k1, k2 = fused_ssim._launch_ssim_bwd(flat(a), flat(b), torch.tensor(-3.0, device=cuda))
    assert float((k1 - r1).abs().max()) <= 1e-4 * float(r1.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("amp", [1e-2, 1e-3, 1e-4])
def test_ssim_kernels_near_constant(cuda, amp):
    """Near-constant images (0.5 + amp U[0, 1)): D = sigma1^2 + sigma2^2 + C2
    sits near C2, where the map's partials are largest and float32 loses
    digits to E[x^2] - mu^2. Held to a float64 evaluation of the plain
    versions: K3 within 1e-5 of the mean; K4 no further from it than the
    float32 plain version, up to 1e-5 of the largest gradient."""
    gen = torch.Generator(cuda).manual_seed(11)
    a = 0.5 + amp * torch.rand((3, 70, 129), generator=gen, device=cuda)
    b = 0.5 + amp * torch.rand((3, 70, 129), generator=gen, device=cuda)
    g = torch.tensor(-3.0, device=cuda)
    m64 = float(fused_ssim.ssim_plain(a.double(), b.double()))
    r = fused_ssim.ssim_bwd_plain(a.double(), b.double(), g.double())
    p32 = fused_ssim.ssim_bwd_plain(a, b, g)
    k3 = float(fused_ssim._launch_ssim_fwd(a, b))
    k4 = fused_ssim._launch_ssim_bwd(a, b, g)
    scale = max(float(x.abs().max()) for x in r)
    err = lambda got: max(float((x.double() - y).abs().max()) for x, y in zip(got, r)) / scale
    print(f"amp {amp}: K3 - f64 {k3 - m64:+.3e}; K4 {err(k4):.3e}, plain f32 {err(p32):.3e} of max |grad| {scale:.3e}")
    assert abs(k3 - m64) <= 1e-5
    assert err(k4) <= err(p32) + 1e-5


@pytest.mark.gpu
def test_ssim_wrappers_do_not_synchronise(cuda):
    """A forward and a backward through fused_ssim on CUDA tensors pass under
    torch.cuda.set_sync_debug_mode("error"): no host copy, no host read."""
    rng = np.random.RandomState(9)
    a, b = (torch.from_numpy(rng.rand(3, 70, 133).astype(np.float32)).to(cuda) for _ in range(2))
    x = a[..., :129].clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = -2.0 * fused_ssim.fused_ssim(x, b[..., :129])
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and torch.isfinite(x.grad).all()


@pytest.mark.gpu
def test_ssim_kernels_unaligned_planes_and_repeats(cuda):
    """Planes that are not 16-byte aligned (a misaligned base; a crop read in
    place, rows of an odd stride) take the kernels' 4-byte staging and give
    the bits of aligned contiguous copies; K3's mean (written by its last
    CTA from the per-CTA partials in a fixed order) repeats bit for bit."""
    rng = np.random.RandomState(10)
    N, H, W = 3, 100, 192
    flat = [torch.from_numpy(rng.rand(N * H * W + 1).astype(np.float32)).to(cuda) for _ in range(2)]
    a, b = (f[1:].view(N, H, W) for f in flat)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    ac, bc = a.clone(), b.clone()
    assert ac.data_ptr() % 16 == 0
    g = torch.tensor(0.5, device=cuda)
    assert torch.equal(fused_ssim._launch_ssim_fwd(a, b), fused_ssim._launch_ssim_fwd(ac, bc))
    for u, v in zip(fused_ssim._launch_ssim_bwd(a, b, g), fused_ssim._launch_ssim_bwd(ac, bc, g)):
        assert torch.equal(u, v)
    # Rows of an odd stride from a misaligned base (a crop, read in place).
    wide = [torch.from_numpy(rng.rand(N, H, W + 5).astype(np.float32)).to(cuda)[..., 3:W + 2] for _ in range(2)]
    assert wide[0].stride(1) == W + 5 and not wide[0].is_contiguous()
    tight = [w.contiguous() for w in wide]
    assert torch.equal(fused_ssim._launch_ssim_fwd(*wide), fused_ssim._launch_ssim_fwd(*tight))
    for u, v in zip(fused_ssim._launch_ssim_bwd(*wide, g), fused_ssim._launch_ssim_bwd(*tight, g)):
        assert torch.equal(u, v)
    big = [torch.from_numpy(rng.rand(12, 540, 960).astype(np.float32)).to(cuda) for _ in range(2)]
    means = torch.stack([fused_ssim._launch_ssim_fwd(*big) for _ in range(20)])
    assert torch.all(means == means[0])
    assert abs(float(means[0]) - float(fused_ssim.ssim_plain(*big))) < 1e-5


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
    counts = torch.full((1,), 64, dtype=torch.int32, device=cuda)  # 64 rows of opacity 0
    for bad_counts in (counts.float(), counts.cpu(), counts.repeat(2)):
        with pytest.raises(ValueError):
            stream.composite_stream_tiles(props, ct, bad_counts, 1, 1)
    color, t = stream.composite_stream_tiles(props, ct, counts, 1, 1)
    (color.sum() + t.sum()).backward()
    assert props.grad is not None and float(props.grad.abs().max()) == 0.0  # empty rows: no gradient
    # Counts larger than their runs: K1 ends each run at its padded end (never
    # in the next tile's run, nor past the stream), so it matches its plain
    # version and its walk to the real counts.
    (props, ct), (_, counts) = _replay_layouts(_forward_edge_tiles(), 32, cuda)
    fwd = stream.composite_stream_tiles(props, ct, counts, 2, 1)
    over = stream.composite_stream_tiles(props, ct, counts + 10 * 32, 2, 1)
    assert all(torch.equal(a, b) for a, b in zip(fwd, over))
    ref = stream.composite_stream_tiles_plain(props, ct, 2, 1)
    err = torch.cat([(over[0] - ref[0]).flatten(), (over[1] - ref[1]).flatten()]).abs()
    assert float(err.max()) <= 1e-3 and float((err > K1_ATOL).float().mean()) <= 1e-4


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


def _row(x, y, a, b, c, opac, rgb=(0.6, 0.3, 0.2)):
    return [x, y, a, b, c, *rgb, opac] + [0.0] * 7


def _replay_case(case):
    """Per-tile rows (absolute means) of a 2x1 tile grid for the replay
    backwards' edge cases, and the stream's chunk:
    one_lane: a row that only pixel (5, 9) of tile 0 (warp 4, lane 21) sees;
    capped: broad rows of opacity 0.995 at two pixels apart, so alpha_raw >
      0.99 near their centres (w nonzero, g_power zero) and below it further
      out;
    partial_batch_exit: tile 0's 48 rows at chunk 16 (not a multiple of
      32), and two rows that cap every pixel of tile 1 at rows 40-41, so the
      whole tile stops at row 41 of 96, mid-batch;
    flat_exit, flatter_exit: as partial_batch_exit with three near-flat
      rows (conic 1e-4, 1e-5) of opacity 0.98, below the cap at every pixel
      (so g_power is nonzero across the tile, amplified by 1 / (1 - alpha)),
      at rows 40-42; the tile stops at row 42. Their conic gradients are
      sums of 256 large per-pixel terms of both signs, where float32
      summation orders part most.
    Each case keeps every pixel's T away from the 1e-4 stop, where the
    kernels' sequential product and the plain cumprod may part."""
    rng = np.random.RandomState(11)

    def soft(n, ox, opac=(0.05, 0.3)):
        return [_row(ox + rng.uniform(0, 16), rng.uniform(0, 16), *rng.uniform(0.02, 0.2, 1), 0.0,
                     *rng.uniform(0.02, 0.2, 1), rng.uniform(*opac)) for _ in range(n)]

    if case == "one_lane":
        return [soft(10, 0) + [_row(5.0, 9.0, 50.0, 0.0, 50.0, 0.8)] + soft(30, 0), soft(20, 16)], 32
    if case == "capped":
        capped = lambda ox: [_row(ox + 4.0, 4.0, 0.01, 0.0, 0.01, 0.995), _row(ox + 11.0, 11.0, 0.01, 0.0, 0.01, 0.995)]
        return [soft(6, 0) + capped(0) + soft(20, 0), capped(16) + soft(25, 16)], 32
    opac, conic, n = {"flat_exit": (0.98, 1e-4, 3), "flatter_exit": (0.98, 1e-5, 3)}.get(case, (0.9999, 1e-4, 2))
    opaque = [_row(24.0, 8.0, conic, 0.0, conic, opac) for _ in range(n)]
    return [soft(48, 0), soft(40, 16, (0.02, 0.08)) + opaque + soft(56 - n, 16)], 16


def _replay_layouts(tiles, chunk, device):
    """The same per-tile rows as a stream (props [I_pad, 16], chunk_tile
    with one trash chunk) and as a table (props [T, K, 16], counts); the
    counts are also the stream's tile counts."""
    stream_rows, chunk_tile = [], []
    for t, rows in enumerate(tiles):
        n = -(-len(rows) // chunk) * chunk
        stream_rows += rows + [[0.0] * 16] * (n - len(rows))
        chunk_tile += [t] * (n // chunk)
    stream_rows += [[0.0] * 16] * chunk
    chunk_tile.append(len(tiles))
    K = -(-max(len(r) for r in tiles) // 32) * 32 + 32
    table = np.zeros((len(tiles), K, 16), np.float32)
    for t, rows in enumerate(tiles):
        table[t, :len(rows)] = rows
    as_t = lambda v, dt=torch.float32: torch.tensor(np.asarray(v), dtype=dt, device=device)
    return ((as_t(stream_rows), as_t(chunk_tile, torch.int32)),
            (as_t(table), as_t([len(r) for r in tiles], torch.int32)))


def _cotangents(color, t, seed):
    gen = torch.Generator(color.device).manual_seed(seed)
    return torch.randn(color.shape, generator=gen, device=color.device), torch.randn(t.shape, generator=gen, device=color.device)


def _k2_rule(got, ref):
    """(max abs error, share beyond atol), both against K2's rule: 1e-3 and
    2e-4 of the largest reference gradient, at most 1e-4 of values beyond."""
    scale = float(ref.abs().max())
    assert scale > 0
    err = (got.double() - ref.double()).abs()
    return float(err.max()) / scale, float((err > 2e-4 * scale).double().mean())


def _table_bwd_f64(table, counts, grid_w, color, t, g_color, g_t):
    """K6's function with every per-pixel term and sum in float64, on the
    float32 walk's alpha, T and stop flags (so the same pixels contribute):
    the reference that the float32 summation orders of the plain version
    and the kernels are each an approximation of."""
    d = lambda v: v.double()
    out = torch.zeros(table.shape, dtype=torch.float64, device=table.device)
    pref = torch.zeros(color.shape, dtype=torch.float64, device=table.device)
    for rd in table_composite._plain_rounds(table, counts, grid_w):
        rd = rd._replace(rows=d(rd.rows), dx=d(rd.dx), dy=d(rd.dy), alpha=d(rd.alpha), t_in=d(rd.t_in),
                         live_k=d(rd.live_k))
        grads, totals = table_composite._round_grads(rd, d(color), pref, d(g_color), d(g_t), d(t))
        out[rd.tiles, rd.start:rd.start + table_composite.CH, :stream.GRAD_F] = grads
        pref[rd.tiles] = pref[rd.tiles] + totals
    return out


def _table_to_stream(table_rows, tiles, chunk):
    """Rows [T, K, 16] of a table as the stream of ``_replay_layouts``."""
    parts = [table_rows[t, :-(-len(rows) // chunk) * chunk] for t, rows in enumerate(tiles)]
    return torch.cat(parts + [table_rows.new_zeros(chunk, table_rows.shape[2])])


def _real_rows(tiles, chunk, device):
    """[I_pad] True at the real rows of the stream of ``_replay_layouts``."""
    mask = []
    for rows in tiles:
        n = -(-len(rows) // chunk) * chunk
        mask += [True] * len(rows) + [False] * (n - len(rows))
    return torch.tensor(mask + [False] * chunk, device=device)


def _check_k7_is_k5(fwd7, fwd5):
    """K7 and K5 walk the same rows in the same frame with the same
    arithmetic: their outputs agree bit for bit in every tile."""
    assert torch.equal(fwd7[0], fwd5[0]) and torch.equal(fwd7[1], fwd5[1])


def _check_k8_is_k6(got8, got6, tiles, chunk):
    """K8's planes 0-8 at each tile's real rows equal K6's rows bit for bit
    (the same walk, reduced in the same order); everywhere else (planes
    9-15, the run padding, the trash chunk) K8 wrote zeros, as K6 did past
    its counts."""
    real = _real_rows(tiles, chunk, got8.device)
    rows = got8.t()[real]
    starts = np.cumsum([0] + [len(r) for r in tiles])
    as_table = torch.zeros_like(got6)
    for t, rows_t in enumerate(tiles):
        as_table[t, :len(rows_t)] = rows[starts[t]:starts[t + 1]]
    assert torch.equal(as_table, got6)
    assert torch.all(got8[:, ~real] == 0) and torch.all(got8[stream.GRAD_F:] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_lane", "capped", "partial_batch_exit", "flat_exit", "flatter_exit"])
def test_replay_backwards_edge_cases(cuda, case):
    """K2, K6 and K8 on hand-made rows: a row one lane of one warp sees,
    rows at the 0.99 cap, row counts off the batch size and a block that
    exits mid-batch (every later row zero), held under K2's rule to their
    plain versions and to the float64 evaluation of their function (the
    plain versions are held to it too); K8's planes equal K6's rows bit for
    bit. Prints each reading (``-s``).

    In the flat cases the kernels and the plain versions are two float32
    evaluations of rows whose per-pixel g_alpha divides a cancelling suffix
    sum by 1 - alpha = 0.02; they part by slightly more than K2's atol (one
    value of K6's 4,096 in flat_exit), while each stays within K2's rule of
    the float64 evaluation. There the kernels are held to that only."""
    tiles, chunk = _replay_case(case)
    (props, ct), (table, counts) = _replay_layouts(tiles, chunk, cuda)
    props_t = props.t().contiguous()
    fwd2 = stream.composite_stream_tiles(props, ct, counts, 2, 1)
    g_color, g_t = _cotangents(*fwd2, seed=3)
    got2 = stream._launch_stream_bwd(props, ct, 2, 1, *fwd2, g_color, g_t)
    ref2 = stream.composite_stream_tiles_bwd_plain(props, ct, 2, 1, *fwd2, g_color, g_t)
    exact2 = _table_to_stream(_table_bwd_f64(table, counts, 2, *fwd2, g_color, g_t), tiles, chunk)
    fwd6 = table_composite.composite_table_tiles(table, counts, 2)
    got6 = table_composite._launch_table_bwd(table, counts, 2, *fwd6, g_color, g_t)
    ref6 = table_composite.composite_table_tiles_bwd_plain(table, counts, 2, *fwd6, g_color, g_t)
    exact6 = _table_bwd_f64(table, counts, 2, *fwd6, g_color, g_t)
    fwd7 = stream_t.composite_stream_tiles_t(props_t, ct, counts, 2, 1)
    got8 = stream_t._launch_stream_t_bwd(props_t, ct, counts, 2, 1, *fwd7, g_color, g_t)
    ref8 = stream_t.composite_stream_tiles_t_bwd_plain(props_t, ct, 2, 1, *fwd7, g_color, g_t)
    exact8 = _table_to_stream(_table_bwd_f64(table, counts, 2, *fwd7, g_color, g_t), tiles, chunk).t()
    torch.cuda.synchronize()
    _check_k7_is_k5(fwd7, fwd6)
    _check_k8_is_k6(got8, got6, tiles, chunk)
    readings = {
        "K2 vs plain": _k2_rule(got2, ref2), "K6 vs plain": _k2_rule(got6, ref6), "K8 vs plain": _k2_rule(got8, ref8),
        "K2 vs float64": _k2_rule(got2, exact2), "K6 vs float64": _k2_rule(got6, exact6),
        "K8 vs float64": _k2_rule(got8, exact8),
        "plain K2 vs float64": _k2_rule(ref2, exact2), "plain K6 vs float64": _k2_rule(ref6, exact6),
        "plain K8 vs float64": _k2_rule(ref8, exact8),
    }
    for name, (max_err, share) in readings.items():
        print(f"{case}: {name}: max abs error {max_err:.3e} of the largest gradient, share beyond 2e-4 {share:.3e}")
    for name, (max_err, share) in readings.items():
        if case.startswith("flat") and name.endswith("vs plain"):
            continue
        assert max_err <= 1e-3 and share <= 1e-4, (name, max_err, share)
    assert torch.all(got2[:, stream.GRAD_F:] == 0) and torch.all(got6[..., stream.GRAD_F:] == 0)
    if case == "one_lane":  # the row at 10: only w gC of one pixel, and its g_power terms
        assert float(got6[0, 10, 5:8].abs().min()) > 0 and float(got2[10, 5:8].abs().min()) > 0
    if case.endswith("_exit"):  # tile 1's run starts at stream row 48
        last = 40 if case == "partial_batch_exit" else 41
        assert float(got6[1, last, 5:8].abs().min()) > 0 and float(got2[48 + last, 5:8].abs().min()) > 0
        assert torch.all(got6[1, last + 1:] == 0) and torch.all(got2[48 + last + 1:] == 0)
        assert float(got8[5:8, 48 + last].abs().min()) > 0 and torch.all(got8[:, 48 + last + 1:] == 0)


@pytest.mark.parametrize("case", ["one_lane", "capped", "partial_batch_exit", "flat_exit", "flatter_exit"])
def test_plain_replay_backwards_edge_cases(case):
    """The references of the card test above, on the CPU: plain K2, plain
    K6 and plain K8 on the same hand-made rows each within K2's rule of the
    float64 evaluation of their function, so a kernel held to any of them is
    held to the function."""
    cpu = torch.device("cpu")
    tiles, chunk = _replay_case(case)
    (props, ct), (table, counts) = _replay_layouts(tiles, chunk, cpu)
    fwd2 = stream.composite_stream_tiles(props, ct, counts, 2, 1)
    g_color, g_t = _cotangents(*fwd2, seed=3)
    ref2 = stream.composite_stream_tiles_bwd_plain(props, ct, 2, 1, *fwd2, g_color, g_t)
    exact2 = _table_to_stream(_table_bwd_f64(table, counts, 2, *fwd2, g_color, g_t), tiles, chunk)
    fwd6 = table_composite.composite_table_tiles(table, counts, 2)
    ref6 = table_composite.composite_table_tiles_bwd_plain(table, counts, 2, *fwd6, g_color, g_t)
    exact6 = _table_bwd_f64(table, counts, 2, *fwd6, g_color, g_t)
    props_t = props.t().contiguous()
    fwd8 = stream_t.composite_stream_tiles_t(props_t, ct, counts, 2, 1)
    ref8 = stream_t.composite_stream_tiles_t_bwd_plain(props_t, ct, 2, 1, *fwd8, g_color, g_t)
    exact8 = _table_to_stream(_table_bwd_f64(table, counts, 2, *fwd8, g_color, g_t), tiles, chunk).t()
    for got, exact in ((ref2, exact2), (ref6, exact6), (ref8, exact8)):
        max_err, share = _k2_rule(got, exact)
        assert max_err <= 1e-3 and share <= 1e-4, (max_err, share)


def _forward_edge_tiles(spike=True):
    """Hand-made rows (absolute means) of a 2x1 tile grid for the forward
    walk's edge cases. Tile 0 (45 rows: not a multiple of 32, and no pixel
    terminates): for k = -3..3, a row whose alpha at pixel (8 + 2k, 6) is
    k float32 ulps from 1/255 as numpy evaluates it (expf may differ by an ulp
    or two), so the exact test and the exp-free floor both decide rows on
    either side of the threshold; rows of opacity 0; with ``spike``, a row of
    conic 1e38 that only its centre pixel sees (power -inf elsewhere; its
    per-pixel gradient terms overflow, so the backward checks go without
    it); soft rows between. Tile 1 (77 rows): soft rows, then three opaque
    broad rows (opacity 0.99, below the cap) that stop every pixel by row 32,
    then rows no pixel reaches."""
    rng = np.random.RandomState(12)
    f32 = np.float32

    def soft(n, ox, opac=(0.02, 0.2)):
        return [_row(ox + rng.uniform(0, 16), rng.uniform(0, 16), *rng.uniform(0.02, 0.2, 1), 0.0,
                     *rng.uniform(0.02, 0.2, 1), rng.uniform(*opac)) for _ in range(n)]

    near = []
    for k in range(-3, 4):
        px, py = f32(8 + 2 * k), f32(6)
        x, y = px + f32(2), py  # dx = 2, dy = 0: power = -0.5 * (1 * 2 * 2) = -2 exactly
        opac = f32(f32(1.0 / 255.0) / np.exp(f32(-2.0)))
        opac = (np.array([opac], f32).view(np.int32) + k).view(f32)[0]
        near.append(_row(float(x), float(y), 1.0, 0.0, 1.0, float(opac)))
    zero = [_row(4.0, 4.0, 0.05, 0.0, 0.05, 0.0), _row(12.0, 3.0, 0.0, 0.0, 0.0, 0.0)]
    spike = [_row(5.0, 11.0, 1e38 if spike else 0.05, 0.0, 1e38 if spike else 0.05, 0.6)]
    tile0 = soft(10, 0) + near + zero + soft(12, 0) + spike + soft(13, 0)
    opaque = [_row(24.0, 8.0, 1e-4, 0.0, 1e-4, 0.99) for _ in range(3)]
    tile1 = soft(30, 16) + opaque + soft(44, 16)
    assert (len(tile0), len(tile1)) == (45, 77)
    return [tile0, tile1]


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [512, 32])
def test_forward_kernels_edge_rows(cuda, chunk):
    """K1, K5 and K7 on ``_forward_edge_tiles`` (each run walked to its real
    count; at chunk 512 most of a run is sentinel) against their plain
    versions under K1's rule; tile 0's frame is the screen's for K1, so
    K1's and K5's outputs there agree bit for bit, and K7's equal K5's in
    every tile. K2, K6 and K8, fed the forwards' outputs (rows without the
    spike), against their plain versions under K2's rule; K8's planes equal
    K6's rows bit for bit."""
    tiles = _forward_edge_tiles()
    (props, ct), (table, counts) = _replay_layouts(tiles, chunk, cuda)
    props_t = props.t().contiguous()
    kernels = (stream.STREAM_FWD, table_composite.TABLE_FWD, stream_t.STREAM_T_FWD)
    before = [k.launches for k in kernels]
    fwd1 = stream.composite_stream_tiles(props, ct, counts, 2, 1)
    fwd5 = table_composite.composite_table_tiles(table, counts, 2)
    fwd7 = stream_t.composite_stream_tiles_t(props_t, ct, counts, 2, 1)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    for got, ref in ((fwd1, stream.composite_stream_tiles_plain(props, ct, 2, 1)),
                     (fwd5, table_composite.composite_table_tiles_plain(table, counts, 2)),
                     (fwd7, stream_t.composite_stream_tiles_t_plain(props_t, ct, 2, 1))):
        err = torch.cat([(got[0] - ref[0]).flatten(), (got[1] - ref[1]).flatten()]).abs()
        assert float(err.max()) <= 1e-3
        assert float((err > K1_ATOL).float().mean()) <= 1e-4
    assert torch.equal(fwd1[0][0], fwd5[0][0]) and torch.equal(fwd1[1][0], fwd5[1][0])
    _check_k7_is_k5(fwd7, fwd5)
    # Tile 1 stops by row 32 (a run cut there gives the same bits), tile 0 never.
    cut = counts.clone()
    cut[1] = 33
    assert all(torch.equal(a, b) for a, b in zip(fwd1, stream.composite_stream_tiles(props, ct, cut, 2, 1)))
    assert all(torch.equal(a, b) for a, b in zip(fwd7, stream_t.composite_stream_tiles_t(props_t, ct, cut, 2, 1)))
    assert float(fwd1[1][0].min()) > 0.1 and float(fwd1[1][1].max()) < 0.02
    tiles = _forward_edge_tiles(spike=False)
    (props, ct), (table, counts) = _replay_layouts(tiles, chunk, cuda)
    props_t = props.t().contiguous()
    fwd1 = stream.composite_stream_tiles(props, ct, counts, 2, 1)
    fwd5 = table_composite.composite_table_tiles(table, counts, 2)
    fwd7 = stream_t.composite_stream_tiles_t(props_t, ct, counts, 2, 1)
    _check_k7_is_k5(fwd7, fwd5)
    g_color, g_t = _cotangents(*fwd1, seed=6)
    got2 = stream._launch_stream_bwd(props, ct, 2, 1, *fwd1, g_color, g_t)
    ref2 = stream.composite_stream_tiles_bwd_plain(props, ct, 2, 1, *fwd1, g_color, g_t)
    got6 = table_composite._launch_table_bwd(table, counts, 2, *fwd5, g_color, g_t)
    ref6 = table_composite.composite_table_tiles_bwd_plain(table, counts, 2, *fwd5, g_color, g_t)
    got8 = stream_t._launch_stream_t_bwd(props_t, ct, counts, 2, 1, *fwd7, g_color, g_t)
    ref8 = stream_t.composite_stream_tiles_t_bwd_plain(props_t, ct, 2, 1, *fwd7, g_color, g_t)
    for got, ref in ((got2, ref2), (got6, ref6), (got8, ref8)):
        max_err, share = _k2_rule(got, ref)
        assert max_err <= 1e-3 and share <= 1e-4, (max_err, share)
    _check_k8_is_k6(got8, got6, tiles, chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [512, 32])
def test_bf16_kernels_edge_rows(cuda, chunk):
    """K1.bf16 and K2.bf16 on ``_forward_edge_tiles`` rounded as
    ``kernel_props`` rounds them: the opacity-0 rows, the sentinel padding
    and the trash chunk (all shifted to x = -origin with opacity 0), the
    spike, a tile that never stops, counts off 32; against their plain
    versions under K1's and K2's rules. Tile 1 stops by row 32, so a run
    cut there gives the same bits."""
    (props, ct), (_, counts) = _replay_layouts(_forward_edge_tiles(), chunk, cuda)
    rows = stream.kernel_props(props, ct, 2, "bf16")
    fwd = stream._launch_stream_fwd(rows, ct, counts, 2, 1, "bf16")
    ref = stream.composite_stream_tiles_plain(rows, ct, 2, 1)
    err = torch.cat([(fwd[0] - ref[0]).flatten(), (fwd[1] - ref[1]).flatten()]).abs()
    assert float(err.max()) <= 1e-3 and float((err > K1_ATOL).float().mean()) <= 1e-4
    cut = counts.clone()
    cut[1] = 33
    assert all(torch.equal(a, b) for a, b in zip(fwd, stream._launch_stream_fwd(rows, ct, cut, 2, 1, "bf16")))
    assert float(fwd[1][0].min()) > 0.1 and float(fwd[1][1].max()) < 0.02
    (props, ct), (_, counts) = _replay_layouts(_forward_edge_tiles(spike=False), chunk, cuda)
    rows = stream.kernel_props(props, ct, 2, "bf16")
    fwd = stream._launch_stream_fwd(rows, ct, counts, 2, 1, "bf16")
    g_color, g_t = _cotangents(*fwd, seed=7)
    got = stream._launch_stream_bwd(rows, ct, 2, 1, *fwd, g_color, g_t, "bf16")
    ref = stream.composite_stream_tiles_bwd_plain(rows, ct, 2, 1, *fwd, g_color, g_t)
    max_err, share = _k2_rule(got, ref)
    assert max_err <= 1e-3 and share <= 1e-4, (max_err, share)
    pad = slice(int(counts[0]), -(-int(counts[0]) // chunk) * chunk)  # tile 0's sentinel rows
    assert int(torch.count_nonzero(got[pad])) == 0


def _skip_floor_sweep():
    """Rows of a 48x1 tile grid that sweep the forward walk's exp-free skip
    (absolute means), and the walk's outputs evaluated in float64. Tile t
    holds 32 rows of one opacity o_t (44 values over [1/255, 1] and four
    just above 1/255), each centred one pixel left of the tile with conic
    (a, 0, 0), a = -2p, so its power at pixel column 0 is exactly p = ln(1/255
    / o_t) + d: d runs from 1e-5 to 3e-3 on either side of the exact alpha
    threshold, so rows fall below the floor (1e-3 under the threshold),
    between floor and threshold, and above it. Every pair's alpha is at
    least 5e-6 (in log) from 1/255, so float32 (with expf's 2 ulp) and
    float64 take the same skips; the rows' colors are 1 and T stays above
    0.8, so a row skipped wrongly moves its pixels by ~3e-3. Returns
    (tiles, color [48, 3, 256], final_T [48, 1, 256])."""
    f32, f64 = np.float32, np.float64
    lo = f32(1.0 / 255.0)
    opac = np.concatenate([np.geomspace(lo, 1.0, 44), lo * (1 + np.array([1e-3, 2e-3, 1e-2, 3e-2]))]).astype(f32)
    d = np.concatenate([-np.geomspace(3e-3, 1e-5, 16), np.geomspace(1e-5, 3e-3, 16)])
    power0 = (np.log(f64(lo) / opac.astype(f64))[:, None] + d[None, :]).astype(f32)  # [48, 32]
    tiles = [[_row(16.0 * t - 1.0, 8.0, float(f32(-2) * p), 0.0, 0.0, float(o), rgb=(1.0, 1.0, 1.0))
              for p in power0[t]] for t, o in enumerate(opac)]
    pix = np.arange(256)
    color = np.zeros((len(tiles), 3, 256))
    final_t = np.zeros((len(tiles), 1, 256))
    for t, rows in enumerate(tiles):
        rows = np.asarray(rows, f32)
        dx = rows[:, :1] - (f32(16 * t) + pix % 16).astype(f32)  # [32, 256], as the kernels round
        dy = rows[:, 1:2] - (pix // 16).astype(f32)
        a, b, c = rows[:, 2:3], rows[:, 3:4], rows[:, 4:5]
        power = f32(-0.5) * ((a * dx) * dx + (c * dy) * dy) - (b * dx) * dy
        assert power.dtype == f32 and np.array_equal(power[:, 0], power0[t])
        log_alpha = np.log(rows[:, 8:9].astype(f64)) + power - np.log(f64(lo))
        assert np.all((power > 0) | (np.abs(log_alpha) >= 5e-6))
        alpha = np.minimum(0.99, rows[:, 8:9].astype(f64) * np.exp(np.minimum(power, 0).astype(f64)))
        alpha = np.where((power > 0) | (log_alpha < 0), 0.0, alpha)
        T = np.ones(256)
        for k in range(len(rows)):
            color[t] += rows[k, 5:8, None] * alpha[k] * T
            T = T * (1.0 - alpha[k])
        final_t[t, 0] = T
    lit = (color[:, 0] > 0).sum(axis=1)  # at o = 1/255 no row reaches the threshold
    assert final_t.min() > 0.8 and lit[0] == 0 and lit[1:].min() > 0 and lit.max() < 256
    return tiles, color, final_t


@pytest.mark.gpu
def test_forward_kernels_skip_floor_sweep(cuda):
    """The exp-free skip with the kernels' own logf and expf: K1, K5 and K7
    on ``_skip_floor_sweep``'s rows against the float64 evaluation (1e-5)
    and against their plain versions under K1's rule; K1 = K5 = K7 bit for
    bit (the same dx in both frames)."""
    tiles, color, final_t = _skip_floor_sweep()
    (props, ct), (table, counts) = _replay_layouts(tiles, 32, cuda)
    props_t = props.t().contiguous()
    fwd1 = stream.composite_stream_tiles(props, ct, counts, len(tiles), 1)
    fwd5 = table_composite.composite_table_tiles(table, counts, len(tiles))
    fwd7 = stream_t.composite_stream_tiles_t(props_t, ct, counts, len(tiles), 1)
    for got, ref in ((fwd1, stream.composite_stream_tiles_plain(props, ct, len(tiles), 1)),
                     (fwd5, table_composite.composite_table_tiles_plain(table, counts, len(tiles))),
                     (fwd7, stream_t.composite_stream_tiles_t_plain(props_t, ct, len(tiles), 1))):
        assert float((got[0].cpu().double() - torch.from_numpy(color)).abs().max()) <= 1e-5
        assert float((got[1].cpu().double() - torch.from_numpy(final_t)).abs().max()) <= 1e-5
        err = torch.cat([(got[0] - ref[0]).flatten(), (got[1] - ref[1]).flatten()]).abs()
        assert float(err.max()) <= 1e-3 and float((err > K1_ATOL).float().mean()) <= 1e-4
    assert torch.equal(fwd1[0], fwd5[0]) and torch.equal(fwd1[1], fwd5[1])
    _check_k7_is_k5(fwd7, fwd5)


@pytest.mark.parametrize("layout", ["stream", "table"])
def test_plain_forward_skip_floor_sweep(layout):
    """The plain K1 and K5 (the CPU path) on ``_skip_floor_sweep``'s rows
    against its float64 evaluation, as the card test holds the kernels."""
    cpu = torch.device("cpu")
    tiles, color, final_t = _skip_floor_sweep()
    (props, ct), (table, counts) = _replay_layouts(tiles, 32, cpu)
    if layout == "stream":
        got = stream.composite_stream_tiles(props, ct, counts, len(tiles), 1)
    else:
        got = table_composite.composite_table_tiles(table, counts, len(tiles))
    assert float((got[0].double() - torch.from_numpy(color)).abs().max()) <= 1e-5
    assert float((got[1].double() - torch.from_numpy(final_t)).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_replay_backwards_deterministic(cuda):
    """Two launches of K2, of K6 and of K8 give the same bits."""
    with torch.no_grad():
        s = prepare_stream(_camera(160, 112, cuda), _scene(4000, 1, cuda))
        props, ct, gw, gh = s.props(), s.chunk_tile, s.grid_w, s.grid_h
        color, t = stream.composite_stream_tiles(props, ct, s.binned.tile_counts, gw, gh)
        k2_in = (props, ct, gw, gh, color, t, *_cotangents(color, t, seed=4))
        first = stream._launch_stream_bwd(*k2_in)
        assert torch.equal(first, stream._launch_stream_bwd(*k2_in))
        k8_in = (props.t().contiguous(), ct, s.binned.tile_counts, *k2_in[2:])
        first = stream_t._launch_stream_t_bwd(*k8_in)
        assert torch.equal(first, stream_t._launch_stream_t_bwd(*k8_in))
        s = prepare_table(_camera(160, 112, cuda), _scene(4000, 1, cuda), RenderConfig(use_stream=False, max_per_tile=256))
        props, counts = s.props(), s.binned.tile_counts
        color, t = table_composite.composite_table_tiles(props, counts, s.grid_w)
        k6_in = (props, counts, s.grid_w, color, t, *_cotangents(color, t, seed=5))
        first = table_composite._launch_table_bwd(*k6_in)
        assert torch.equal(first, table_composite._launch_table_bwd(*k6_in))


def _check_k7_k8(s, seed):
    """K7 and K8 against their plain versions (and K7 against K1) on one
    view's stream as planes, under K1's and K2's rules; K8 writes zero
    planes 9-15."""
    props = s.props()
    props_t, ct, gw, gh = props.t().contiguous(), s.chunk_tile, s.grid_w, s.grid_h
    before = (stream_t.STREAM_T_FWD.launches, stream_t.STREAM_T_BWD.launches)
    color, t = stream_t.composite_stream_tiles_t(props_t, ct, s.binned.tile_counts, gw, gh)
    cov = s.binned.covered
    for ref_color, ref_t in (stream_t.composite_stream_tiles_t_plain(props_t, ct, gw, gh),
                             stream.composite_stream_tiles(props, ct, s.binned.tile_counts, gw, gh)):
        err = torch.cat([(color - ref_color)[cov].flatten(), (t - ref_t)[cov].flatten()]).abs()
        assert float(err.max()) <= 1e-3
        assert float((err > K1_ATOL).float().mean()) <= 1e-4
    gen = torch.Generator(props.device).manual_seed(seed)
    g_color = torch.randn(color.shape, generator=gen, device=props.device)
    g_t = torch.randn(t.shape, generator=gen, device=props.device)
    got = stream_t._launch_stream_t_bwd(props_t, ct, s.binned.tile_counts, gw, gh, color, t, g_color, g_t)
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
@pytest.mark.parametrize("chunk", [512, 32])
def test_transposed_kernels_never_read_past_the_real_rows(cuda, chunk):
    """K7 and K8 on ``_forward_edge_tiles``' stream with NaN in every row
    past each tile's count (the run padding and the trash chunk): the
    outputs are finite and equal those of the zero-sentinel stream bit for
    bit, and K8 writes zeros at the NaN rows, so neither kernel reads
    them."""
    tiles = _forward_edge_tiles(spike=False)
    (props, ct), (_, counts) = _replay_layouts(tiles, chunk, cuda)
    real = _real_rows(tiles, chunk, cuda)
    props_t = props.t().contiguous()
    poisoned = props_t.clone()
    poisoned[:, ~real] = float("nan")
    fwd = stream_t.composite_stream_tiles_t(props_t, ct, counts, 2, 1)
    fwd_nan = stream_t.composite_stream_tiles_t(poisoned, ct, counts, 2, 1)
    assert all(bool(torch.isfinite(v).all()) for v in fwd_nan)
    assert all(torch.equal(a, b) for a, b in zip(fwd, fwd_nan))
    g_color, g_t = _cotangents(*fwd, seed=8)
    d8 = stream_t._launch_stream_t_bwd(props_t, ct, counts, 2, 1, *fwd, g_color, g_t)
    d8_nan = stream_t._launch_stream_t_bwd(poisoned, ct, counts, 2, 1, *fwd_nan, g_color, g_t)
    assert bool(torch.isfinite(d8_nan).all()) and torch.equal(d8, d8_nan)
    assert torch.all(d8_nan[:, ~real] == 0) and float(d8_nan[:, real].abs().max()) > 0


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


# ------------------------------------------------------------------ images ---


@pytest.mark.gpu
def test_committed_image_digests_through_the_tier_on_the_card(cuda):
    """On the card's machine (no libpng, libjpeg or Pillow there): every
    committed PNG in both outputs and every JPEG mode file decode to the
    digests recorded from libpng, Pillow and libjpeg, and a Blender view's
    ``image_to_array`` at ``-r 2`` to the JAX reader's."""
    import hashlib
    import json
    from pathlib import Path

    from gaussian_transformer_tpu_torch import native
    from gaussian_transformer_tpu_torch.scene.camera_utils import image_to_array

    testdata = Path(__file__).resolve().parent.parent / "gaussian_transformer_tpu_torch" / "native" / "testdata"

    def digest(arr):
        return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()

    assert native.codecs() == ("jpeg", "png"), native.unavailable_reason()
    record = json.loads((testdata / "png" / "digests.json").read_text())
    paths = {n: str(testdata / "png" / n) for n in record["files"]}
    rgb, rgba = native.decode_folder(list(paths.values())), native.decode_folder(list(paths.values()), rgba=True)
    for n, p in paths.items():
        assert digest(rgb[p]) == record["files"][n]["rgb"] and digest(rgba[p]) == record["files"][n]["rgba"], n
    modes = json.loads((testdata / "jpeg_modes" / "digests.json").read_text())
    got = native.decode_folder([str(testdata / "jpeg_modes" / n) for n in modes])
    for n, want in modes.items():
        assert digest(got[str(testdata / "jpeg_modes" / n)]) == want, n
    view = rgba[paths["blender/train/r_0.png"]] / 255.0
    composite = np.array(view[:, :, :3] * view[:, :, 3:4] * 255.0, dtype=np.uint8)
    assert digest(image_to_array(composite, (400, 400))) == record["scene"]["r2"]["train/r_0"]


def test_kernels_line_names_k1_to_k9_and_images_only_add_launches():
    """``chip_smoke.py``'s kernels line keeps its entries for K1-K9 (and
    K1/K2's bf16 entry points): section 35's ``image_launches`` adds a key
    to K1-K4's entries and no entry."""
    import chip_smoke

    names = ["stream_fwd", "ssim_fwd", "stream_bwd", "ssim_bwd", "table_fwd", "table_bwd", "stream_fwd_bf16",
             "stream_bwd_bf16", "stream_t_fwd", "stream_t_bwd", "layout_probe"]
    src = open(chip_smoke.__file__).read()
    assert [n for n in names if f'{{"name": "{n}", "route": "cuda",' in src] == names
    entries = [{"name": n} for n in names]
    chip_smoke.add_path_launches(entries, "image_launches", {"train": {"K1": 3, "K2": 2, "K3": 2, "K4": 2}})
    assert [e["name"] for e in entries] == names
    with_key = [e["name"] for e in entries if "image_launches" in e]
    assert with_key == ["stream_fwd", "ssim_fwd", "stream_bwd", "ssim_bwd"]
    assert entries[0]["image_launches"] == {"train": 3}
