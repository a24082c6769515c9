"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card only (marker ``gpu``; each test skips without a CUDA device).

This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from gaussian_transformer_tpu_torch.convert import scene_from_numpy
from gaussian_transformer_tpu_torch.ops import fused_ssim
from gaussian_transformer_tpu_torch.ops.losses import ssim
from gaussian_transformer_tpu_torch.render import prepare_stream, render
from gaussian_transformer_tpu_torch.render import stream
from gaussian_transformer_tpu_torch.scene.cameras import Camera

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
    from gaussian_transformer_tpu_torch.render import RenderConfig

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


@pytest.mark.gpu
def test_kernels_reject_bad_inputs_and_gradients(cuda):
    a = torch.rand(3, 16, 16, device=cuda)
    with pytest.raises(ValueError):
        fused_ssim.fused_ssim(a, a.double())
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_ssim.fused_ssim(a.clone().requires_grad_(), a).backward()
    props = torch.zeros(64, 16, device=cuda, requires_grad=True)
    ct = torch.zeros(2, dtype=torch.int32, device=cuda)
    color, t = stream.composite_stream_tiles(props, ct, 1, 1)
    with pytest.raises(NotImplementedError, match="training slice"):
        (color.sum() + t.sum()).backward()
