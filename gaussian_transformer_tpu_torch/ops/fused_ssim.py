"""Fused SSIM forward (port of ``gaussian_transformer_tpu/ops/fused_ssim.py``).

Kernel K3: ``csrc/ssim_fwd.cu`` replaces the TPU kernel
``ops/fused_ssim.py:106 _fwd_kernel``: the mean 11x11, sigma 1.5 windowed
SSIM ('same' zero padding, C1 = 0.01^2, C2 = 0.03^2) in one pass that keeps
the five filtered fields on chip. It is bound by operations (~240 fp32
operations per pixel against 8 bytes read); its design answer is one CTA per
(image, 32x32 tile) with the halo and the vertical-pass fields in shared
memory (see the source's header). Images are CHW or BCHW; the batch is
handled natively (the Pallas version had no batching rule).

``fused_ssim`` launches K3 for CUDA tensors and uses the plain version,
``ssim_plain``, only for CPU tensors. The analytic backward (the reference's
``_bwd_kernel``) comes with the training slice.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from gaussian_transformer_tpu_torch.kernels import CudaKernel

K = 11  # window size
C1 = 0.01**2
C2 = 0.03**2

SSIM_FWD = CudaKernel(
    "ssim_fwd.cu",
    "ssim_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)
# Output tile of one K3 block (must match csrc/ssim_fwd.cu).
_BX = _BY = 32


@functools.lru_cache(maxsize=None)
def gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    """The reference's 2-D Gaussian window (numpy float32, outer product)."""
    xs = np.asarray(
        [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2)) for x in range(window_size)],
        dtype=np.float32,
    )
    xs = xs / xs.sum()
    return np.outer(xs, xs)


def taps(window_size: int = K) -> np.ndarray:
    """Separable 1-D factor of the window ([K] float32, sums to 1)."""
    return gaussian_window(window_size, 1.5).sum(axis=1).astype(np.float32)


def filter2d_same(img: torch.Tensor, g1: np.ndarray) -> torch.Tensor:
    """Separable 'same' zero-padded filter over the last two axes by explicit
    shift-and-accumulate: the vertical pass, then the horizontal one. No
    convolution call: cuDNN would run a float32 convolution in TF32."""
    k = len(g1)
    half = k // 2

    def pass_along(x, dim):
        n = x.shape[dim]
        pad = [0, 0] * (x.ndim - 1 - (dim % x.ndim)) + [half, half]
        xp = F.pad(x, pad)
        acc = None
        for i in range(k):
            sl = xp.narrow(dim, i, n) * float(g1[i])
            acc = sl if acc is None else acc + sl
        return acc

    return pass_along(pass_along(img, -2), -1)


def map_terms(mu1, mu2, m11, m22, m12):
    """The SSIM map from the five filtered fields (the reference's
    ``_map_partials`` form, map only)."""
    a_ = 2.0 * mu1 * mu2 + C1
    sigma12 = m12 - mu1 * mu2
    b_ = 2.0 * sigma12 + C2
    c_ = mu1 * mu1 + mu2 * mu2 + C1
    d_ = (m11 - mu1 * mu1) + (m22 - mu2 * mu2) + C2
    return a_ * b_ * (1.0 / (c_ * d_))


def _flatten(img: torch.Tensor) -> torch.Tensor:
    """CHW or BCHW -> [N, H, W]."""
    if img.ndim == 3:
        return img
    return img.reshape(-1, *img.shape[-2:])


def windowed_ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = K,
                  size_average: bool = True) -> torch.Tensor:
    """Plain windowed SSIM of CHW or BCHW images: the scalar mean
    (size_average) or per-batch means (a scalar for CHW)."""
    squeeze = img1.ndim == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    fields = torch.stack([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    ssim_map = map_terms(*filter2d_same(fields, taps(window_size)))
    if size_average:
        return torch.mean(ssim_map)
    per_batch = torch.mean(ssim_map, dim=(1, 2, 3))
    return per_batch[0] if squeeze else per_batch


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: mean SSIM of CHW/BCHW float32 images."""
    return windowed_ssim(img1, img2)


def _launch_ssim_fwd(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    if img1.shape != img2.shape or img1.ndim not in (3, 4):
        raise ValueError(f"need two CHW or BCHW images of one shape, got {tuple(img1.shape)}, {tuple(img2.shape)}")
    if img1.dtype != torch.float32 or img2.dtype != torch.float32:
        raise ValueError("fused SSIM takes float32 images")
    if img1.device != img2.device:
        raise ValueError("images must be on the same device")
    a, b = _flatten(img1).contiguous(), _flatten(img2).contiguous()
    N, H, W = a.shape
    dev = a.device
    g = torch.as_tensor(taps(), device=dev)
    partials = torch.empty(N, -(-H // _BY), -(-W // _BX), dtype=torch.float32, device=dev)
    SSIM_FWD.launch(
        a.data_ptr(), b.data_ptr(), g.data_ptr(), N, H, W, partials.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return (partials.sum(dtype=torch.float64) / (N * H * W)).to(torch.float32)


class _SsimFwd(torch.autograd.Function):
    """K3 launch; the analytic backward arrives with the training slice."""

    @staticmethod
    def forward(ctx, img1, img2):
        return _launch_ssim_fwd(img1, img2)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the fused SSIM backward (TPU kernel ops/fused_ssim.py:132) is "
            "ported with the training slice"
        )


def fused_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean 11x11/sigma-1.5 windowed SSIM of CHW or BCHW float32 images:
    kernel K3 for CUDA tensors, the plain version for CPU tensors."""
    if img1.is_cuda:
        return _SsimFwd.apply(img1, img2)
    if img1.device.type != "cpu":
        raise ValueError(f"no fused SSIM for device {img1.device}")
    return ssim_plain(img1, img2)
