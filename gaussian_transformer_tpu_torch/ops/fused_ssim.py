"""Fused SSIM forward and backward (port of
``gaussian_transformer_tpu/ops/fused_ssim.py``).

Kernel K3: ``csrc/ssim_fwd.cu`` replaces the TPU kernel
``ops/fused_ssim.py:106 _fwd_kernel``: the mean 11x11, sigma 1.5 windowed
SSIM ('same' zero padding, C1 = 0.01^2, C2 = 0.03^2) in one pass that keeps
the five filtered fields on chip. It is bound by operations (240 fp32
operations per pixel against 8 bytes read); its design answer is one CTA per
(image, 32x64 tile), register-blocked separable passes
(``csrc/ssim_common.cuh``), ~73 KB of shared memory and three CTAs an SM,
and the last CTA to finish writing the mean, so the call needs no other op.

Kernel K4: ``csrc/ssim_bwd.cu`` replaces the TPU kernel
``ops/fused_ssim.py:132 _bwd_kernel``: the analytic gradient of the mean
SSIM w.r.t. both images (the fields recomputed on the tile extended by the
window, the map's closed-form partials, the same filter applied to the four
cotangent maps, a pointwise combine). It is bound by operations (441 fp32
operations per pixel against 16 bytes moved); its design answer is one CTA
per (image, 32x64 tile) of 512 threads on the same register-blocked passes,
with its intermediates in one ~108 KB shared buffer reused across phases
(two CTAs an SM).

The taps are compile-time constants of the kernels (``ssim_common.cuh``,
the bits of ``taps()``), and ``g`` stays on the card: neither wrapper copies
from the host or synchronises. The kernels read each image through its row
and plane strides, so a cropped render is read in place.

Images are CHW or BCHW; the batch is handled natively (the Pallas version had
no batching rule). ``fused_ssim`` launches K3 (and K4 in its backward) for
CUDA tensors and uses the plain versions, ``ssim_plain`` and
``ssim_bwd_plain``, only for CPU tensors.
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

# Both entry points take each image as N planes with a unit column stride
# and their own row and plane strides (in floats).
_PLANES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_longlong, ctypes.c_longlong]  # N, H, W, row strides, plane strides
SSIM_FWD = CudaKernel(
    "ssim_fwd.cu",
    "ssim_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, *_PLANES, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p],
)
SSIM_BWD = CudaKernel(
    "ssim_bwd.cu",
    "ssim_bwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, *_PLANES,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
)
# Output tile of one K3 block, rows x columns (must match csrc/ssim_fwd.cu).
_TH, _TW = 32, 64


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


def _map_factors(mu1, mu2, m11, m22, m12):
    """(A, B, C, D) of map = A B / (C D), from the five filtered fields."""
    a_ = 2.0 * mu1 * mu2 + C1
    sigma12 = m12 - mu1 * mu2
    b_ = 2.0 * sigma12 + C2
    c_ = mu1 * mu1 + mu2 * mu2 + C1
    d_ = (m11 - mu1 * mu1) + (m22 - mu2 * mu2) + C2
    return a_, b_, c_, d_


def map_terms(mu1, mu2, m11, m22, m12):
    """The SSIM map from the five filtered fields (the reference's
    ``_map_partials`` form, map only)."""
    a_, b_, c_, d_ = _map_factors(mu1, mu2, m11, m22, m12)
    return a_ * b_ * (1.0 / (c_ * d_))


def map_partials(mu1, mu2, m11, m22, m12):
    """The map's partials w.r.t. the five fields (the reference's
    ``_map_partials``): (d_mu1, d_mu2, d_m11, d_m12); d_m22 == d_m11."""
    a_, b_, c_, d_ = _map_factors(mu1, mu2, m11, m22, m12)
    inv_cd = 1.0 / (c_ * d_)
    ssim_map = a_ * b_ * inv_cd
    d_m12 = 2.0 * a_ * inv_cd
    d_m11 = -ssim_map / d_
    common = ssim_map * (d_ - c_) * inv_cd
    d_mu1 = 2.0 * mu2 * (b_ - a_) * inv_cd - 2.0 * mu1 * common
    d_mu2 = 2.0 * mu1 * (b_ - a_) * inv_cd - 2.0 * mu2 * common
    return d_mu1, d_mu2, d_m11, d_m12


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


def ssim_bwd_plain(img1: torch.Tensor, img2: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch version of K4 (the reference's ``_jnp_bwd``): the
    gradients (d_img1, d_img2) of g * mean-SSIM of [N, H, W] images."""
    N, H, W = img1.shape
    g1 = taps()
    fields = torch.stack([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    d_mu1, d_mu2, d_m11, d_m12 = map_partials(*filter2d_same(fields, g1))
    scale = g / (N * H * W)
    # d_m22 == d_m11 pointwise, so one transposed filter serves both.
    cot = torch.stack([d_mu1, d_mu2, d_m11, d_m12], dim=0) * scale
    t_mu1, t_mu2, t_m, t_m12 = filter2d_same(cot, g1)
    d1 = t_mu1 + 2.0 * img1 * t_m + img2 * t_m12
    d2 = t_mu2 + 2.0 * img2 * t_m + img1 * t_m12
    return d1, d2


def _check_images(img1: torch.Tensor, img2: torch.Tensor) -> None:
    if img1.shape != img2.shape or img1.ndim not in (3, 4):
        raise ValueError(f"need two CHW or BCHW images of one shape, got {tuple(img1.shape)}, {tuple(img2.shape)}")
    if img1.dtype != torch.float32 or img2.dtype != torch.float32:
        raise ValueError("fused SSIM takes float32 images")
    if img1.device != img2.device:
        raise ValueError("images must be on the same device")


def _planes(a: torch.Tensor, b: torch.Tensor):
    """The kernels' plane arguments of two [N, H, W] images: (a, b, N, H, W,
    row strides, plane strides). A view with a unit column stride (the
    renderer's cropped output) is passed as it is; only other layouts are
    copied."""
    a = a if a.stride(-1) == 1 else a.contiguous()
    b = b if b.stride(-1) == 1 else b.contiguous()
    N, H, W = a.shape
    return a, b, (N, H, W, a.stride(1), b.stride(1), a.stride(0), b.stride(0))


def _launch_ssim_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3 on [N, H, W] images: the mean SSIM (a 0-dim tensor), written by
    the kernel itself."""
    dev = a.device
    if a.numel() == 0:
        return torch.full((), float("nan"), device=dev)  # the mean of no pixels
    a, b, dims = _planes(a, b)
    N, H, W = dims[:3]
    partials = torch.empty(N * -(-H // _TH) * -(-W // _TW), dtype=torch.float32, device=dev)
    mean = torch.empty((), dtype=torch.float32, device=dev)
    SSIM_FWD.launch(
        a.data_ptr(), b.data_ptr(), *dims, partials.data_ptr(), mean.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return mean


def _launch_ssim_bwd(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor):
    """K4 on [N, H, W] images: (d_img1, d_img2) of g * mean SSIM, contiguous.
    ``g`` stays on the card (no host read)."""
    dev = a.device
    a, b, dims = _planes(a, b)
    N, H, W = dims[:3]
    g = g.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    d1 = torch.empty((N, H, W), dtype=torch.float32, device=dev)
    d2 = torch.empty((N, H, W), dtype=torch.float32, device=dev)
    SSIM_BWD.launch(
        a.data_ptr(), b.data_ptr(), g.data_ptr(), 1.0 / (N * H * W), *dims,
        d1.data_ptr(), d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    return d1, d2


class _FusedSsim(torch.autograd.Function):
    """K3 forward and K4 backward on CUDA tensors; the plain versions on CPU
    tensors. Saves both images."""

    @staticmethod
    def forward(ctx, img1, img2):
        a, b = _flatten(img1), _flatten(img2)
        ctx.save_for_backward(a, b)
        ctx.shapes = (img1.shape, img2.shape)
        if a.is_cuda:
            return _launch_ssim_fwd(a, b)
        return ssim_plain(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if a.is_cuda:
            d1, d2 = _launch_ssim_bwd(a, b, g)
        else:
            d1, d2 = ssim_bwd_plain(a, b, g)
        return d1.reshape(ctx.shapes[0]), d2.reshape(ctx.shapes[1])


def fused_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean 11x11/sigma-1.5 windowed SSIM of CHW or BCHW float32 images,
    differentiable in both: kernels K3 and K4 for CUDA tensors, the plain
    versions for CPU tensors."""
    _check_images(img1, img2)
    if not (img1.is_cuda or img1.device.type == "cpu"):
        raise ValueError(f"no fused SSIM for device {img1.device}")
    return _FusedSsim.apply(img1, img2)
