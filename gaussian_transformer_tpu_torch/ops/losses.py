"""Losses: L1, L2 and windowed SSIM (port of ``gaussian_transformer_tpu/ops/losses.py``).

11x11 Gaussian window with sigma 1.5, depthwise 'same' zero padding,
C1 = 0.01^2, C2 = 0.03^2. Images are CHW or BCHW float in [0, 1].
"""

from __future__ import annotations

import torch

from gaussian_transformer_tpu_torch.ops.fused_ssim import fused_ssim, windowed_ssim


def l1_loss(network_output, gt):
    return torch.mean(torch.abs(network_output - gt))


def l2_loss(network_output, gt):
    return torch.mean((network_output - gt) ** 2)


def ssim(img1, img2, window_size: int = 11, size_average: bool = True):
    """Windowed SSIM of CHW or BCHW images: the scalar mean (size_average)
    or per-batch means.

    The reference's TPU dispatch rule with "tpu" read as "cuda": CUDA float32
    images of one shape with the default 11x11 window and size_average go
    through the fused kernel (ops.fused_ssim, K3); everything else takes the
    plain version (``fused_ssim.windowed_ssim``)."""
    if (
        window_size == 11
        and size_average
        and img1.is_cuda
        and img1.dtype == torch.float32
        and img2.dtype == torch.float32
        and img1.shape == img2.shape
    ):
        return fused_ssim(img1, img2)
    return windowed_ssim(img1, img2, window_size, size_average)
