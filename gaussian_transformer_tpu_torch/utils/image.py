"""Image metrics (port of ``gaussian_transformer_tpu/utils/image.py``).

Both reduce over all but the LEADING axis. The metrics CLI passes CHW images,
as the reference does, so its PSNR is the mean of three per-channel PSNRs."""

from __future__ import annotations

import torch


def mse(img1, img2):
    """Per-leading-axis-element MSE; returns [B, 1]."""
    b = img1.shape[0]
    return torch.mean(((img1 - img2) ** 2).reshape(b, -1), dim=1, keepdim=True)


def psnr(img1, img2):
    """Peak SNR for [0,1] images, per leading-axis element; returns [B, 1]."""
    return 20 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))
