"""Float32 convolutions, forward and backward.

cuDNN computes float32 convolutions in TF32 while
``torch.backends.cudnn.allow_tf32`` is set (PyTorch's default), and it reads
the flag when each convolution runs, its backward included. ``conv`` holds
the flag off around its own forward and backward and leaves it as it found
it, so the port's convolutions (the autoencoder, LPIPS) compute in float32,
as the JAX package's do, whatever the caller has set. ``Conv1d`` is
``nn.Conv1d`` (zero padding) through ``conv``.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


@contextlib.contextmanager
def fp32_convs():
    """cuDNN convolutions in float32 (TF32 off) inside the block."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        nd = x.ndim - 2
        ctx.conf = (stride, padding, nd, bias is not None)
        ctx.save_for_backward(x, weight)
        with fp32_convs():
            return torch.ops.aten.convolution(x, weight, bias, stride, padding, [1] * nd, False, [0] * nd, 1)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, nd, has_bias = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], has_bias and ctx.needs_input_grad[2]]
        with fp32_convs():
            gx, gw, gb = torch.ops.aten.convolution_backward(g, x, weight, [weight.shape[0]] if has_bias else None,
                                                              stride, padding, [1] * nd, False, [0] * nd, 1, mask)
        return gx, gw, gb, None, None


def conv(x, weight, bias=None, stride=1, padding=0):
    """``F.conv1d``/``F.conv2d`` (by ``x.ndim``) with zero padding, in float32
    forward and backward. ``stride`` and ``padding``: an int, or one per
    spatial dim."""
    nd = x.ndim - 2
    per_dim = lambda v: [v] * nd if isinstance(v, int) else list(v)
    return _Conv.apply(x, weight, bias, per_dim(stride), per_dim(padding))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` (zero padding) computed by ``conv``."""

    def forward(self, x):
        return conv(x, self.weight, self.bias, self.stride, self.padding)
