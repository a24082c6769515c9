"""Gaussian-token autoencoder family (port of
``gaussian_transformer_tpu/models/autoencoder.py``).

``GAutoEncoder`` is the reference's active model, a single scalar weight
``w * x`` (w = 0.1); ``GEncoder`` (strided-Conv1d downsampler),
``gaussian_unshuffle_1d`` and ``GDecoder`` (its upsampler) form
``GConvAutoEncoder``. Sequences are channels-first [B, 26, L] at the module
boundary. Submodules carry the flax names (``encoder.stem0``,
``encoder.down{i}``, ``encoder.down{i}_conv{j}``, ``decoder.up{i}_conv{j}``,
``decoder.head``), so ``models/transformer.py params_from_jax`` carries a
flax tree across (a conv kernel [k, in, out] transposes to Conv1d's [out, in,
k]). flax infers each conv's input channels; here they follow from
``factor``. ``init_autoencoder`` draws flax's default initialiser (lecun
normal kernels, zero biases). The convolutions run in float32 forward and
backward (``ops/conv.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.models.codec import TOKEN_DIM
from gaussian_transformer_tpu_torch.models.transformer import jax_order, lecun_normal_
from gaussian_transformer_tpu_torch.ops.conv import Conv1d


class GAutoEncoder(nn.Module):
    """The reference's active model: a single scalar weight."""

    def __init__(self, factor: int = 1, device=None):
        super().__init__()
        self.factor = factor
        self.w = nn.Parameter(torch.full((1,), 0.1, device=resolve_device(device)))

    def forward(self, x):
        return self.w * x


def _conv(cin, cout, k, stride=1, pad=0, device=None):
    return Conv1d(cin, cout, k, stride=stride, padding=pad, device=device)


def encoder_channels(factor: int) -> int:
    """Channels of ``GEncoder``'s output: 32, doubled per level after the first."""
    return 32 if factor <= 1 else 2 ** (factor - 2) * 32


class GEncoder(nn.Module):
    """26 -> 32 channels through five k=1 convs, then per level a stride-2
    k=5 conv (pad 2) and three k=3 convs (pad 1), each followed by SiLU."""

    def __init__(self, factor: int = 1, device=None):
        super().__init__()
        device = resolve_device(device)
        self.factor = factor
        self.stem0 = _conv(TOKEN_DIM, 32, 1, device=device)
        self.stem1 = _conv(32, 32, 1, device=device)
        for i in range(3):
            self.add_module(f"stem2_{i}", _conv(32, 32, 1, device=device))
        c = 32
        for i in range(factor - 1):
            out_d = 2**i * 32
            self.add_module(f"down{i}", _conv(c, out_d, 5, stride=2, pad=2, device=device))
            for j in range(3):
                self.add_module(f"down{i}_conv{j}", _conv(out_d, out_d, 3, pad=1, device=device))
            c = out_d

    def forward(self, x):  # [B, 26, L]
        x = self.stem1(self.stem0(x))
        for i in range(3):
            x = getattr(self, f"stem2_{i}")(x)
        for i in range(self.factor - 1):
            x = F.silu(getattr(self, f"down{i}")(x))
            for j in range(3):
                x = F.silu(getattr(self, f"down{i}_conv{j}")(x))
        return x


def gaussian_unshuffle_1d(x):
    """[B, C, L] -> [B, C/2, 2L]."""
    b, c, l = x.shape
    return x.reshape(b, c // 2, l * 2)


class GDecoder(nn.Module):
    """Upsampler inverse of GEncoder: per level (factor - 1 down to 1) an
    unshuffle, SiLU and three k=3 convs to 2^i * 64 channels; then a k=1
    head to 26. ``in_channels`` defaults to GEncoder's output at ``factor``."""

    def __init__(self, factor: int = 1, in_channels: int = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.factor = factor
        c = encoder_channels(factor) if in_channels is None else in_channels
        for i in range(factor - 1, 0, -1):
            out_d = 2**i * 64
            c //= 2
            for j in range(3):
                self.add_module(f"up{i}_conv{j}", _conv(c if j == 0 else out_d, out_d, 3, pad=1, device=device))
            c = out_d
        self.head = _conv(c, TOKEN_DIM, 1, device=device)

    def forward(self, x):  # [B, C, L]
        for i in range(self.factor - 1, 0, -1):
            x = F.silu(gaussian_unshuffle_1d(x))
            for j in range(3):
                x = getattr(self, f"up{i}_conv{j}")(x)
        return self.head(x)


class GConvAutoEncoder(nn.Module):
    """The encoder-decoder pair."""

    def __init__(self, factor: int = 1, device=None):
        super().__init__()
        self.factor = factor
        self.encoder = GEncoder(factor, device=device)
        self.decoder = GDecoder(factor, device=device)

    def forward(self, x):
        return self.decoder(self.encoder(x))


@torch.no_grad()
def init_autoencoder(model: nn.Module, seed: int = 0) -> nn.Module:
    """flax's defaults from a ``torch.Generator`` seeded with ``seed``, drawn
    in ``jax_order``: lecun-normal conv kernels, zero biases; the stub's
    ``w`` keeps 0.1."""
    params = dict(model.named_parameters())
    gen = None
    for name in jax_order(model):
        p = params[name]
        if name.endswith("weight"):
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            lecun_normal_(p, gen)
        elif name.endswith("bias"):
            p.zero_()
    return model
