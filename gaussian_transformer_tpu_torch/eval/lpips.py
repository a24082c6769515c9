"""LPIPS perceptual metric (vgg / alex trunks), port of
``gaussian_transformer_tpu/eval/lpips.py``.

The reference pipeline: z-score the [0, 1] images with the richzhang scaling
constants (no 2x-1 remap, as the JAX package and metrics.py feed it), run a
conv trunk, unit-normalise each stage's features over channels, square their
difference, weigh it with the stage's 1x1 head, take the spatial mean and sum
the stages. Convolutions are ``ops/conv.py conv`` (``F.conv2d``'s, in float32
forward and backward) and pools ``F.max_pool2d`` (in the JAX package
``lax.conv_general_dilated`` and ``reduce_window``, not Pallas kernels); the
result is differentiable.

The weights come from an ``.npz`` in the layout ``tools/convert_lpips_weights.py``
writes (``conv{i}.w`` [out, in, kh, kw], ``conv{i}.b``, ``lin{i}.w`` [1, C, 1, 1]),
found in the JAX package's order, so one converted file serves both packages:
``$GT_LPIPS_WEIGHTS``, ``./weights/lpips_<net>.npz``,
``~/.cache/gaussian_transformer_tpu/lpips_<net>.npz``. ``available()`` says
whether one is present; callers report LPIPS as null without it.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gaussian_transformer_tpu_torch.ops.conv import conv

# richzhang scaling-layer constants, applied to the [0, 1] tensors directly.
_MEAN = np.asarray([-0.030, -0.088, -0.188], np.float32)
_STD = np.asarray([0.458, 0.448, 0.450], np.float32)

# Conv configs (torchvision .features layouts). VGG16: out channels per 3x3
# conv (stride 1, pad 1), "M" a 2x2 max pool; AlexNet: (out, kernel, stride,
# pad) per conv, "M" a 3x3 stride-2 max pool.
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
# Stage boundaries: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 (conv counts at stage ends).
VGG16_STAGES = [2, 4, 7, 10, 13]
ALEX_CFG = [
    (64, 11, 4, 2),
    "M",
    (192, 5, 1, 2),
    "M",
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
ALEX_STAGES = [1, 2, 3, 4, 5]


def weights_path(net: str = "vgg") -> Optional[str]:
    cands = [
        os.environ.get("GT_LPIPS_WEIGHTS"),
        os.path.join("weights", f"lpips_{net}.npz"),
        os.path.expanduser(f"~/.cache/gaussian_transformer_tpu/lpips_{net}.npz"),
    ]
    for c in cands:
        if c and os.path.exists(c):
            return c
    return None


def available(net: str = "vgg") -> bool:
    return weights_path(net) is not None


@functools.lru_cache(maxsize=4)
def _load(net: str, device: str = "cpu") -> Dict[str, torch.Tensor]:
    """The weights of ``net`` as float32 tensors on ``device`` (cached per
    net and device; ``_load.cache_clear()`` after changing the file)."""
    path = weights_path(net)
    if path is None:
        raise FileNotFoundError(
            f"LPIPS weights for '{net}' not found; run tools/convert_lpips_weights.py "
            "on a machine with torchvision + network access and set GT_LPIPS_WEIGHTS."
        )
    with np.load(path) as data:
        return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in data.items()}


def _vgg_features(params, x) -> List[torch.Tensor]:
    feats = []
    ci = 0
    for item in VGG16_CFG:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = F.relu(conv(x, params[f"conv{ci}.w"], params[f"conv{ci}.b"], 1, 1))
            ci += 1
            if ci in VGG16_STAGES:
                feats.append(x)
    return feats


def _alex_features(params, x) -> List[torch.Tensor]:
    feats = []
    ci = 0
    for item in ALEX_CFG:
        if item == "M":
            x = F.max_pool2d(x, 3, 2)
        else:
            _, _, s, p = item
            x = F.relu(conv(x, params[f"conv{ci}.w"], params[f"conv{ci}.b"], s, p))
            ci += 1
            feats.append(x)
    return feats


def _normalize_act(x, eps=1e-10):
    n = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (n + eps)


def lpips(x: torch.Tensor, y: torch.Tensor, net: str = "vgg") -> torch.Tensor:
    """LPIPS distance between images in [0, 1], CHW or NCHW, on their device.
    Returns a scalar (the mean over the batch)."""
    params = _load(net, str(x.device))
    if x.ndim == 3:
        x, y = x[None], y[None]
    mean = torch.from_numpy(_MEAN).to(x.device)[None, :, None, None]
    std = torch.from_numpy(_STD).to(x.device)[None, :, None, None]
    feats = _vgg_features if net == "vgg" else _alex_features
    fx = feats(params, (x - mean) / std)
    fy = feats(params, (y - mean) / std)

    total = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        d = (_normalize_act(a) - _normalize_act(b)) ** 2
        w = params[f"lin{i}.w"]  # [1, C, 1, 1]
        total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
    return torch.mean(total)
