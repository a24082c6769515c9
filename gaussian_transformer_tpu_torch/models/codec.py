"""Gaussian <-> token codec (26-dim layout) and special tokens (port of
``gaussian_transformer_tpu/models/codec.py``).

Token layout for sh_degree=1 (26 dims):

  [0:12)  SH features, [N, 4, 3] row-major ((1 DC + 3 rest) x 3 channels)
  [12:16) rotation (raw, unnormalized quaternion)
  [16:17) opacity (logit)
  [17:20) xyz
  [20:23) scaling (log)
  [23:26) flags: one-hot START(23) / PAD(24) / END(25)

START additionally sets opacity = -5 and scaling = -5 so it renders
invisible if decoded. The special tokens are float32 CPU tensors; callers
move them with ``.to(device)``.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_transformer_tpu_torch.scene.gaussians import TensorScene

TOKEN_DIM = 26
FLAG_START, FLAG_PAD, FLAG_END = 23, 24, 25


def _special(opacity_scale_neg5: bool, flag: int) -> torch.Tensor:
    t = np.zeros(TOKEN_DIM, np.float32)
    if opacity_scale_neg5:
        t[16:17] = -5.0
        t[20:23] = -5.0
    t[flag] = 1.0
    return torch.from_numpy(t)


START_GAUSSIAN = _special(True, FLAG_START)
PAD_GAUSSIAN = _special(False, FLAG_PAD)
END_GAUSSIAN = _special(False, FLAG_END)


def fuzzy_token_equal(gaussians: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """L1 distance <= 0.5; detects PAD/START/END rows when building masks."""
    return torch.sum(torch.abs(gaussians - token.to(gaussians.device)), -1) <= 0.5


def flatten_gaussians(scene) -> torch.Tensor:
    """[C, 26] tokens from the RAW (pre-activation) parameters, sh_degree=1."""
    feats = scene.get_features  # [C, 4, 3] raw dc+rest
    features = feats.reshape(feats.shape[0], -1)
    flags = torch.zeros(features.shape[0], 3, dtype=features.dtype, device=features.device)
    return torch.cat([features, scene.rotation, scene.opacity, scene.xyz, scene.scaling, flags], dim=1)


def unflatten_gaussians(tokens: torch.Tensor) -> TensorScene:
    """Tokens -> TensorScene with active_sh_degree=1, all slots alive; its
    fields are views of ``tokens`` (gradients flow back to them)."""
    n = tokens.shape[0]
    features = tokens[:, :12].reshape(n, 4, 3)
    return TensorScene(
        xyz=tokens[:, 17:20],
        features_dc=features[:, 0:1, :],
        features_rest=features[:, 1:, :],
        scaling=tokens[:, 20:23],
        rotation=tokens[:, 12:16],
        opacity=tokens[:, 16:17],
        alive=torch.ones(n, dtype=torch.bool, device=tokens.device),
        active_sh_degree=1,
        max_sh_degree=1,
    )


def stack_tokens(tokens: torch.Tensor, times: int) -> torch.Tensor:
    """Fold the sequence ``times`` times: [L, D] -> [L / 2^times, D * 2^times]
    via repeated concat(x[0::2], x[1::2]) on the feature axis. Length must be
    divisible by 2^times."""
    for _ in range(times):
        tokens = torch.cat([tokens[0::2], tokens[1::2]], dim=-1)
    return tokens


def unstack_tokens(tokens: torch.Tensor, times: int) -> torch.Tensor:
    """Inverse fold."""
    for _ in range(times):
        d = tokens.shape[-1] // 2
        tokens = torch.stack([tokens[:, :d], tokens[:, d:]], dim=1).reshape(-1, d)
    return tokens
