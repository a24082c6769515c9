"""Per-leaf Adam for the GaussianScene, with state surgery (port of
``gaussian_transformer_tpu/train/optim.py``).

The state is an explicit ``AdamState``: (mu, nu) tensors shaped like the
scene's learnable leaves plus a per-leaf step counter, keyed by leaf name,
rather than ``torch.optim.Adam``. Densify and prune then stay plain tensor
edits (zero the state of new or pruned slots), and a capacity change repacks
the state beside the scene (``compact_state``). Every slot is updated, dead
ones too: their gradients are zero, so their parameters do not move. Adam's
eps is the reference's 1e-15. The xyz learning rate follows the exponential
schedule ``expon_lr``; the other leaves have fixed rates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

# The learnable leaves of GaussianScene, in a fixed order.
PARAM_LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


@dataclasses.dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    counts: Dict[str, torch.Tensor]  # per-leaf step counters (float32 scalars)

    @staticmethod
    def init(scene) -> "AdamState":
        params = {k: getattr(scene, k).detach() for k in PARAM_LEAVES}
        return AdamState(
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
            counts={k: torch.zeros((), dtype=torch.float32, device=v.device) for k, v in params.items()},
        )


def leaf_learning_rates(opt, xyz_lr) -> Dict[str, object]:
    """Per-leaf learning rates (features_rest takes feature_lr / 20)."""
    return {
        "xyz": xyz_lr,
        "features_dc": opt.feature_lr,
        "features_rest": opt.feature_lr / 20.0,
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
        "opacity": opt.opacity_lr,
    }


@torch.no_grad()
def adam_step(scene, grads: Dict[str, torch.Tensor], state: AdamState, lrs, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-15):
    """One Adam update of the scene's learnable leaves, in place. Returns
    (scene, new state)."""
    mu_out, nu_out, counts_out = {}, {}, {}
    for k in PARAM_LEAVES:
        g = grads[k]
        t = state.counts[k] + 1.0
        mu = b1 * state.mu[k] + (1 - b1) * g
        nu = b2 * state.nu[k] + (1 - b2) * (g * g)
        mu_hat = mu / (1 - b1**t)
        nu_hat = nu / (1 - b2**t)
        param = getattr(scene, k)
        param.copy_(param - lrs[k] * mu_hat / (torch.sqrt(nu_hat) + eps))
        mu_out[k], nu_out[k], counts_out[k] = mu, nu, t
    return scene, AdamState(mu=mu_out, nu=nu_out, counts=counts_out)


def zero_state_slots(state: AdamState, slot_mask: torch.Tensor) -> AdamState:
    """Zero mu/nu at the given capacity slots on every leaf (how the reference
    treats newly appended points)."""

    def zero(arr):
        m = slot_mask.reshape((-1,) + (1,) * (arr.ndim - 1))
        return torch.where(m, torch.zeros_like(arr), arr)

    return AdamState(
        mu={k: zero(v) for k, v in state.mu.items()},
        nu={k: zero(v) for k, v in state.nu.items()},
        counts=state.counts,
    )


def zero_state_leaf(state: AdamState, leaf: str) -> AdamState:
    """Reset one leaf's mu/nu entirely (the reference's optimizer-tensor
    replacement on opacity reset); its step count stays."""
    mu, nu = dict(state.mu), dict(state.nu)
    mu[leaf] = torch.zeros_like(mu[leaf])
    nu[leaf] = torch.zeros_like(nu[leaf])
    return AdamState(mu=mu, nu=nu, counts=state.counts)


@torch.no_grad()
def compact_state(state: AdamState, alive: torch.Tensor, capacity: int) -> AdamState:
    """Repack the state as ``GaussianScene.compact`` repacks the scene: alive
    slots to the front, new and freed slots with zero state (momentum
    survives the capacity change)."""
    idx = torch.nonzero(alive).flatten()
    n = idx.numel()

    def pack(arr):
        out = arr.new_zeros((capacity,) + tuple(arr.shape[1:]))
        out[:n] = arr[idx]
        return out

    return AdamState(
        mu={k: pack(v) for k, v in state.mu.items()},
        nu={k: pack(v) for k, v in state.nu.items()},
        counts=state.counts,
    )


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1000000) -> torch.Tensor:
    """The Plenoxels exponential learning-rate schedule, as a float32 CPU
    scalar computed with the reference's float32 operations (a 0-dim CPU
    tensor scales CUDA tensors without a transfer)."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)
    step = f32(step)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(f32(lr_init)) * (1 - t) + torch.log(f32(lr_final)) * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1)
        )
    else:
        delay_rate = 1.0
    off = bool(step < 0) or (float(lr_init) == 0.0 and float(lr_final) == 0.0)
    return (0.0 if off else 1.0) * delay_rate * log_lerp
