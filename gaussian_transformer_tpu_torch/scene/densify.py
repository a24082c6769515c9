"""Adaptive density control on the capacity-padded GaussianScene (port of
``gaussian_transformer_tpu/scene/densify.py``).

Densify and prune are slot edits at a static capacity, as in the reference:

  * prune  -> clear ``alive`` bits,
  * clone  -> copy a source slot's parameters into a free slot,
  * split  -> two Gaussians sampled from the source's ellipsoid into two free
              slots, and the source killed,
  * new and pruned slots get zero Adam state.

Free slots are taken in ascending order, clones first, then the split pairs;
what does not fit is dropped and counted (``n_dropped``), and the trainer
then compacts to a larger capacity. The parameters are edited in place; the
Adam state and the stats come back new.

The split's normal samples cannot be the reference's (``jax.random`` bits),
so ``densify_and_prune`` takes them as ``samples`` [2, C, 3] or draws them
from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gaussian_transformer_tpu_torch.train.optim import (
    PARAM_LEAVES,
    AdamState,
    zero_state_leaf,
    zero_state_slots,
)
from gaussian_transformer_tpu_torch.utils.general import inverse_sigmoid
from gaussian_transformer_tpu_torch.utils.graphics import build_rotation


@dataclasses.dataclass
class DensifyStats:
    """Running densification statistics per slot."""

    xyz_gradient_accum: torch.Tensor  # [C]
    denom: torch.Tensor  # [C]
    max_radii2d: torch.Tensor  # [C] float

    @staticmethod
    def init(capacity: int, device=None) -> "DensifyStats":
        z = lambda: torch.zeros(capacity, dtype=torch.float32, device=device)
        return DensifyStats(xyz_gradient_accum=z(), denom=z(), max_radii2d=z())


def ndc_grad_scale(width: int, height: int, device=None) -> torch.Tensor:
    """Pixel-space -> NDC-half-extent gradient scale [2]: the reference's
    CUDA backward reports dL/dmean2D in NDC units (pixel gradients times
    0.5 W, 0.5 H), and ``densify_grad_threshold`` = 0.0002 is calibrated to
    that; the screen-space offset differentiates in pixels."""
    return torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32, device=device)


def add_densification_stats(stats: DensifyStats, screenspace_grad: torch.Tensor,
                            visibility: torch.Tensor, radii: torch.Tensor,
                            image_size=None) -> DensifyStats:
    """Accumulate screen-space gradient norms (rescaled to NDC units when
    ``image_size`` = (width, height) is given) and track the max radius."""
    g = screenspace_grad[:, :2]
    if image_size is not None:
        g = g * ndc_grad_scale(image_size[0], image_size[1], g.device)[None, :]
    gnorm = torch.sqrt(torch.sum(g * g, dim=-1))
    vis = visibility.to(torch.float32)
    return DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum + gnorm * vis,
        denom=stats.denom + vis,
        max_radii2d=torch.where(
            visibility, torch.maximum(stats.max_radii2d, radii.to(torch.float32)), stats.max_radii2d
        ),
    )


class DensifyReport(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor  # points lost to capacity exhaustion


def _nonzero_fill(mask: torch.Tensor) -> torch.Tensor:
    """The indices of ``mask``'s set entries in ascending order, padded with
    C to length C (``jnp.nonzero(mask, size=C, fill_value=C)``), without a
    host read."""
    C = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    out = torch.full((C + 1,), C, dtype=torch.int64, device=mask.device)
    out.scatter_(0, torch.where(mask, pos, C), torch.arange(C, device=mask.device))
    return out[:C]


def _set_drop(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """``arr[idx] = vals`` in place, where idx == C drops the row (the
    reference's scatter with mode="drop"); the kept indices are distinct."""
    ext = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
    ext[idx] = vals.to(arr.dtype)
    arr.copy_(ext[:-1])


@torch.no_grad()
def densify_and_prune(scene, adam: AdamState, stats: DensifyStats,
                      samples: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None, *, max_grad: float,
                      min_opacity: float, extent: float, max_screen_size: float,
                      percent_dense: float):
    """One densify + prune pass. ``samples``: standard normals [2, C, 3] for
    the split children (drawn from ``generator`` when not given). Returns
    (scene, adam, fresh stats, report); the scene is edited in place."""
    C = scene.capacity
    dev = scene.xyz.device
    alive = scene.alive.clone()

    denom_safe = torch.clamp(stats.denom, min=1.0)
    grads = torch.where(stats.denom > 0, stats.xyz_gradient_accum / denom_safe, 0.0)
    scale_act = scene.get_scaling
    scale_max = torch.amax(scale_act, dim=-1)
    wants = alive & (grads >= max_grad)
    clone_mask = wants & (scale_max <= percent_dense * extent)
    split_mask = wants & (scale_max > percent_dense * extent)
    n_clone = clone_mask.sum()
    n_split = split_mask.sum()

    free_idx = _nonzero_fill(~alive)
    n_free = (~alive).sum()
    clone_src = _nonzero_fill(clone_mask)
    split_src = _nonzero_fill(split_mask)

    slot_pos = torch.arange(C, device=dev)
    # Clones take free slots [0, n_clone); split j takes n_clone + 2j and +1.
    clone_valid = slot_pos < torch.minimum(n_clone, n_free)
    clone_tgt = torch.where(clone_valid, free_idx, C)
    split_off = n_clone + 2 * slot_pos
    sa_valid = (slot_pos < n_split) & (split_off + 1 < torch.clamp(n_free, max=C))
    split_tgt_a = torch.where(sa_valid, free_idx[torch.clamp(split_off, max=C - 1)], C)
    split_tgt_b = torch.where(sa_valid, free_idx[torch.clamp(split_off + 1, max=C - 1)], C)

    clone_at = torch.clamp(clone_src, max=C - 1)
    split_at = torch.clamp(split_src, max=C - 1)
    src = {leaf: getattr(scene, leaf).detach().clone() for leaf in PARAM_LEAVES}

    # Split children: N(0, diag(s^2)) in the source's frame (read before any edit).
    stds = scale_act[split_at]  # [C, 3]
    rots = build_rotation(src["rotation"][split_at])  # [C, 3, 3]
    if samples is None:
        samples = torch.randn((2, C, 3), generator=generator, device=dev)
    samples = samples.to(device=dev, dtype=stds.dtype) * stds[None]
    new_xyz = torch.einsum("cij,ncj->nci", rots, samples) + src["xyz"][split_at][None]
    new_scaling = torch.log(torch.clamp(stds / (0.8 * 2.0), min=1e-30))

    for leaf in PARAM_LEAVES:
        arr = getattr(scene, leaf)
        _set_drop(arr, clone_tgt, src[leaf][clone_at])
        if leaf == "xyz":
            vals_a, vals_b = new_xyz[0], new_xyz[1]
        elif leaf == "scaling":
            vals_a = vals_b = new_scaling
        else:
            vals_a = vals_b = src[leaf][split_at]
        _set_drop(arr, split_tgt_a, vals_a)
        _set_drop(arr, split_tgt_b, vals_b)
    new_alive = alive.clone()
    for tgt in (clone_tgt, split_tgt_a, split_tgt_b):
        _set_drop(new_alive, tgt, torch.ones_like(tgt, dtype=torch.bool))
    # Kill split sources, but only those whose children got slots.
    killed = torch.where(sa_valid, split_src, C)
    _set_drop(new_alive, killed, torch.zeros_like(killed, dtype=torch.bool))
    scene.alive.copy_(new_alive)

    fresh = torch.zeros(C, dtype=torch.bool, device=dev)
    for tgt in (clone_tgt, split_tgt_a, split_tgt_b):
        _set_drop(fresh, tgt, torch.ones_like(tgt, dtype=torch.bool))
    adam = zero_state_slots(adam, fresh)

    # Prune: low opacity, oversized screen radius, or world scale > 0.1 extent.
    opac = scene.get_opacity[:, 0]
    prune = scene.alive & (opac < min_opacity)
    if max_screen_size:
        prune = prune | (scene.alive & (stats.max_radii2d > max_screen_size))
        prune = prune | (scene.alive & (torch.amax(scene.get_scaling, dim=-1) > 0.1 * extent))
    n_pruned = prune.sum()
    scene.alive.copy_(scene.alive & ~prune)
    adam = zero_state_slots(adam, prune)

    n_dropped = (n_clone - (clone_valid & (clone_src < C)).sum()) + 2 * (
        n_split - (sa_valid & (split_src < C)).sum()
    )
    report = DensifyReport(n_cloned=n_clone, n_split=n_split, n_pruned=n_pruned, n_dropped=n_dropped)
    return scene, adam, DensifyStats.init(C, dev), report


@torch.no_grad()
def reset_opacity(scene, adam: AdamState):
    """Clamp alive opacities to <= 0.01 and reset the opacity leaf's Adam
    state. Returns (scene, adam); the scene is edited in place."""
    new_op = inverse_sigmoid(torch.clamp(torch.sigmoid(scene.opacity), max=0.01))
    scene.opacity.copy_(torch.where(scene.alive[:, None], new_op, scene.opacity))
    return scene, zero_state_leaf(adam, "opacity")
