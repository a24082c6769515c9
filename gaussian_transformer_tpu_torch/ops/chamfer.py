"""Blockwise Chamfer distance (port of ``gaussian_transformer_tpu/ops/chamfer.py``).

Given point sets a [B, N, D] and b [B, M, D], return (dist1 [B,N], dist2
[B,M], idx1, idx2) where dist1[i] = min_j |a_i - b_j|^2 and idx1 the argmin
(indices carry no gradient). The distance matrix is built in row blocks as
|a|^2 + |b|^2 - 2ab (matmuls), clamped at 0, with a running min, so memory
stays O(block * M); the argmin runs on detached inputs and the matched pairs
are gathered again, so gradients flow through them exactly.
"""

from __future__ import annotations

import torch


def _min_dist_one_way(a: torch.Tensor, b: torch.Tensor, block: int, b_valid=None):
    """a [N, D], b [M, D] -> (min squared dist [N], argmin [N]). Invalid b
    points (``b_valid`` False) are never match targets: their distances
    ride as +inf in the min."""
    b_sq = torch.sum(b * b, dim=-1)
    b_penalty = None
    if b_valid is not None:
        b_penalty = torch.where(b_valid, 0.0, float("inf")).to(a.dtype)
    mins, idxs = [], []
    for start in range(0, a.shape[0], block):
        rows = a[start:start + block]
        d2 = torch.sum(rows * rows, dim=-1)[:, None] + b_sq[None, :] - 2.0 * rows @ b.T
        d2 = torch.clamp(d2, min=0.0)
        if b_penalty is not None:
            d2 = d2 + b_penalty[None, :]
        mn, idx = torch.min(d2, dim=-1)
        mins.append(mn)
        idxs.append(idx)
    return torch.cat(mins), torch.cat(idxs)


def chamfer_distance(a, b, a_valid=None, b_valid=None, block: int = 512):
    """a [B, N, D], b [B, M, D] -> (dist1 [B,N], dist2 [B,M], idx1, idx2).

    Differentiable in a and b through the matched pairs. Optional
    ``a_valid`` [B, N] / ``b_valid`` [B, M] bool masks support padded point
    sets: invalid points are never match targets of the other set, and their
    own distances are zeroed (take means as sum(dist) / count(valid)). A
    direction with no valid target at all is zeroed as a whole."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if a_valid is None:
        a_valid = torch.ones(a.shape[:2], dtype=torch.bool, device=a.device)
    if b_valid is None:
        b_valid = torch.ones(b.shape[:2], dtype=torch.bool, device=b.device)

    outs = []
    for a1, b1, av, bv in zip(a, b, a_valid, b_valid):
        with torch.no_grad():
            _, idx1 = _min_dist_one_way(a1.detach(), b1.detach(), block, b_valid=bv)
            _, idx2 = _min_dist_one_way(b1.detach(), a1.detach(), block, b_valid=av)
        # A fully invalid target set makes every distance +inf, so the argmin
        # degenerates to 0 and the re-gather would give finite garbage.
        has_b = bv.any().to(a1.dtype)
        has_a = av.any().to(b1.dtype)
        d1 = torch.sum((a1 - b1[idx1]) ** 2, dim=-1) * av.to(a1.dtype) * has_b
        d2 = torch.sum((b1 - a1[idx2]) ** 2, dim=-1) * bv.to(b1.dtype) * has_a
        outs.append((d1, d2, idx1, idx2))
    return tuple(torch.stack(parts) for parts in zip(*outs))
