"""Exact attention for long Gaussian token sequences (port of
``gaussian_transformer_tpu/ops/attention.py``).

``blockwise_attention`` streams over key blocks with an online softmax, so
the score memory is O(Lq * block_k). Its semantics are the reference's:
masked scores are SET to ``MASK_FILL`` = -1e4 (not -inf), so a fully masked
row becomes a uniform distribution, exactly as the dense path's fill does.
Dropout on the attention weights applies to the numerator only, scaled by
1/(1-rate), while the denominator accumulates unmasked: algebraically
dropout(softmax(scores)) @ V. ``reference_attention`` is the dense O(L^2)
form. Both are plain ``torch.matmul``/``exp`` code; gradients come from
autograd.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

MASK_FILL = -1e4


def dropout_keep(shape, rate: float, generator: torch.Generator, device) -> torch.Tensor:
    """A Bernoulli(1 - rate) keep mask drawn from ``generator`` (so a
    recomputation seeded alike draws the same mask)."""
    return torch.rand(shape, generator=generator, device=device) >= rate


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with masks from ``generator``; identity when
    ``generator`` is None (evaluation) or the rate is 0."""
    if generator is None or rate <= 0.0:
        return x
    return x * dropout_keep(x.shape, rate, generator, x.device).to(x.dtype) / (1.0 - rate)


def _block_update(carry, qkT, v_blk, mask_blk, drop_keep=None, dropout_rate=0.0):
    """Online-softmax accumulation for one key block.

    carry: (m [.., Lq, 1] running max, l [.., Lq, 1] running denominator,
            acc [.., Lq, D] running numerator); qkT [.., Lq, Bk] scaled
    scores; drop_keep: optional bool [.., Lq, Bk] keep mask of the
    numerator."""
    m, l, acc = carry
    if mask_blk is not None:
        qkT = torch.where(mask_blk, qkT, torch.full_like(qkT, MASK_FILL))
    m_new = torch.maximum(m, qkT.amax(-1, keepdim=True))
    p = torch.exp(qkT - m_new)
    scale = torch.exp(m - m_new)
    l_new = l * scale + p.sum(-1, keepdim=True)
    p_num = p
    if drop_keep is not None:
        p_num = p * drop_keep.to(p.dtype) / (1.0 - dropout_rate)
    acc_new = acc * scale + torch.matmul(p_num, v_blk)
    return m_new, l_new, acc_new


def blockwise_attention(
    q: torch.Tensor,  # [..., Lq, D]
    k: torch.Tensor,  # [..., Lk, D]
    v: torch.Tensor,  # [..., Lk, D]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [..., Lq, Lk], True = attend
    block_k: int = 512,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Exact attention with O(Lq * block_k) score memory. Dropout is active
    when ``dropout_rate`` > 0 and a ``generator`` is given; each block's
    mask is drawn from it in block order."""
    *lead, Lq, D = q.shape
    Lk = k.shape[-2]
    scale = 1.0 / math.sqrt(D)
    use_dropout = dropout_rate > 0.0 and generator is not None
    if mask is not None:
        mask = mask.expand(*torch.broadcast_shapes(mask.shape[:-2], tuple(lead)), Lq, Lk)

    m = torch.full((*lead, Lq, 1), -float("inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((*lead, Lq, 1), dtype=q.dtype, device=q.device)
    acc = torch.zeros((*lead, Lq, D), dtype=q.dtype, device=q.device)
    for start in range(0, Lk, block_k):
        stop = min(start + block_k, Lk)
        qkT = torch.matmul(q, k[..., start:stop, :].transpose(-1, -2)) * scale
        mb = None if mask is None else mask[..., start:stop]
        drop = None
        if use_dropout:
            drop = dropout_keep((*lead, Lq, stop - start), dropout_rate, generator, q.device)
        m, l, acc = _block_update((m, l, acc), qkT, v[..., start:stop, :], mb, drop, dropout_rate)
    return acc / torch.clamp(l, min=1e-30)


def reference_attention(q, k, v, mask=None):
    """The reference's O(L^2) attention, for tests and short sequences."""
    D = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, MASK_FILL))
    return torch.matmul(torch.softmax(scores, dim=-1), v)
