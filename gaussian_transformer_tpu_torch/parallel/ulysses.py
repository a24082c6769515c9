"""Ulysses sequence parallelism: all-to-all head sharding (port of
``gaussian_transformer_tpu/parallel/ulysses.py``).

The alternative to the ring: two ``all_to_all`` collectives re-shard the
attention input from sequence-sharded [B, H, L/n, D] to head-sharded
[B, H/n, L, D], ordinary dense attention runs on the resident head group
(``ops/attention.py reference_attention``, with its -1e4 mask fill), and a
third all-to-all shards the output back. It needs H divisible by n and
moves the activations through the interconnect, where the ring never
holds the whole sequence; both are exact. q, k and v travel as one
message, so the backward's collectives are one chain on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from gaussian_transformer_tpu_torch.ops.attention import reference_attention
from gaussian_transformer_tpu_torch.parallel import collectives as cc


def ulysses_attention(
    q: torch.Tensor,  # [B, H, L_local, D]: this rank's token shard
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],  # [B, 1|H, 1|L, L] whole on every rank, True = attend
    group=None,
) -> torch.Tensor:
    """Exact attention with all-to-all head sharding over ``group``; returns
    this rank's rows [B, H, L_local, D]."""
    n = cc.size(group)
    if q.shape[1] % n:
        raise ValueError(f"{q.shape[1]} heads do not split over {n} ranks")
    # Split the heads, gather the sequence: q, k and v in one message.
    qh, kh, vh = cc.all_to_all(torch.stack([q, k, v]), 2, 3, group).unbind(0)
    if mask is not None and mask.shape[1] > 1:
        h_loc = qh.shape[1]
        mask = mask[:, cc.rank(group) * h_loc:(cc.rank(group) + 1) * h_loc]
    out = reference_attention(qh, kh, vh, mask)
    return cc.all_to_all(out, 2, 1, group)  # split the sequence, gather the heads
