"""Ring attention: sequence parallelism over a process group (port of
``gaussian_transformer_tpu/parallel/ring.py``).

The sequence axis of q, k and v is sharded over the group; a rank holds its
token shard of each. At each of n steps every rank applies the online-softmax
update of ``ops/attention.py _block_update`` to its queries against the k/v
shard it holds, then passes k and v one hop around the ring
(``collectives.ring_shift``, receiving from rank + 1; k and v travel as one
message): after n steps every query has seen every key, with the blockwise
path's accumulation (exact, not an approximation). The forward holds the
scores of one shard pair at a time ([L/n, L/n] a head) and no more k/v
than the resident shard and the next.

Each step is one ``ops/attention.py _BlockStep``: its backward recomputes
the step's scores from its saved inputs (q, the resident k/v shard, the
mask slice and the incoming carries), as ``jax.checkpoint`` on the JAX
package's step body does. Like the JAX package's loop, which keeps each
step's carry for its backward, it keeps each step's resident shard, so the
backward reads every shard that passed through the rank; the rotation's
backward passes k's and v's gradients back around the ring to the rank
that owns them.

Masks: sliced at the resident shard's key columns; a mask with a size-1
query axis (the encoder's source PAD mask) is whole on every rank, any
other is this rank's query rows [.., Lq_local, Lk_global].

Dropout (``dropout_rate`` > 0 and a ``dropout_key``): the numerator is
masked by an independent Bernoulli draw for each (query shard, key shard)
pair, from a generator seeded from (key, rank, source shard). The bits are
not the JAX package's; the semantics (blockwise numerator masking, full
denominator) are.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import torch

from gaussian_transformer_tpu_torch.ops.attention import _block_step, _BlockStep
from gaussian_transformer_tpu_torch.parallel import collectives as cc


def _generator(device, key: Sequence[int]) -> torch.Generator:
    from gaussian_transformer_tpu_torch.train.stacked import dropout_generator

    return dropout_generator(device, key)


def ring_attention(
    q: torch.Tensor,  # [B, H, L_local, D]: this rank's token shard
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],  # [B, 1|H, 1|L_local, L] or None (True = attend)
    group=None,
    dropout_rate: float = 0.0,
    dropout_key: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Exact sequence-parallel attention of this rank's queries over the
    whole sharded sequence; returns this rank's rows [B, H, L_local, D]."""
    n, me = cc.size(group), cc.rank(group)
    Lk, D = k.shape[-2], q.shape[-1]
    if mask is not None and mask.shape[-1] != n * Lk:
        raise ValueError(f"mask key axis {mask.shape[-1]} != {n} shards x {Lk}")
    scale = float(1.0 / torch.tensor(float(D), dtype=q.dtype).sqrt())
    use_dropout = dropout_rate > 0.0 and dropout_key is not None
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    lead = q.shape[:-2]
    m = torch.full((*lead, q.shape[-2], 1), -float("inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((*lead, q.shape[-2], 1), dtype=q.dtype, device=q.device)
    acc = torch.zeros_like(q)
    kv = torch.stack([k, v])  # one message a hop: the backward's hops stay one chain
    for i in range(n):
        k_cur, v_cur = kv[0], kv[1]
        src = (me + i) % n  # whose shard is resident this step
        mask_blk = None if mask is None else mask[..., src * Lk:(src + 1) * Lk]
        gen = _generator(q.device, tuple(dropout_key) + (me, src)) if use_dropout else None
        rate = dropout_rate if use_dropout else 0.0
        if remat:
            state = None if gen is None else gen.get_state()
            m, l, acc = _BlockStep.apply(q, k_cur, v_cur, mask_blk, m, l, acc, scale, rate, gen, state)
        else:
            m, l, acc = _block_step(q, k_cur, v_cur, mask_blk, (m, l, acc), scale, rate, gen)
        if i < n - 1:
            kv = cc.ring_shift(kv, -1, group)
    return acc / torch.clamp(l, min=1e-30)


def generator_key(rng: torch.Generator) -> tuple:
    """A dropout key for ``ring_attention`` taken from a caller's generator
    (its state, read on the host without a device sync), which is then
    moved on by one draw so the next call's key differs."""
    digest = hashlib.sha256(rng.get_state().numpy().tobytes()).digest()
    key = (int.from_bytes(digest[:8], "little"), int.from_bytes(digest[8:16], "little"))
    torch.empty(1, device=rng.device).uniform_(generator=rng)
    return key
