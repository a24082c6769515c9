"""Exact attention for long Gaussian token sequences (port of
``gaussian_transformer_tpu/ops/attention.py``).

``blockwise_attention`` streams over key blocks with an online softmax, so
the score memory is O(Lq * block_k). Its semantics are the reference's:
masked scores are SET to ``MASK_FILL`` = -1e4 (not -inf), so a fully masked
row becomes a uniform distribution, exactly as the dense path's fill does.
Dropout on the attention weights applies to the numerator only, scaled by
1/(1-rate), while the denominator accumulates unmasked: algebraically
dropout(softmax(scores)) @ V. ``reference_attention`` is the dense O(L^2)
form. Both are plain ``torch.matmul``/``exp`` code.

In bf16, as in the JAX package, the blockwise path keeps its running max,
sum and accumulator in q's dtype and scales the scores by 1/sqrt(D)
computed in that dtype; the dense form takes its scores and softmax in
float32 and casts the probabilities to v's dtype (the model's dense path).

Backward recomputes each key block, as the JAX package's ``jax.checkpoint``
on its scan body does: a block is one ``_BlockStep`` whose forward keeps
only its inputs (q, the key/value/mask slices and the incoming (m, l, acc)
carries), so what autograd holds is O(Lq * (D + block_k)) per block and no
[Lq, Lk] score, probability or keep-mask tensor survives the forward. The
block's dropout masks are drawn from a copy of the caller's generator taken
just before the block, and the caller's generator is left where drawing in
place would have left it, so outputs, gradients and the masks are those of
the plain loop (``remat=False``).
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


def _block_step(q, k_blk, v_blk, mask_blk, carry, scale, dropout_rate, generator):
    """One key block: its scaled scores, its keep mask (drawn from
    ``generator`` when given) and the online-softmax update."""
    qkT = torch.matmul(q, k_blk.transpose(-1, -2)) * scale
    drop = None
    if generator is not None:
        drop = dropout_keep(qkT.shape, dropout_rate, generator, q.device)
    return _block_update(carry, qkT, v_blk, mask_blk, drop, dropout_rate)


def _generator_at(state: torch.Tensor, device) -> torch.Generator:
    """A new generator on ``device`` in the given state."""
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


class _BlockStep(torch.autograd.Function):
    """``_block_step`` whose backward recomputes the block from its saved
    inputs (mask_blk None is passed through). ``gen_state`` is the caller's
    generator state before the block (None: no dropout); the forward and the
    recomputation both draw from a generator in that state, and the forward
    moves the caller's ``generator`` to the state after the block's draw."""

    @staticmethod
    def forward(ctx, q, k_blk, v_blk, mask_blk, m, l, acc, scale, dropout_rate, generator, gen_state):
        local = None if gen_state is None else _generator_at(gen_state, q.device)
        out = _block_step(q, k_blk, v_blk, mask_blk, (m, l, acc), scale, dropout_rate, local)
        if local is not None:
            generator.set_state(local.get_state())
        ctx.has_mask = mask_blk is not None
        ctx.save_for_backward(q, k_blk, v_blk, *([mask_blk] if ctx.has_mask else []), m, l, acc)
        ctx.args = (scale, dropout_rate, gen_state)
        return out

    @staticmethod
    def backward(ctx, g_m, g_l, g_acc):
        saved = list(ctx.saved_tensors)
        mask_blk = saved.pop(3) if ctx.has_mask else None
        scale, dropout_rate, gen_state = ctx.args
        needs = [ctx.needs_input_grad[i] for i in (0, 1, 2, 4, 5, 6)]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        q, k_blk, v_blk, m, l, acc = inputs
        local = None if gen_state is None else _generator_at(gen_state, q.device)
        with torch.enable_grad():
            out = _block_step(q, k_blk, v_blk, mask_blk, (m, l, acc), scale, dropout_rate, local)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, (g_m, g_l, g_acc), allow_unused=True))
        q_g, k_g, v_g, m_g, l_g, acc_g = (next(grads) if t.requires_grad else None for t in inputs)
        return q_g, k_g, v_g, None, m_g, l_g, acc_g, None, None, None, None


def blockwise_attention(
    q: torch.Tensor,  # [..., Lq, D]
    k: torch.Tensor,  # [..., Lk, D]
    v: torch.Tensor,  # [..., Lk, D]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [..., Lq, Lk], True = attend
    block_k: int = 512,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    remat: bool = True,
) -> torch.Tensor:
    """Exact attention with O(Lq * block_k) score memory. Dropout is active
    when ``dropout_rate`` > 0 and a ``generator`` is given; each block's
    mask is drawn from it in block order. With ``remat`` (and autograd
    recording) each block is recomputed in backward instead of keeping its
    scores; the results are the same either way."""
    *lead, Lq, D = q.shape
    Lk = k.shape[-2]
    scale = float(1.0 / torch.tensor(float(D), dtype=q.dtype).sqrt())
    gen = generator if dropout_rate > 0.0 and generator is not None else None
    if mask is not None:
        mask = mask.expand(*torch.broadcast_shapes(mask.shape[:-2], tuple(lead)), Lq, Lk)
    remat = remat and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))

    m = torch.full((*lead, Lq, 1), -float("inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((*lead, Lq, 1), dtype=q.dtype, device=q.device)
    acc = torch.zeros((*lead, Lq, D), dtype=q.dtype, device=q.device)
    for start in range(0, Lk, block_k):
        stop = min(start + block_k, Lk)
        blk = (k[..., start:stop, :], v[..., start:stop, :], None if mask is None else mask[..., start:stop])
        if remat:
            state = None if gen is None else gen.get_state()
            m, l, acc = _BlockStep.apply(q, *blk, m, l, acc, scale, dropout_rate, gen, state)
        else:
            m, l, acc = _block_step(q, *blk, (m, l, acc), scale, dropout_rate, gen)
    return acc / torch.clamp(l, min=1e-30)


def reference_attention(q, k, v, mask=None):
    """The reference's O(L^2) attention, for tests and short sequences:
    scores and softmax in float32, the probabilities cast to v's dtype."""
    D = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(D)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, MASK_FILL))
    return torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)
