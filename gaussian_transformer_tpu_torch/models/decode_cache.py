"""KV-cached autoregressive decoding for the EncoderDecoder (port of
``gaussian_transformer_tpu/models/decode_cache.py``): the serving path.

The trainer's greedy decode (``train.stacked.greedy_decode``) re-runs the
whole decoder over the prefix every step, O(L^3) attention work in all,
because it backpropagates through the decode. Inference takes the O(L^2)
path here: cross-attention K/V are computed once from the encoder memory,
and each layer's self-attention K/V cache grows by one token a step. It runs
under ``torch.no_grad()`` and is not differentiable, as in the JAX package.

The model's modules do the work, so a bf16 model decodes as its scan decode
does: the K/V caches are held in the compute dtype, the attention scores
and softmax in float32.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from gaussian_transformer_tpu_torch.models.transformer import EncoderDecoder, merge_heads, split_heads
from gaussian_transformer_tpu_torch.ops.attention import reference_attention


@torch.no_grad()
def init_decode_state(model: EncoderDecoder, src, src_mask, max_len: int) -> Dict:
    """Encode once; precompute the cross-attention K/V and empty self-attention
    caches of ``max_len`` positions ([B, h, max_len, d_k] each, in the
    model's compute dtype)."""
    memory = model.encode(src, src_mask)
    B, h = src.shape[0], model.h
    d_k = model.d_model // h
    layers: List[Dict] = []
    for layer in model.decoder.layers():
        layers.append({
            "cross_k": split_heads(layer.src_attn.k(memory), h),
            "cross_v": split_heads(layer.src_attn.v(memory), h),
            "self_k": memory.new_zeros(B, h, max_len, d_k, dtype=model.dtype),
            "self_v": memory.new_zeros(B, h, max_len, d_k, dtype=model.dtype),
        })
    cross_mask = None
    if src_mask is not None:
        cross_mask = src_mask[:, None] if src_mask.ndim == 3 else src_mask
    return {"memory": memory, "layers": layers, "cross_mask": cross_mask}


@torch.no_grad()
def decode_step(model: EncoderDecoder, state: Dict, token, pos: int):
    """One cached decoder step: ``token`` [B, 1, D] at position ``pos``.
    Writes its K/V into the caches and returns the next-token prediction
    [B, D_out]; attention reads the cache's first ``pos + 1`` positions."""
    h = model.h
    x = model.tgt_embed(token)  # [B, 1, D]
    for layer, cache in zip(model.decoder.layers(), state["layers"]):
        y = layer.sub0.norm(x)
        cache["self_k"][:, :, pos:pos + 1] = split_heads(layer.self_attn.k(y), h)
        cache["self_v"][:, :, pos:pos + 1] = split_heads(layer.self_attn.v(y), h)
        q = split_heads(layer.self_attn.q(y), h)
        attn = reference_attention(q, cache["self_k"][:, :, :pos + 1], cache["self_v"][:, :, :pos + 1])
        x = x + layer.self_attn.out(merge_heads(attn))

        y = layer.sub1.norm(x)
        q = split_heads(layer.src_attn.q(y), h)
        attn = reference_attention(q, cache["cross_k"], cache["cross_v"], state["cross_mask"])
        x = x + layer.src_attn.out(merge_heads(attn))

        x = x + layer.feed_forward(layer.sub2.norm(x))
    return model.generator(model.decoder.norm(x))[:, 0]


@torch.no_grad()
def greedy_decode_cached(model: EncoderDecoder, src, src_mask, max_len: int, start_token) -> torch.Tensor:
    """Cached greedy decode; the trainer's scan decode's outputs with O(L)
    attention per step. Returns ys [B, max_len, D]."""
    B, D = src.shape[0], start_token.shape[-1]
    state = init_decode_state(model, src, src_mask, max_len)
    ys = src.new_zeros(B, max_len, D)
    ys[:, 0] = start_token.to(ys.device)
    for i in range(max_len - 1):
        ys[:, i + 1] = decode_step(model, state, ys[:, i:i + 1], i)
    return ys
