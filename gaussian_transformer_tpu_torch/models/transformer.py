"""Encoder-decoder transformer over Gaussian token sequences (port of
``gaussian_transformer_tpu/models/transformer.py``).

  * pre-norm residual sublayers with the torch-style LayerNorm of the
    reference: (x - mean) / (unbiased std + eps), eps added to the std;
  * FFN: Linear(d, 2d) -> SwiGLU (silu of the first half times the second)
    -> dropout -> Linear(d, d);
  * multi-head attention with masked scores set to -1e4 and dropout on the
    attention weights; ``block_k > 0`` takes the blockwise online-softmax
    path (ops/attention.py);
  * src/tgt "embeddings" are FFN copies (inputs are already d_model-dim
    tokens); the generator is one Linear regression head; no positional
    encoding;
  * Xavier-uniform weights from a ``torch.Generator`` (``init_model``).

Submodules carry the flax names (``encoder.layer0.sub0.norm.a_2``,
``decoder.layer1.src_attn.q``, ``feed_forward.w_1``, ``generator_proj``), so
``params_from_jax`` and ``tensor_to_jax`` only transpose dense kernels and
rename ``kernel`` <-> ``weight``, and ``jax_order`` lists the parameters in
``jax.tree_util`` flatten order (sorted keys) without importing flax.

Dropout is active exactly when a ``torch.Generator`` is passed as ``rng``;
every mask is drawn from it, in call order, so a computation run twice
with generators seeded alike draws the same masks (what a checkpointed
decode step's recomputation needs).

``dtype`` and ``param_dtype`` (float32 or bfloat16 each; anything else
raises) follow the flax modules tensor by tensor, with explicit casts (no
autocast, whose per-op lists are not flax's per-module dtypes):
  * every ``Dense`` holds its weight and bias in ``param_dtype`` and casts
    its input and both to ``dtype`` for the product;
  * ``TorchLayerNorm``'s a_2/b_2 stay float32, so the norm of a bf16
    residual is float32, as is the generator head;
  * the embeddings' output makes the residual stream ``dtype``;
  * the dense path's scores and softmax are float32 (flax's
    ``preferred_element_type``), the probabilities cast to v's dtype.

Sequence parallelism (the JAX package's ``ring_axis``/``mesh``):
``seq_group``, a ``torch.distributed`` process group, makes every attention
``parallel/ring.py ring_attention`` over the group. The model then runs on
this rank's token shards: LayerNorm, the FFN, the embeddings and the head
are per token and stay local; masks keep the whole key axis (a query-
broadcast mask whole, any other this rank's query rows).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.ops.attention import MASK_FILL, blockwise_attention, dropout


DTYPES = (torch.float32, torch.bfloat16)


def check_dtypes(dtype, param_dtype) -> None:
    for what, dt in (("dtype", dtype), ("param_dtype", param_dtype)):
        if dt not in DTYPES:
            raise NotImplementedError(f"{what}={dt}: the ported dtypes are float32 and bfloat16")


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Causal mask [1, size, size]; True = may attend."""
    return torch.ones(1, size, size, dtype=torch.bool, device=device).tril()


class TorchLayerNorm(nn.Module):
    """(x - mean) / (std + eps) with the UNBIASED std, learnable scale/shift."""

    def __init__(self, d: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.a_2 = nn.Parameter(torch.ones(d, device=device))
        self.b_2 = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        d = x.shape[-1]
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).sum(-1, keepdim=True) / max(d - 1, 1)
        return self.a_2 * (x - mean) / (torch.sqrt(var) + self.eps) + self.b_2


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype, param_dtype)``: weight and bias held in
    ``param_dtype``; the input, weight and bias cast to ``dtype`` for the
    product (no-ops where the dtypes already agree)."""

    def __init__(self, in_features: int, out_features: int, device=None, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__(in_features, out_features, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class FeedForward(nn.Module):
    """Position-wise FFN with SwiGLU: w_1 [d_model -> d_ff], silu(a) * b on
    its halves, dropout, w_2 [d_ff / 2 -> d_model]."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.1, device=None, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        self.w_1 = Dense(d_model, d_ff, device, dtype, param_dtype)
        self.w_2 = Dense(d_ff // 2, d_model, device, dtype, param_dtype)

    def forward(self, x, rng: Optional[torch.Generator] = None):
        a, b = self.w_1(x).chunk(2, dim=-1)
        return self.w_2(dropout(F.silu(a) * b, self.dropout, rng))


def split_heads(y: torch.Tensor, h: int) -> torch.Tensor:
    B, L, D = y.shape
    return y.reshape(B, L, h, D // h).transpose(1, 2)  # [B, h, L, d_k]


def merge_heads(y: torch.Tensor) -> torch.Tensor:
    B, h, L, d_k = y.shape
    return y.transpose(1, 2).reshape(B, L, h * d_k)


class MultiHeadedAttention(nn.Module):
    """h-head scaled dot-product attention; ``block_k > 0`` runs the
    O(L)-memory blockwise path (same outputs, same dropout semantics);
    ``seq_group`` the ring over the group's token shards."""

    def __init__(self, h: int, d_model: int, dropout: float = 0.1, block_k: int = 0, device=None,
                 dtype=torch.float32, param_dtype=torch.float32, seq_group=None):
        super().__init__()
        if d_model % h:
            raise ValueError(f"d_model {d_model} is not a multiple of h {h}")
        self.h, self.dropout, self.block_k, self.seq_group = h, dropout, block_k, seq_group
        for name in ("q", "k", "v", "out"):
            self.add_module(name, Dense(d_model, d_model, device, dtype, param_dtype))

    def forward(self, query, key, value, mask=None, rng: Optional[torch.Generator] = None):
        q = split_heads(self.q(query), self.h)
        k = split_heads(self.k(key), self.h)
        v = split_heads(self.v(value), self.h)
        if mask is not None and mask.ndim == 3:
            mask = mask[:, None]  # broadcast over heads
        if self.seq_group is not None:
            from gaussian_transformer_tpu_torch.parallel.ring import generator_key, ring_attention

            train = rng is not None and self.dropout > 0.0
            x = ring_attention(q, k, v, mask, self.seq_group, self.dropout if train else 0.0,
                               generator_key(rng) if train else None)
        elif self.block_k > 0:
            x = blockwise_attention(q, k, v, mask=mask, block_k=self.block_k,
                                    dropout_rate=self.dropout if rng is not None else 0.0,
                                    generator=rng)
        else:
            # Scores and softmax in float32 whatever the dtype.
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
            if mask is not None:
                scores = torch.where(mask, scores, torch.full_like(scores, MASK_FILL))
            p_attn = dropout(torch.softmax(scores, dim=-1), self.dropout, rng)
            x = torch.matmul(p_attn.to(v.dtype), v)
        return self.out(merge_heads(x))


class SublayerConnection(nn.Module):
    """Pre-norm residual: x + dropout(sublayer(norm(x)))."""

    def __init__(self, d_model: int, dropout: float = 0.1, device=None):
        super().__init__()
        self.dropout = dropout
        self.norm = TorchLayerNorm(d_model, device=device)

    def forward(self, x, sublayer, rng: Optional[torch.Generator] = None):
        return x + dropout(sublayer(self.norm(x)), self.dropout, rng)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, h: int, dropout: float = 0.1, block_k: int = 0, device=None,
                 dtype=torch.float32, param_dtype=torch.float32, seq_group=None):
        super().__init__()
        self.self_attn = MultiHeadedAttention(h, d_model, dropout, block_k, device, dtype, param_dtype, seq_group)
        self.feed_forward = FeedForward(d_model, 2 * d_model, dropout, device, dtype, param_dtype)
        self.sub0 = SublayerConnection(d_model, dropout, device)
        self.sub1 = SublayerConnection(d_model, dropout, device)

    def forward(self, x, mask, rng=None):
        x = self.sub0(x, lambda y: self.self_attn(y, y, y, mask, rng), rng)
        return self.sub1(x, lambda y: self.feed_forward(y, rng), rng)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, h: int, dropout: float = 0.1, block_k: int = 0, device=None,
                 dtype=torch.float32, param_dtype=torch.float32, seq_group=None):
        super().__init__()
        self.self_attn = MultiHeadedAttention(h, d_model, dropout, block_k, device, dtype, param_dtype, seq_group)
        self.src_attn = MultiHeadedAttention(h, d_model, dropout, block_k, device, dtype, param_dtype, seq_group)
        self.feed_forward = FeedForward(d_model, 2 * d_model, dropout, device, dtype, param_dtype)
        self.sub0 = SublayerConnection(d_model, dropout, device)
        self.sub1 = SublayerConnection(d_model, dropout, device)
        self.sub2 = SublayerConnection(d_model, dropout, device)

    def forward(self, x, memory, src_mask, tgt_mask, rng=None):
        x = self.sub0(x, lambda y: self.self_attn(y, y, y, tgt_mask, rng), rng)
        x = self.sub1(x, lambda y: self.src_attn(y, memory, memory, src_mask, rng), rng)
        return self.sub2(x, lambda y: self.feed_forward(y, rng), rng)


class _Stack(nn.Module):
    """N layers named layer0..layer{N-1}, then a final norm."""

    def __init__(self, layer_cls, d_model, h, N, dropout, block_k, device, dtype, param_dtype, seq_group=None):
        super().__init__()
        self.N = N
        for i in range(N):
            self.add_module(f"layer{i}", layer_cls(d_model, h, dropout, block_k, device, dtype, param_dtype,
                                                   seq_group))
        self.norm = TorchLayerNorm(d_model, device=device)

    def layers(self) -> List[nn.Module]:
        return [getattr(self, f"layer{i}") for i in range(self.N)]


class Encoder(_Stack):
    def __init__(self, d_model, h, N, dropout=0.1, block_k=0, device=None, dtype=torch.float32,
                 param_dtype=torch.float32, seq_group=None):
        super().__init__(EncoderLayer, d_model, h, N, dropout, block_k, device, dtype, param_dtype, seq_group)

    def forward(self, x, mask, rng=None):
        for layer in self.layers():
            x = layer(x, mask, rng)
        return self.norm(x)


class Decoder(_Stack):
    def __init__(self, d_model, h, N, dropout=0.1, block_k=0, device=None, dtype=torch.float32,
                 param_dtype=torch.float32, seq_group=None):
        super().__init__(DecoderLayer, d_model, h, N, dropout, block_k, device, dtype, param_dtype, seq_group)

    def forward(self, x, memory, src_mask, tgt_mask, rng=None):
        for layer in self.layers():
            x = layer(x, memory, src_mask, tgt_mask, rng)
        return self.norm(x)


class EncoderDecoder(nn.Module):
    """The full model. ``src_embed``/``tgt_embed`` are FeedForward copies;
    ``generator`` is the linear regression head."""

    def __init__(self, src_g_len: int, tgt_g_len: int, N: int = 2, d_model: int = 32, h: int = 8,
                 dropout: float = 0.1, block_k: int = 0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None, seq_group=None):
        super().__init__()
        check_dtypes(dtype, param_dtype)
        device = resolve_device(device)
        self.src_g_len, self.tgt_g_len = src_g_len, tgt_g_len
        self.N, self.d_model, self.h, self.block_k = N, d_model, h, block_k
        self.dtype, self.param_dtype = dtype, param_dtype
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.encoder = Encoder(d_model, h, N, dropout, block_k, seq_group=seq_group, **kw)
        self.decoder = Decoder(d_model, h, N, dropout, block_k, seq_group=seq_group, **kw)
        self.src_embed = FeedForward(d_model, 2 * d_model, dropout, **kw)
        self.tgt_embed = FeedForward(d_model, 2 * d_model, dropout, **kw)
        # The regression head stays float32.
        self.generator_proj = nn.Linear(d_model, tgt_g_len, device=device)

    def encode(self, src, src_mask, rng=None):
        return self.encoder(self.src_embed(src, rng), src_mask, rng)

    def decode(self, memory, src_mask, tgt, tgt_mask, rng=None):
        return self.decoder(self.tgt_embed(tgt, rng), memory, src_mask, tgt_mask, rng)

    def generator(self, x):
        return self.generator_proj(x)

    def forward(self, src, tgt, src_mask, tgt_mask, rng=None):
        return self.decode(self.encode(src, src_mask, rng), src_mask, tgt, tgt_mask, rng)


def make_model(stacking: int, src_g_len: int = 64, tgt_g_len: int = 64, N: int = 2,
               d_model: int = 32, h: int = 8, dropout: float = 0.1, block_k: int = 0,
               dtype=torch.float32, param_dtype=torch.float32, device=None, seq_group=None) -> EncoderDecoder:
    """Construct the model (``stacking`` is part of the reference signature
    and unused, as there). Its weights are torch's defaults until
    ``init_model``. ``seq_group``: ring attention over the group's token
    shards (the JAX package's ``ring_axis``/``mesh``)."""
    del stacking
    return EncoderDecoder(src_g_len, tgt_g_len, N=N, d_model=d_model, h=h, dropout=dropout,
                          block_k=block_k, dtype=dtype, param_dtype=param_dtype, device=device,
                          seq_group=seq_group)


def _jax_path(name: str) -> tuple:
    *scope, leaf = name.split(".")
    return (*scope, "kernel" if leaf == "weight" else leaf)


def jax_order(model: nn.Module) -> List[str]:
    """Parameter names in ``jax.tree_util`` flatten order of the flax params
    (dict keys sorted at every level)."""
    return sorted((n for n, _ in model.named_parameters()), key=_jax_path)


@torch.no_grad()
def init_model(model: EncoderDecoder, seed: int = 0) -> EncoderDecoder:
    """Xavier-uniform weight matrices, zero biases, LayerNorm ones/zeros,
    drawn in ``jax_order`` from a ``torch.Generator`` on the model's device
    seeded with ``seed`` (in float32, then rounded to a bf16 weight)."""
    params = dict(model.named_parameters())
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    for name in jax_order(model):
        p = params[name]
        if p.ndim == 2:
            fan_out, fan_in = p.shape
            a = math.sqrt(6.0 / (fan_in + fan_out))
            if p.dtype == torch.float32:
                p.uniform_(-a, a, generator=gen)
            else:
                p.copy_(torch.empty(p.shape, device=p.device).uniform_(-a, a, generator=gen))
        elif name.endswith("a_2"):
            p.fill_(1.0)
        else:
            p.zero_()
    return model


# flax's lecun_normal: a normal truncated to +-2 standard deviations, scaled
# so that the truncated draw has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(p: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel initialiser on a torch weight ([out, in, ...]:
    fan_in is everything but the first axis)."""
    std = math.sqrt(1.0 / p[0].numel()) / _TRUNC_STD
    torch.nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return p.mul_(std)


def _flatten_tree(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten_tree(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def is_bf16(arr: np.ndarray) -> bool:
    """Whether a numpy leaf is ml_dtypes' bfloat16 (the JAX package's bf16
    leaves as ``np.asarray`` gives them)."""
    return arr.dtype.name == "bfloat16"


def numpy_to_tensor(arr, dtype=torch.float32) -> torch.Tensor:
    """A numpy leaf as a tensor of ``dtype``. A bfloat16 tensor comes from a
    bf16 leaf or from its uint16 bit pattern, the JAX package's npz view
    (numpy has no bfloat16), bit for bit; anything else goes through
    float32."""
    arr = np.asarray(arr)
    if dtype == torch.bfloat16:
        if not (is_bf16(arr) or arr.dtype == np.uint16):
            raise TypeError(f"a bfloat16 tensor needs a bf16 or uint16 leaf, got {arr.dtype}")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; a bfloat16 one as its uint16 bit pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A state_dict from the JAX package's flax params (nested dicts of numpy
    arrays, with or without the outer ``{"params": ...}``): dense kernels
    [in, out] become ``Linear.weight`` [out, in]; bf16 leaves stay bf16,
    bit for bit, and every other leaf becomes float32."""
    tree = tree.get("params", tree)
    out = {}
    for path, value in _flatten_tree(tree):
        arr = np.asarray(value)
        t = numpy_to_tensor(arr, torch.bfloat16 if is_bf16(arr) else torch.float32)
        *scope, leaf = path
        if leaf == "kernel":
            out[".".join(scope + ["weight"])] = t.T.contiguous()
        else:
            out[".".join(path)] = t
    return out


def tensor_to_jax(name: str, t: torch.Tensor) -> np.ndarray:
    """One parameter (or a moment of it) in the flax layout; a bf16 one as
    its uint16 bit pattern (``numpy_to_tensor`` reads it back)."""
    arr = tensor_to_numpy(t)
    return np.ascontiguousarray(arr.T) if name.endswith("weight") else arr


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
