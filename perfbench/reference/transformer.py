"""Plain float32 PyTorch encoder-decoder over stacked Gaussian tokens, as
the reference repository's ``train_stacked_transformer.py`` defines it, for
judging the port's stacked trainer.

  * pre-norm residual sublayers; LayerNorm (x - mean) / (unbiased std +
    1e-5) with a scale and a shift;
  * attention: h heads, scores / sqrt(d_k), masked scores set to -1e4,
    softmax, dropout on the weights;
  * feed-forward: Linear(d, 2d), silu of the first half times the second,
    dropout, Linear(d, d); the token embeddings are such feed-forwards;
  * the generator: one Linear regression head;
  * dropout: inverted, each mask ``rand(shape) >= rate`` drawn from a
    ``torch.Generator`` in call order (the encoder's generator, then one
    per decode step), so a run seeded alike draws the same masks;
  * the training loss: a greedy decode that runs the decoder over the
    whole buffer at every position, then the symmetric Chamfer distance of
    the unstacked Gaussians with PAD rows masked out;
  * Adam (b1 0.9, b2 0.999, eps 1e-4).

Parameters are plain tensors in a dict keyed by the names both sides use
(``encoder.layer0.self_attn.q.weight``, ...). Matrix products run with TF32
off unless ``tf32`` asks for it (the benchmark's control). Imports nothing
of the port.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

MASK_FILL = -1e4
TOKEN_DIM = 26
PAD_FLAG, START_FLAG = 24, 23


def special_token(flag: int, stack: int) -> torch.Tensor:
    """A fat START or PAD token: the flag set; START also has opacity and
    log-scales at -5."""
    t = torch.zeros(TOKEN_DIM)
    if flag == START_FLAG:
        t[16] = -5.0
        t[20:23] = -5.0
    t[flag] = 1.0
    return t.repeat(2 ** stack)


def is_token(x: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Rows within L1 distance 0.5 of ``token``."""
    return torch.sum(torch.abs(x - token.to(x)), -1) <= 0.5


def unstack(tokens: torch.Tensor, stack: int) -> torch.Tensor:
    """[L, 26 * 2^s] fat tokens -> [L * 2^s, 26] Gaussians (the inverse of
    folding by concat(x[0::2], x[1::2]) s times)."""
    for _ in range(stack):
        d = tokens.shape[-1] // 2
        tokens = torch.stack([tokens[:, :d], tokens[:, d:]], dim=1).reshape(-1, d)
    return tokens


def shapes(d: int, layers: int) -> Dict[str, tuple]:
    """Every parameter's name and shape (weights [out, in])."""
    out = {}

    def dense(name, n_in, n_out):
        out[f"{name}.weight"] = (n_out, n_in)
        out[f"{name}.bias"] = (n_out,)

    def ffn(name):
        dense(f"{name}.w_1", d, 2 * d)
        dense(f"{name}.w_2", d, d)

    def norm(name):
        out[f"{name}.a_2"] = (d,)
        out[f"{name}.b_2"] = (d,)

    for side, subs, attns in (("encoder", 2, ("self_attn",)), ("decoder", 3, ("self_attn", "src_attn"))):
        for i in range(layers):
            for a in attns:
                for p in ("q", "k", "v", "out"):
                    dense(f"{side}.layer{i}.{a}.{p}", d, d)
            ffn(f"{side}.layer{i}.feed_forward")
            for s in range(subs):
                norm(f"{side}.layer{i}.sub{s}.norm")
        norm(f"{side}.norm")
    ffn("src_embed")
    ffn("tgt_embed")
    dense("generator_proj", d, d)
    return out


def draw_weights(d: int, layers: int, seed: int, device):
    """Yield (name, initial value): Xavier-uniform matrices, zero biases,
    LayerNorm scales one and shifts zero, drawn in sorted name order from a
    generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, shape in sorted(shapes(d, layers).items()):
        if len(shape) == 2:
            a = math.sqrt(6.0 / (shape[0] + shape[1]))
            yield name, torch.empty(shape, device=device).uniform_(-a, a, generator=gen)
        elif name.endswith("a_2"):
            yield name, torch.ones(shape, device=device)
        else:
            yield name, torch.zeros(shape, device=device)


def init_weights(d: int, layers: int, seed: int, device) -> Dict[str, torch.Tensor]:
    return dict(draw_weights(d, layers, seed, device))


def dropout_generator(device, key) -> torch.Generator:
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


class Model:
    """The encoder-decoder as functions of a parameter dict ``P``."""

    def __init__(self, P: Dict[str, torch.Tensor], layers: int, heads: int = 8, rate: float = 0.1):
        self.P, self.layers, self.h, self.rate = P, layers, heads, rate

    def drop(self, x, rng):
        if rng is None:
            return x
        return x * (torch.rand(x.shape, generator=rng, device=x.device) >= self.rate).to(x.dtype) / (1 - self.rate)

    def dense(self, name, x):
        return F.linear(x, self.P[f"{name}.weight"], self.P[f"{name}.bias"])

    def norm(self, name, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).sum(-1, keepdim=True) / (x.shape[-1] - 1)
        return self.P[f"{name}.a_2"] * (x - mean) / (torch.sqrt(var) + 1e-5) + self.P[f"{name}.b_2"]

    def ffn(self, name, x, rng):
        a, b = self.dense(f"{name}.w_1", x).chunk(2, dim=-1)
        return self.dense(f"{name}.w_2", self.drop(F.silu(a) * b, rng))

    def heads(self, y):
        B, L, D = y.shape
        return y.reshape(B, L, self.h, D // self.h).transpose(1, 2)

    def attn(self, name, xq, xkv, mask, rng):
        q, k, v = (self.heads(self.dense(f"{name}.{p}", x)) for p, x in (("q", xq), ("k", xkv), ("v", xkv)))
        s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if mask is not None:
            s = torch.where(mask[:, None] if mask.ndim == 3 else mask, s, torch.full_like(s, MASK_FILL))
        o = self.drop(torch.softmax(s, dim=-1), rng) @ v
        B, h, L, dk = o.shape
        return self.dense(f"{name}.out", o.transpose(1, 2).reshape(B, L, h * dk))

    def sub(self, name, x, f, rng):
        return x + self.drop(f(self.norm(f"{name}.norm", x)), rng)

    def encode(self, src, src_mask, rng=None):
        x = self.ffn("src_embed", src, rng)
        for i in range(self.layers):
            n = f"encoder.layer{i}"
            x = self.sub(f"{n}.sub0", x, lambda y: self.attn(f"{n}.self_attn", y, y, src_mask, rng), rng)
            x = self.sub(f"{n}.sub1", x, lambda y: self.ffn(f"{n}.feed_forward", y, rng), rng)
        return self.norm("encoder.norm", x)

    def decode(self, memory, src_mask, tgt, tgt_mask, rng=None):
        x = self.ffn("tgt_embed", tgt, rng)
        for i in range(self.layers):
            n = f"decoder.layer{i}"
            x = self.sub(f"{n}.sub0", x, lambda y: self.attn(f"{n}.self_attn", y, y, tgt_mask, rng), rng)
            x = self.sub(f"{n}.sub1", x, lambda y: self.attn(f"{n}.src_attn", y, memory, src_mask, rng), rng)
            x = self.sub(f"{n}.sub2", x, lambda y: self.ffn(f"{n}.feed_forward", y, rng), rng)
        return self.norm("decoder.norm", x)

    def generator(self, x):
        return self.dense("generator_proj", x)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def greedy_decode(m: Model, src, src_mask, max_len: int, start: torch.Tensor, key=None):
    """The training decode: position i + 1 is the generator's output at row
    i of the decoder run over the whole buffer (the causal mask hides the
    unwritten rows, which hold an iota filler). Differentiable."""
    B, D, dev = src.shape[0], src.shape[-1], src.device

    def rng(i):
        return None if key is None else dropout_generator(dev, tuple(key) + (i,))

    memory = m.encode(src, src_mask, rng(0))
    filler = (torch.arange(D, dtype=src.dtype, device=dev) * 1e-3).expand(B, max_len, D)
    causal = torch.ones(1, max_len, max_len, dtype=torch.bool, device=dev).tril()
    ys = torch.cat([start.to(dev, src.dtype).expand(B, 1, D), filler[:, 1:]], dim=1)
    for i in range(max_len - 1):
        nxt = m.generator(m.decode(memory, src_mask, ys, causal, rng(i + 1))[:, i])
        ys = torch.cat([ys[:, : i + 1], nxt[:, None, :], filler[:, i + 2:]], dim=1)
    return ys


def chamfer(a, b, valid):
    """Symmetric Chamfer distance of [n, 26] point sets over the valid rows,
    each direction summed and divided by the valid count."""
    inf = torch.where(valid, 0.0, float("inf")).to(a.dtype)
    with torch.no_grad():
        d = torch.cdist(a.detach().double(), b.detach().double()) ** 2
        i1 = torch.argmin(d + inf.double()[None, :], dim=1)
        i2 = torch.argmin(d.T + inf.double()[None, :], dim=1)
    w = valid.to(a.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    return (torch.sum((a - b[i1]) ** 2, -1) * w).sum() / n + (torch.sum((b - a[i2]) ** 2, -1) * w).sum() / n


def train_loss(m: Model, src, trg_y, src_mask, stack: int, key):
    """The stacked trainer's loss with the image branch shut: Chamfer
    between the greedy decode and the target, PAD rows out."""
    pred = greedy_decode(m, src, src_mask, trg_y.shape[1] + 1, special_token(START_FLAG, stack), key)[:, 1:]
    valid = (~is_token(trg_y[0], special_token(PAD_FLAG, stack))).repeat_interleave(2 ** stack)
    return chamfer(unstack(pred[0], stack), unstack(trg_y[0], stack), valid)


class Adam:
    """Adam with torch's update rule, on a parameter dict."""

    def __init__(self, P, b1=0.9, b2=0.999, eps=1e-4):
        self.P, self.b1, self.b2, self.eps, self.t = P, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in P.items()}
        self.v = {k: torch.zeros_like(v) for k, v in P.items()}

    @torch.no_grad()
    def step(self, grads, lr: float):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.P.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (self.m[k] / c1) / (torch.sqrt(self.v[k]) / math.sqrt(c2) + self.eps))


def param_count(d: int, layers: int, prefix: Optional[str] = None) -> int:
    return sum(math.prod(s) for n, s in shapes(d, layers).items() if prefix is None or n.startswith(prefix))
