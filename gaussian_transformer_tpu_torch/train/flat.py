"""Flat (unstacked) masked-Gaussian-modeling trainer (port of
``gaussian_transformer_tpu/train/flat.py``).

Per camera, the VISIBLE Gaussians split into kept (src) and dropped (tgt)
rows by a Bernoulli mask at the epoch-scheduled rate ``1.05 - exp(-0.0005 *
epoch)``; the model is teacher-forced on them, and the loss renders the
prompt plus the prediction and the prompt plus the truth: 0.5 x the L1 of
the first over the L1 of the second (against the camera's image), plus 0.1
x the token L2, plus 0.4 x LPIPS(alex) when its weights are present.
Adamax(b1 0.9, b2 0.98, eps 1e-4) at the Noam rate (factor 0.5, warmup
2000); cameras are kept when 5,000 < visible and visible + 1 < max_len.

``EmbeddedEncoderDecoder`` wraps ``models/transformer.py``'s encoder-decoder
(``core``, Xavier-initialised) between two 26 -> d_model Dense layers and a
d_model -> 26 head (flax's default lecun-normal kernels, zero biases), with
the flax submodule names, so ``params_from_jax`` carries a flax tree across
and ``best_model.npz`` (``arr_i`` in ``jax.tree_util`` flatten order) loads
in either package. Batches pad to ``bucket`` multiples with PAD tokens
(``bucket + 1`` for the decoder sequence) and draw their masks from
``np.random.RandomState(seed)`` as the JAX package does, so both build the
same batches. Dropout comes from per-step generators
(``train/stacked.py dropout_generator``).

Sequence parallelism (``--seq_shard``): ``EmbeddedEncoderDecoder(seq_group=
...)`` runs ring attention over the group (``parallel/ring.py``) on this
rank's token shards. ``make_flat_loss`` still takes the whole batch: it
hands the model this rank's rows (the source PAD mask whole, the target
mask's query rows), all-gathers the generated tokens before its two renders,
and every rank then computes the same loss (``collectives.replicated_output``
makes it count once). The weight gradients are summed over the group
(``reduce_grads``) before Adamax. Sequence lengths must divide by the group
size, which the bucket padding keeps.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.eval import lpips as lpips_mod
from gaussian_transformer_tpu_torch.models.codec import (
    END_GAUSSIAN,
    PAD_GAUSSIAN,
    START_GAUSSIAN,
    TOKEN_DIM,
    flatten_gaussians,
    fuzzy_token_equal,
    unflatten_gaussians,
)
from gaussian_transformer_tpu_torch.models.transformer import (
    init_model,
    jax_order,
    lecun_normal_,
    make_model,
    subsequent_mask,
    tensor_to_jax,
)
from gaussian_transformer_tpu_torch.ops.losses import l1_loss, l2_loss
from gaussian_transformer_tpu_torch.parallel import collectives as cc
from gaussian_transformer_tpu_torch.render import RenderConfig, render
from gaussian_transformer_tpu_torch.train.stacked import dropout_generator


class EmbeddedEncoderDecoder(nn.Module):
    """26-dim tokens <-> d_model around the encoder-decoder ``core``.
    ``block_k > 0``: blockwise attention for long visible-set sequences."""

    def __init__(self, N: int = 6, d_model: int = 1024, h: int = 8, dropout: float = 0.1, block_k: int = 0,
                 device=None, seq_group=None):
        super().__init__()
        device = resolve_device(device)
        self.seq_group = seq_group
        self.embed_in_src = nn.Linear(TOKEN_DIM, d_model, device=device)
        self.embed_in_tgt = nn.Linear(TOKEN_DIM, d_model, device=device)
        self.core = make_model(0, d_model, d_model, N, d_model, h, dropout, block_k, device=device,
                               seq_group=seq_group)
        self.out_proj = nn.Linear(d_model, TOKEN_DIM, device=device)

    def encode(self, src, src_mask, rng=None):
        return self.core.encode(self.embed_in_src(src), src_mask, rng)

    def decode(self, memory, src_mask, tgt, tgt_mask, rng=None):
        return self.core.decode(memory, src_mask, self.embed_in_tgt(tgt), tgt_mask, rng)

    def generator(self, x):
        return self.out_proj(self.core.generator(x))

    def forward(self, src, tgt, src_mask, tgt_mask, rng: Optional[torch.Generator] = None):
        return self.decode(self.encode(src, src_mask, rng), src_mask, tgt, tgt_mask, rng)


@torch.no_grad()
def init_flat_model(model: EmbeddedEncoderDecoder, seed: int = 0) -> EmbeddedEncoderDecoder:
    """The core as ``init_model`` draws it (Xavier uniform from ``seed``);
    the wrapper's three Dense layers lecun normal (from ``seed + 1``) with
    zero biases, as flax's ``nn.Dense`` defaults."""
    init_model(model.core, seed)
    gen = torch.Generator(device=model.out_proj.weight.device).manual_seed(seed + 1)
    for layer in (model.embed_in_src, model.embed_in_tgt, model.out_proj):
        lecun_normal_(layer.weight, gen)
        layer.bias.zero_()
    return model


def noam_rate(step, model_size: int, factor: float = 0.5, warmup: int = 2000):
    """NoamOpt schedule."""
    step = max(step, 1)
    return factor * (model_size ** (-0.5) * min(step ** (-0.5), step * warmup ** (-1.5)))


def make_noam_adamax(params, model_size: int, factor: float = 0.5, warmup: int = 2000, foreach=None):
    """Adamax(b1 0.9, b2 0.98, eps 1e-4) and a ``LambdaLR`` at the Noam rate
    (call ``scheduler.step()`` after each ``optimizer.step()``). The k-th
    update runs at ``noam_rate(k - 1)``, which is ``noam_rate(1)`` for the
    first two: optax evaluates its schedule at the update count before the
    update, and ``LambdaLR``'s epoch counts the updates made so far."""
    optimizer = torch.optim.Adamax(params, lr=1.0, betas=(0.9, 0.98), eps=1e-4, foreach=foreach)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: noam_rate(count, model_size, factor, warmup))
    return optimizer, scheduler


def dropout_schedule_flat(epoch: int) -> float:
    return 1.05 - math.exp(-0.0005 * epoch)


def make_std_mask(tgt: torch.Tensor) -> torch.Tensor:
    """PAD + causal mask [B, L, L]."""
    not_pad = ~fuzzy_token_equal(tgt[:, None, :, :], PAD_GAUSSIAN)
    return not_pad & subsequent_mask(tgt.shape[1], tgt.device)


class FlatTrainingScene:
    """Camera batcher with visibility pre-filtering (one render per camera,
    K1 on the card). Sequences pad to ``bucket`` multiples."""

    def __init__(self, scene_obj, render_cfg: RenderConfig = RenderConfig(), max_len: int = 15_000,
                 min_len: int = 5_000, bucket: int = 256, seed: int = 0):
        self.render_cfg = render_cfg
        self.bucket = bucket
        self.rng = np.random.RandomState(seed)
        self.dropout = 0.01
        self.gaussians = scene_obj.gaussians
        self.device = self.gaussians.get_xyz.device
        with torch.no_grad():
            self.tokens = flatten_gaussians(self.gaussians).cpu().numpy()
        self.cameras, self.visible, self.counts = [], [], []
        for cam in scene_obj.get_train_cameras():
            with torch.no_grad():
                vis = render(cam, self.gaussians, render_cfg)["visibility_filter"].cpu().numpy()
            count = int(vis.sum())
            self.counts.append(count)
            if count + 1 >= max_len or count <= min_len:
                continue
            self.cameras.append(cam)
            self.visible.append(vis)
        self.size = len(self.cameras)

    def set_epoch(self, epoch: int) -> None:
        self.dropout = dropout_schedule_flat(epoch)

    def make_batch(self, cam_idx: int) -> dict:
        vis = self.visible[cam_idx]
        seen = self.tokens[vis]
        mask = self.rng.rand(len(seen)) >= self.dropout
        src_real = seen[mask]
        tgt_real = seen[~mask]
        start, end, pad = (t.numpy() for t in (START_GAUSSIAN, END_GAUSSIAN, PAD_GAUSSIAN))

        def build(rows, trailing_end):
            seq = [start[None], rows] + ([end[None]] if trailing_end else [])
            arr = np.concatenate(seq, axis=0)
            want = ((len(arr) + self.bucket - 1) // self.bucket) * self.bucket
            if trailing_end:
                # bucket + 1, so trg = arr[:-1] and trg_y = arr[1:] stay
                # bucket-divisible.
                want += 1
            return np.concatenate([arr, np.tile(pad, (want - len(arr), 1))], axis=0)

        src = torch.from_numpy(build(src_real, False)[None]).to(self.device)
        tgt_full = torch.from_numpy(build(tgt_real, True)[None]).to(self.device)
        trg = tgt_full[:, :-1]
        return {
            "src": src,
            "src_mask": ~fuzzy_token_equal(src[:, None, :, :], PAD_GAUSSIAN),
            "trg": trg,
            "trg_y": tgt_full[:, 1:],
            "trg_mask": make_std_mask(trg),
            "cam": self.cameras[cam_idx],
            "n_src": len(src_real),
            "n_tgt": len(tgt_real),
        }


def make_flat_loss(model: EmbeddedEncoderDecoder, render_cfg: RenderConfig = RenderConfig(),
                   use_lpips: Optional[bool] = None):
    """Returns fn(src, trg, trg_y, src_mask, trg_mask, cam, dropout_key=None)
    -> (loss, {"base", "gen", "l2", "overflow"}), ``overflow`` [2] the
    instances the two renders dropped. It renders the prompt (the whole src
    row block, START and PAD rows included) with the teacher-forced
    prediction and with the true targets (END and PAD rows included), as
    the JAX package does. ``dropout_key`` (a tuple of ints) turns on
    train-mode dropout from its generator; None runs deterministically."""
    if use_lpips is None:
        use_lpips = lpips_mod.available("alex")

    group = getattr(model, "seq_group", None)

    def loss_fn(batch_src, batch_trg, batch_trg_y, src_mask, trg_mask, cam,
                dropout_key: Optional[Sequence[int]] = None):
        if group is None:
            rng = None if dropout_key is None else dropout_generator(batch_src.device, dropout_key)
            out = model(batch_src, batch_trg, src_mask, trg_mask, rng)
            x = model.generator(out)[0]  # [Lt, 26]
        else:
            # This rank's token rows (and its own dropout draws).
            n, me = cc.size(group), cc.rank(group)
            rows = lambda t: t.chunk(n, dim=1)[me]
            rng = None if dropout_key is None else dropout_generator(batch_src.device, tuple(dropout_key) + (me,))
            out = model(rows(batch_src), rows(batch_trg), src_mask, rows(trg_mask), rng)
            x = cc.all_gather(model.generator(out)[0], group)  # [Lt, 26]

        prompt = batch_src[0]
        g_combined = unflatten_gaussians(torch.cat([prompt, x], dim=0))
        # Baseline: rendering ALL tokens (prompt + true targets).
        g_base = unflatten_gaussians(torch.cat([prompt, batch_trg_y[0]], dim=0))
        out_gen = render(cam, g_combined, render_cfg)
        out_base = render(cam, g_base, render_cfg)
        image, y_img = out_gen["render"], out_base["render"]
        original = cam.original_image

        base = l1_loss(y_img, original)
        gen = l1_loss(image, original)
        l2 = l2_loss(x, batch_trg_y[0])
        loss = ((base - (base - gen)) / torch.clamp(base, min=1e-8)) * 0.5
        loss = loss + 0.1 * l2
        if use_lpips:
            loss = loss + 0.4 * lpips_mod.lpips(torch.clamp(image, 0, 1), torch.clamp(original, 0, 1), "alex")
        overflow = torch.stack([torch.as_tensor(o["overflow"]) for o in (out_gen, out_base)])
        if group is not None:
            loss = cc.replicated_output(loss, group)  # every rank scored the same renders
        return loss, {"base": base, "gen": gen, "l2": l2, "overflow": overflow}

    return loss_fn


@torch.no_grad()
def reduce_grads(params, group) -> None:
    """Sum the weight gradients over ``group``: the ring's ranks each hold
    their token shard's share."""
    grads = [p.grad for p in params if p.grad is not None]
    for g, total in zip(grads, cc.all_reduce_tensors(grads, group)):
        g.copy_(total)


@torch.no_grad()
def greedy_decode_flat(model: EmbeddedEncoderDecoder, src, src_mask, max_len: int) -> torch.Tensor:
    """Greedy decode from the flat START token into a [1, max_len, 26]
    buffer; each step runs the decoder over the whole buffer (the causal
    mask hides the unwritten tail, an iota filler)."""
    D = TOKEN_DIM
    dev = src.device
    memory = model.encode(src, src_mask)
    ys = (torch.arange(D, dtype=src.dtype, device=dev) * 1e-3).repeat(1, max_len, 1)
    ys[:, 0] = START_GAUSSIAN.to(dev, src.dtype)
    causal = subsequent_mask(max_len, dev)
    for i in range(max_len - 1):
        out = model.decode(memory, src_mask, ys, causal)
        ys[:, i + 1] = model.generator(out[:, i])
    return ys


def save_flat_params(path: str, model: nn.Module) -> None:
    """``np.savez`` of the parameters as the flax tree flattens them
    (``arr_0, arr_1, ...``; dense kernels [in, out]). Under
    ``torch.distributed`` every rank calls it (FSDP shards are gathered
    whole) and rank 0 alone writes."""
    from gaussian_transformer_tpu_torch.parallel.fsdp import full_tensor
    from gaussian_transformer_tpu_torch.parallel.mesh import is_lead

    params = dict(model.named_parameters())
    arrays = [tensor_to_jax(n, full_tensor(params[n])) for n in jax_order(model)]
    if is_lead():
        np.savez(path, *arrays)


@torch.no_grad()
def load_flat_params(path: str, model: nn.Module) -> None:
    """Load a ``save_flat_params`` file written by either package into
    ``model`` in place."""
    params = dict(model.named_parameters())
    with np.load(path) as data:
        names = jax_order(model)
        if len(data.files) != len(names):
            raise ValueError(f"{path}: {len(data.files)} arrays for {len(names)} parameters")
        for i, n in enumerate(names):
            t = torch.from_numpy(np.asarray(data[f"arr_{i}"], np.float32))
            params[n].copy_((t.T if n.endswith("weight") else t).to(params[n].device))
