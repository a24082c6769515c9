"""Stacked-transformer trainer (port of the single-device part of
``gaussian_transformer_tpu/train/stacked.py``).

A trained scene is box-sorted once; a batch ORs ``batch_size`` cameras'
visibility, truncates the visible run to a multiple of 2^STACK, folds it
STACK times into fat tokens and carves an epoch-scheduled contiguous window
as the target. The loss runs a full greedy decode (gradients flow through
every step), then Chamfer, plus the L1/SSIM image loss of renders of the
decoded and target Gaussians when Chamfer < 3. Adam(eps=1e-4) with the lr
of a ``ReduceLROnPlateau`` set each step, or (the stacked campaign's
recipe) bf16 parameters and ``train/adafactor.py Adafactor`` at its own
rate 1.0, its update scaled by that lr.

Batches are padded to ``bucket`` multiples with PAD tokens (masks carry
correctness), as in the JAX package, and the host-side batching draws from
``np.random.RandomState(seed)`` in the same order, so both packages build
the same batches. The decode is checkpointed per step
(``torch.utils.checkpoint``), and each step's dropout masks come from a
generator seeded from (dropout key, step), created inside the checkpointed
function so its recomputation draws the same masks.

Data parallelism (``--dp``): ``make_batch_group`` draws N independent
windows, identically on every rank (the same seeded ``rng``), and
``make_dp_train_step`` has rank w decode and render window w, averages the
gradients over the data axis and makes one update; with the model sharded
by ``parallel/fsdp.py shard_model`` over a ``("data", "fsdp")`` mesh FSDP2
does the averaging. The chamfer gate reads the loss on the host, but no
collective lies inside either branch, so the ranks of a group issue theirs
in the same order whatever their windows' gates say. Checkpoints of a
sharded model are gathered whole and written by rank 0 alone.

The viewer: ``LiveViewerStream`` streams the cached greedy decode
(``models/decode_cache.py``) of the last batch to the SIBR viewer, one
rendered frame per token, and ``make_viewer_train_fn`` serves the
teacher-forced decode while training goes on.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from gaussian_transformer_tpu_torch.models.box_sort import GaussianHandler
from gaussian_transformer_tpu_torch.models.codec import (
    PAD_GAUSSIAN,
    START_GAUSSIAN,
    TOKEN_DIM,
    fuzzy_token_equal,
    stack_tokens,
    unflatten_gaussians,
    unstack_tokens,
)
from gaussian_transformer_tpu_torch.models.decode_cache import decode_step, init_decode_state
from gaussian_transformer_tpu_torch.models.transformer import (
    EncoderDecoder,
    init_model,
    jax_order,
    make_model,
    numpy_to_tensor,
    subsequent_mask,
    tensor_to_jax,
    tensor_to_numpy,
)
from gaussian_transformer_tpu_torch.ops.chamfer import chamfer_distance
from gaussian_transformer_tpu_torch.ops.losses import l1_loss, ssim
from gaussian_transformer_tpu_torch.render import RenderConfig, render
from gaussian_transformer_tpu_torch.train.adafactor import Adafactor
from gaussian_transformer_tpu_torch.utils.profiling import span

STACK = 8


def stacked_token_dim(stack: int = STACK) -> int:
    return TOKEN_DIM * 2**stack


def start_token(stack: int = STACK) -> torch.Tensor:
    return START_GAUSSIAN.repeat(2**stack)


def pad_token(stack: int = STACK) -> torch.Tensor:
    return PAD_GAUSSIAN.repeat(2**stack)


def make_std_mask(tgt: torch.Tensor, stack: int = STACK) -> torch.Tensor:
    """PAD + causal mask [B, L, L]."""
    not_pad = ~fuzzy_token_equal(tgt[:, None, :, :], pad_token(stack))  # [B, 1, L]
    return not_pad & subsequent_mask(tgt.shape[1], tgt.device)


def dropout_schedule(epoch: int) -> float:
    """Target-window half-width schedule."""
    return min(1.30 - math.exp(-1e-4 * epoch), 0.6)


def make_stacked_model(stack: int = STACK, layers: int = 2, block_k: int = 0, seed: int = 0,
                       device=None, dtype=torch.float32, param_dtype=torch.float32) -> EncoderDecoder:
    """The stacked CLI's model: token dim = d_model = 26 * 2^stack, h 8,
    dropout 0.1, Xavier-uniform from ``seed``; the campaign's is bf16 in
    ``dtype`` and ``param_dtype``."""
    D = stacked_token_dim(stack)
    model = make_model(stack, D, D, N=layers, d_model=D, block_k=block_k, dtype=dtype,
                       param_dtype=param_dtype, device=device)
    return init_model(model, seed)


@dataclasses.dataclass
class StackedBatch:
    src: torch.Tensor  # [1, Ls, D]
    src_mask: torch.Tensor  # [1, 1, Ls]: False on bucket-padding PAD tokens
    trg: torch.Tensor  # [1, Lt, D] (decoder input, starts with START)
    trg_y: torch.Tensor  # [1, Lt, D] (shifted target)
    trg_mask: torch.Tensor  # [1, Lt, Lt]
    cameras: List  # batch cameras
    ntokens: int


class TrainingScene:
    """Scene + camera batcher.

    The scene is box-sorted ONCE at load; per batch we OR ``batch_size``
    cameras' visibility (one render per camera, cached), fold the visible
    run, and split a scheduled contiguous window as the target. src/tgt are
    padded up to multiples of ``bucket`` fat tokens with PAD."""

    def __init__(self, scene_obj, render_cfg: RenderConfig = RenderConfig(), batch_size: int = 4,
                 stack: int = STACK, interval_num: int = 40, bucket: int = 16, seed: int = 0):
        self.batch_size = batch_size
        self.stack = stack
        self.bucket = bucket
        self.render_cfg = render_cfg
        self.rng = np.random.RandomState(seed)
        self.dropout = 0.0

        gaussians = scene_obj.gaussians
        self.device = gaussians.get_xyz.device
        with torch.no_grad():
            self.handler = GaussianHandler.create(gaussians, interval_num)
            sorted_tokens = self.handler.box_sort(gaussians)  # [C, 26] normalized
            # Every slot alive, dead ones included (visibility is cut to the
            # alive prefix afterwards), as the JAX package renders it.
            self.gaussians = self.handler.denormalize(unflatten_gaussians(sorted_tokens))
        self.n_alive = gaussians.num_alive
        # The model consumes NORMALIZED tokens; batching is host-side.
        self.tokens = sorted_tokens[: self.n_alive].cpu().numpy()
        self.cameras = list(scene_obj.get_train_cameras())
        self.size = len(self.cameras)
        self._vis_cache = {}

    @torch.no_grad()
    def _visibility(self, cam_idx: int) -> np.ndarray:
        if cam_idx not in self._vis_cache:
            vis = render(self.cameras[cam_idx], self.gaussians, self.render_cfg)["visibility_filter"]
            self._vis_cache[cam_idx] = vis.cpu().numpy()[: self.n_alive]
        return self._vis_cache[cam_idx]

    def set_epoch(self, epoch: int) -> None:
        self.dropout = dropout_schedule(epoch)

    def batches(self):
        idxs = np.arange(self.size)
        self.rng.shuffle(idxs)
        idxs = idxs[: (self.size // self.batch_size) * self.batch_size]
        for group in idxs.reshape(-1, self.batch_size):
            yield self.make_batch(list(group))

    def make_batch_group(self, n_windows: int) -> Optional[StackedBatch]:
        """``n_windows`` independent windows stacked on a leading axis for
        the data-parallel step: each draws its own cameras and scheduled
        split, and all re-pad to the group's common src/tgt lengths.
        ``cameras`` is one list of cameras per window; ``trg_mask`` is None."""
        idxs = np.arange(self.size)
        self.rng.shuffle(idxs)
        bs = self.batch_size
        reps = [[int(idxs[(i * bs + j) % self.size]) for j in range(bs)] for i in range(n_windows)]
        batches = [self.make_batch(g) for g in reps]
        if any(b is None for b in batches):
            return None
        padt = pad_token(self.stack).numpy()

        def repad(arr, want):
            arr = arr[0].cpu().numpy()
            return np.concatenate([arr, np.tile(padt, (want - len(arr), 1))], axis=0)

        ls = max(b.src.shape[1] for b in batches)
        lt = max(b.trg_y.shape[1] for b in batches)
        src = torch.from_numpy(np.stack([repad(b.src, ls) for b in batches])).to(self.device)
        trg_full = np.stack([np.concatenate([b.trg[0, :1].cpu().numpy(), repad(b.trg_y, lt)], axis=0)
                             for b in batches])  # [N, lt + 1, D]: START + the re-padded targets
        trg_full = torch.from_numpy(trg_full).to(self.device)
        return StackedBatch(
            src=src,
            src_mask=~fuzzy_token_equal(src, pad_token(self.stack))[:, None, :],
            trg=trg_full[:, :-1],
            trg_y=trg_full[:, 1:],
            trg_mask=None,
            cameras=[b.cameras for b in batches],
            ntokens=sum(b.ntokens for b in batches),
        )

    def make_batch(self, cam_idxs: Sequence[int]) -> Optional[StackedBatch]:
        """The spans ``stacked.batch.build`` (visibility, fold, window and
        padding on the host) and ``stacked.batch.upload`` (the copies to the
        device and the masks)."""
        with span("stacked.batch.build"):
            fold = 2**self.stack
            vis = np.zeros(self.n_alive, bool)
            cams = []
            for i in cam_idxs:
                vis |= self._visibility(i)
                cams.append(self.cameras[i])

            seen = self.tokens[vis]
            seen = seen[: (len(seen) // fold) * fold]
            if len(seen) < 2 * fold:
                return None
            folded = stack_tokens(torch.from_numpy(seen), self.stack).numpy()  # [L, D]
            L = folded.shape[0]

            # Scheduled contiguous window.
            mid = L // 2
            low = int(mid - mid * self.dropout)
            high = int(mid + mid * self.dropout)
            offset = int((self.rng.random_sample() * 0.8 + 0.1) * (low + (L - high)) - (L - high))
            low -= offset
            high -= offset
            low, high = max(0, low), min(L, max(high, low + 1))

            start = start_token(self.stack).numpy()
            padt = pad_token(self.stack).numpy()

            def pad_to(arr, mult):
                want = ((len(arr) + mult - 1) // mult) * mult
                return np.concatenate([arr, np.tile(padt, (want - len(arr), 1))], axis=0)

            src = pad_to(np.concatenate([folded[:low], folded[high:]], axis=0), self.bucket)
            tgt_full = pad_to(np.concatenate([start[None], folded[low:high]], axis=0), self.bucket)

        with span("stacked.batch.upload"):
            dev = self.device
            trg = torch.from_numpy(tgt_full[None, :-1]).to(dev)
            src_t = torch.from_numpy(src[None]).to(dev)
            # The static buckets pad with PAD tokens, which must be masked out of
            # the encoder.
            src_mask = ~fuzzy_token_equal(src_t, pad_token(self.stack))[:, None, :]
            return StackedBatch(
                src=src_t,
                src_mask=src_mask,
                trg=trg,
                trg_y=torch.from_numpy(tgt_full[None, 1:]).to(dev),
                trg_mask=make_std_mask(trg, self.stack),
                cameras=cams,
                ntokens=high - low,
            )


def dropout_generator(device, key: Sequence[int]) -> torch.Generator:
    """A generator on ``device`` seeded from the integer ``key``."""
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def greedy_decode(model: EncoderDecoder, src, src_mask, max_len: int, stack: int = STACK,
                  dropout_key: Optional[Sequence[int]] = None, remat: bool = True) -> torch.Tensor:
    """Autoregressive decode into a [1, max_len, D] buffer, differentiable
    through every step. Each step runs the decoder over the whole buffer
    (the causal mask hides the unwritten tail) and is checkpointed when
    ``remat``. ``dropout_key`` enables train-mode dropout: the encoder draws
    from the generator of ``key + (0,)``, decode step i from ``key + (i+1,)``."""
    D = src.shape[-1]
    dev = src.device

    def rng(i):
        return None if dropout_key is None else dropout_generator(dev, tuple(dropout_key) + (i,))

    with span("stacked.encode"):
        memory = model.encode(src, src_mask, rng(0))
    # One span around the whole loop: the backward's recomputations of
    # ``step`` open none.
    with span("stacked.decode"):
        # Unwritten tail rows are causally masked and never read, but they do
        # flow through the pre-norm LayerNorm, whose sqrt(var) has an infinite
        # derivative at var = 0: constant filler rows would turn the gradients
        # into NaN. An iota filler keeps every row's variance > 0.
        filler = (torch.arange(D, dtype=src.dtype, device=dev) * 1e-3).expand(1, max_len, D)
        causal = subsequent_mask(max_len, dev)
        ys = torch.cat([start_token(stack).to(dev, src.dtype).expand(1, 1, D), filler[:, 1:]], dim=1)

        def step(ys, i):
            # The generator is made here, so a recomputation draws the same masks.
            out = model.decode(memory, src_mask, ys, causal, rng(i + 1))
            return model.generator(out[:, i])

        for i in range(max_len - 1):
            if remat and torch.is_grad_enabled():
                nxt = checkpoint(step, ys, i, use_reentrant=False, preserve_rng_state=False)
            else:
                nxt = step(ys, i)
            ys = torch.cat([ys[:, : i + 1], nxt[:, None, :], filler[:, i + 2:]], dim=1)
    return ys


def image_loss(pred_list, tgt_list, valid, handler: GaussianHandler, cams, render_cfg: RenderConfig):
    """The image branch of the loss: render the decoded and the target
    Gaussians (tokens [n, 26], normalized) from every camera, PAD rows kept
    out through ``alive=valid``, and score L1 and SSIM. Returns (loss,
    overflow [2, n_cams] of the pred and target renders)."""
    g_pred = handler.denormalize(unflatten_gaussians(pred_list)).replace(alive=valid)
    g_tgt = handler.denormalize(unflatten_gaussians(tgt_list)).replace(alive=valid)
    images, tgt_images, overflow = [], [], []
    for cam in cams:
        a = render(cam, g_pred, render_cfg)
        b = render(cam, g_tgt, render_cfg)
        images.append(torch.clamp(torch.nan_to_num(a["render"]), 0.0, 1.0))
        tgt_images.append(torch.clamp(torch.nan_to_num(b["render"]), 0.0, 1.0))
        overflow.append(torch.stack([torch.as_tensor(a["overflow"]), torch.as_tensor(b["overflow"])]))
    images, tgt_images = torch.stack(images), torch.stack(tgt_images)
    n_cams = len(cams)
    gen = l1_loss(images, tgt_images) * (5.0 / n_cams)
    ssim_l = (1.0 - ssim(images, tgt_images)) * (0.2 / n_cams)
    return gen * 0.1 + ssim_l * 0.1, torch.stack(overflow, dim=1)


def make_loss_fn(model: EncoderDecoder, handler: GaussianHandler, render_cfg: RenderConfig,
                 stack: int = STACK):
    """Returns fn(src, trg_y, cams, src_mask=None, dropout_key=None) ->
    (loss, metrics)."""

    def loss_fn(src, trg_y, cams, src_mask=None, dropout_key=None):
        ys = greedy_decode(model, src, src_mask, trg_y.shape[1] + 1, stack, dropout_key)
        with span("stacked.loss"):
            pred_list = unstack_tokens(ys[0, 1:], stack)  # [Lt * 2^s, 26]
            tgt_list = unstack_tokens(trg_y[0], stack)

            # PAD fat tokens of the buckets must not contribute to the loss. A
            # fat token's 2^s Gaussians are contiguous after the unstack.
            valid_fat = ~fuzzy_token_equal(trg_y[0], pad_token(stack))  # [Lt]
            valid = valid_fat.repeat_interleave(2**stack)  # [Lt * 2^s]
            n_valid = torch.clamp(valid.float().sum(), min=1.0)

            d1, d2, _, _ = chamfer_distance(pred_list[None], tgt_list[None], a_valid=valid[None],
                                            b_valid=valid[None])
            chamfer = d1.sum() / n_valid + d2.sum() / n_valid
            metrics = {"chamfer": chamfer.detach()}
            loss = chamfer
            # The gate is the step's one intended host synchronisation: the JAX
            # package's lax.cond becomes a Python branch on one read of chamfer.
            if float(chamfer.detach()) < 3.0:
                img_loss, overflow = image_loss(pred_list, tgt_list, valid, handler, cams, render_cfg)
                loss = chamfer + img_loss
                metrics.update(img_loss=img_loss.detach(), overflow=overflow)
            else:
                metrics["img_loss"] = torch.zeros((), device=chamfer.device)
            return loss, metrics

    return loss_fn


class LiveViewerStream:
    """Live autoregressive viewer streaming: when the SIBR viewer pauses
    training (train=False), every greedy-decode step's partial
    reconstruction is rendered and sent at once. The decode runs the
    KV-cached path (``models/decode_cache.py``, O(L) attention a step);
    training keeps the differentiable scan decode. Everything runs under
    ``torch.no_grad()``.

    ``viewer/network_gui.py pump_stacked`` drives ``start``/``step``/
    ``render`` inside ``decoding()`` and reads ``n_steps``; the trainer
    hands over each step's batch with ``set_batch`` (the model is the live
    module, so its weights are always the current ones). On an
    FSDP2-sharded model ``decoding()`` gathers the parameters whole once for
    the stream (``parallel/fsdp.py unsharded``: the cached decode reads the
    layers' weights outside their forwards), a collective every rank
    enters; ``start`` and ``step`` run inside it."""

    def __init__(self, model: EncoderDecoder, handler: GaussianHandler, render_cfg: RenderConfig,
                 stack: int = STACK):
        self.model, self.handler, self.render_cfg, self.stack = model, handler, render_cfg, stack
        self.n_steps = 0
        self.batch: Optional[StackedBatch] = None

    def set_batch(self, batch: StackedBatch) -> None:
        self.batch = batch
        self.n_steps = int(batch.trg_y.shape[1])

    def decoding(self):
        """The block in which ``start`` and ``step`` run: the model's
        parameters whole for it (gathered once when it is FSDP2-sharded)."""
        from gaussian_transformer_tpu_torch.parallel.fsdp import unsharded

        return unsharded(self.model)

    @torch.no_grad()
    def start(self):
        """(ys [B, Lt + 1, D] holding START in row 0, the decode state, 0)."""
        b = self.batch
        max_len = int(b.trg_y.shape[1]) + 1
        state = init_decode_state(self.model, b.src, b.src_mask, max_len)
        ys = b.src.new_zeros(b.src.shape[0], max_len, b.src.shape[-1])
        ys[:, 0] = start_token(self.stack).to(ys)
        return ys, state, 0

    @torch.no_grad()
    def step(self, carry):
        """One cached decode step: row i + 1 of ys from row i."""
        ys, state, i = carry
        ys[:, i + 1] = decode_step(self.model, state, ys[:, i:i + 1], i)
        return ys, state, i + 1

    def render(self, carry, cam, smod, show_prompt, show_pred):
        ys, _, i = carry
        return self.compose(ys, i, cam, smod, show_prompt, show_pred)

    @torch.no_grad()
    def compose(self, ys, n_valid, cam, smod, show_prompt, show_pred):
        """The display composite of any prediction buffer ``ys`` whose rows
        0..n_valid are live: the prompt's real tokens (``show_prompt``)
        and/or those rows (``show_pred``); with neither flag, the target
        without its PAD tokens. Shared by the stream and the teacher-forced
        image."""
        b, stack = self.batch, self.stack
        if show_prompt or show_pred:
            tokens = torch.cat([b.src[0], ys[0].to(b.src.dtype)], dim=0)
            alive_fat = torch.cat([
                b.src_mask[0, 0] & bool(show_prompt),
                (torch.arange(ys.shape[1], device=ys.device) <= int(n_valid)) & bool(show_pred),
            ])
        else:
            tokens = b.trg_y[0]
            alive_fat = ~fuzzy_token_equal(b.trg_y[0], pad_token(stack))
        g = self.handler.denormalize(unflatten_gaussians(unstack_tokens(tokens, stack))).replace(
            alive=alive_fat.repeat_interleave(2**stack))
        return render(cam, g, self.render_cfg, scaling_modifier=float(smod))["render"]


def make_viewer_train_fn(stream: LiveViewerStream):
    """The viewer's image while training goes on: the teacher-forced decode
    of the stream's batch, ``generator(decode(encode(src), trg))``, run
    deterministically (``model.eval()``, no dropout generator), composed by
    ``stream.compose`` with every row live. The model's train/eval mode is
    restored after the call. Returns fn(cam, smod, show_prompt, show_pred)
    -> image, or None before the first batch."""

    @torch.no_grad()
    def viewer_train_fn(cam, smod, show_prompt, show_pred):
        if stream.batch is None:
            return None
        b, model = stream.batch, stream.model
        was_training = model.training
        model.eval()
        try:
            memory = model.encode(b.src, b.src_mask)
            gen = model.generator(model.decode(memory, b.src_mask, b.trg, b.trg_mask))
        finally:
            model.train(was_training)
        return stream.compose(gen, gen.shape[1], cam, smod, show_prompt, show_pred)

    return viewer_train_fn


class ReduceLROnPlateau:
    """Host-side lr controller with torch's semantics (mode='min',
    threshold_mode='rel', threshold=1e-4) plus the reference's cooldown=5:
    factor 0.1, patience 10. Order per step: (1) ``loss < best * (1 -
    threshold)`` updates best and resets the bad count, else the bad count
    increments; (2) during cooldown the counter decrements and the bad count
    is HELD at 0; (3) reduce when the bad count exceeds patience."""

    def __init__(self, lr: float, factor: float = 0.1, patience: int = 10, cooldown: int = 5,
                 threshold: float = 1e-4):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.cooldown = cooldown
        self.threshold = threshold
        self.best = float("inf")
        self.bad = 0
        self.cool = 0

    def step(self, loss: float) -> float:
        if loss < self.best * (1.0 - self.threshold):
            self.best = loss
            self.bad = 0
        else:
            self.bad += 1
        if self.cool > 0:
            self.cool -= 1
            self.bad = 0
        if self.bad > self.patience:
            self.lr *= self.factor
            self.cool = self.cooldown
            self.bad = 0
        return self.lr


def make_optimizer(model: EncoderDecoder, lr: float = 5e-4) -> torch.optim.Adam:
    """Adam(b1 0.9, b2 0.999, eps 1e-4); the train step sets the lr. optax's
    ``adam(1.0)`` scaled by lr is the same update. On an FSDP-sharded model
    the per-tensor loop (its shards are DTensors, its small leaves not)."""
    from gaussian_transformer_tpu_torch.parallel.fsdp import is_sharded

    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-4,
                            foreach=False if is_sharded(model) else None)


def make_train_step(model: EncoderDecoder, handler: GaussianHandler, render_cfg: RenderConfig,
                    optimizer: torch.optim.Optimizer, stack: int = STACK):
    """Returns step(src, trg_y, cams, lr, src_mask=None, dropout_key=None) ->
    (loss, metrics): one loss, its backward and one update at ``lr`` (the
    JAX step's ``updates * lr``: Adam's rule at ``lr``, ``Adafactor``'s
    update scaled by it). Spans: the root ``stacked.step``; ``stacked.encode``,
    ``stacked.decode`` (``greedy_decode``), ``stacked.loss`` (the rest of the
    loss), ``stacked.backward`` and ``stacked.optimizer`` (the zeroing of
    the gradients and the update) under it."""
    from gaussian_transformer_tpu_torch.parallel.fsdp import is_sharded, reduce_replicated_grads

    loss_fn = make_loss_fn(model, handler, render_cfg, stack)

    def step(src, trg_y, cams, lr: float, src_mask=None, dropout_key=None):
        with span("stacked.step"):
            with span("stacked.optimizer"):
                optimizer.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(src, trg_y, cams, src_mask, dropout_key)
            with span("stacked.backward"):
                loss.backward()
                if is_sharded(model):
                    reduce_replicated_grads(model)
            with span("stacked.optimizer"):
                for group in optimizer.param_groups:
                    group["lr"] = lr
                optimizer.step()
            return loss.detach(), metrics

    return step


def make_dp_train_step(model: EncoderDecoder, handler: GaussianHandler, render_cfg: RenderConfig,
                       optimizer: torch.optim.Optimizer, stack: int = STACK, mesh=None, axis: str = "data"):
    """Data-parallel step over independent windows (``make_batch_group``):
    rank w of mesh axis ``axis`` decodes and renders window w with its own
    cameras and dropout key (``dropout_key + (w,)``, (0, w) without one: the
    step always runs in train mode, as the JAX package's), the gradients are
    averaged over the axis, and one update follows on every rank. Returns
    step(src, trg_y, cams, lr, src_mask, dropout_key=None) -> (loss,
    metrics), both the mean over the windows; the arguments are the whole
    group's. On a ``("data", "fsdp")`` mesh with the model sharded by
    ``parallel/fsdp.py shard_model`` over it, FSDP2 averages over the mesh."""
    from gaussian_transformer_tpu_torch.parallel import collectives as cc
    from gaussian_transformer_tpu_torch.parallel.fsdp import is_sharded, reduce_replicated_grads

    loss_fn = make_loss_fn(model, handler, render_cfg, stack)
    group = mesh.get_group(axis)
    w = mesh.get_local_rank(axis)

    def step(src, trg_y, cams, lr: float, src_mask, dropout_key=None):
        optimizer.zero_grad(set_to_none=True)
        key = tuple(dropout_key if dropout_key is not None else (0,)) + (w,)
        loss, metrics = loss_fn(src[w:w + 1], trg_y[w:w + 1], cams[w], src_mask[w:w + 1], key)
        loss.backward()
        if is_sharded(model):
            reduce_replicated_grads(model)
        else:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            for g, mean in zip(grads, cc.all_reduce_tensors(grads, group, "mean")):
                g.copy_(mean)
        for g in optimizer.param_groups:
            g["lr"] = lr
        optimizer.step()
        with torch.no_grad():
            names = sorted(k for k, v in metrics.items() if v.ndim == 0)
            mean = cc.all_reduce(torch.stack([loss.detach()] + [metrics[k].float() for k in names]), group, "mean")
        return mean[0], dict(zip(names, mean[1:]))

    return step


# Checkpoints keep the JAX package's npz layout: model.npz is the flax params
# flattened in jax.tree_util order (arr_0, arr_1, ...; dense kernels [in,
# out]; bf16 leaves as their uint16 bit patterns); optim.npz is optax's state
# in its flatten order: adam's (count, mu..., nu...), adafactor's (count,
# v_row..., v_col..., v...), each leaf in the parameters' order.


def save_checkpoint(run_dir: str, epoch, model: EncoderDecoder, optimizer: torch.optim.Optimizer) -> None:
    """Write ``checkpoint_<epoch>/{model,optim}.npz``. Under
    ``torch.distributed`` every rank calls it (an FSDP shard is gathered
    whole, a collective) and rank 0 alone writes."""
    from gaussian_transformer_tpu_torch.parallel.fsdp import full_tensor
    from gaussian_transformer_tpu_torch.parallel.mesh import is_lead

    d = os.path.join(run_dir, f"checkpoint_{epoch}")
    names = jax_order(model)
    params = dict(model.named_parameters())
    states = [optimizer.state.get(params[n], {}) for n in names]
    count = next((int(st["step"]) for st in states if st), 0)
    weights = [tensor_to_jax(n, full_tensor(params[n])) for n in names]
    if isinstance(optimizer, Adafactor):
        # The state is already in the flax layout (train/adafactor.py).
        states = [st or Adafactor.init_state(params[n]) for n, st in zip(names, states)]
        leaves = [tensor_to_numpy(st[k]) for k in ("v_row", "v_col", "v") for st in states]
    else:
        def moment(i, n, st, key):
            return tensor_to_jax(n, full_tensor(st[key])) if st else np.zeros_like(weights[i])

        leaves = [moment(i, n, st, key) for key in ("exp_avg", "exp_avg_sq") for i, (n, st) in
                  enumerate(zip(names, states))]
    if not is_lead():
        return
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "model.npz"), *weights)
    np.savez(os.path.join(d, "optim.npz"), np.asarray(count, np.int32), *leaves)


@torch.no_grad()
def load_checkpoint(run_dir: str, epoch, model: EncoderDecoder, optimizer: torch.optim.Optimizer) -> None:
    """Load a checkpoint written by either package into ``model`` and
    ``optimizer`` (Adam or Adafactor, as it was saved) in place; an FSDP
    shard takes its piece of each whole tensor."""
    from gaussian_transformer_tpu_torch.parallel.fsdp import like

    d = os.path.join(run_dir, f"checkpoint_{epoch}")
    names = jax_order(model)
    params = dict(model.named_parameters())

    def leaf(arr, like):
        return numpy_to_tensor(arr, like.dtype).to(like.device)

    def from_jax(name, arr):
        p = params[name]
        return like(leaf(arr.T if name.endswith("weight") else arr, p).contiguous(), p)

    with np.load(os.path.join(d, "model.npz")) as m:
        for i, n in enumerate(names):
            params[n].copy_(from_jax(n, m[f"arr_{i}"]))
    P = len(names)
    with np.load(os.path.join(d, "optim.npz")) as o:
        count = int(o["arr_0"])
        for i, n in enumerate(names):
            p = params[n]
            if isinstance(optimizer, Adafactor):
                optimizer.state[p] = {"step": count, **{k: leaf(o[f"arr_{1 + j * P + i}"], p)
                                                        for j, k in enumerate(("v_row", "v_col", "v"))}}
            else:
                optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": from_jax(n, o[f"arr_{1 + i}"]),
                    "exp_avg_sq": from_jax(n, o[f"arr_{1 + P + i}"]),
                }
