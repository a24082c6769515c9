"""Flat transformer training CLI (port of the root ``train_transformer.py``,
single device).

Masked-Gaussian modeling on a trained scene: loads the latest PLY of a model
dir at SH degree 1, keeps the training cameras that see between ``MIN_LEN`` (5,000,
fixed as in the reference) and ``--max_len`` Gaussians (one visibility render each), and trains
``train/flat.py EmbeddedEncoderDecoder`` (``--d_model 1024``, ``--layers 6``,
h 8, dropout 0.1, dense attention unless ``--attn_block_k``) with Noam-rate
Adamax, one camera a step in a ``RandomState(0)`` permutation per epoch.
Dropout masks come from the step's generator (key (42, step)). After each
epoch it prints the mean loss and, when it is the lowest yet, writes
``best_model.npz`` (the JAX package's layout) to the working directory; a
``best_model.npz`` found there at start is loaded. Runs on the CUDA card
unless ``--device cpu`` is given. TensorBoard scalars go to
``runs/gaussian_trainer_embed`` when ``torch.utils.tensorboard`` imports.
The SIBR viewer's listener is bound at ``--ip``/``--port`` (default
127.0.0.1:6009; rank 0 alone), as the reference binds it; no frame is
served. When the address is taken the run prints ``viewer disabled: ...``.

Several cards, one process each under ``torchrun --nproc_per_node N`` (N
other than ``WORLD_SIZE`` raises, and so do both flags together):

  * ``--seq_shard N`` (> 1): the token axis sharded over N ranks, every
    attention a ring over them (``parallel/ring.py``; sequences pad to
    buckets that N divides), the weight gradients summed before Adamax;
  * ``--fsdp N``: parameters and Adamax state sharded over N ranks (FSDP2,
    ``parallel/fsdp.py``), every rank on the same camera.

Rank 0 alone writes ``best_model.npz`` (whole tensors), TensorBoard scalars
and the log; ``--device cpu`` runs the ranks on gloo.

    python -m gaussian_transformer_tpu_torch.cli.train_transformer -s <data> -m <model> [--epochs N]
    torchrun --nproc_per_node 8 -m gaussian_transformer_tpu_torch.cli.train_transformer -s <data> -m <model> --seq_shard 8
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch
import torch.distributed as dist

from gaussian_transformer_tpu_torch.config import ModelParams, OptimizationParams, PipelineParams
from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.parallel.fsdp import make_fsdp_mesh, reduce_replicated_grads, shard_model
from gaussian_transformer_tpu_torch.parallel.mesh import init_distributed, is_lead, seed_host_random_alike, world_size
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.scene import Scene
from gaussian_transformer_tpu_torch.train.flat import (
    EmbeddedEncoderDecoder,
    FlatTrainingScene,
    init_flat_model,
    load_flat_params,
    make_flat_loss,
    make_noam_adamax,
    reduce_grads,
    save_flat_params,
)
from gaussian_transformer_tpu_torch.viewer import network_gui

DROPOUT_BASE_SEED = 42  # model.train(): fresh dropout masks every step
BEST_MODEL = "best_model.npz"
MIN_LEN = 5_000  # a training camera must see more Gaussians than this


def _parse(argv):
    parser = ArgumentParser(description="Training script parameters")
    lp = ModelParams(parser)
    OptimizationParams(parser)
    PipelineParams(parser)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--epochs", type=int, default=20000)
    parser.add_argument("--d_model", type=int, default=1024)
    parser.add_argument("--layers", type=int, default=6)
    parser.add_argument("--max_len", type=int, default=15000)
    parser.add_argument("--attn_block_k", type=int, default=0,
                        help="key-block size for blockwise (flash-style) attention; 0 = dense")
    parser.add_argument("--seq_shard", type=int, default=0,
                        help="ring attention: the token axis sharded over this many ranks (torchrun)")
    parser.add_argument("--fsdp", type=int, default=0,
                        help="FSDP: parameters and optimizer state sharded over this many ranks (torchrun)")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return lp, parser.parse_args(sys.argv[1:] if argv is None else argv)


def main(argv=None, on_step=None):
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``); ``on_step``, if
    given, is called with each step's record as it is made. Returns a
    summary: ``model``, ``optimizer``, ``tscene``, ``history`` (one dict per
    step: epoch, step, cam, n_src, n_tgt, src_len, tgt_len, loss, base, gen,
    l2, overflow (the two renders'), lr, and ``ms`` on the card), ``epochs`` (epoch, mean loss) and
    ``best_epoch`` (the epoch of the last ``best_model.npz`` written, or
    None)."""
    lp, args = _parse(argv)
    device = resolve_device(args.device)
    ring = args.seq_shard > 1
    if ring or args.fsdp:
        if ring and args.fsdp:
            raise ValueError("--fsdp and --seq_shard shard different axes; pick one")
        n = args.seq_shard if ring else args.fsdp
        if n != world_size():
            raise ValueError(f"--{'seq_shard' if ring else 'fsdp'} {n} needs {n} processes, WORLD_SIZE is "
                             f"{world_size()}: launch with torchrun --nproc_per_node {n}")
        init_distributed(device)
        seed_host_random_alike()  # every rank shuffles the cameras alike
    log = print if is_lead() else (lambda *a, **k: None)
    log("Optimizing " + args.model_path)
    if is_lead():
        network_gui.bind_viewer(args.ip, args.port)
    dataset = lp.extract(args)
    render_cfg = RenderConfig()

    scene = Scene(dataset, load_iteration=-1, sh_degree=1, device=device)
    tscene = FlatTrainingScene(scene, render_cfg, max_len=args.max_len, min_len=MIN_LEN)
    assert tscene.size > 0, "no cameras within the visible-count window"
    if ring and tscene.bucket % args.seq_shard:
        raise ValueError(f"bucket {tscene.bucket} not divisible by seq_shard {args.seq_shard}")

    group = dist.group.WORLD if ring else None
    model = init_flat_model(EmbeddedEncoderDecoder(N=args.layers, d_model=args.d_model,
                                                   block_k=args.attn_block_k, device=device,
                                                   seq_group=group), seed=0)
    if os.path.exists(BEST_MODEL):
        log("Loading Model")
        load_flat_params(BEST_MODEL, model)
    if args.fsdp:
        shard_model(model, make_fsdp_mesh(args.fsdp))
        log(f"FSDP: params+optimizer sharded over {args.fsdp} ranks")
    optimizer, scheduler = make_noam_adamax(model.parameters(), args.d_model,
                                            foreach=False if args.fsdp else None)
    loss_fn = make_flat_loss(model, render_cfg)

    tb_writer = None
    try:
        if is_lead():
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter("runs/gaussian_trainer_embed")
    except ImportError:
        pass

    model.train()
    on_card = device.type == "cuda"
    history, epochs = [], []
    global_step = 0
    lowest_loss, best_epoch = 1e9, None
    rng = np.random.RandomState(0)
    for epoch in range(args.epochs):
        tscene.set_epoch(epoch)
        order = rng.permutation(tscene.size)
        total = 0.0
        for cam_idx in order:
            batch = tscene.make_batch(int(cam_idx))
            lr = optimizer.param_groups[0]["lr"]
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            optimizer.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(batch["src"], batch["trg"], batch["trg_y"], batch["src_mask"],
                                    batch["trg_mask"], batch["cam"], dropout_key=(DROPOUT_BASE_SEED, global_step))
            loss.backward()
            if ring:
                reduce_grads(model.parameters(), group)
            elif args.fsdp:
                reduce_replicated_grads(model)
            optimizer.step()
            scheduler.step()
            if on_card:
                ev[1].record()
            record = {"epoch": epoch, "step": global_step, "cam": int(cam_idx), "n_src": batch["n_src"],
                      "n_tgt": batch["n_tgt"], "src_len": batch["src"].shape[1], "tgt_len": batch["trg"].shape[1],
                      "loss": float(loss.detach()), **{k: float(metrics[k].detach()) for k in ("base", "gen", "l2")},
                      "overflow": metrics["overflow"].tolist(), "lr": lr}
            if on_card:
                record["ms"] = ev[0].elapsed_time(ev[1])
            history.append(record)
            if on_step is not None:
                on_step(record)
            total += record["loss"]
            if tb_writer:
                tb_writer.add_scalar("loss", record["loss"], global_step)
                tb_writer.add_scalar("l2_loss", record["l2"], global_step)
            global_step += 1
        epoch_loss = total / max(len(order), 1)
        log(f"Epoch: {epoch} Loss: {epoch_loss}")
        epochs.append({"epoch": epoch, "loss": epoch_loss})
        if epoch_loss < lowest_loss:
            lowest_loss, best_epoch = epoch_loss, epoch
            save_flat_params(BEST_MODEL, model)
    if tb_writer:
        tb_writer.close()
    log("\nTraining complete.")
    return {"model": model, "optimizer": optimizer, "tscene": tscene, "history": history, "epochs": epochs,
            "best_epoch": best_epoch}


if __name__ == "__main__":
    main()
