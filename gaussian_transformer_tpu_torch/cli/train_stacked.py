"""Stacked-transformer training CLI (port of the root
``train_stacked_transformer.py``, single device).

Loads the latest trained PLY of a model dir at SH degree 1, box-sorts it
once, and trains the fat-token encoder-decoder (``--stack 8``: token dim
and d_model 26 * 2^8 = 6656, ``--layers 2``, h 8, dropout 0.1, dense
attention unless ``--attn_block_k``) with Adam(eps=1e-4) and a
ReduceLROnPlateau from lr 5e-4 fed ``loss / ntokens`` each epoch.
Checkpoints go to ``<run_name>/checkpoint_<epoch>`` every
``--checkpoint_every`` epochs and on a RuntimeError/FloatingPointError
(crash save); a run resumes from its newest checkpoint. With ``--orbax``
the periodic saves are snapshots instead (``<run_name>/orbax/<epoch>/``,
``train/orbax_ckpt.py``: the model's and the optimizer's state dicts,
written in the background, the newest three kept), a run resumes from the
newest snapshot first, and the crash save stays a checkpoint. Runs on the
CUDA card unless ``--device cpu`` is given. TensorBoard scalars go to
``logs/<run_name>/base`` (``<run_name>/base`` for an absolute run name) when
``torch.utils.tensorboard`` imports; ``--ip``/``--port`` are accepted and
unused (no viewer). ``--dp`` and ``--fsdp`` raise ``NotImplementedError``
(the parallel tier is on the port's roadmap).

    python -m gaussian_transformer_tpu_torch.cli.train_stacked -s <data> -m <model> [--epochs N]
"""

from __future__ import annotations

import datetime
import os
import sys
import time
from argparse import ArgumentParser

import torch

from gaussian_transformer_tpu_torch.config import ModelParams, OptimizationParams, PipelineParams
from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.scene import Scene
from gaussian_transformer_tpu_torch.train import orbax_ckpt
from gaussian_transformer_tpu_torch.train.stacked import (
    ReduceLROnPlateau,
    TrainingScene,
    load_checkpoint,
    make_optimizer,
    make_stacked_model,
    make_train_step,
    save_checkpoint,
)
from gaussian_transformer_tpu_torch.utils.system import search_for_max_iteration

DROPOUT_BASE_SEED = 42  # model.train(): fresh dropout masks every step


def _parse(argv):
    parser = ArgumentParser(description="Training script parameters")
    lp = ModelParams(parser)
    OptimizationParams(parser)
    PipelineParams(parser)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--stack", type=int, default=8)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--attn_block_k", type=int, default=0,
                        help="key-block size for blockwise (flash-style) attention; 0 = dense")
    parser.add_argument("--epochs", type=int, default=20000)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--run_name", type=str, default=None)
    parser.add_argument("--checkpoint_every", type=int, default=50)
    parser.add_argument("--dp", type=int, default=0, help="not ported (ROADMAP Queue 1: the parallel tier)")
    parser.add_argument("--fsdp", type=int, default=0, help="not ported (ROADMAP Queue 1: the parallel tier)")
    parser.add_argument("--orbax", action="store_true",
                        help="snapshots under <run_name>/orbax/ in place of the periodic checkpoints")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return lp, parser.parse_args(sys.argv[1:] if argv is None else argv)


def main(argv=None):
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``). Returns a summary:
    ``run_name``, ``first_epoch``, ``model``, ``optimizer``, ``tscene``,
    ``history`` (one dict per step: epoch, loss, chamfer, img_loss, ntokens,
    src_len, trg_len, and ``ms`` on the card) and ``epochs`` (one dict per
    epoch: epoch, loss per token, lr after the scheduler step)."""
    lp, args = _parse(argv)
    if args.dp or args.fsdp:
        raise NotImplementedError("--dp/--fsdp: the parallel tier is on the port's roadmap (ROADMAP Queue 1)")
    device = resolve_device(args.device)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    print("Optimizing " + args.model_path)
    dataset = lp.extract(args)
    render_cfg = RenderConfig()
    scene = Scene(dataset, load_iteration=-1, sh_degree=1, device=device)
    tscene = TrainingScene(scene, render_cfg, batch_size=args.batch_size, stack=args.stack)

    model = make_stacked_model(args.stack, args.layers, args.attn_block_k, seed=0, device=device)
    optimizer = make_optimizer(model)
    scheduler = ReduceLROnPlateau(lr=0.0005)

    run_name = args.run_name or (
        "runs/" + datetime.datetime.fromtimestamp(time.time()).strftime("%a_%d_%b_%I_%M%p")
    )
    first_epoch = 0
    orbax_mgr = None
    if args.orbax:
        orbax_mgr = orbax_ckpt.make_manager(run_name)
        snap = orbax_ckpt.restore(orbax_mgr, {"params": None, "opt_state": None})
        if snap is not None:
            model.load_state_dict(snap["params"])
            optimizer.load_state_dict(snap["opt_state"])
            first_epoch = orbax_mgr.latest_step() + 1
            print(f"resumed from orbax epoch {first_epoch - 1}")
    if first_epoch == 0 and os.path.exists(run_name):
        max_iter = search_for_max_iteration(run_name)
        if max_iter is not None:
            print(f"loading Model iter {max_iter}")
            load_checkpoint(run_name, max_iter, model, optimizer)
            first_epoch = max_iter + 1
    os.makedirs(run_name, exist_ok=True)

    tb_writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter

        tb_writer = SummaryWriter(os.path.join("logs", run_name, "base"))
    except ImportError:
        pass

    step_fn = make_train_step(model, tscene.handler, render_cfg, optimizer, args.stack)
    model.train()
    on_card = device.type == "cuda"
    history, epochs = [], []
    global_step = 0
    for epoch in range(first_epoch, args.epochs):
        try:
            tscene.set_epoch(epoch)
            total_loss, total_tokens = 0.0, 0
            for batch in tscene.batches():
                if batch is None:
                    continue
                if on_card:
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                loss, metrics = step_fn(batch.src, batch.trg_y, batch.cameras, scheduler.lr,
                                        batch.src_mask, (DROPOUT_BASE_SEED, global_step))
                if on_card:
                    ev[1].record()
                loss = float(loss)
                record = {"epoch": epoch, "loss": loss, "chamfer": float(metrics["chamfer"]),
                          "img_loss": float(metrics["img_loss"]), "ntokens": batch.ntokens,
                          "src_len": batch.src.shape[1], "trg_len": batch.trg_y.shape[1]}
                if on_card:
                    record["ms"] = ev[0].elapsed_time(ev[1])
                history.append(record)
                total_loss += loss
                total_tokens += batch.ntokens
                if tb_writer:
                    tb_writer.add_scalar("loss", loss, global_step)
                    tb_writer.add_scalar("chamfer", record["chamfer"], global_step)
                global_step += 1
            epoch_loss = total_loss / max(total_tokens, 1)
            print(f"Epoch: {epoch} Loss: {epoch_loss}")
            scheduler.step(epoch_loss)
            epochs.append({"epoch": epoch, "loss": epoch_loss, "lr": scheduler.lr})
            if tb_writer:
                tb_writer.add_scalar("lr", scheduler.lr, epoch)
                tb_writer.add_scalar("dropout", tscene.dropout, epoch)
            if epoch % args.checkpoint_every == 0 and epoch > first_epoch:
                if orbax_mgr is not None:
                    orbax_ckpt.save(orbax_mgr, epoch, {"params": model.state_dict(),
                                                       "opt_state": optimizer.state_dict()})
                else:
                    save_checkpoint(run_name, epoch, model, optimizer)
        except (RuntimeError, FloatingPointError) as e:
            # Crash save: keep what was trained, and go on with the next epoch.
            print(e)
            save_checkpoint(run_name, epoch, model, optimizer)
    if orbax_mgr is not None:
        orbax_mgr.wait_until_finished()
    if tb_writer:
        tb_writer.close()
    print("\nTraining complete.")
    return {"run_name": run_name, "first_epoch": first_epoch, "model": model, "optimizer": optimizer,
            "tscene": tscene, "history": history, "epochs": epochs}


if __name__ == "__main__":
    main()
