"""Stacked-transformer training CLI (port of the root
``train_stacked_transformer.py``).

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
``torch.utils.tensorboard`` imports.

The SIBR remote viewer connects to ``--ip``/``--port`` (default
127.0.0.1:6009; rank 0 alone binds, and a taken address prints ``viewer
disabled: ...``). Before every step it is served: while it asks to train,
the teacher-forced decode of the last batch (``model.eval()`` for the
call, then ``model.train()`` again); when it pauses training
(train=False), the cached greedy decode of the last batch streams live,
one frame per decoded token, until it asks to train again. Its request's
``shs_python`` flag shows the prediction and ``keep_alive`` the prompt;
with neither, the target. Under ``--fsdp`` alone every rank serves it
(``network_gui.pump_stacked`` with a gloo group of its own): rank 0 reads
each request and shares it before any rank computes, every rank runs the
same decode and renders (each forward all-gathers), and rank 0 alone
sends. Under ``--dp`` (with or without ``--fsdp``) the viewer gets empty
replies: each rank trains its own window.

Several cards, one process each under ``torchrun --nproc_per_node <dp x
fsdp>`` (a product other than ``WORLD_SIZE`` raises):

  * ``--dp N``: each step trains N independent windows, one per rank
    (``train/stacked.py make_dp_train_step``: gradients averaged, one
    update), ``tscene.size // (N * batch_size)`` steps an epoch;
  * ``--fsdp M``: parameters and Adam moments sharded over M ranks
    (``parallel/fsdp.py``, FSDP2), every rank on the same batches;
  * both: N windows x M-way shards on a ("data", "fsdp") mesh.

Rank 0 alone writes checkpoints and snapshots (gathered whole, so the
unsharded trainer reads them, and a snapshot of any world size resumes at
any other), TensorBoard scalars and the log; every rank enters the gather
and the restore. ``--device cpu`` runs the ranks on gloo.

    python -m gaussian_transformer_tpu_torch.cli.train_stacked -s <data> -m <model> [--epochs N]
    torchrun --nproc_per_node 8 -m gaussian_transformer_tpu_torch.cli.train_stacked -s <data> -m <model> --dp 8
"""

from __future__ import annotations

import datetime
import os
import sys
import time
from argparse import ArgumentParser

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from gaussian_transformer_tpu_torch.config import ModelParams, OptimizationParams, PipelineParams
from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.parallel.fsdp import make_fsdp_mesh, shard_model
from gaussian_transformer_tpu_torch.parallel.mesh import init_distributed, is_lead, seed_host_random_alike, world_device_type, world_size
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.scene import Scene
from gaussian_transformer_tpu_torch.train import orbax_ckpt
from gaussian_transformer_tpu_torch.train.stacked import (
    LiveViewerStream,
    ReduceLROnPlateau,
    TrainingScene,
    load_checkpoint,
    make_dp_train_step,
    make_optimizer,
    make_stacked_model,
    make_train_step,
    make_viewer_train_fn,
    save_checkpoint,
)
from gaussian_transformer_tpu_torch.utils.system import search_for_max_iteration
from gaussian_transformer_tpu_torch.viewer import network_gui

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
    parser.add_argument("--dp", type=int, default=0,
                        help="data parallelism: one independent window per rank (torchrun)")
    parser.add_argument("--fsdp", type=int, default=0,
                        help="FSDP: parameters and optimizer state sharded over this many ranks (torchrun)")
    parser.add_argument("--orbax", action="store_true",
                        help="snapshots under <run_name>/orbax/ in place of the periodic checkpoints")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return lp, parser.parse_args(sys.argv[1:] if argv is None else argv)


def main(argv=None):
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``). Returns a summary:
    ``run_name``, ``first_epoch``, ``model``, ``optimizer``, ``tscene``,
    ``history`` (one dict per step: epoch, loss, chamfer, img_loss, ntokens,
    src_len, trg_len, and ``ms`` on the card), ``epochs`` (one dict per
    epoch: epoch, loss per token, lr after the scheduler step) and
    ``snapshots`` (``--orbax``: the epoch restored and the seconds it took,
    the ms each save held training by epoch, the seconds each write took
    by epoch, rank 0's)."""
    lp, args = _parse(argv)
    device = resolve_device(args.device)
    parallel = bool(args.dp or args.fsdp)
    if parallel:
        n = max(args.dp, 1) * max(args.fsdp, 1)
        if n != world_size():
            raise ValueError(f"--dp {args.dp} x --fsdp {args.fsdp} needs {n} processes, WORLD_SIZE is "
                             f"{world_size()}: launch with torchrun --nproc_per_node {n}")
        init_distributed(device)
        seed_host_random_alike()  # every rank shuffles the cameras alike
    log = print if is_lead() else (lambda *a, **k: None)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    log("Optimizing " + args.model_path)
    # Under --fsdp alone every rank serves the viewer; its requests travel
    # on a gloo group of their own, so a tick adds no CUDA synchronisation.
    viewer_group = dist.new_group(backend="gloo") if args.fsdp and not args.dp else None
    viewer_ok = is_lead() and network_gui.bind_viewer(args.ip, args.port)
    if viewer_group is not None:
        viewer_ok = network_gui.share(viewer_ok, viewer_group)
    dataset = lp.extract(args)
    render_cfg = RenderConfig()
    scene = Scene(dataset, load_iteration=-1, sh_degree=1, device=device)
    tscene = TrainingScene(scene, render_cfg, batch_size=args.batch_size, stack=args.stack)

    model = make_stacked_model(args.stack, args.layers, args.attn_block_k, seed=0, device=device)
    mesh = None
    if args.dp and args.fsdp:
        mesh = init_device_mesh(world_device_type(), (args.dp, args.fsdp), mesh_dim_names=("data", "fsdp"))
        shard_model(model, mesh)
        log(f"DPxFSDP: {args.dp} windows x {args.fsdp}-way param shards")
    elif args.dp:
        mesh = init_device_mesh(world_device_type(), (args.dp,), mesh_dim_names=("data",))
        log(f"DP: one window per rank over {args.dp} ranks")
    elif args.fsdp:
        shard_model(model, make_fsdp_mesh(args.fsdp))
        log(f"FSDP: params+optimizer sharded over {args.fsdp} ranks")
    optimizer = make_optimizer(model)
    scheduler = ReduceLROnPlateau(lr=0.0005)

    run_name = args.run_name or (
        "runs/" + datetime.datetime.fromtimestamp(time.time()).strftime("%a_%d_%b_%I_%M%p")
    )
    first_epoch = 0
    orbax_mgr = None
    snapshots = {"restored": None, "restore_s": None, "save_ms": {}, "write_s": {}}
    if args.orbax:
        orbax_mgr = orbax_ckpt.make_manager(run_name)
        t0 = time.perf_counter()
        step = orbax_ckpt.restore_state(orbax_mgr, model, optimizer)
        if step is not None:
            snapshots.update(restored=step, restore_s=time.perf_counter() - t0)
            first_epoch = step + 1
            log(f"resumed from orbax epoch {step}")
    if first_epoch == 0 and os.path.exists(run_name):
        max_iter = search_for_max_iteration(run_name)
        if max_iter is not None:
            log(f"loading Model iter {max_iter}")
            load_checkpoint(run_name, max_iter, model, optimizer)
            first_epoch = max_iter + 1
    if is_lead():
        os.makedirs(run_name, exist_ok=True)

    tb_writer = None
    try:
        if is_lead():
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(os.path.join("logs", run_name, "base"))
    except ImportError:
        pass

    if args.dp:
        step_fn = make_dp_train_step(model, tscene.handler, render_cfg, optimizer, args.stack, mesh=mesh)
    else:
        step_fn = make_train_step(model, tscene.handler, render_cfg, optimizer, args.stack)
    # The viewer: the teacher-forced composite of the last batch while
    # training goes on, the live cached decode when it pauses training.
    stream = LiveViewerStream(model, tscene.handler, render_cfg, args.stack)
    viewer_train_fn = make_viewer_train_fn(stream)
    model.train()
    on_card = device.type == "cuda"
    history, epochs = [], []
    global_step = 0
    for epoch in range(first_epoch, args.epochs):
        try:
            tscene.set_epoch(epoch)
            total_loss, total_tokens = 0.0, 0
            if args.dp:
                # One group of args.dp independent windows per step.
                n_steps = max(1, tscene.size // (args.dp * args.batch_size))
                batch_iter = (tscene.make_batch_group(args.dp) for _ in range(n_steps))
            else:
                batch_iter = tscene.batches()
            for batch in batch_iter:
                if batch is None:
                    continue
                if not args.dp:
                    stream.set_batch(batch)
                if viewer_ok:
                    network_gui.pump_stacked(viewer_train_fn, stream, dataset.source_path, device=device,
                                             group=viewer_group)
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
            log(f"Epoch: {epoch} Loss: {epoch_loss}")
            scheduler.step(epoch_loss)
            epochs.append({"epoch": epoch, "loss": epoch_loss, "lr": scheduler.lr})
            if tb_writer:
                tb_writer.add_scalar("lr", scheduler.lr, epoch)
                tb_writer.add_scalar("dropout", tscene.dropout, epoch)
            if epoch % args.checkpoint_every == 0 and epoch > first_epoch:
                if orbax_mgr is not None:
                    t0 = time.perf_counter()
                    orbax_ckpt.save_state(orbax_mgr, epoch, model, optimizer)  # every rank: the gather
                    snapshots["save_ms"][epoch] = (time.perf_counter() - t0) * 1e3
                else:
                    save_checkpoint(run_name, epoch, model, optimizer)
        except (RuntimeError, FloatingPointError) as e:
            # Crash save: keep what was trained, and go on with the next epoch.
            log(e)
            save_checkpoint(run_name, epoch, model, optimizer)
    if orbax_mgr is not None:
        orbax_mgr.wait_until_finished()
        snapshots["write_s"] = dict(orbax_mgr.write_s)
        if parallel:
            dist.barrier()  # the snapshot is on disk before any rank goes on
    if viewer_group is not None:
        dist.destroy_process_group(viewer_group)
    if tb_writer:
        tb_writer.close()
    log("\nTraining complete.")
    return {"run_name": run_name, "first_epoch": first_epoch, "model": model, "optimizer": optimizer,
            "tscene": tscene, "history": history, "epochs": epochs, "snapshots": snapshots}


if __name__ == "__main__":
    main()
