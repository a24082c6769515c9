"""The full-scale stacked-transformer campaign on one card (counterpart of
``tools/stacked_campaign.py``).

    python -m gaussian_transformer_tpu_torch.tools.stacked_campaign [--steps 1200]
        [--bucket 96] [--batch_size 4] [--lr 5e-4] [--out build/torch_stacked_campaign]
        [--ckpt_every 150] [--resume] [--orbax] [--profile N] [--device cpu]
    ... --report-only     # RUN.md again from <out>/loss_curve.csv and meta.json
    ... --eval            # EVAL.md: the newest checkpoint on a held-out window
    ... --smoke           # the reference's tiny sizes (30 steps unless --steps)

The reference's flagship recipe: STACK 8, d_model 26 * 2^8 = 6656, N 2, h
8, dropout 0.1 (1,905,446,400 parameters), bf16 ``dtype`` and
``param_dtype``, ``train/adafactor.py Adafactor`` (optax's
``adafactor(learning_rate=1.0, min_dim_size_to_factor=128)``) with its
update scaled by the lr of a ``ReduceLROnPlateau`` (5e-4, stepped on each
epoch's loss per token), batches of 4 cameras, one bucket of 96 fat tokens,
the decode checkpointed per step. ``--smoke`` picks STACK 4, 8 cameras at
160x120, bucket 8 and float32 parameters, and no device.

The scene: the reference trains on the table_ds point cloud (17,618 points),
which is not in the repo. In its place, ``tools/synthetic.py
synthetic_scene(17_618, seed 5)`` at SH degree 1 (``chip_smoke.py``
section 16's scene), with the reference's ring of cameras (32 at 320x240,
FoV 70 degrees, at twice the scene's extent from its centre; no images:
the loss renders its own targets).

Writes under ``--out`` (default ``build/torch_stacked_campaign``, which
git ignores): ``meta.json``, ``loss_curve.csv`` (step, epoch,
loss_per_token, chamfer, ms: the host's clock around a step and the read of
its loss), ``RUN.md``, ``EVAL.md``, and the checkpoints every
``--ckpt_every`` steps and at the end (``checkpoint_step<N>/``, the JAX
package's npz layout, ~3.8 GB at full scale; with ``--orbax``,
``orbax/<step>/``, the newest three, written synchronously). A ``STOP``
file in ``--out`` ends the run after the current step, with a checkpoint.
``--profile N`` runs step N under ``torch.profiler`` and writes its CUDA
kernels' device time by name to ``profile_step<N>.txt`` (a profiler window
slows the host's later launches, so profile the last step). Runs on the
CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
GAUSSIANS = 17_618  # the reference scene's points (table_ds)
SCENE_SEED = 5  # chip_smoke.py section 16: synthetic_scene(17_618, seed 0 + 5)
DROPOUT_BASE_SEED = 42  # model.train(): fresh dropout masks every step
EVAL_SEED, EVAL_EPOCH, EVAL_CAMS = 1234, 50, 8  # the held-out window and the PSNR cameras


def write_report(out_dir: str, meta: dict) -> None:
    """RUN.md from the loss-curve CSV: windowed chamfer table + first/last
    window means (the JAX tool's report)."""
    csv_path = os.path.join(out_dir, "loss_curve.csv")
    try:
        rows = np.genfromtxt(csv_path, delimiter=",", names=True)
    except IndexError:  # header-only curve (run killed before any flush)
        print("loss curve is empty; no report written")
        return
    cham = np.atleast_1d(np.asarray(rows["chamfer"], np.float64))
    steps = np.atleast_1d(np.asarray(rows["step"], np.int64))
    ms = np.atleast_1d(np.asarray(rows["ms"], np.float64))
    k = max(len(cham) // 12, 1)
    card = meta.get("card") or meta["device"]  # the card's name and power limit
    with open(os.path.join(out_dir, "RUN.md"), "w") as f:
        f.write("# Full-scale stacked campaign\n\n")
        f.write(
            f"STACK={meta['stack']} d_model={meta['d_model']} N={meta['layers']} "
            f"params={meta['n_params']/1e9:.2f}B (bf16 params, Adafactor, "
            f"decode-scan remat) — {len(cham)} steps on {card}; "
            f"median {np.median(ms[4:] if len(ms) > 8 else ms):.0f} ms/step\n\n"
        )
        if meta.get("scene"):
            f.write(f"scene: {meta['scene']}\n\n")
        f.write("| step | chamfer (mean over window) |\n|---|---|\n")
        for i in range(0, len(cham), k):
            f.write(f"| {int(steps[i])} | {np.mean(cham[i:i+k]):.4f} |\n")
        first, last = np.mean(cham[:k]), np.mean(cham[-k:])
        f.write(f"\nchamfer first-window {first:.4f} -> last-window {last:.4f}\n")
        print(f"chamfer {first:.4f} -> {last:.4f} over {len(cham)} steps")


def build_scene_stub(n_cams=32, width=320, height=240, device=None, gaussians=GAUSSIANS, seed=SCENE_SEED):
    """A seeded synthetic SH-1 scene as the trained-scene stand-in, and the
    reference's camera ring (cameras carry no images)."""
    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.scene.cameras import Camera
    from gaussian_transformer_tpu_torch.tools.synthetic import synthetic_scene

    fields = synthetic_scene(gaussians, seed)
    fields["features_rest"] = fields["features_rest"][:, :3]  # SH degree 1
    scene = scene_from_numpy(fields, 1, device)
    points = fields["xyz"].astype(np.float64)
    center = points.mean(0)
    extent = float(np.abs(points - center).max())

    cams = []
    for i in range(n_cams):
        ang = 2 * math.pi * i / n_cams
        Rw2c = np.array([[math.cos(ang), 0, -math.sin(ang)], [0, 1, 0], [math.sin(ang), 0, math.cos(ang)]])
        t = np.asarray(-Rw2c @ center + np.array([0, 0, extent * 2.0]))
        cams.append(Camera.create(colmap_id=i, R=Rw2c.T, T=t, fovx=math.radians(70),
                                  fovy=math.radians(70 * height / width), image=None, gt_alpha_mask=None,
                                  image_name=f"cam{i}", uid=i, width=width, height=height, device=device))

    class SceneStub:
        def __init__(self):
            self.gaussians = scene

        def get_train_cameras(self, scale=1.0):
            return cams

    return SceneStub()


def _setup(args, gaussians: int):
    """The campaign's device, scene of ``gaussians``, batcher, model and
    optimizer."""
    from gaussian_transformer_tpu_torch.device import resolve_device
    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.train.adafactor import Adafactor
    from gaussian_transformer_tpu_torch.train.stacked import TrainingScene, make_stacked_model

    device = resolve_device(args.device)
    stack = 4 if args.smoke else 8
    scene_obj = build_scene_stub(n_cams=8 if args.smoke else 32, width=160 if args.smoke else 320,
                                 height=120 if args.smoke else 240, device=device, gaussians=gaussians)
    render_cfg = RenderConfig()
    tscene = TrainingScene(scene_obj, render_cfg, batch_size=args.batch_size, stack=stack,
                           bucket=8 if args.smoke else args.bucket)
    model = make_stacked_model(stack, 2, 0, seed=0, device=device, dtype=torch.bfloat16,
                               param_dtype=torch.float32 if args.smoke else torch.bfloat16)
    optimizer = Adafactor(model.parameters())
    return device, stack, scene_obj, render_cfg, tscene, model, optimizer


def _latest_checkpoint(out: str):
    tags = [int(d.split("_step")[1]) for d in os.listdir(out) if d.startswith("checkpoint_step")]
    return max(tags) if tags else None


def _next_epoch(csv_path: str) -> int:
    try:
        rows = np.genfromtxt(csv_path, delimiter=",", names=True)
        return int(np.atleast_1d(rows["epoch"])[-1]) + 1
    except (OSError, IndexError, KeyError, ValueError):  # header-only or missing curve
        return 0


def run_eval(args, gaussians: int = GAUSSIANS) -> dict:
    """The end-of-campaign quality eval: the newest checkpoint greedy-decodes
    one held-out window (``RandomState(1234)``, the epoch-50 schedule,
    cameras 0-3) without dropout; chamfer between the decoded and target
    Gaussians, and the PSNR of the decoded scene rendered against the target
    scene rendered over cameras 0-7. Writes <out>/EVAL.md; returns the
    numbers."""
    from gaussian_transformer_tpu_torch.models.codec import unflatten_gaussians
    from gaussian_transformer_tpu_torch.ops.chamfer import chamfer_distance
    from gaussian_transformer_tpu_torch.render import render
    from gaussian_transformer_tpu_torch.train import orbax_ckpt
    from gaussian_transformer_tpu_torch.train.stacked import (
        fuzzy_token_equal,
        greedy_decode,
        load_checkpoint,
        pad_token,
        unstack_tokens,
    )
    from gaussian_transformer_tpu_torch.utils.image import psnr as psnr_fn

    device, stack, scene_obj, render_cfg, tscene, model, optimizer = _setup(args, gaussians)
    if os.path.isdir(os.path.join(args.out, "orbax")):
        mgr = orbax_ckpt.make_manager(args.out)
        snap = orbax_ckpt.restore(mgr, {"params": None, "opt_state": None})
        if snap is None:
            raise FileNotFoundError(f"no snapshot under {args.out}/orbax")
        model.load_state_dict(snap["params"])
        latest = int(mgr.latest_step())
        print(f"evaluating orbax step {latest}")
    else:
        latest = _latest_checkpoint(args.out)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint_step* under {args.out}")
        load_checkpoint(args.out, f"step{latest}", model, optimizer)
        print(f"evaluating checkpoint_step{latest}")
    model.eval()

    tscene.rng = np.random.RandomState(EVAL_SEED)
    tscene.set_epoch(EVAL_EPOCH)
    batch = tscene.make_batch(list(range(min(4, tscene.size))))
    if batch is None:
        raise RuntimeError("the held-out window is too short")
    with torch.no_grad():
        pred = greedy_decode(model, batch.src, batch.src_mask, batch.trg_y.shape[1] + 1, stack)[:, 1:]
        pred_list = unstack_tokens(pred[0], stack)
        tgt_list = unstack_tokens(batch.trg_y[0], stack)
        valid = (~fuzzy_token_equal(batch.trg_y[0], pad_token(stack))).repeat_interleave(2**stack)
        n_valid = float(torch.clamp(valid.float().sum(), min=1.0))
        d1, d2, _, _ = chamfer_distance(pred_list[None], tgt_list[None], a_valid=valid[None], b_valid=valid[None])
        chamfer = float(d1.sum()) / n_valid + float(d2.sum()) / n_valid
        g_pred = tscene.handler.denormalize(unflatten_gaussians(pred_list)).replace(alive=valid)
        g_tgt = tscene.handler.denormalize(unflatten_gaussians(tgt_list)).replace(alive=valid)
        clip = lambda img: torch.clamp(torch.nan_to_num(img), 0.0, 1.0)
        psnrs = []
        for cam in scene_obj.get_train_cameras()[:EVAL_CAMS]:
            a = clip(render(cam, g_pred, render_cfg)["render"])
            b = clip(render(cam, g_tgt, render_cfg)["render"])
            psnrs.append(float(psnr_fn(a, b).mean()))
    mean_psnr = float(np.mean(psnrs))

    lines = [
        "# End-of-campaign quality eval",
        "",
        f"checkpoint_step{latest}; held-out window {int(n_valid)} gaussians "
        f"({batch.trg_y.shape[1]} fat tokens), decoded autoregressively.",
        "",
        f"* chamfer (decoded vs target, per gaussian): **{chamfer:.4f}**",
        f"* PSNR (decoded scene rendered vs target scene rendered, "
        f"{len(psnrs)} cameras): **{mean_psnr:.2f} dB** "
        f"(min {min(psnrs):.2f}, max {max(psnrs):.2f})",
        "",
    ]
    with open(os.path.join(args.out, "EVAL.md"), "w") as f:
        f.write("\n".join(lines))
    print("\n".join(lines))
    return {"step": latest, "chamfer": chamfer, "psnr": mean_psnr, "psnrs": psnrs, "n_valid": int(n_valid),
            "trg_len": int(batch.trg_y.shape[1])}


def _parse(argv):
    parser = argparse.ArgumentParser(description="the stacked campaign (STACK 8, d_model 6656, N 2, bf16, "
                                                 "Adafactor) on one card")
    parser.add_argument("--smoke", action="store_true",
                        help="the reference's tiny sizes: STACK 4, 8 cameras at 160x120, bucket 8, float32 "
                        "parameters, 30 steps unless --steps")
    parser.add_argument("--steps", type=int, default=None, help="optimizer steps (default 1200; --smoke: 30)")
    parser.add_argument("--bucket", type=int, default=96)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--out", default=str(REPO / "build" / "torch_stacked_campaign"))
    parser.add_argument("--ckpt_every", type=int, default=150, help="periodic checkpoint cadence (steps)")
    parser.add_argument("--resume", action="store_true", help="resume from the latest checkpoint in --out")
    parser.add_argument("--report-only", action="store_true",
                        help="regenerate RUN.md from the existing loss curve")
    parser.add_argument("--eval", action="store_true",
                        help="greedy-decode a held-out window from the latest checkpoint, render decoded vs "
                        "target over the camera ring, write EVAL.md")
    parser.add_argument("--orbax", action="store_true",
                        help="snapshots under <out>/orbax/ (train/orbax_ckpt.py, synchronous, the newest "
                        "three) instead of the npz checkpoints")
    parser.add_argument("--profile", type=int, default=None,
                        help="run this step under torch.profiler (card only): <out>/profile_step<N>.txt")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return parser.parse_args(argv)


def _profiled(prof, path: str, cuda_ms: float) -> dict:
    """The profiled step's CUDA kernels: their device time by name into
    ``path``; returns kernel ms, kernel count and the device's idle share."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40, max_name_column_width=70))
    return {"kernel_ms": busy, "kernels": len(kernels), "idle": 1.0 - busy / cuda_ms}


def main(argv=None, gaussians: int = GAUSSIANS):
    """Run the campaign on ``argv`` (on a scene of ``gaussians``: the
    reference's count unless a rehearsal asks for fewer). Returns a summary: ``model``,
    ``optimizer``, ``tscene``, ``meta``, ``history`` (one dict per step:
    step, epoch, loss, chamfer, img_loss, ntokens, src_len, trg_len, ms on
    the host's clock, and cuda_ms by CUDA events on the card), ``epochs``
    (epoch, loss per token, lr after the scheduler), ``first_step`` and
    ``global_step``; with ``--eval``, the eval's numbers; with
    ``--report-only``, None."""
    from gaussian_transformer_tpu_torch.models.transformer import count_params
    from gaussian_transformer_tpu_torch.tools.card import smi_line
    from gaussian_transformer_tpu_torch.train import orbax_ckpt
    from gaussian_transformer_tpu_torch.train.stacked import (
        ReduceLROnPlateau,
        load_checkpoint,
        make_train_step,
        save_checkpoint,
    )

    args = _parse(argv)
    if args.report_only:
        with open(os.path.join(args.out, "meta.json")) as f:
            write_report(args.out, json.load(f))
        return None
    os.makedirs(args.out, exist_ok=True)
    if args.eval:
        return run_eval(args, gaussians)

    device, stack, scene_obj, render_cfg, tscene, model, optimizer = _setup(args, gaussians)
    on_card = device.type == "cuda"
    layers, D = model.N, model.d_model
    steps_target = args.steps if args.steps is not None else (30 if args.smoke else 1200)
    print(f"scene: {tscene.n_alive} gaussians, {tscene.size} cameras, D={D}, N={layers}, stack={stack}")
    n_params = count_params(model)
    bytes_per = model.param_dtype.itemsize
    print(f"params: {n_params/1e9:.2f}B ({n_params * bytes_per / 1e9:.1f} GB, {model.param_dtype})")
    scheduler = ReduceLROnPlateau(lr=args.lr)
    step_fn = make_train_step(model, tscene.handler, render_cfg, optimizer, stack)
    model.train()

    meta = {"stack": stack, "d_model": D, "layers": layers, "n_params": n_params,
            "device": torch.cuda.get_device_name(device) if on_card else "cpu",
            "card": smi_line(device) if on_card else None,
            "dtype": str(model.dtype).removeprefix("torch."),
            "param_dtype": str(model.param_dtype).removeprefix("torch."),
            "scene": f"synthetic_scene({tscene.n_alive}, seed {SCENE_SEED}) at SH 1 (table_ds is not in the "
                     f"repo), {tscene.size} ring cameras at {scene_obj.get_train_cameras()[0].image_width}x"
                     f"{scene_obj.get_train_cameras()[0].image_height}, bucket {tscene.bucket}"}
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f)
    csv_path = os.path.join(args.out, "loss_curve.csv")

    mgr = orbax_ckpt.make_manager(args.out, max_to_keep=3, async_save=False) if args.orbax else None
    global_step, epoch = 0, 0
    if args.resume and mgr is not None:
        snap = orbax_ckpt.restore(mgr, {"params": None, "opt_state": None})
        if snap is not None:
            model.load_state_dict(snap["params"])
            optimizer.load_state_dict(snap["opt_state"])
            global_step, epoch = int(mgr.latest_step()), _next_epoch(csv_path)
            print(f"resumed from orbax step {global_step} (epoch {epoch})")
    elif args.resume:
        latest = _latest_checkpoint(args.out)
        if latest is not None:
            load_checkpoint(args.out, f"step{latest}", model, optimizer)
            global_step, epoch = latest, _next_epoch(csv_path)
            print(f"resumed from checkpoint_step{latest} (epoch {epoch})")
    first_step = global_step

    def save():
        if mgr is not None:
            orbax_ckpt.save(mgr, global_step, {"params": model.state_dict(), "opt_state": optimizer.state_dict()})
        else:
            save_checkpoint(args.out, f"step{global_step}", model, optimizer)

    history, epochs, saved_at = [], [], None
    stop_file = os.path.join(args.out, "STOP")
    stopping = False
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    with open(csv_path, "a") as csv:
        if csv.tell() == 0:
            csv.write("step,epoch,loss_per_token,chamfer,ms\n")
        while global_step < steps_target and not stopping:
            tscene.set_epoch(epoch)
            total_loss, total_tokens = 0.0, 0
            for batch in tscene.batches():
                if batch is None:
                    continue
                profiled = on_card and args.profile == global_step + 1
                window = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                             torch.profiler.ProfilerActivity.CUDA])
                          if profiled else contextlib.nullcontext())
                with window as prof:
                    if on_card:
                        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                        ev[0].record()
                    t0 = time.perf_counter()
                    loss, metrics = step_fn(batch.src, batch.trg_y, batch.cameras, scheduler.lr, batch.src_mask,
                                            (DROPOUT_BASE_SEED, global_step))
                    loss = float(loss)
                    dt = (time.perf_counter() - t0) * 1e3
                rec = {"step": global_step + 1, "epoch": epoch, "loss": loss, "chamfer": float(metrics["chamfer"]),
                       "img_loss": float(metrics["img_loss"]), "ntokens": batch.ntokens,
                       "src_len": batch.src.shape[1], "trg_len": batch.trg_y.shape[1], "ms": dt}
                if on_card:
                    ev[1].record()
                    ev[1].synchronize()
                    rec["cuda_ms"] = ev[0].elapsed_time(ev[1])
                if profiled:
                    path = os.path.join(args.out, f"profile_step{global_step + 1}.txt")
                    rec["profile"] = _profiled(prof, path, rec["cuda_ms"])
                    print(f"[{meta['card']}] step {global_step + 1} under torch.profiler: {rec['cuda_ms']:.1f} ms, "
                          f"{rec['profile']['kernels']} kernels, {rec['profile']['kernel_ms']:.1f} ms of kernel "
                          f"time (device idle {rec['profile']['idle']:.3f}); by kernel: {path}")
                if not history and on_card:
                    print(f"first step: {dt / 1e3:.1f} s; peak memory "
                          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {global_step}")
                history.append(rec)
                total_loss += loss
                total_tokens += batch.ntokens
                global_step += 1
                csv.write(f"{global_step},{epoch},{loss / max(batch.ntokens, 1):.6f},{rec['chamfer']:.6f},"
                          f"{dt:.3f}\n")
                csv.flush()
                if global_step % 25 == 0:
                    print(f"step {global_step} chamfer {rec['chamfer']:.4f} "
                          f"loss/token {loss / max(batch.ntokens, 1):.4f} {dt:.0f}ms", flush=True)
                if global_step % args.ckpt_every == 0:
                    save()
                    saved_at = global_step
                if os.path.exists(stop_file):
                    print(f"STOP file seen at step {global_step}; saving and exiting")
                    stopping = True
                if global_step >= steps_target or stopping:
                    break
            epoch_loss = total_loss / max(total_tokens, 1)
            scheduler.step(epoch_loss)
            epochs.append({"epoch": epoch, "loss": epoch_loss, "lr": scheduler.lr})
            epoch += 1

    if saved_at != global_step:
        save()
    if mgr is not None:
        mgr.wait_until_finished()
        print(f"saved orbax step {global_step} under {args.out}/orbax")
    else:
        print(f"saved checkpoint_step{global_step} under {args.out}")
    if on_card and history:
        print(f"[{meta['card']}] median step {np.median([h['cuda_ms'] for h in history]):.2f} ms (CUDA events) over "
              f"{len(history)} steps; peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    write_report(args.out, meta)
    return {"model": model, "optimizer": optimizer, "tscene": tscene, "meta": meta, "history": history,
            "epochs": epochs, "first_step": first_step, "global_step": global_step}


if __name__ == "__main__":
    main()
