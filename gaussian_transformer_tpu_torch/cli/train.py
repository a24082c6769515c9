"""3DGS scene-optimization CLI (port of the root ``train.py``).

Same flags, defaults and outputs as the reference: ``cfg_args``,
``input.ply`` and ``cameras.json`` (first run), ``point_cloud/iteration_N/
point_cloud.ply`` at each ``--save_iterations`` (and the last iteration) and
full-state ``chkpnt<N>.npz`` at each ``--checkpoint_iterations``; resume
with ``--start_checkpoint``. ``--orbax_every N`` snapshots the full state
every N iterations under ``<model>/orbax/<iteration>/`` (the newest three,
``train/orbax_ckpt.py``) and a rerun with the same model dir resumes from
the newest. TensorBoard scalars (the reference's) go to the model dir when
``torch.utils.tensorboard`` imports. Runs on the CUDA card unless
``--device cpu`` is given. Progress is printed as plain lines (``--quiet``
silences them). The SIBR remote viewer connects to ``--ip``/``--port``
(default 127.0.0.1:6009): every iteration first serves its requests with
renders of the current Gaussians (``viewer/network_gui.py``). When the
address is taken the run prints ``viewer disabled: ...`` and trains on.

    python -m gaussian_transformer_tpu_torch.cli.train -s <data> -m <model> [--iterations N]
"""

from __future__ import annotations

import os
import sys
import time
from argparse import ArgumentParser

from gaussian_transformer_tpu_torch.config import (
    ModelParams,
    OptConfig,
    OptimizationParams,
    PipelineParams,
    save_cfg_args,
)
from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.scene import Scene
from gaussian_transformer_tpu_torch.train.splat import evaluate_psnr, training
from gaussian_transformer_tpu_torch.utils.general import safe_state
from gaussian_transformer_tpu_torch.viewer.network_gui import bind_viewer


def main(argv=None):
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``). Returns a summary:
    ``model_path``, ``n_alive`` at the end, ``history`` (one dict per step:
    iteration, loss, overflow, and ``phase_ms`` on the card, ``densify`` on a
    densify step), ``render_cfgs`` ([(first iteration, RenderConfig)], one
    entry per budget the trainer tuned) and ``evals`` ({iteration: {split:
    (PSNR, L1)}})."""
    parser = ArgumentParser(description="Training script parameters")
    lp = ModelParams(parser)
    op = OptimizationParams(parser)
    PipelineParams(parser)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument(
        "--test_iterations", nargs="+", type=int, default=[1_000, 2_000, 5_000, 7_000, 30_000]
    )
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    # Snapshots (atomic, bounded history, written in the background) and
    # auto-resume from the newest; 0 disables.
    parser.add_argument("--orbax_every", type=int, default=0)
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    args.save_iterations.append(args.iterations)
    device = resolve_device(args.device)

    print("Optimizing " + args.model_path)
    stdout = sys.stdout
    try:
        safe_state(args.quiet)
        if args.detect_anomaly:
            import torch

            torch.autograd.set_detect_anomaly(True)
        dataset = lp.extract(args)
        opt = OptConfig.from_args(op.extract(args))
        os.makedirs(dataset.model_path, exist_ok=True)
        save_cfg_args(dataset.model_path, dataset)
        viewer_ok = bind_viewer(args.ip, args.port)

        scene = Scene(dataset, sh_degree=dataset.sh_degree, device=device)
        history, evals, render_cfgs = [], {}, []
        tb_writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(dataset.model_path)
        except ImportError:
            print("Tensorboard not available: not logging progress")
        last_t = [time.time()]

        def log_fn(iteration, metrics, loss, l1, overflow, phase_ms, densify, gaussians, render_cfg,
                   bg, testing):
            record = {"iteration": iteration, "loss": loss, "overflow": overflow}
            if tb_writer:
                now = time.time()
                tb_writer.add_scalar("train_loss_patches/l1_loss", l1, iteration)
                tb_writer.add_scalar("train_loss_patches/total_loss", loss, iteration)
                tb_writer.add_scalar("iter_time", (now - last_t[0]) * 1000.0, iteration)
                last_t[0] = now
            if not render_cfgs or render_cfgs[-1][1] != render_cfg:
                render_cfgs.append((iteration, render_cfg))
            if phase_ms is not None:
                record["phase_ms"] = phase_ms
            if densify is not None:
                record["densify"] = densify
                print(f"[ITER {iteration}] densify: {densify}")
            history.append(record)
            print(f"[ITER {iteration}] loss {loss:.6f} overflow {overflow}")
            if testing:
                evals[iteration] = {}
                splits = (("test", scene.get_test_cameras()), ("train", scene.get_train_cameras()[:5]))
                for name, cams in splits:
                    if cams:
                        p, view_l1 = evaluate_psnr(gaussians, cams, render_cfg, bg)
                        evals[iteration][name] = (p, view_l1)
                        print(f"\n[ITER {iteration}] Evaluating {name}: L1 {view_l1} PSNR {p}")
                        if tb_writer:
                            tb_writer.add_scalar(f"{name}/loss_viewpoint - l1_loss", view_l1, iteration)
                            tb_writer.add_scalar(f"{name}/loss_viewpoint - psnr", p, iteration)
                if tb_writer:
                    tb_writer.add_scalar("total_points", gaussians.num_alive, iteration)

        gaussians = training(
            scene,
            opt,
            RenderConfig(),
            white_background=dataset.white_background,
            testing_iterations=set(args.test_iterations),
            saving_iterations=set(args.save_iterations),
            checkpoint_iterations=set(args.checkpoint_iterations),
            start_checkpoint=args.start_checkpoint,
            log_fn=log_fn,
            orbax_dir=dataset.model_path if args.orbax_every else None,
            orbax_every=args.orbax_every,
            viewer=viewer_ok,
        )
        if tb_writer:
            tb_writer.close()
        print("\nTraining complete.")
        return {"model_path": dataset.model_path, "n_alive": gaussians.num_alive,
                "history": history, "render_cfgs": render_cfgs, "evals": evals}
    finally:
        sys.stdout = stdout


if __name__ == "__main__":
    main()
