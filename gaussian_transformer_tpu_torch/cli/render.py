"""Offline render CLI (port of the root ``render.py``).

Loads a trained scene at ``--iteration`` (-1 = latest) and writes the
train/test splits as PNG trees ``<model>/<split>/ours_<iter>/{renders,gt}/
00000.png``, as the reference does. Runs on the CUDA card unless
``--device cpu`` is given.

    python -m gaussian_transformer_tpu_torch.cli.render -m <model_dir> [--skip_train]
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from gaussian_transformer_tpu_torch.config import ModelParams, get_combined_args
from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.render import RenderConfig, render
from gaussian_transformer_tpu_torch.scene import Scene
from gaussian_transformer_tpu_torch.utils.general import safe_state
from gaussian_transformer_tpu_torch.utils.png import write_png


def _to_png_array(chw: torch.Tensor) -> np.ndarray:
    """[3, H, W] float in [0, 1] -> uint8 HWC, truncating as the reference."""
    arr = torch.clamp(chw, 0.0, 1.0).cpu().numpy()
    return (arr.transpose(1, 2, 0) * 255).astype(np.uint8)


@torch.no_grad()
def render_set(model_path, name, iteration, views, gaussians, render_cfg, background):
    """Render and write one split; returns per-view diagnostics."""
    render_path = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gts_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gts_path, exist_ok=True)

    stats = []
    for idx, view in enumerate(views):
        out = render(view, gaussians, render_cfg, bg_color=background)
        write_png(os.path.join(render_path, f"{idx:05d}.png"), _to_png_array(out["render"]))
        write_png(os.path.join(gts_path, f"{idx:05d}.png"), _to_png_array(view.original_image))
        stats.append({
            "split": name,
            "view": idx,
            "overflow": int(out["overflow"]),
            "n_instances": int(out["n_instances"]),
            "n_padded": int(out["n_padded"]),
        })
        print(f"{name} view {idx}: overflow {stats[-1]['overflow']}, "
              f"{stats[-1]['n_instances']} instances")
    return stats


def render_sets(dataset, iteration, skip_train, skip_test, device):
    scene = Scene(dataset, load_iteration=iteration, shuffle=False, sh_degree=dataset.sh_degree,
                  device=device)
    background = torch.tensor(
        [1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0], device=device
    )
    render_cfg = RenderConfig()
    stats = []
    if not skip_train:
        stats += render_set(dataset.model_path, "train", scene.loaded_iter,
                            scene.get_train_cameras(), scene.gaussians, render_cfg, background)
    if not skip_test:
        stats += render_set(dataset.model_path, "test", scene.loaded_iter,
                            scene.get_test_cameras(), scene.gaussians, render_cfg, background)
    return stats


def main(argv=None):
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``); returns the
    per-view diagnostics (overflow, instance counts)."""
    parser = ArgumentParser(description="Testing script parameters")
    model = ModelParams(parser, sentinel=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = get_combined_args(parser, argv)
    device = resolve_device(getattr(args, "device", None))  # dropped from args when None
    print("Rendering " + args.model_path)
    stdout = sys.stdout
    try:
        safe_state(args.quiet)
        return render_sets(model.extract(args), args.iteration, args.skip_train, args.skip_test,
                           device)
    finally:
        sys.stdout = stdout


if __name__ == "__main__":
    main()
