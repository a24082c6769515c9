"""Metrics CLI (port of the root ``metrics.py``).

Walks ``<model>/test/<method>/{renders,gt}``, computes per-view SSIM and PSNR,
and writes ``results.json`` and ``per_view.json`` in the reference's format.
LPIPS is reported as null: the port has no LPIPS network yet (the reference
also reports null when its weights are missing). SSIM goes through the fused
kernel on the card; PSNR is the reference's mean of per-channel PSNRs.

    python -m gaussian_transformer_tpu_torch.cli.metrics -m <model_dir> [...]
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.ops.losses import ssim
from gaussian_transformer_tpu_torch.utils.image import psnr
from gaussian_transformer_tpu_torch.utils.png import read_png


def read_images(renders_dir: Path, gt_dir: Path):
    """Float32 CHW arrays in [0, 1] of every render and its ground truth."""
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        render = read_png(str(renders_dir / fname)).astype(np.float32) / 255.0
        gt = read_png(str(gt_dir / fname)).astype(np.float32) / 255.0
        renders.append(render[..., :3].transpose(2, 0, 1))
        gts.append(gt[..., :3].transpose(2, 0, 1))
        names.append(fname)
    return renders, gts, names


@torch.no_grad()
def evaluate(model_paths, device):
    full_dict = {}
    per_view_dict = {}
    print("LPIPS is not ported yet — reporting SSIM/PSNR only (lpips = null)")

    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full_dict[scene_dir] = {}
        per_view_dict[scene_dir] = {}
        test_dir = Path(scene_dir) / "test"

        for method in sorted(os.listdir(test_dir)):
            print("Method:", method)
            method_dir = test_dir / method
            renders, gts, image_names = read_images(method_dir / "renders", method_dir / "gt")

            ssims, psnrs, lpipss = [], [], []
            for r, g in zip(renders, gts):
                rt = torch.from_numpy(np.ascontiguousarray(r)).to(device)
                gt = torch.from_numpy(np.ascontiguousarray(g)).to(device)
                ssims.append(float(ssim(rt, gt)))
                psnrs.append(float(torch.mean(psnr(rt, gt))))
                lpipss.append(None)

            print("  SSIM : {:>12.7f}".format(np.mean(ssims)))
            print("  PSNR : {:>12.7f}".format(np.mean(psnrs)))

            full_dict[scene_dir][method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
                "LPIPS": None,
            }
            per_view_dict[scene_dir][method] = {
                "SSIM": dict(zip(image_names, ssims)),
                "PSNR": dict(zip(image_names, psnrs)),
                "LPIPS": dict(zip(image_names, lpipss)),
            }

        with open(scene_dir + "/results.json", "w") as fp:
            json.dump(full_dict[scene_dir], fp, indent=True)
        with open(scene_dir + "/per_view.json", "w") as fp:
            json.dump(per_view_dict[scene_dir], fp, indent=True)
    return full_dict


def main(argv=None):
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``); returns
    {model_path: {method: {"SSIM", "PSNR", "LPIPS"}}}."""
    parser = ArgumentParser(description="Training script parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+", type=str, default=[])
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, resolve_device(args.device))


if __name__ == "__main__":
    main()
