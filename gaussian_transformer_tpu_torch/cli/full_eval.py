"""The full evaluation chain (port of the root ``full_eval.py``).

Trains, renders (iterations 7000 and 30000) and scores the 13 standard
scenes, MipNeRF360 x9 (``images_4`` for the outdoor scenes, ``images_2``
for the indoor ones), Tanks&Temples x2 and DeepBlending x2, by running the
port's ``cli.train``, ``cli.render`` and ``cli.metrics`` as subprocesses
with the root script's flags. The one addition is ``--device``: given, it
is passed on to every child (``--device cpu`` runs the chain on the CPU).

    python -m gaussian_transformer_tpu_torch.cli.full_eval -m360 <dir> -tat <dir> -db <dir> [--output_path ./eval]
    python -m gaussian_transformer_tpu_torch.cli.full_eval --skip_training --skip_rendering --output_path <dir>
"""

from __future__ import annotations

import os
import subprocess
import sys
from argparse import ArgumentParser

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump", "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]

CLI = "gaussian_transformer_tpu_torch.cli"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(cmd) -> int:
    """Run one child (the repository on its ``PYTHONPATH``); returns its exit
    code. A failed child does not stop the chain, as in the root script."""
    print("+", " ".join(cmd))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.run(cmd, check=False, env=env).returncode


def main(argv=None):
    """Run the chain on ``argv`` (default: ``sys.argv[1:]``). Returns
    [(command, exit code)] in the order run."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--device", default=None, help="torch device of every child (default: the CUDA card)")
    args, _ = parser.parse_known_args(argv)

    all_scenes = (
        mipnerf360_outdoor_scenes
        + mipnerf360_indoor_scenes
        + tanks_and_temples_scenes
        + deep_blending_scenes
    )

    if not args.skip_training or not args.skip_rendering:
        parser.add_argument("--mipnerf360", "-m360", required=True, type=str)
        parser.add_argument("--tanksandtemples", "-tat", required=True, type=str)
        parser.add_argument("--deepblending", "-db", required=True, type=str)
        args = parser.parse_args(argv)

    py = sys.executable
    device = [] if args.device is None else ["--device", args.device]
    done = []

    def child(module, rest):
        cmd = [py, "-m", f"{CLI}.{module}"] + rest + device
        done.append((cmd, run(cmd)))

    if not args.skip_training:
        common = ["--quiet", "--eval", "--test_iterations", "-1"]
        for scene in mipnerf360_outdoor_scenes:
            child("train", ["-s", f"{args.mipnerf360}/{scene}", "-i", "images_4",
                            "-m", f"{args.output_path}/{scene}"] + common)
        for scene in mipnerf360_indoor_scenes:
            child("train", ["-s", f"{args.mipnerf360}/{scene}", "-i", "images_2",
                            "-m", f"{args.output_path}/{scene}"] + common)
        for scene in tanks_and_temples_scenes:
            child("train", ["-s", f"{args.tanksandtemples}/{scene}",
                            "-m", f"{args.output_path}/{scene}"] + common)
        for scene in deep_blending_scenes:
            child("train", ["-s", f"{args.deepblending}/{scene}",
                            "-m", f"{args.output_path}/{scene}"] + common)

    if not args.skip_rendering:
        all_sources = (
            [f"{args.mipnerf360}/{s}" for s in mipnerf360_outdoor_scenes + mipnerf360_indoor_scenes]
            + [f"{args.tanksandtemples}/{s}" for s in tanks_and_temples_scenes]
            + [f"{args.deepblending}/{s}" for s in deep_blending_scenes]
        )
        common = ["--quiet", "--eval", "--skip_train"]
        for scene, source in zip(all_scenes, all_sources):
            for iteration in ("7000", "30000"):
                child("render", ["--iteration", iteration, "-s", source,
                                 "-m", f"{args.output_path}/{scene}"] + common)

    if not args.skip_metrics:
        child("metrics", ["-m"] + [f"{args.output_path}/{s}" for s in all_scenes])
    return done


if __name__ == "__main__":
    main()
