"""The port's full-pipeline quality gate (counterpart of ``tools/full_gate.py``).

    python -m gaussian_transformer_tpu_torch.tools.full_gate [--iters 15000] [--cams 28]
        [--seed-points 10000] [--gt-size 200000] [--width 1280] [--height 720]
        [--psnr-floor 25] [--min-final 150000] [--grad-threshold 0.0001]
        [--out build/full_gate] [--work <out>/work] [--device cpu]
        [any cli.train flag, e.g. --densify_from_iter 50]

A multi-camera scene goes through the port's own CLI chain: ``cli.train``
with densification growing the scene from a sparse seed, then
``cli.render`` and ``cli.metrics``; the gate passes when the test views'
PSNR and the final size reach their floors. The defaults are the shape of
the JAX package's recorded run (``logs/r5/full_gate.md``): 15,000
iterations, 28 cameras at 1280x720, a 10,000-point seed, a 200,000-Gaussian
ground truth and ``--densify_grad_threshold 0.0001``.

The ground truth is ``tools/synthetic.py synthetic_scene`` (SH degree 3),
rendered by the port from a ring of tilted cameras around it at twice its
extent, as the reference gate places its ring. The dataset is COLMAP text:
``sparse/0/cameras.txt`` (one PINHOLE camera), ``images.txt`` (the
world-to-camera rotations through ``scene/colmap.py rotmat2qvec``),
``points3D.txt`` (a random subsample of the ground truth's centres with
their DC colours, as SfM would give) and PNG images. A ground-truth view
that overflows its render budgets fails the gate.

The CLIs run in this process through their ``main(argv)``, so the kernel
launch counters (K1-K4) are read around each stage. Flags this tool does
not know go to ``cli.train``; ``--device`` goes to all three CLIs. Writes
``full_gate.md`` and ``full_gate_results.json`` under ``--out``: the PSNR,
SSIM and final size (from the PLY header), the wall time of each stage, the
steps whose render overflowed, the capacity doublings, the launches per
step, the step's phases by 1000-iteration window and the card's name and
power limit. Exits 1 on FAIL.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.tools.card import kernel_counters, read_counts, smi_line, zero_counts

REPO = Path(__file__).resolve().parents[2]
FOVX_DEG = 70.0
SEED_RNG = 7  # the reference gate's seed-subsample generator
GT_SEED = 0  # the ground-truth scene's seed
WINDOW = 1000  # iterations per row of the phase table


def ring_w2c(i: int, cams: int, center: np.ndarray, extent: float):
    """World-to-camera (R, t) of ring camera ``i``: a turn about y, a tilt
    of 0.35 sin(3 angle) about x, at 2 x extent from the centre along the
    view axis (``tools/full_gate.py:72-87``)."""
    ang = 2 * math.pi * i / cams
    tilt = 0.35 * math.sin(3 * ang)
    Ry = np.array([[math.cos(ang), 0, -math.sin(ang)], [0, 1, 0], [math.sin(ang), 0, math.cos(ang)]])
    Rx = np.array([[1, 0, 0], [0, math.cos(tilt), -math.sin(tilt)], [0, math.sin(tilt), math.cos(tilt)]])
    R = Rx @ Ry
    return R, -R @ center + np.array([0.0, 0.0, 2.0 * extent])


def build_scene_dir(root, cams: int, width: int, height: int, gt_size: int, seed_points: int, seed: int,
                    device) -> dict:
    """Write the gate's COLMAP text dataset under ``root``. Returns
    {"R": [world-to-camera rotations], "T": [translations], "names": [...],
    "gt_instances": [instances a ground-truth view binned]}."""
    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.render import RenderConfig, render
    from gaussian_transformer_tpu_torch.scene.cameras import Camera
    from gaussian_transformer_tpu_torch.scene.colmap import rotmat2qvec
    from gaussian_transformer_tpu_torch.tools.synthetic import synthetic_scene
    from gaussian_transformer_tpu_torch.utils.png import write_png
    from gaussian_transformer_tpu_torch.utils.sh import sh_to_rgb

    root = Path(root)
    fields = synthetic_scene(gt_size, seed)
    target = scene_from_numpy(fields, 3, device)
    xyz = fields["xyz"].astype(np.float64)
    center = xyz.mean(0)
    extent = float(np.abs(xyz - center).max())
    W, H = width, height
    fovx = math.radians(FOVX_DEG)
    focal = W / (2 * math.tan(fovx / 2))
    fovy = 2 * math.atan(H / (2 * focal))

    (root / "sparse/0").mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "sparse/0/cameras.txt").write_text(f"# Camera list\n1 PINHOLE {W} {H} {focal} {focal} {W / 2} {H / 2}\n")
    cfg, bg = RenderConfig(), torch.zeros(3, device=device)
    lines, out = ["# Image list"], {"R": [], "T": [], "names": [], "gt_instances": []}
    for i in range(cams):
        Rw2c, tvec = ring_w2c(i, cams, center, extent)
        cam = Camera.create(i, Rw2c.T, tvec, fovx, fovy, None, None, f"im{i}", i, width=W, height=H,
                            device=device)
        with torch.no_grad():
            res = render(cam, target, cfg, bg_color=bg)
        if int(res["overflow"]):
            raise RuntimeError(f"ground-truth view {i} overflowed its render budgets ({int(res['overflow'])})")
        img = torch.clamp(res["render"], 0.0, 1.0).cpu().numpy().transpose(1, 2, 0)
        name = f"{i:03d}.png"
        write_png(str(root / "images" / name), (img * 255).astype(np.uint8))
        q = rotmat2qvec(Rw2c)
        lines += [f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} {tvec[0]} {tvec[1]} {tvec[2]} 1 {name}", ""]
        out["R"].append(Rw2c)
        out["T"].append(tvec)
        out["names"].append(name)
        out["gt_instances"].append(int(res["n_instances"]))
    (root / "sparse/0/images.txt").write_text("\n".join(lines) + "\n")

    rng = np.random.RandomState(SEED_RNG)
    cols = np.clip(sh_to_rgb(fields["features_dc"][:, 0, :]), 0, 1)
    sel = rng.choice(gt_size, size=seed_points, replace=False)
    with open(root / "sparse/0/points3D.txt", "w") as f:
        f.write("# 3D point list\n")
        for j, i in enumerate(sel):
            r, g, b = (cols[i] * 255).astype(np.uint8)
            f.write(f"{j + 1} {xyz[i, 0]} {xyz[i, 1]} {xyz[i, 2]} {r} {g} {b} 0.5 1 0\n")
    return out


def ply_vertex_count(path) -> int:
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"element vertex"):
                return int(line.split()[-1])
            if line.startswith(b"end_header"):
                break
    raise ValueError(f"{path}: no vertex element in the header")


def phase_windows(history, window: int = WINDOW) -> list:
    """The train steps' medians by window of ``window`` iterations: step ms
    and each phase's ms (on the card), the steps that overflowed, and the
    alive count after the window's last densify pass."""
    rows, n_alive = [], None
    for lo in range(0, history[-1]["iteration"] if history else 0, window):
        steps = [h for h in history if lo < h["iteration"] <= lo + window]
        if not steps:
            continue
        for h in steps:
            if "densify" in h:
                n_alive = h["densify"]["n_alive"]
        row = {"iterations": f"{steps[0]['iteration']}-{steps[-1]['iteration']}",
               "overflowed_steps": sum(1 for h in steps if h["overflow"]), "n_alive": n_alive}
        timed = [h["phase_ms"] for h in steps if "phase_ms" in h and "densify" not in h]
        if timed:
            row["step_ms"] = float(np.median([sum(p.values()) for p in timed]))
            row.update({f"{k}_ms": float(np.median([p[k] for p in timed])) for k in timed[0]})
        rows.append(row)
    return rows


def gate_verdict(psnr: float, n_final: int, psnr_floor: float, min_final: int) -> str:
    return "PASS" if math.isfinite(psnr) and psnr >= psnr_floor and n_final >= min_final else "FAIL"


def run_gate(args, extra_train_args=()) -> dict:
    """Build the dataset, run the chain, write the record; returns the results."""
    from gaussian_transformer_tpu_torch.cli import metrics as cli_metrics
    from gaussian_transformer_tpu_torch.cli import render as cli_render
    from gaussian_transformer_tpu_torch.cli import train as cli_train

    device = resolve_device(args.device)
    dev_arg = [] if args.device is None else ["--device", args.device]
    out_dir = Path(args.out)
    work = Path(args.work) if args.work else out_dir / "work"
    scene_dir, model_dir = work / "scene", work / "model"
    # A stale model dir would satisfy the PLY parse even if this run's
    # training failed: start clean.
    shutil.rmtree(work, ignore_errors=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = smi_line(device)
    counters = kernel_counters()
    times, launches = {}, {}

    def stage(name, fn):
        zero_counts(counters)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        res = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.time() - t0
        launches[name] = read_counts(counters)
        print(f"[{smi}] {name}: {times[name]:.1f} s, launches {launches[name]}", flush=True)
        return res

    print(f"building the ground truth: {args.gt_size} Gaussians, {args.cams} cameras at "
          f"{args.width}x{args.height}, {args.seed_points} seed points", flush=True)
    built = stage("dataset", lambda: build_scene_dir(scene_dir, args.cams, args.width, args.height,
                                                     args.gt_size, args.seed_points, GT_SEED, device))
    it = str(args.iters)
    train_argv = ["-s", str(scene_dir), "-m", str(model_dir), "--eval", "--quiet", "--iterations", it,
                  "--test_iterations", it, "--save_iterations", it,
                  "--densify_grad_threshold", str(args.grad_threshold), *extra_train_args, *dev_arg]
    trained = stage("train", lambda: cli_train.main(train_argv))
    n_final = ply_vertex_count(model_dir / "point_cloud" / f"iteration_{it}" / "point_cloud.ply")
    rendered = stage("render", lambda: cli_render.main(["-m", str(model_dir), "--quiet", *dev_arg]))
    scores = stage("metrics", lambda: cli_metrics.main(["-m", str(model_dir), *dev_arg]))
    scores = scores[str(model_dir)][f"ours_{it}"]

    hist = trained["history"]
    steps = len(hist)
    doublings = [{"iteration": h["iteration"], "capacity": h["densify"]["capacity"],
                  "n_alive": h["densify"]["n_alive"]}
                 for h in hist if "densify" in h and "capacity" in h["densify"]]
    psnr, ssim = float(scores["PSNR"]), float(scores["SSIM"])
    results = {
        "verdict": gate_verdict(psnr, n_final, args.psnr_floor, args.min_final),
        "psnr": psnr, "ssim": ssim, "n_final": n_final,
        "floors": {"psnr": args.psnr_floor, "n_final": args.min_final},
        "iters": args.iters, "cams": args.cams, "width": args.width, "height": args.height,
        "gt_size": args.gt_size, "seed_points": args.seed_points, "grad_threshold": args.grad_threshold,
        "extra_train_args": list(extra_train_args),
        "device": smi,
        "stage_s": times,
        "time_to_gate_s": times["train"] + times["render"] + times["metrics"],
        "overflowed_steps": sum(1 for h in hist if h["overflow"]),
        "render_overflowed_views": sum(1 for s in rendered if s["overflow"]),
        "capacity_doublings": doublings,
        "densify_passes": sum(1 for h in hist if "densify" in h),
        "densify": [{"iteration": h["iteration"], **h["densify"]} for h in hist if "densify" in h],
        "launches": launches,
        "launches_per_step": {k: v / max(steps, 1) for k, v in launches["train"].items()},
        "train_evals": {str(k): v for k, v in trained["evals"].items()},
        "render_budgets": [(i, c.max_instances, c.max_stream, c.chunk) for i, c in trained["render_cfgs"]],
        "windows": phase_windows(hist),
        "gt_instances": built["gt_instances"],
    }
    write_record(out_dir, results)
    print(f"{results['verdict']}: PSNR {psnr:.4f} dB, SSIM {ssim:.5f}, final {n_final} Gaussians, "
          f"{results['overflowed_steps']} overflowed steps, {len(doublings)} capacity doublings, "
          f"time to the gate {results['time_to_gate_s']:.1f} s [{smi}]", flush=True)
    return results


def write_record(out_dir: Path, r: dict) -> None:
    with open(out_dir / "full_gate_results.json", "w") as f:
        json.dump(r, f, indent=1)
    lines = [
        "# Full-pipeline quality gate of the PyTorch port",
        "",
        f"date: {time.strftime('%Y-%m-%d %H:%M')}; device: {r['device']}",
        "",
        f"Ground truth: `tools/synthetic.py synthetic_scene` at {r['gt_size']} Gaussians, {r['cams']} ring "
        f"cameras at {r['width']}x{r['height']}; seed {r['seed_points']} points; `cli.train --iterations "
        f"{r['iters']} --densify_grad_threshold {r['grad_threshold']}` "
        f"{' '.join(r['extra_train_args'])}, then `cli.render` and `cli.metrics`.",
        "",
        f"**{r['verdict']}**: PSNR {r['psnr']:.4f} dB (floor {r['floors']['psnr']}), SSIM {r['ssim']:.5f}, "
        f"final size {r['n_final']} Gaussians (floor {r['floors']['n_final']}).",
        "",
        "| stage | wall s |",
        "|---|---|",
        *(f"| {k} | {v:.1f} |" for k, v in r["stage_s"].items()),
        f"| time to the gate (train + render + metrics) | {r['time_to_gate_s']:.1f} |",
        "",
        f"Overflowed train steps: {r['overflowed_steps']}; overflowed views in `cli.render`: "
        f"{r['render_overflowed_views']}; densify passes: {r['densify_passes']}.",
        "",
        f"Capacity doublings: {r['capacity_doublings']}",
        "",
        "Densify passes: " + "; ".join(
            f"{d['iteration']}: +{d['n_cloned']} cloned, {d['n_split']} split, -{d['n_pruned']} pruned, "
            f"{d['n_alive']} alive" for d in r["densify"]),
        "",
        f"Launches per train step: {r['launches_per_step']}; by stage: {r['launches']}",
        "",
    ]
    phase_keys = [k for k in (r["windows"][0] if r["windows"] else {}) if k.endswith("_ms") and k != "step_ms"]
    lines.append("| " + " | ".join(["iterations", "alive", "overflowed steps", "step ms"]
                                   + [k[:-3] + " ms" for k in phase_keys]) + " |")
    lines.append("|---" * (4 + len(phase_keys)) + "|")
    for w in r["windows"]:
        cells = [w["iterations"], w["n_alive"], w["overflowed_steps"], w.get("step_ms")]
        cells += [w.get(k) for k in phase_keys]
        lines.append("| " + " | ".join(f"{c:.3f}" if isinstance(c, float) else str(c) for c in cells) + " |")
    (out_dir / "full_gate.md").write_text("\n".join(lines) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    ap.add_argument("--iters", type=int, default=15_000)
    ap.add_argument("--cams", type=int, default=28)
    ap.add_argument("--seed-points", type=int, default=10_000)
    ap.add_argument("--gt-size", type=int, default=200_000)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--psnr-floor", type=float, default=25.0)
    ap.add_argument("--min-final", type=int, default=150_000)
    ap.add_argument("--grad-threshold", type=float, default=0.0001)
    ap.add_argument("--out", default=str(REPO / "build" / "full_gate"))
    ap.add_argument("--work", default=None, help="dataset and model dirs (default <out>/work)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args, train_args = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    results = run_gate(args, train_args)
    return 0 if results["verdict"] == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
