#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--gaussians 1000000] [--views 4]

1. Device and build: the card's name and power limit, torch/CUDA versions,
   and the nvcc build of every kernel in gaussian_transformer_tpu_torch/csrc
   (into build/torch_kernels/).
2. A seeded synthetic trained-looking scene (1,000,000 Gaussians at SH
   degree 3 on a few surfaces) written as a trained model dir with a
   Blender-layout dataset of 1920x1080 test views; the ground truth is the
   port's own render plus N(0, 0.05) noise.
3. Kernel checks on one main-path view: K1 (stream compositor forward) and
   K3 (fused SSIM forward) against their plain PyTorch versions.
4. The main path: ``cli.render`` then ``cli.metrics`` through their
   ``main(argv)``, with the kernel launch counters zeroed just before and
   read just after; checks overflow, SSIM, and the PSNR against a numpy
   recomputation from the written PNGs.
5. Times (CUDA events) of each kernel (over repeated launches, and with the
   L2 cache flushed before each launch) and its plain version, the per-view
   render time, and each kernel's bound.

The last three lines of standard output are the kernels JSON line, the
card's ``name, power.limit`` as nvidia-smi prints them, and
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
those lines. Without a CUDA device, or outside a checkout of the repo, it
exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from argparse import Namespace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# Published H100 SXM peaks (the card's data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# Operation counts used for the bounds (fp32, outside the tensor cores).
K1_OPS_PER_PAIR = 20  # power (10), exp, alpha cap/skip tests, T update, 3 FMAs
K3_OPS_PER_PIXEL = 3 + 2 * (5 * 11 * 2) + 17  # products, two 11-tap passes x 5 fields, map
K1_ATOL = 2e-5
K1_MAX_ERR = 1e-3
K1_MAX_SHARE = 1e-4
K3_ATOL = 1e-5


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- scene ----


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def synthetic_scene(n: int, seed: int):
    """Fields of a trained-looking scene in the JAX package's layouts: points
    on a sphere, a ground disk, a torus and a cylinder; per-axis log-scales
    from each surface's point spacing; Beta(2, 2) opacities; per-surface
    base colors in the SH DC band and small SH rest coefficients (degree 3)."""
    rng = np.random.RandomState(seed)
    shares = {"sphere": 0.35, "ground": 0.35, "torus": 0.15, "cylinder": 0.15}
    counts = {k: int(n * v) for k, v in shares.items()}
    counts["sphere"] += n - sum(counts.values())
    xyz, spacing, base = [], [], []
    m = counts["sphere"]  # radius 1 at (0, 0.2, 0)
    xyz.append(_unit(rng.randn(m, 3)) + [0.0, 0.2, 0.0])
    spacing.append(np.full(m, math.sqrt(4 * math.pi / m)))
    base.append(np.tile([0.8, 0.3, 0.2], (m, 1)))
    m = counts["ground"]  # disk of radius 3 at y = -1
    r, a = 3.0 * np.sqrt(rng.rand(m)), 2 * np.pi * rng.rand(m)
    xyz.append(np.stack([r * np.cos(a), np.full(m, -1.0), r * np.sin(a)], 1))
    spacing.append(np.full(m, math.sqrt(math.pi * 9.0 / m)))
    base.append(np.tile([0.4, 0.5, 0.3], (m, 1)) + 0.1 * np.sin(3 * r)[:, None])
    m = counts["torus"]  # R 1.6, r 0.25 around the sphere
    u, v = 2 * np.pi * rng.rand(m), 2 * np.pi * rng.rand(m)
    ring = 1.6 + 0.25 * np.cos(v)
    xyz.append(np.stack([ring * np.cos(u), 0.2 + 0.25 * np.sin(v), ring * np.sin(u)], 1))
    spacing.append(np.full(m, math.sqrt(4 * math.pi**2 * 1.6 * 0.25 / m)))
    base.append(np.tile([0.2, 0.3, 0.8], (m, 1)))
    m = counts["cylinder"]  # radius 0.4, height 1.2, standing on the ground
    a, h = 2 * np.pi * rng.rand(m), 1.2 * rng.rand(m)
    xyz.append(np.stack([1.9 + 0.4 * np.cos(a), -1.0 + h, -1.2 + 0.4 * np.sin(a)], 1))
    spacing.append(np.full(m, math.sqrt(2 * math.pi * 0.4 * 1.2 / m)))
    base.append(np.tile([0.9, 0.8, 0.3], (m, 1)))

    xyz = np.concatenate(xyz).astype(np.float32)
    spacing = np.concatenate(spacing)
    color = np.clip(np.concatenate(base) + 0.08 * rng.randn(n, 3), 0.0, 1.0)
    scale = spacing[:, None] * rng.uniform(0.5, 1.1, (n, 3))
    opac = rng.beta(2.0, 2.0, n)
    c0 = 0.28209479177387814
    return {
        "xyz": xyz,
        "features_dc": ((color - 0.5) / c0).astype(np.float32)[:, None, :],
        "features_rest": (0.02 * rng.randn(n, 15, 3)).astype(np.float32),
        "scaling": np.log(scale).astype(np.float32),
        "rotation": rng.randn(n, 4).astype(np.float32),
        "opacity": np.log(opac / (1.0 - opac)).astype(np.float32)[:, None],
        "alive": np.ones(n, bool),
    }


def orbit_c2w(angle: float, radius: float = 4.2, height: float = 1.3) -> list:
    """Blender/OpenGL camera-to-world of a camera on a circle, looking at the origin."""
    eye = np.array([radius * math.sin(angle), height, radius * math.cos(angle)])
    f = _unit(-eye)
    r = _unit(np.cross(f, [0.0, 1.0, 0.0]))
    u = np.cross(r, f)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, u, -f, eye
    return c2w.tolist()


def camera_from_c2w(c2w, fovx, width, height, device):
    """The camera the port's Blender reader builds from this frame."""
    from gaussian_transformer_tpu_torch.scene.cameras import Camera
    from gaussian_transformer_tpu_torch.utils.graphics import focal2fov, fov2focal

    c2w = np.array(c2w)
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    return Camera.create(0, np.transpose(w2c[:3, :3]), w2c[:3, 3], fovx,
                         focal2fov(fov2focal(fovx, width), height), None, None, "view", 0,
                         width=width, height=height, device=device)


def write_model_dir(work: Path, scene, n_views, width, height, fovx, seed, device):
    """Blender-layout dataset + trained model dir; GT = render + N(0, 0.05)."""
    import torch

    from gaussian_transformer_tpu_torch.config import save_cfg_args
    from gaussian_transformer_tpu_torch.render import render
    from gaussian_transformer_tpu_torch.scene.ply import store_point_cloud
    from gaussian_transformer_tpu_torch.utils.png import write_png

    data, model = work / "data", work / "model"
    rng = np.random.RandomState(seed + 1)
    splits = {
        "train": [orbit_c2w(math.pi / 4)],
        "test": [orbit_c2w(2 * math.pi * i / n_views + 0.3) for i in range(n_views)],
    }
    for split, c2ws in splits.items():
        (data / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i, c2w in enumerate(c2ws):
            with torch.no_grad():
                img = render(camera_from_c2w(c2w, fovx, width, height, device), scene)["render"]
            noisy = np.clip(img.cpu().numpy().transpose(1, 2, 0) + rng.normal(0, 0.05, (height, width, 3)), 0, 1)
            write_png(str(data / split / f"r_{i}.png"), (noisy * 255).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w})
        with open(data / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)
    store_point_cloud(str(data / "points3d.ply"), np.zeros((16, 3)), np.zeros((16, 3)))
    scene.save_ply(str(model / "point_cloud" / "iteration_30000" / "point_cloud.ply"))
    save_cfg_args(str(model), Namespace(
        sh_degree=3, source_path=str(data), model_path=str(model), images="images",
        resolution=1, white_background=False, data_device=str(device), eval=True,
    ))
    return model, splits


# ---------------------------------------------------------------- timing ----


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int) -> float:
    """Mean CUDA-event ms of single launches, each after writing a 256 MB
    buffer so that the 50 MB L2 holds none of the inputs."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def render_profile(fn, top: int = 12) -> str:
    """Device time by CUDA kernel over one warm call of ``fn`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="cuda_time_total", row_limit=top, max_name_column_width=60)


def numpy_psnr(model: Path, method: str) -> float:
    """Mean over views of the mean per-channel PSNR, from the written PNGs."""
    from gaussian_transformer_tpu_torch.utils.png import read_png

    d = model / "test" / method
    vals = []
    for name in sorted(os.listdir(d / "renders")):
        r = read_png(str(d / "renders" / name))[..., :3].astype(np.float64) / 255.0
        g = read_png(str(d / "gt" / name))[..., :3].astype(np.float64) / 255.0
        mse = ((r - g) ** 2).reshape(-1, 3).mean(axis=0)
        vals.append(float(np.mean(20 * np.log10(1.0 / np.sqrt(mse)))))
    return float(np.mean(vals))


# ------------------------------------------------------------------ main ----


def run(args, device) -> dict:
    import torch

    from gaussian_transformer_tpu_torch import kernels
    from gaussian_transformer_tpu_torch.cli import metrics as cli_metrics
    from gaussian_transformer_tpu_torch.cli import render as cli_render
    from gaussian_transformer_tpu_torch.convert import scene_from_numpy
    from gaussian_transformer_tpu_torch.ops import fused_ssim
    from gaussian_transformer_tpu_torch.render import project_view
    from gaussian_transformer_tpu_torch.render import prepare_stream, render
    from gaussian_transformer_tpu_torch.render import stream

    on_card = device.type == "cuda"
    summary = {"seed": args.seed, "gaussians": args.gaussians, "views": args.views,
               "width": args.width, "height": args.height}

    print("== 1. device and build")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    if on_card:
        sources = kernels.all_sources()
        fresh = [src for src in sources if not kernels.library_path(src).exists()]
        t0 = time.time()
        kernels.build(sources)
        summary["build_s"] = time.time() - t0
        print(f"nvcc build of {fresh} ({len(sources) - len(fresh)} of {sources} already built): "
              f"{summary['build_s']:.1f} s")
        for src in sources:
            log = kernels.library_path(src).with_suffix(".log")
            if log.exists():
                print(f"-- {src} ptxas:\n" + log.read_text().strip())

    print("== 2. scene and model dir")
    t0 = time.time()
    fields = synthetic_scene(args.gaussians, args.seed)
    scene = scene_from_numpy(fields, active_sh_degree=3, device=device)
    fovx = math.radians(50.0)
    model, splits = write_model_dir(Path(args.work), scene, args.views, args.width, args.height,
                                    fovx, args.seed, device)
    print(f"{args.gaussians} Gaussians, {args.views} test views at {args.width}x{args.height}: "
          f"{time.time() - t0:.1f} s")

    print("== 3. kernel checks on test view 0")
    cam0 = camera_from_c2w(splits["test"][0], fovx, args.width, args.height, device)
    results = []
    with torch.no_grad():
        s = prepare_stream(cam0, scene)
        props = s.props()
        ct = s.chunk_tile
        color, t_fin = stream.composite_stream_tiles(props, ct, s.grid_w, s.grid_h)
        p_color, p_t, pairs = stream.composite_stream_tiles_plain(props, ct, s.grid_w, s.grid_h, count_work=True)
        cov = s.binned.covered
        err = torch.cat([(color - p_color)[cov].flatten(), (t_fin - p_t)[cov].flatten()]).abs()
        k1_err = float(err.max()) if err.numel() else 0.0
        k1_share = float((err > K1_ATOL).float().mean()) if err.numel() else 0.0
        print(f"K1: {int(s.binned.n_instances)} instances, {int(s.binned.n_padded)} padded rows, "
              f"chunk {props.shape[0] // ct.shape[0]}, {pairs} evaluated (row, pixel) pairs")
        print(f"K1 vs plain: max abs diff {k1_err:.3e} (tolerance {K1_MAX_ERR}), "
              f"share beyond {K1_ATOL}: {k1_share:.3e} (tolerance {K1_MAX_SHARE})")
        check(k1_err <= K1_MAX_ERR and k1_share <= K1_MAX_SHARE, "K1 agrees with its plain version")

        img = render(cam0, scene)["render"]
        gt = torch.clamp(img + 0.05 * torch.randn(img.shape, generator=torch.Generator(device).manual_seed(args.seed), device=device), 0, 1)
        k3 = fused_ssim.fused_ssim(img, gt)
        k3_plain = fused_ssim.ssim_plain(img, gt)
        k3_err = abs(float(k3) - float(k3_plain))
        print(f"K3 vs plain: SSIM {float(k3):.7f} vs {float(k3_plain):.7f}, "
              f"abs diff {k3_err:.3e} (tolerance {K3_ATOL})")
        check(k3_err <= K3_ATOL, "K3 agrees with its plain version")

    print("== 4. main path: cli.render then cli.metrics")
    stream.STREAM_FWD.launches = 0
    fused_ssim.SSIM_FWD.launches = 0
    t0 = time.time()
    dev_arg = [] if on_card else ["--device", str(device)]
    stats = cli_render.main(["-m", str(model), "--skip_train", "--quiet"] + dev_arg)
    t_render = time.time() - t0
    k1_launches = stream.STREAM_FWD.launches
    t0 = time.time()
    scores = cli_metrics.main(["-m", str(model)] + dev_arg)[str(model)]
    t_metrics = time.time() - t0
    k3_launches = fused_ssim.SSIM_FWD.launches
    print(f"cli.render {t_render:.1f} s, cli.metrics {t_metrics:.1f} s; "
          f"K1 launches {k1_launches}, K3 launches {k3_launches}")
    if on_card:
        check(k1_launches == args.views, f"K1 launched once per rendered view ({args.views})")
        check(k3_launches == args.views, f"K3 launched once per scored view ({args.views})")
    check(len(stats) == args.views and all(v["overflow"] == 0 for v in stats),
          f"overflow == 0 on every view ({[v['overflow'] for v in stats]})")
    method = "ours_30000"
    res = scores[method]
    with open(model / "results.json") as f:
        on_disk = json.load(f)[method]
    check(on_disk == res, "results.json holds the returned scores")
    check(math.isfinite(res["SSIM"]) and res["SSIM"] < 1.0, f"SSIM {res['SSIM']:.6f} finite and < 1")
    ref_psnr = numpy_psnr(model, method)
    check(abs(res["PSNR"] - ref_psnr) <= 1e-3,
          f"PSNR {res['PSNR']:.6f} dB == numpy recomputation {ref_psnr:.6f} dB (1e-3 dB)")
    check(20.0 <= res["PSNR"] <= 35.0, "PSNR within [20, 35] dB")
    summary.update(cli_render_s=t_render, cli_metrics_s=t_metrics, ssim=res["SSIM"],
                   psnr=res["PSNR"], views_stats=stats)

    if not on_card:
        return summary

    print("== 5. times (CUDA events)")
    smi = smi_line()
    with torch.no_grad():
        render_ms = cuda_ms(lambda: render(cam0, scene), reps=5)
        stages = {
            "project": cuda_ms(lambda: project_view(cam0, scene, 1.0, None), reps=5),
            "project+bin": cuda_ms(lambda: prepare_stream(cam0, scene), reps=5),
            "gather": cuda_ms(lambda: s.props(), reps=5),
        }
        profile = render_profile(lambda: render(cam0, scene))
        k1_ms = cuda_ms(lambda: stream.composite_stream_tiles(props, ct, s.grid_w, s.grid_h), reps=20)
        k1_plain_ms = cuda_ms(lambda: stream.composite_stream_tiles_plain(props, ct, s.grid_w, s.grid_h), reps=2)
        k3_ms = cuda_ms(lambda: fused_ssim.fused_ssim(img, gt), reps=50)
        k3_plain_ms = cuda_ms(lambda: fused_ssim.ssim_plain(img, gt), reps=5)
        k1_cold_ms = cuda_ms_cold(lambda: stream.composite_stream_tiles(props, ct, s.grid_w, s.grid_h), reps=10)
        k3_cold_ms = cuda_ms_cold(lambda: fused_ssim.fused_ssim(img, gt), reps=20)
    T = s.grid_w * s.grid_h
    real_rows = int(s.binned.tile_counts.sum())
    k1_bytes = real_rows * 9 * 4 + T * 4 * 256 * 4 + 2 * T * 4
    k1_ops = pairs * K1_OPS_PER_PAIR
    n_px = img.numel()
    k3_bytes = 2 * n_px * 4 + 4 * math.ceil(args.height / 32) * math.ceil(args.width / 32) * img.shape[0]
    k3_ops = n_px * K3_OPS_PER_PIXEL

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k3_bound, k3_by = bound(k3_bytes, k3_ops)
    print(f"[{smi}] render {render_ms:.3f} ms/view: project {stages['project']:.3f} ms, "
          f"bin {stages['project+bin'] - stages['project']:.3f} ms, gather {stages['gather']:.3f} ms, "
          f"K1 {k1_ms:.3f} ms (stages timed apart)")
    print(f"top CUDA kernels of one render (torch.profiler, device time):\n{profile}")
    print(f"[{smi}] K1 {k1_ms:.4f} ms (L2 cold {k1_cold_ms:.4f}), plain {k1_plain_ms:.2f} ms, "
          f"bound {k1_bound:.4f} ms ({k1_by}: {k1_bytes} B, {k1_ops} fp32 ops)")
    print(f"[{smi}] K3 {k3_ms:.4f} ms (L2 cold {k3_cold_ms:.4f}), plain {k3_plain_ms:.3f} ms, "
          f"bound {k3_bound:.4f} ms ({k3_by}: {k3_bytes} B, {k3_ops} fp32 ops)")
    kernels_line = {"kernels": [
        {"name": "stream_fwd", "route": "cuda",
         "source": "gaussian_transformer_tpu_torch/csrc/stream_fwd.cu",
         "replaces": "gaussian_transformer_tpu/render/stream.py:266",
         "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms, "ms_l2_cold": k1_cold_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "tolerance": {"atol": K1_ATOL, "max_share_beyond": K1_MAX_SHARE, "max_abs": K1_MAX_ERR},
         "share_beyond_atol": k1_share},
        {"name": "ssim_fwd", "route": "cuda",
         "source": "gaussian_transformer_tpu_torch/csrc/ssim_fwd.cu",
         "replaces": "gaussian_transformer_tpu/ops/fused_ssim.py:106",
         "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms, "ms_l2_cold": k3_cold_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None,
         "tolerance": {"atol": K3_ATOL}},
    ]}
    summary.update(smi=smi, render_ms=render_ms, stage_ms=stages, evaluated_pairs=pairs,
                   real_rows=real_rows, render_profile=profile, **kernels_line)
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gaussians", type=int, default=1_000_000)
    parser.add_argument("--views", type=int, default=4)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--work", default=str(ROOT / "build" / "chip_smoke"),
                        help="scratch dir for the model dir (default build/chip_smoke)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "gaussian_transformer_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, {torch.cuda.device_count()} visible")
    print(f"nvidia-smi name, power.limit: {smi_line()}")
    t0 = time.time()
    try:
        summary = run(args, device)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    summary["total_s"] = time.time() - t0
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_summary.json").write_text(json.dumps(summary, indent=1))
    print(f"total {summary['total_s']:.1f} s")
    print(json.dumps({"kernels": summary["kernels"]}))
    print(summary["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
