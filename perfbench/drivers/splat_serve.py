"""Serving a trained scene: one client in a closed loop. A request is a
novel view; the server renders it with the port's ``render.render`` at
``cli/render.py``'s ``RenderConfig()`` (the auto budgets) under
``torch.no_grad()`` and converts the frame with
``viewer/network_gui.image_to_bytes`` (uint8 bytes on the host). A request's
latency runs from its start to its bytes on the host; a view whose render
overflows its budget counts as failed.

Correctness: a seeded sample of the window's served frames is held byte for
byte against the reference's render of the same view, converted alike.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import core, scenes
from perfbench.drivers.splat_train import port_camera, splat_work
from perfbench.reference import splat as ref


def served_bytes(img: torch.Tensor) -> np.ndarray:
    """A [3, H, W] float frame as the viewer's protocol sends it: HWC uint8
    of clip(x, 0, 1) * 255, truncated."""
    return (img.clamp(0.0, 1.0) * 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()


def request_order(n_pool: int, n: int, seed: int) -> list:
    """``n`` requests over the pool: seeded permutations, one after another."""
    rng = np.random.RandomState(scenes.sub_seed(seed, 5) % 2**32)
    out = []
    while len(out) < n:
        out.extend(rng.permutation(n_pool).tolist())
    return out[:n]


def frame_gaps(frames, fields, views, sh_degree: int) -> dict:
    """Served frames [(view, HWC uint8)] against the reference's frames of
    the same views: the worst frame's mean squared byte error, and the share
    of all bytes more than one level off (a float32 render can differ by a
    level where truncation meets rounding, and by more where a Gaussian
    sits on one of the rasterizer's thresholds)."""
    bg = torch.zeros(3, device=fields["xyz"].device)
    mse, off, total = 0.0, 0, 0
    with torch.no_grad():
        for i, frame in frames:
            v = views[i]
            img, _, _ = ref.composite(ref.project(fields, v, sh_degree), v.width, v.height, bg)
            d = np.abs(np.asarray(frame, np.int32) - served_bytes(img).astype(np.int32))
            mse = max(mse, float(np.mean(d.astype(np.float64) ** 2)))
            off += int((d > 1).sum())
            total += d.size
    return {"frame_mse": mse, "bytes_off_share": off / max(total, 1)}


def judge(gaps: dict, limits: dict) -> dict:
    return {k: {"value": gaps[k], "limit": limits[k]} for k in ("frame_mse", "bytes_off_share")}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from gaussian_transformer_tpu_torch.render import RenderConfig, render
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.viewer.network_gui import image_to_bytes

    cfg, traffic = cell.config, cell.traffic
    sh = cfg["sh_degree"]
    fields = scenes.synthetic_scene(cfg["gaussians"], seed, device, sh)
    views = scenes.orbit_views(traffic["views"], seed, device, tag=4)
    cams = [port_camera(i, v, None) for i, v in enumerate(views)]
    core.sync(torch, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    scene = GaussianScene(cfg["gaussians"], sh, device)
    with torch.no_grad():
        for k in ref.LEAVES:
            getattr(scene, k).copy_(fields[k])
        scene.alive.fill_(True)
    scene.active_sh_degree = sh
    del fields
    render_cfg = RenderConfig()
    bg = torch.zeros(3, device=device)

    def serve(i):
        with torch.no_grad():
            out = render(cams[i], scene, render_cfg, bg_color=bg)
            return image_to_bytes(out["render"]), out["overflow"]

    n_max = traffic["max_requests"]
    order = request_order(len(views), n_max, seed)
    for i in order[:traffic["warmup_views"]]:
        serve(i)
    keep = set(np.random.RandomState(scenes.sub_seed(seed, 6) % 2**32)
               .choice(traffic["min_requests"], traffic["checked_views"], replace=False).tolist())
    # The sampled frames are copied out after their latency is taken, into
    # buffers made now: holding the served buffers themselves would leave
    # the host's heap in a state that differs from seed to seed.
    v0 = views[0]
    copies = [np.empty((v0.height, v0.width, 3), np.uint8) for _ in keep]
    lat, overflow, frames = [], [], []
    tracer = core.Trace(torch) if trace else None
    t0 = time.perf_counter()
    setup = t0 - t_start
    slice_at, slice_views = None, []
    for n, i in enumerate(order):
        a = time.perf_counter()
        buf, of = serve(i)
        b = time.perf_counter()
        lat.append(b - a)
        overflow.append(of)
        if n in keep:
            dst = copies[len(frames)]
            dst[...] = np.asarray(buf)
            frames.append((i, dst))
        del buf
        if slice_at is not None:
            slice_views.append(i)
            if len(slice_views) == traffic["trace_views"]:
                break
        elif b - t0 >= seconds and n + 1 >= traffic["min_requests"]:
            if tracer is None:
                break
            # Traced run: after the untraced window, a slice of views under
            # the profiler.
            untraced = (n + 1, b - t0)
            tracer.start()
            slice_at = (n + 1, time.perf_counter())
    t_end = time.perf_counter()
    if tracer is not None:
        trace_s = t_end - slice_at[1]
        tracer.stop()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    failed = sum(int(x) > 0 for x in overflow)
    n_views = len(lat)
    del scene, cams
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = {"cell": cell.name, "views": n_views, "window_s": t_end - t0}
    fields = scenes.synthetic_scene(cfg["gaussians"], seed, device, sh)
    if tracer is not None:
        readings.update(trace=tracer.summary(), trace_units=n_views - slice_at[0], trace_s=trace_s,
                        untraced_steps=untraced[0], untraced_s=untraced[1],
                        view_p50_ms=1e3 * float(np.median(lat[:untraced[0]])),
                        work=splat_work(fields, [views[i] for i in slice_views], sh))
    gaps = frame_gaps(frames, fields, views, sh)
    return {"e2e": {"view_p95_ms": 1e3 * core.percentile(lat, 95)}, "setup_s": setup, "readings": readings,
            "attempted": n_views, "failed": failed, "checks": judge(gaps, traffic["limits"]),
            "memory_peak_bytes": peak, "detail": {"gaps": gaps, "frames_checked": len(frames),
                                                  "latency_ms": {q: 1e3 * float(np.percentile(lat, q)) for q in (5, 25, 50, 75, 90, 95, 99, 100)}}}


def control(cell, seed: int, device) -> dict:
    """The control: frames rendered by the reference in bfloat16, judged as
    served frames against the reference in float32."""
    cfg, traffic = cell.config, cell.traffic
    sh = cfg["sh_degree"]
    fields = scenes.synthetic_scene(cfg["gaussians"], seed, device, sh)
    views = scenes.orbit_views(traffic["views"], seed, device, tag=4)
    order = request_order(len(views), traffic["checked_views"], seed)
    bg = torch.zeros(3, device=device, dtype=torch.bfloat16)
    low = {k: v.to(torch.bfloat16) for k, v in fields.items()}
    frames = []
    with torch.no_grad():
        for i in order:
            v = views[i]
            img, _, _ = ref.composite(ref.project(low, v, sh), v.width, v.height, bg)
            frames.append((i, served_bytes(img.float())))
    del low
    gaps = frame_gaps(frames, fields, views, sh)
    return {"checks": judge(gaps, traffic["limits"]), "detail": {"gaps": gaps}}
