"""3DGS training in a closed loop: the port's ``train/splat.py training()``
(the CLI's loop) from a state at the configuration's start iteration,
handed in as ``start_checkpoint`` (an in-memory npz). No viewer, no
snapshots, no densification (it is over by then). ``log_fn`` runs after each
step's host read: it closes the window, and starts and stops the traced
slice at the window's end.

Correctness: two runs of three steps of the window's own loop are held
against ``perfbench/reference/splat.py`` run from the same state on the same
views: the first three steps, from the seed's state, and the window's last
three (before the traced slice, in a traced run), from the state the loop
had reached, taken just before them. Of each: the losses, the first
gradient (from Adam's first moment) and each leaf's change after the
third. A step whose render dropped instances at one of its static caps
(the instance budget, the tiles a Gaussian may cover) left part of the
image out: any such step, in set-up or in the window, makes the run not
correct.
"""

from __future__ import annotations

import io
import time

import numpy as np
import torch

from perfbench import core, scenes
from perfbench.reference import splat as ref

LEAVES = ref.LEAVES
N_CHECKED = 3


class _StopWindow(Exception):
    pass


def port_camera(i: int, v: ref.View, gt):
    from gaussian_transformer_tpu_torch.scene.cameras import Camera

    return Camera(uid=i, colmap_id=i, image_name=f"{i:03d}", image_width=v.width, image_height=v.height,
                  fovx=v.fovx, fovy=v.fovy, world_view_transform=v.world_view, full_proj_transform=v.full_proj,
                  camera_center=v.center, original_image=gt)


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    """(fields, views, ground truths, camera extent): the ground truth of a
    view is the reference's render of the scene plus N(0, noise) noise, so
    the scene sits near a fixed point of its loss, as in late training."""
    fields = scenes.synthetic_scene(cfg["gaussians"], seed, device, cfg["sh_degree"])
    views = scenes.orbit_views(traffic["views"], seed, device)
    g = torch.Generator(device=device).manual_seed(scenes.sub_seed(seed, 3))
    bg = torch.zeros(3, device=device)
    gts = []
    with torch.no_grad():
        for v in views:
            img, _, _ = ref.composite(ref.project(fields, v, cfg["sh_degree"]), v.width, v.height, bg)
            noise = traffic["gt_noise"] * torch.randn(img.shape, generator=g, device=device)
            gts.append(torch.clamp(img + noise, 0.0, 1.0))
    return fields, views, gts, scenes.cameras_extent(views)


def checkpoint_npz(fields, cfg: dict, extent: float) -> io.BytesIO:
    """The state at ``cfg['start_iteration']`` as ``training()`` reads a
    checkpoint: the fields, Adam restarted (its moments and its count at
    zero, so its bias correction applies from the first step), empty
    densification statistics."""
    n = fields["xyz"].shape[0]
    it = cfg["start_iteration"]
    out = {"iteration": np.asarray(it), "spatial_lr_scale": np.asarray(extent),
           "active_sh_degree": np.asarray(cfg["sh_degree"]), "max_sh_degree": np.asarray(cfg["sh_degree"]),
           "alive": np.ones(n, bool), "stats.accum": np.zeros(n, np.float32),
           "stats.denom": np.zeros(n, np.float32), "stats.max_radii2d": np.zeros(n, np.float32)}
    for k in LEAVES:
        a = fields[k].detach().cpu().numpy()
        out[f"param.{k}"] = a
        out[f"adam.mu.{k}"] = np.zeros_like(a)
        out[f"adam.nu.{k}"] = np.zeros_like(a)
        out[f"adam.count.{k}"] = np.asarray(np.float32(0.0))
    buf = io.BytesIO()
    np.savez(buf, **out)
    buf.seek(0)
    return buf


def splat_work(fields, views, sh_degree: int) -> dict:
    """What the floors read: each view's contributing pairs and included
    Gaussians by the reference's rules, the pixels, the live Gaussians."""
    bg = torch.zeros(3, device=fields["xyz"].device)
    out = []
    with torch.no_grad():
        for v in views:
            p = ref.project(fields, v, sh_degree)
            included = int(((p.radii > 0) & (p.opacities >= 1.0 / 255.0)).sum())
            out.append([ref.composite(p, v.width, v.height, bg)[2], included])
    return {"views": out, "pixels": views[0].width * views[0].height if views else 0,
            "gaussians": int(fields["xyz"].shape[0]), "sh_degree": sh_degree}


def opt_config(cfg: dict):
    from gaussian_transformer_tpu_torch.config import OptConfig

    o = cfg["optimization"]
    return OptConfig(iterations=cfg["start_iteration"] + 10**8, position_lr_init=o["position_lr_init"],
                     position_lr_final=o["position_lr_final"], position_lr_delay_mult=o["position_lr_delay_mult"],
                     position_lr_max_steps=o["position_lr_max_steps"], feature_lr=o["feature_lr"],
                     opacity_lr=o["opacity_lr"], scaling_lr=o["scaling_lr"], rotation_lr=o["rotation_lr"],
                     lambda_dssim=o["lambda_dssim"], densify_until_iter=o["densify_until_iter"])


def learning_rates(cfg: dict, extent: float, iteration: int) -> dict:
    o = cfg["optimization"]
    return {"xyz": ref.expon_lr(iteration, o["position_lr_init"] * extent, o["position_lr_final"] * extent,
                                o["position_lr_max_steps"]),
            "features_dc": o["feature_lr"], "features_rest": o["feature_lr"] / 20.0,
            "scaling": o["scaling_lr"], "rotation": o["rotation_lr"], "opacity": o["opacity_lr"]}


class Probe:
    """``N_CHECKED`` steps of the loop held against the reference: the state
    before the first (the scene's leaves, Adam's moments and count), each
    step's view and loss, the first step's gradient (from Adam's first
    moment: m_1 = b1 m_0 + (1 - b1) g) and each leaf's change after the
    last."""

    def __init__(self):
        self.start, self.views, self.losses, self.grad, self.delta = None, [], [], {}, None

    def before(self, scene, adam):
        if self.start is None:
            self.start = {"params": {k: getattr(scene, k).detach().clone() for k in LEAVES},
                          "mu": {k: adam.mu[k].clone() for k in LEAVES},
                          "nu": {k: adam.nu[k].clone() for k in LEAVES},
                          "count": float(adam.counts[LEAVES[0]])}

    def after(self, camera, adam_before, adam_after):
        self.views.append(camera.uid)
        if len(self.views) == 1:
            b1 = 0.9
            self.grad = {k: float(torch.linalg.vector_norm(
                adam_after.mu[k].double() - b1 * adam_before.mu[k].double())) / (1 - b1) for k in LEAVES}

    def logged(self, loss, gaussians) -> bool:
        """Called after each of its steps; True after the last."""
        self.losses.append(loss)
        if len(self.losses) < N_CHECKED:
            return False
        self.delta = {k: float(torch.linalg.vector_norm((getattr(gaussians, k).detach()
                                                         - self.start["params"][k]).double())) for k in LEAVES}
        return True

    def numbers(self) -> dict:
        return {"losses": self.losses, "grad": self.grad, "delta": self.delta}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.train import splat

    cfg, traffic = cell.config, cell.traffic
    fields, views, gts, extent = make_inputs(cfg, traffic, seed, device)
    cams = [port_camera(i, v, gt) for i, (v, gt) in enumerate(zip(views, gts))]
    ckpt = checkpoint_npz(fields, cfg, extent)
    del fields
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    class SceneObj:
        gaussians = GaussianScene(1, cfg["sh_degree"], device)
        cameras_extent = extent
        model_path = ""

        @staticmethod
        def get_train_cameras():
            return cams

    # The loop's steps, seen from inside: the probe that is open (the first
    # steps, then the window's last steps), and each traced step's view.
    original_step = splat.train_step
    slice_views = []

    def watched_step(scene, adam, stats, camera, *a, **k):
        probe = st["probe"]
        if probe is not None:
            probe.before(scene, adam)
        out = original_step(scene, adam, stats, camera, *a, **k)
        if probe is not None:
            probe.after(camera, adam, out[1])
        if st["slice_start"] is not None:
            slice_views.append(camera.uid)
        return out

    warm, slice_steps = traffic["warmup_steps"], traffic["trace_steps"]
    first, last = Probe(), Probe()
    st = {"n": 0, "t0": None, "t_end": None, "phase": [], "overflow": 0, "dropped": [], "probe": first,
          "trace": None, "slice_start": None, "untraced": None, "final": None, "t_setup": None}
    tracer = core.Trace(torch) if trace else None

    def log_fn(iteration, loss, overflow, phase_ms, gaussians, **_):
        st["n"] += 1
        n = st["n"]
        st["dropped"].append(int(overflow))
        probe = st["probe"]
        closed = probe is not None and probe.logged(loss, gaussians)
        if closed:
            st["probe"] = None
        if n == warm:
            st["t0"] = time.perf_counter()
            st["t_setup"] = st["t0"] - t_start
            return
        if st["t0"] is None:
            return
        st["overflow"] += int(overflow > 0)
        now = time.perf_counter()
        if st["slice_start"] is None:
            if phase_ms:
                st["phase"].append(phase_ms)
            # The window's last steps (before the traced slice, in a traced
            # run) are held against the reference.
            end = seconds if tracer is None else max(seconds - 1.0, 0.5 * seconds)
            if probe is None and last.start is None and now - st["t0"] >= end:
                st["probe"] = last
                return
            if not (closed and probe is last):
                return
            if tracer is None:
                st["t_end"] = now
                st["window_steps"] = n - warm
                raise _StopWindow
            # Traced run: ``slice_steps`` more steps under the profiler
            # (which leaves the host slower afterwards).
            st["untraced"] = (n - warm, now - st["t0"])
            tracer.start()
            st["slice_start"] = (n, time.perf_counter())
            return
        if n - st["slice_start"][0] >= slice_steps:
            core.sync(torch, device)
            st["trace"] = (n - st["slice_start"][0], time.perf_counter() - st["slice_start"][1])
            tracer.stop()
            st["t_end"] = now
            st["window_steps"] = n - warm
            st["final"] = {k: getattr(gaussians, k).detach().clone() for k in LEAVES}
            raise _StopWindow

    splat.train_step = watched_step
    try:
        splat.training(SceneObj, opt_config(cfg), RenderConfig(), start_checkpoint=ckpt, seed=seed % 2**32,
                       log_fn=log_fn, capacity_headroom=1.0)
    except _StopWindow:
        pass
    finally:
        splat.train_step = original_step
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    del SceneObj, ckpt, cams
    if device.type == "cuda":
        torch.cuda.empty_cache()

    steps = st["window_steps"]
    window_s = st["t_end"] - st["t0"]
    readings = {"cell": cell.name, "steps": steps, "window_s": window_s}
    if st["phase"]:
        readings["phase_ms"] = {k: float(np.mean([p[k] for p in st["phase"]])) for k in st["phase"][0]}
    if tracer is not None:
        readings["trace"] = tracer.summary()
        readings["trace_units"], readings["trace_s"] = st["trace"]
        readings["untraced_steps"], readings["untraced_s"] = st["untraced"]
        # Floors of the slice's own views, from the reference's pair counts
        # on the scene as the window left it.
        readings["work"] = splat_work(st["final"], [views[u] for u in slice_views], cfg["sh_degree"])
    st["final"] = None

    limits = traffic["limits"]
    it0 = cfg["start_iteration"]
    start = seed_state(cfg, seed, device)
    ref_first = reference_steps(cfg, start, views, gts, extent, first.views, it0, torch.float32)
    ref_last = reference_steps(cfg, last.start, views, gts, extent, last.views,
                               it0 + int(last.start["count"]), torch.float32)
    checks = core.training_checks(first.numbers(), ref_first, limits, N_CHECKED)
    window = core.training_checks(last.numbers(), ref_last, limits, N_CHECKED)
    checks.update({f"window_{k}": v for k, v in window.items()})
    drops = sum(d > 0 for d in st["dropped"])
    checks["steps_with_drops"] = {"value": drops, "limit": limits["steps_with_drops"]}
    return {"e2e": {"splat_step_ms": 1e3 * window_s / steps}, "setup_s": st["t_setup"], "readings": readings,
            "attempted": steps, "failed": st["overflow"], "checks": checks, "memory_peak_bytes": peak,
            "detail": {"first": {"program": first.numbers(), "reference": ref_first, "views": first.views},
                       "window": {"program": last.numbers(), "reference": ref_last, "views": last.views,
                                  "adam_count": last.start["count"]},
                       "dropped_instances": {"steps": len(st["dropped"]), "steps_with_drops": drops,
                                             "max": max(st["dropped"]), "mean": float(np.mean(st["dropped"]))}}}


def seed_state(cfg, seed, device) -> dict:
    """The state at the start iteration as the checkpoint holds it: the
    seed's scene, Adam's moments at zero and its count at zero."""
    fields = scenes.synthetic_scene(cfg["gaussians"], seed, device, cfg["sh_degree"])
    return {"params": {k: fields[k] for k in LEAVES}, "mu": {k: torch.zeros_like(fields[k]) for k in LEAVES},
            "nu": {k: torch.zeros_like(fields[k]) for k in LEAVES}, "count": 0.0}


def reference_steps(cfg, state, views, gts, extent, order, iteration, dtype) -> dict:
    """The reference's ``N_CHECKED`` steps from ``state`` (taken over: its
    tensors are stepped in place) on the views ``order`` names, the first
    at ``iteration`` + 1: each loss, the first gradient's norm and each
    leaf's change after the last, by leaf."""
    fields, mu, nu = state["params"], state["mu"], state["nu"]
    start = {k: fields[k].clone() for k in LEAVES}
    bg = torch.zeros(3, device=fields["xyz"].device)
    losses, grad = [], {}
    for s, view in enumerate(order):
        loss, grads = ref.loss_and_grads(fields, views[view], gts[view], bg, cfg["sh_degree"],
                                         cfg["optimization"]["lambda_dssim"], dtype)
        losses.append(loss)
        if s == 0:
            grad = {k: float(torch.linalg.vector_norm(grads[k].double())) for k in LEAVES}
        with torch.no_grad():
            ref.adam(fields, grads, mu, nu, state["count"] + s, learning_rates(cfg, extent, iteration + s + 1))
    delta = {k: float(torch.linalg.vector_norm((fields[k] - start[k]).double())) for k in LEAVES}
    return {"losses": losses, "grad": grad, "delta": delta}


def loop_order(seed: int, n_views: int, steps: int) -> list:
    """The views ``training()`` picks for its first steps (its seeded pops
    from the view stack)."""
    rng = np.random.RandomState(seed % 2**32)
    stack, out = [], []
    for _ in range(steps):
        if not stack:
            stack = list(range(n_views))
        out.append(stack.pop(rng.randint(len(stack))))
    return out


def control(cell, seed: int, device) -> dict:
    """The control: the reference in bfloat16 put in the port's place,
    judged against the reference in float32 on the same state and views."""
    cfg, traffic = cell.config, cell.traffic
    _, views, gts, extent = make_inputs(cfg, traffic, seed, device)
    order = loop_order(seed, len(views), N_CHECKED)
    it0 = cfg["start_iteration"]
    refr = reference_steps(cfg, seed_state(cfg, seed, device), views, gts, extent, order, it0, torch.float32)
    low = reference_steps(cfg, seed_state(cfg, seed, device), views, gts, extent, order, it0, torch.bfloat16)
    return {"checks": core.training_checks(low, refr, traffic["limits"], N_CHECKED),
            "detail": {"program": low, "reference": refr}}
