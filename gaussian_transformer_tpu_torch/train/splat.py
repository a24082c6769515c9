"""3DGS per-scene optimization (port of ``gaussian_transformer_tpu/train/splat.py``).

One train step renders a camera (kernels K1 and K2 on the card, or K5 and
K6 with ``RenderConfig(use_stream=False)``), takes the
reference loss (1 - lambda) L1 + lambda (1 - SSIM) (kernels K3 and K4),
differentiates it w.r.t. the scene's leaves and an explicit zero screen-space
offset (the densification's screen gradient), applies Adam and accumulates
the densification statistics. ``training`` is the reference's loop around it:
random cameras, the SH degree bump every 1000 iterations, the densify /
prune / opacity-reset window, capacity growth by compaction, PLY saves,
full-state ``chkpnt<N>.npz`` checkpoints whose keys are the JAX package's, so
a JAX checkpoint resumes here, and snapshots (``train/orbax_ckpt.py``) every
``orbax_every`` iterations with auto-resume from the latest; their tree is
the JAX package's Orbax tree (``orbax_payload``), so a JAX snapshot read as
numpy restores through ``orbax_restore_state``. With ``viewer=True`` each
iteration first serves the SIBR viewer (``viewer/network_gui.py pump``)
renders of the current Gaussians.

Host reads per step: the stream length (``render.stream.used_stream``) and
one read of (loss, overflow) after the step; a snapshot step also copies the
state to the host.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gaussian_transformer_tpu_torch.config import OptConfig
from gaussian_transformer_tpu_torch.convert import adam_from_numpy, scene_from_numpy, stats_from_numpy
from gaussian_transformer_tpu_torch.ops.losses import l1_loss, ssim
from gaussian_transformer_tpu_torch.render import RenderConfig, render, tune_config
from gaussian_transformer_tpu_torch.scene.densify import (
    DensifyStats,
    add_densification_stats,
    densify_and_prune,
    reset_opacity,
)
from gaussian_transformer_tpu_torch.train import orbax_ckpt
from gaussian_transformer_tpu_torch.train.optim import (
    PARAM_LEAVES,
    AdamState,
    adam_step,
    compact_state,
    expon_lr,
    leaf_learning_rates,
)
from gaussian_transformer_tpu_torch.utils.image import psnr

# Phases of a train step, in order (the step timer's marks).
PHASES = ("forward", "loss", "backward", "adam")


class StepTimer:
    """CUDA events at the phase boundaries of train steps on the card; read
    them (``phase_ms``) only after something has synchronised the step."""

    def __init__(self):
        self.events = []

    def __call__(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def phase_ms(self) -> dict:
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = a.elapsed_time(b)
        self.events = []
        return out


def train_step(scene, adam: AdamState, stats: DensifyStats, camera, bg: torch.Tensor,
               iteration: int, spatial_lr_scale: float, opt: OptConfig,
               render_cfg: RenderConfig, mark: Optional[Callable[[str], None]] = None):
    """One optimization step on one camera: the scene is updated in place.
    Returns (scene, adam, stats, metrics); the metrics stay on the device.
    ``mark(name)`` is called at the start and after each of ``PHASES``."""
    mark = mark or (lambda name: None)
    mark("start")
    params = [getattr(scene, k) for k in PARAM_LEAVES]
    offset = torch.zeros(scene.capacity, 2, dtype=scene.xyz.dtype, device=scene.xyz.device,
                         requires_grad=True)
    gt = camera.original_image
    out = render(camera, scene, render_cfg, bg_color=bg, screenspace_offset=offset)
    img = out["render"]
    mark("forward")
    l1 = l1_loss(img, gt)
    loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - ssim(img, gt))
    mark("loss")
    grads = torch.autograd.grad(loss, params + [offset], allow_unused=True)
    # A leaf the render did not read (SH rest bands above the active degree)
    # has a zero gradient.
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params + [offset], grads)]
    mark("backward")
    xyz_lr = expon_lr(
        iteration,
        torch.tensor(opt.position_lr_init, dtype=torch.float32) * spatial_lr_scale,
        torch.tensor(opt.position_lr_final, dtype=torch.float32) * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )
    scene, adam = adam_step(scene, dict(zip(PARAM_LEAVES, grads)), adam,
                            leaf_learning_rates(opt, xyz_lr))
    vis = out["visibility_filter"]
    stats = add_densification_stats(stats, grads[-1], vis, out["radii"],
                                    image_size=(camera.image_width, camera.image_height))
    mark("adam")
    metrics = {"loss": loss.detach(), "l1": l1.detach(), "n_visible": vis.sum(),
               "radii": out["radii"], "overflow": out["overflow"]}
    return scene, adam, stats, metrics


def tuned_config(cfg: RenderConfig, gaussians, camera, bg: torch.Tensor) -> RenderConfig:
    """The trainer's render budgets: ``cfg`` right-sized to the counts of a
    probe render of ``camera``. Only worth it at scale: below 50k slots the
    default budgets are kept."""
    if gaussians.capacity < 50_000:
        return cfg
    with torch.no_grad():
        probe = render(camera, gaussians, cfg, bg_color=bg)
    # The table path reports no stream length (``n_padded``, ``n_tiles``).
    return tune_config(cfg, {k: int(probe[k]) for k in ("n_instances", "n_padded", "n_tiles") if k in probe})


def capture(scene, adam: AdamState, stats: DensifyStats, iteration, spatial_lr_scale) -> dict:
    """Full-state checkpoint payload as a flat npz-able dict (the JAX
    package's keys)."""
    host = lambda t: t.detach().cpu().numpy()
    out = {"iteration": np.asarray(iteration), "spatial_lr_scale": np.asarray(spatial_lr_scale),
           "active_sh_degree": np.asarray(scene.active_sh_degree),
           "max_sh_degree": np.asarray(scene.max_sh_degree),
           "alive": host(scene.alive)}
    for k in PARAM_LEAVES:
        out[f"param.{k}"] = host(getattr(scene, k))
        out[f"adam.mu.{k}"] = host(adam.mu[k])
        out[f"adam.nu.{k}"] = host(adam.nu[k])
        out[f"adam.count.{k}"] = host(adam.counts[k])
    out["stats.accum"] = host(stats.xyz_gradient_accum)
    out["stats.denom"] = host(stats.denom)
    out["stats.max_radii2d"] = host(stats.max_radii2d)
    return out


def restore(payload: dict, device=None):
    """Inverse of ``capture`` (a JAX package's payload too). Returns (scene,
    adam, stats, iteration, spatial_lr_scale)."""
    fields = {k: payload[f"param.{k}"] for k in PARAM_LEAVES}
    fields["alive"] = payload["alive"]
    scene = scene_from_numpy(fields, int(payload["active_sh_degree"]), device)
    dev = scene.xyz.device
    adam = adam_from_numpy(
        {k: payload[f"adam.mu.{k}"] for k in PARAM_LEAVES},
        {k: payload[f"adam.nu.{k}"] for k in PARAM_LEAVES},
        {k: payload[f"adam.count.{k}"] for k in PARAM_LEAVES},
        dev,
    )
    stats = stats_from_numpy(payload["stats.accum"], payload["stats.denom"],
                             payload["stats.max_radii2d"], dev)
    return scene, adam, stats, int(payload["iteration"]), float(payload["spatial_lr_scale"])


def orbax_payload(gaussians, adam: AdamState, stats: DensifyStats, iteration, spatial_lr_scale) -> dict:
    """``capture`` as the JAX package's snapshot tree: ``param/<leaf>``,
    ``alive``, ``adam/{mu,nu,counts}/<leaf>``, ``stats/{accum,denom,
    max_radii2d}`` and ``meta`` = float32 [iteration, spatial_lr_scale,
    active_sh_degree, max_sh_degree]."""
    return {
        "param": {k: getattr(gaussians, k).detach() for k in PARAM_LEAVES},
        "alive": gaussians.alive,
        "adam": {"mu": dict(adam.mu), "nu": dict(adam.nu), "counts": dict(adam.counts)},
        "stats": {"accum": stats.xyz_gradient_accum, "denom": stats.denom, "max_radii2d": stats.max_radii2d},
        "meta": torch.tensor([iteration, spatial_lr_scale, gaussians.active_sh_degree, gaussians.max_sh_degree],
                             dtype=torch.float32),
    }


def orbax_restore_state(tree: dict, device=None):
    """Inverse of ``orbax_payload`` (tensors or numpy arrays, so a JAX
    snapshot too); shapes come from the snapshot, so a resume works across
    capacity growth. Returns (scene, adam, stats, iteration, spatial_lr_scale)."""
    host = lambda v: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    meta = host(tree["meta"])
    fields = {k: host(v) for k, v in tree["param"].items()}
    fields["alive"] = host(tree["alive"])
    scene = scene_from_numpy(fields, int(meta[2]), device)
    if scene.max_sh_degree != int(meta[3]):
        raise ValueError(f"snapshot says SH degree {int(meta[3])}, its features say {scene.max_sh_degree}")
    dev = scene.xyz.device
    adam = adam_from_numpy(*({k: host(v) for k, v in tree["adam"][m].items()} for m in ("mu", "nu", "counts")),
                           dev)
    st = tree["stats"]
    stats = stats_from_numpy(host(st["accum"]), host(st["denom"]), host(st["max_radii2d"]), dev)
    return scene, adam, stats, int(meta[0]), float(meta[1])


def training(
    scene_obj,
    opt: OptConfig,
    render_cfg: RenderConfig = RenderConfig(),
    *,
    white_background: bool = False,
    testing_iterations: Sequence[int] = (),
    saving_iterations: Sequence[int] = (),
    checkpoint_iterations: Sequence[int] = (),
    start_checkpoint: Optional[str] = None,
    seed: int = 0,
    log_fn=None,
    capacity_headroom: float = 4.0,
    orbax_dir: Optional[str] = None,
    orbax_every: int = 0,
    viewer: bool = False,
):
    """The reference's training loop against a Scene object (``gaussians``,
    ``cameras_extent``, ``model_path``, ``get_train_cameras``, ``save``).

    The scene starts at ceil(N * ``capacity_headroom``) capacity so that
    densification has free slots; when a densify pass drops points or leaves
    it more than 90% full, it is compacted to twice the capacity and the
    render budgets are re-tuned. ``log_fn(iteration=..., metrics=...,
    loss=..., l1=..., overflow=..., phase_ms=..., densify=..., gaussians=...,
    render_cfg=..., bg=..., testing=...)`` is called after every step;
    ``phase_ms`` holds the step's device times by phase on the card (None on
    the CPU) and ``densify`` the report of a densify pass run at that step.
    With ``orbax_dir``, the run resumes from the newest snapshot under it
    (unless ``start_checkpoint`` is given), snapshots every ``orbax_every``
    iterations and at the last one, and waits for the writes before it
    returns. With ``viewer``, each iteration starts with one
    ``network_gui.pump``: requests are served renders of the current
    Gaussians at the current budgets on the base background, under
    ``torch.no_grad()`` and without touching the trainer's random state;
    with no client connected the pump is one non-blocking ``accept``.
    Returns the trained scene."""
    gaussians = scene_obj.gaussians
    dev = gaussians.xyz.device
    n0 = gaussians.num_alive
    gaussians = gaussians.compact(max(256, int(n0 * capacity_headroom)))

    adam = AdamState.init(gaussians)
    stats = DensifyStats.init(gaussians.capacity, dev)
    spatial_lr_scale = float(scene_obj.cameras_extent)
    first_iter = 0
    if start_checkpoint:
        payload = dict(np.load(start_checkpoint, allow_pickle=False))
        gaussians, adam, stats, first_iter, spatial_lr_scale = restore(payload, dev)
    orbax_mgr = None
    if orbax_dir:
        orbax_mgr = orbax_ckpt.make_manager(orbax_dir)
        if start_checkpoint is None:
            snap = orbax_ckpt.restore_raw(orbax_mgr)
            if snap is not None:
                gaussians, adam, stats, first_iter, spatial_lr_scale = orbax_restore_state(snap, dev)
                print(f"resumed from orbax step {first_iter} ({orbax_dir})")

    bg = torch.tensor([1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0], device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cameras = scene_obj.get_train_cameras()
    if not cameras:
        raise ValueError("no training cameras")

    def retune(cfg, g):
        return tuned_config(cfg, g, cameras[0], bg)

    render_cfg = retune(render_cfg, gaussians)
    timer = StepTimer() if dev.type == "cuda" else None
    rng = np.random.RandomState(seed)
    viewpoint_stack = []
    if viewer:
        from gaussian_transformer_tpu_torch.viewer import network_gui

        source_path = getattr(scene_obj, "source_path", "")

        @torch.no_grad()
        def viewer_render(cam, smod):
            return render(cam, gaussians, render_cfg, bg_color=bg, scaling_modifier=smod)["render"]

    for iteration in range(first_iter + 1, opt.iterations + 1):
        if viewer:
            network_gui.pump(viewer_render, source_path=source_path, device=dev)
        if iteration % 1000 == 0:
            gaussians.oneup_sh_degree()
        if not viewpoint_stack:
            viewpoint_stack = list(cameras)
        cam = viewpoint_stack.pop(rng.randint(len(viewpoint_stack)))
        step_bg = torch.rand(3, generator=gen, device=dev) if opt.random_background else bg

        gaussians, adam, stats, metrics = train_step(
            gaussians, adam, stats, cam, step_bg, iteration, spatial_lr_scale, opt, render_cfg,
            mark=timer,
        )
        # The step's one host read.
        loss_f, overflow, l1_f = torch.stack(
            [metrics["loss"], metrics["overflow"].to(torch.float32), metrics["l1"]]).tolist()
        phase_ms = timer.phase_ms() if timer is not None else None

        report = None
        if iteration < opt.densify_until_iter:
            if iteration > opt.densify_from_iter and iteration % opt.densification_interval == 0:
                size_threshold = 20.0 if iteration > opt.opacity_reset_interval else 0.0
                gaussians, adam, stats, rep = densify_and_prune(
                    gaussians, adam, stats, generator=gen,
                    max_grad=opt.densify_grad_threshold, min_opacity=0.005,
                    extent=spatial_lr_scale, max_screen_size=size_threshold,
                    percent_dense=opt.percent_dense,
                )
                report = {k: int(v) for k, v in rep._asdict().items()}
                report["n_alive"] = gaussians.num_alive
                if report["n_dropped"] > 0 or report["n_alive"] > 0.9 * gaussians.capacity:
                    new_cap = max(int(gaussians.capacity * 2), 256)
                    adam = compact_state(adam, gaussians.alive, new_cap)
                    gaussians = gaussians.compact(new_cap)
                    stats = DensifyStats.init(new_cap, dev)
                    render_cfg = retune(render_cfg, gaussians)
                    report["capacity"] = new_cap
            if (iteration % opt.opacity_reset_interval == 0
                    or (white_background and iteration == opt.densify_from_iter)):
                gaussians, adam = reset_opacity(gaussians, adam)

        if log_fn is not None:
            log_fn(iteration=iteration, metrics=metrics, loss=loss_f, l1=l1_f, overflow=int(overflow),
                   phase_ms=phase_ms, densify=report, gaussians=gaussians,
                   render_cfg=render_cfg, bg=bg, testing=(iteration in testing_iterations))
        if iteration in saving_iterations:
            scene_obj.gaussians = gaussians
            scene_obj.save(iteration)
        if iteration in checkpoint_iterations:
            os.makedirs(scene_obj.model_path, exist_ok=True)
            np.savez(
                os.path.join(scene_obj.model_path, f"chkpnt{iteration}.npz"),
                **capture(gaussians, adam, stats, iteration, spatial_lr_scale),
            )
        if orbax_mgr is not None and orbax_every and iteration % orbax_every == 0:
            orbax_ckpt.save(orbax_mgr, iteration, orbax_payload(gaussians, adam, stats, iteration, spatial_lr_scale))
    if orbax_mgr is not None:
        if orbax_mgr.latest_step() != opt.iterations:
            orbax_ckpt.save(orbax_mgr, opt.iterations,
                            orbax_payload(gaussians, adam, stats, opt.iterations, spatial_lr_scale))
        orbax_mgr.wait_until_finished()
    scene_obj.gaussians = gaussians
    return gaussians


@torch.no_grad()
def evaluate_psnr(gaussians, cameras, render_cfg=RenderConfig(), bg=None, max_cameras=None):
    """Mean PSNR and L1 over a camera list (the reference's training report)."""
    dev = gaussians.xyz.device
    bg = torch.zeros(3, device=dev) if bg is None else bg
    cams = cameras[:max_cameras] if max_cameras else cameras
    psnrs, l1s = [], []
    for cam in cams:
        img = torch.clamp(render(cam, gaussians, render_cfg, bg_color=bg)["render"], 0.0, 1.0)
        gt = torch.clamp(cam.original_image, 0.0, 1.0)
        psnrs.append(float(torch.mean(psnr(img, gt))))
        l1s.append(float(l1_loss(img, gt)))
    return float(np.mean(psnrs)), float(np.mean(l1s))
