"""Training the stacked Gaussian-sequence transformer: the stacked CLI's
loop (``cli/train_stacked.py``) around ``train/stacked.py
make_train_step`` on ``TrainingScene.batches()``: float32 Adam, train-mode
dropout from a per-step key, each step's loss and Chamfer read on the
host (in the window once the next step is sent), the plateau scheduler
stepped each epoch. At the start of training
Chamfer is far above the gate, so the image loss is shut and the render is
bypassed; the model's GEMMs and the loss's greedy decode do the work.

Weights are drawn by the benchmark (``perfbench/reference/transformer.py
draw_weights``) and copied into the port's model. Correctness: the first
three steps run through the window's loop; step 1's loss, the first
gradient (from Adam's first moment after step 1) and each parameter's
change after step 3 are held against the reference's three steps on the
same batches, dropout keys and learning rates (``steady_checks``). The reference follows the
program's batches (``TrainingScene`` makes them from the scene);
``batch_check`` holds each checked batch's real Gaussians against the
scene's (and reports, uncompared, their count against the reference's
visibility: every ring camera sees the whole scene, so no fault of the
batcher's camera handling moves it).
"""

from __future__ import annotations

import gc
import itertools
import math
import statistics
import time

import numpy as np
import torch

from perfbench import core, floors, scenes
from perfbench.drivers.splat_train import port_camera
from perfbench.reference import transformer as ref

N_CHECKED = 3


def weight_seed(seed: int) -> int:
    return scenes.sub_seed(seed, 8)


def dropout_base(seed: int) -> int:
    return scenes.sub_seed(seed, 9) % 2**31


def port_scene(cfg, traffic, seed, device):
    """The seeded scene as the port's GaussianScene at SH degree 1, and the
    ring cameras."""
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene

    fields = scenes.synthetic_scene(cfg["gaussians"], seed, device, sh_degree=1)
    views = scenes.orbit_views(traffic["views"], seed, device)
    scene = GaussianScene(cfg["gaussians"], 1, device)
    with torch.no_grad():
        for k, v in fields.items():
            getattr(scene, k).copy_(v)
        scene.alive.fill_(True)
    scene.active_sh_degree = 1
    cams = [port_camera(i, v, None) for i, v in enumerate(views)]

    class SceneObj:
        gaussians = scene

        @staticmethod
        def get_train_cameras():
            return cams

    return SceneObj, fields, views


def port_model(cfg, seed, device):
    from gaussian_transformer_tpu_torch.train import stacked

    model = stacked.make_stacked_model(cfg["stack"], cfg["layers"], 0, seed=0, device=device)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in ref.draw_weights(cfg["d_model"], cfg["layers"], weight_seed(seed), device):
            params[name].copy_(t)
    return model


def change_norms(named, cfg, seed, device) -> dict:
    """Each parameter's distance from its initial draw (drawn again one at a
    time)."""
    return {n: float(torch.linalg.vector_norm((named[n].detach() - t).double()))
            for n, t in ref.draw_weights(cfg["d_model"], cfg["layers"], weight_seed(seed), device)}


def first_moment_norm(optimizer, p) -> float:
    """The norm of the gradient Adam took at its first step, from its first
    moment (zero before it): m_1 = (1 - b1) g."""
    m = optimizer.state.get(p, {}).get("exp_avg")
    return 0.0 if m is None else float(torch.linalg.vector_norm(m.double())) / (1 - 0.9)


def steady_checks(prog: dict, refr: dict, limits: dict) -> dict:
    """The compared numbers: step 1's loss gap, and the median leaf's gap of
    the first gradient's norm and of each leaf's change after the last
    checked step (each leaf against the larger of its own and the median
    leaf's reference norm; leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out). Not the worst step's or the worst leaf's: where two targets lie
    within rounding of one predicted Gaussian, Chamfer's nearest neighbour
    goes either way on the two sides, which moves every later loss and the
    worst leaves of a sound run about as far as the control does."""
    med = statistics.median(refr["grad"].values())
    keep = [k for k, v in refr["grad"].items() if v >= 1e-3 * med]

    def median_gap(key):
        m = statistics.median(refr[key][k] for k in keep)
        return statistics.median(core.rel_gap(prog[key][k], refr[key][k], m) for k in keep)

    loss1 = core.rel_gap(prog["losses"][0], refr["losses"][0]) if prog["losses"] and refr["losses"] else math.inf
    return {"loss1_gap": {"value": loss1, "limit": limits["loss1_gap"]},
            "grad_gap_median": {"value": median_gap("grad"), "limit": limits["grad_gap_median"]},
            "delta_gap_median": {"value": median_gap("delta"), "limit": limits["delta_gap_median"]}}


def worst_readings(prog: dict, refr: dict) -> dict:
    """The worst step's loss gap and the worst leaf's gaps, read beside the
    compared numbers and not compared."""
    limits = {"loss_gap": math.inf, "grad_gap": math.inf, "delta_gap": math.inf}
    return {k: c["value"] for k, c in core.training_checks(prog, refr, limits, N_CHECKED).items()}


def scene_tokens(fields) -> torch.Tensor:
    """The scene's Gaussians as the stacked model's tokens (SH 12, rotation
    4, opacity 1, xyz 3, log-scale 3, flags 3), xyz mapped by each axis'
    range and log-scales by their joint range into [0, 1]."""
    xyz, sc = fields["xyz"], fields["scaling"]
    lo, hi = xyz.amin(0), xyz.amax(0)
    feats = torch.cat([fields["features_dc"], fields["features_rest"]], 1).reshape(xyz.shape[0], -1)
    return torch.cat([feats, fields["rotation"], fields["opacity"], (xyz - lo) / (hi - lo),
                      (sc - sc.min()) / (sc.max() - sc.min()), torch.zeros_like(xyz)], 1)


def batch_check(checked, fields, views, stack: int) -> dict:
    """The batcher, held by itself on each checked batch: the share of its
    real Gaussians (PAD rows out) that are not Gaussians of the scene, and
    the gap between their count and what the reference's projection sees
    from the batch's cameras, cut to whole fat tokens; the worst batch's."""
    from perfbench.reference.splat import project

    pad = ref.special_token(ref.PAD_FLAG, stack)
    toks = scene_tokens(fields)
    radii = {}
    worst = {"batch_rows_off": 0.0, "batch_count_gap": 0.0}
    for b in checked:
        fat = torch.cat([b["src"][0], b["trg_y"][0]])
        rows = ref.unstack(fat[~ref.is_token(fat, pad)], stack)
        off = 0
        for part in rows.split(4096):
            off += int((torch.cdist(part.double(), toks.double()).amin(1) > 1e-5).sum())
        vis = torch.zeros(toks.shape[0], dtype=torch.bool, device=toks.device)
        for uid in b["cameras"]:
            if uid not in radii:
                radii[uid] = project(fields, views[uid], 1).radii > 0
            vis |= radii[uid]
        want = int(vis.sum()) // 2 ** stack * 2 ** stack
        worst["batch_rows_off"] = max(worst["batch_rows_off"], off / max(len(rows), 1))
        worst["batch_count_gap"] = max(worst["batch_count_gap"], abs(len(rows) - want) / max(want, 1))
    return worst


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.train import stacked

    cfg, traffic = cell.config, cell.traffic
    scene_obj, fields, views = port_scene(cfg, traffic, seed, device)
    core.sync(torch, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # The CLI's batcher seed: every run walks the same camera groups and
    # windows, so a seed changes the scene and the weights, not the shapes.
    tscene = stacked.TrainingScene(scene_obj, RenderConfig(), batch_size=cfg["batch_size"], stack=cfg["stack"],
                                   interval_num=cfg["interval_num"], bucket=cfg["bucket"], seed=0)
    model = port_model(cfg, seed, device)
    named = dict(model.named_parameters())
    optimizer = stacked.make_optimizer(model)
    scheduler = stacked.ReduceLROnPlateau(lr=cfg["lr"])
    step_fn = stacked.make_train_step(model, tscene.handler, RenderConfig(), optimizer, cfg["stack"])
    model.train()

    base = dropout_base(seed)
    warm, slice_steps = traffic["warmup_steps"], traffic["trace_steps"]
    tracer = core.Trace(torch) if trace else None
    checked, losses, first_grad, delta = [], [], {}, {}
    fetch_ms, lengths, step_end = [], [], []
    n, global_step, t0, setup, untraced, slice_at, trace_s = 0, 0, None, None, None, None, None
    done = False
    # (step, loss, chamfer, img_loss) not yet read on the host. In the window
    # a step's results are read once the next step is sent, so the card can
    # finish the update while the host builds the next batch; the read
    # costs no wait there, since the next step's gate has read its Chamfer.
    pending = []
    tally = {"loss": 0.0, "failed": 0, "gate_open": 0}

    def settle(keep: int) -> None:
        while len(pending) > keep:
            i, loss_t, chamfer_t, img_t = pending.pop(0)
            loss = float(loss_t)
            float(chamfer_t)
            img_loss = float(img_t)
            tally["loss"] += loss
            if i <= N_CHECKED:
                losses.append(loss)
            if i <= N_CHECKED or i > warm:
                tally["gate_open"] += int(img_loss != 0.0)
            if i > warm:
                tally["failed"] += int(not np.isfinite(loss))

    for epoch in itertools.count():
        tscene.set_epoch(epoch)
        tally["loss"], total_tokens = 0.0, 0
        batches = tscene.batches()
        while True:
            a = time.perf_counter()
            batch = next(batches, StopIteration)
            fetched = time.perf_counter() - a
            if batch is StopIteration:
                break
            if batch is None:
                continue
            key = (base, global_step)
            if n < N_CHECKED:
                checked.append({"src": batch.src.clone(), "trg_y": batch.trg_y.clone(),
                                "src_mask": batch.src_mask.clone(), "key": key, "lr": scheduler.lr,
                                "cameras": [c.uid for c in batch.cameras]})
            loss, metrics = step_fn(batch.src, batch.trg_y, batch.cameras, scheduler.lr, batch.src_mask, key)
            global_step += 1
            n += 1
            total_tokens += batch.ntokens
            pending.append((n, loss, metrics["chamfer"], metrics["img_loss"]))
            if t0 is None:
                # Set-up: every step read at once, the checked steps' state
                # read before the next step moves it.
                settle(0)
                if n == 1:
                    first_grad = {k: first_moment_norm(optimizer, p) for k, p in named.items()}
                if n == N_CHECKED:
                    delta = change_norms(named, cfg, seed, device)
                if n == warm:
                    t0 = time.perf_counter()
                    setup = t0 - t_start
                continue
            settle(1)
            now = time.perf_counter()
            if slice_at is None:
                fetch_ms.append(1e3 * fetched)
                step_end.append(now)
                if tracer is not None:
                    lengths.append((int(batch.src_mask.sum()), batch.ntokens))
                end = seconds if tracer is None else seconds - traffic["trace_seconds"]
                if now - t0 >= end:
                    # Time is up: nothing more is sent, all that was sent is
                    # waited for, and the clock is read after that wait.
                    settle(0)
                    core.sync(torch, device)
                    now = time.perf_counter()
                    if tracer is None:
                        t_end, done = now, True
                        break
                    untraced = (n - warm, now - t0)
                    tracer.start()
                    slice_at = (n, time.perf_counter())
            elif n - slice_at[0] >= slice_steps:
                settle(0)
                core.sync(torch, device)
                t_end = time.perf_counter()
                trace_s = t_end - slice_at[1]
                tracer.stop()
                done = True
                break
        if done:
            break
        settle(0)
        scheduler.step(tally["loss"] / max(total_tokens, 1))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    steps = n - warm
    window_s = t_end - t0
    n_params = sum(p.numel() for p in named.values())
    bc = batch_check(checked, fields, views, cfg["stack"])
    del model, named, optimizer, step_fn, tscene, scene_obj, batches, batch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = {"cell": cell.name, "steps": steps, "window_s": window_s,
                "batch_ms": float(np.mean(fetch_ms)) if fetch_ms else None}
    if tracer is not None:
        d, layers = cfg["d_model"], cfg["layers"]
        readings.update(trace=tracer.summary(), trace_units=slice_steps, trace_s=trace_s,
                        untraced_steps=untraced[0], untraced_s=untraced[1],
                        step_floor_s=float(np.mean([floors.stacked_step(d, layers, n_params, ls, lt)
                                                    for ls, lt in lengths])))
    refr = reference_steps(cfg, seed, checked, device, tf32=False)
    prog = {"losses": losses, "grad": first_grad, "delta": delta}
    checks = steady_checks(prog, refr, traffic["limits"])
    checks["batch_rows_off"] = {"value": bc["batch_rows_off"], "limit": traffic["limits"]["batch_rows_off"]}
    return {"e2e": {"stacked_step_ms": 1e3 * window_s / steps}, "setup_s": setup, "readings": readings,
            "attempted": steps, "failed": tally["failed"], "checks": checks, "memory_peak_bytes": peak,
            "detail": {"program": prog, "reference": refr, "gate_open_steps": tally["gate_open"],
                       "worst": worst_readings(prog, refr),
                       "batch_count_gap": bc["batch_count_gap"],
                       "step_ms": [round(1e3 * (b - a), 2) for a, b in zip([t0] + step_end, step_end)],
                       "fetch_ms": [round(x, 2) for x in fetch_ms]}}


def reference_steps(cfg, seed, checked, device, tf32: bool) -> dict:
    """The reference's steps on the kept batches, from the seed's weights:
    each loss, the first gradient's norm and each parameter's change after
    the last, by parameter."""
    P = {k: v.requires_grad_() for k, v in ref.init_weights(cfg["d_model"], cfg["layers"], weight_seed(seed),
                                                             device).items()}
    m = ref.Model(P, cfg["layers"], cfg["heads"], cfg["dropout"])
    opt = ref.Adam(P, eps=cfg["adam_eps"])
    losses, grad = [], {}
    names = list(P)
    with ref.matmul_precision(tf32):
        for i, b in enumerate(checked):
            loss = ref.train_loss(m, b["src"], b["trg_y"], b["src_mask"], cfg["stack"], b["key"])
            g = torch.autograd.grad(loss, [P[k] for k in names])
            grads = dict(zip(names, g))
            losses.append(float(loss.detach()))
            if i == 0:
                grad = {k: float(torch.linalg.vector_norm(grads[k].double())) for k in names}
            opt.step(grads, b["lr"])
            del g, grads, loss
    delta = change_norms(P, cfg, seed, device)
    del P, m, opt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad": grad, "delta": delta}


def control(cell, seed: int, device) -> dict:
    """The control: the reference with TF32 matrix products steps in the
    port's place on the port's first batches; judged against the float32
    reference on the same batches."""
    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.train import stacked

    cfg, traffic = cell.config, cell.traffic
    scene_obj, _, _ = port_scene(cfg, traffic, seed, device)
    tscene = stacked.TrainingScene(scene_obj, RenderConfig(), batch_size=cfg["batch_size"], stack=cfg["stack"],
                                   interval_num=cfg["interval_num"], bucket=cfg["bucket"], seed=0)
    tscene.set_epoch(0)
    base, checked = dropout_base(seed), []
    for batch in tscene.batches():
        if batch is not None and len(checked) < N_CHECKED:
            checked.append({"src": batch.src, "trg_y": batch.trg_y, "src_mask": batch.src_mask,
                            "key": (base, len(checked)), "lr": cfg["lr"]})
    refr = reference_steps(cfg, seed, checked, device, tf32=False)
    low = reference_steps(cfg, seed, checked, device, tf32=True)
    return {"checks": steady_checks(low, refr, traffic["limits"]),
            "detail": {"program": low, "reference": refr, "worst": worst_readings(low, refr)}}
