"""The densify pass after an opacity reset, where the 20-px screen-size rule
is armed, in both packages from one checkpoint.

Both trainers resume from the same ``chkpnt<s>.npz`` (the JAX package's
``capture`` layout) and run to the pass iteration ``p`` with the densify
window ending there, so each one's own train steps build ``max_radii2d`` up
to the value the pass reads; then each package's densify pass runs on its
own state with the trainer's arguments (``train/splat.py training``:
``min_opacity`` 0.005, ``max_screen_size`` 20 past the reset interval).
Compared: the screen radii at the pass, the pass's report (cloned, split,
pruned, dropped) and the alive mask after it; and the pass of each package
on one shared state.

The test runs this at a small size from a JAX-written checkpoint. Run as a
script, it runs the same comparison on the quality gate's scene at
1280x720 from a checkpoint written by the gate's trainer
(``python -m gaussian_transformer_tpu_torch.tools.full_gate --iters 3500
--checkpoint_iterations 3499`` keeps ``chkpnt3499.npz`` and the dataset
under its work dir)::

    python tests/test_torch_prune_pass.py --scene <work>/scene \\
        --checkpoint <work>/model/chkpnt3499.npz [--out result.json]

and also holds the checkpoint's radii, built up by the run that wrote it,
against the JAX package's projection of the checkpoint's scene into every
training view. Tolerances: at the small size the radii at the pass and the
pass's outcome agree exactly."""

import argparse
import json
import math
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render.project import project_gaussians
from gaussian_transformer_tpu.scene.cameras import Camera as JaxCamera
from gaussian_transformer_tpu.scene.densify import DensifyStats as JaxStats
from gaussian_transformer_tpu.scene.densify import densify_and_prune as jax_densify
from gaussian_transformer_tpu.train.optim import AdamState as JaxAdam
from gaussian_transformer_tpu.train.splat import OptConfig as JaxOptConfig
from gaussian_transformer_tpu.train.splat import capture as jax_capture
from gaussian_transformer_tpu.train.splat import restore as jax_restore
from gaussian_transformer_tpu.train.splat import training as jax_training
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.scene.cameras import Camera
from gaussian_transformer_tpu_torch.scene.densify import densify_and_prune
from gaussian_transformer_tpu_torch.train.splat import OptConfig, restore, training

SCREEN_PX = 20.0  # train/splat.py training: max_screen_size past the reset interval
MIN_OPACITY = 0.005
GATE_GRAD_THRESHOLD = 0.0001  # tools/full_gate.py --grad-threshold
REPORT = ("n_cloned", "n_split", "n_pruned", "n_dropped")


def _scene_obj(gaussians, cams, model_path):
    return types.SimpleNamespace(gaussians=gaussians, cameras_extent=1.0, model_path=str(model_path),
                                 get_train_cameras=lambda scale=1.0: cams,
                                 get_test_cameras=lambda scale=1.0: [], save=lambda it: None)


def _jax_pass(payload, iteration, opt):
    scene, adam, stats, _, extent = jax_restore(payload)
    size = SCREEN_PX if iteration > opt.opacity_reset_interval else 0.0
    scene, _, _, rep = jax_densify(scene, adam, stats, jax.random.PRNGKey(0), max_grad=opt.densify_grad_threshold,
                                   min_opacity=MIN_OPACITY, extent=extent, max_screen_size=size,
                                   percent_dense=opt.percent_dense)
    return {k: int(getattr(rep, k)) for k in REPORT}, np.asarray(scene.alive)


def _port_pass(payload, iteration, opt):
    scene, adam, stats, _, extent = restore(payload, torch.device("cpu"))
    size = SCREEN_PX if iteration > opt.opacity_reset_interval else 0.0
    scene, _, _, rep = densify_and_prune(scene, adam, stats, generator=torch.Generator().manual_seed(0),
                                         max_grad=opt.densify_grad_threshold, min_opacity=MIN_OPACITY,
                                         extent=extent, max_screen_size=size, percent_dense=opt.percent_dense)
    return {k: int(getattr(rep, k)) for k in REPORT}, scene.alive.numpy()


def both_through_the_pass(checkpoint, jax_cams, port_cams, pass_iter, work, **opt_kw) -> dict:
    """Both trainers from ``checkpoint`` to ``pass_iter`` (no pass runs
    between: the densify window ends at ``pass_iter``), then each package's
    pass on its own state and on the JAX trainer's. Returns the radii at the
    pass, the reports and the alive masks, by package."""
    payload = dict(np.load(checkpoint))
    opt_kw = dict(opt_kw, iterations=pass_iter, densify_until_iter=pass_iter)
    jopt, topt = JaxOptConfig(**opt_kw), OptConfig(**opt_kw)
    work = Path(work)
    t0 = time.time()
    jax_training(_scene_obj(jax_restore(payload)[0], jax_cams, work / "jax"), jopt, JaxRenderConfig(),
                 progress=False, start_checkpoint=str(checkpoint), checkpoint_iterations={pass_iter})
    t1 = time.time()
    training(_scene_obj(restore(payload, torch.device("cpu"))[0], port_cams, work / "port"), topt, RenderConfig(),
             start_checkpoint=str(checkpoint), checkpoint_iterations={pass_iter})
    t2 = time.time()
    out = {"seconds": {"jax": t1 - t0, "port": t2 - t1}}
    at_pass = {}
    for name in ("jax", "port"):
        at_pass[name] = dict(np.load(work / name / f"chkpnt{pass_iter}.npz"))
        st = at_pass[name]
        out[name] = {"alive_in": st["alive"], "radii": st["stats.max_radii2d"],
                     "opacity": 1 / (1 + np.exp(-st["param.opacity"][:, 0].astype(np.float64))),
                     "world_big": np.exp(st["param.scaling"].max(-1)) > 0.1 * float(st["spatial_lr_scale"])}
    for name, fn in (("jax", _jax_pass), ("port", _port_pass)):
        out[name]["report"], out[name]["alive_out"] = fn(at_pass[name], pass_iter, topt)
    # Both passes on one state: the JAX trainer's.
    out["shared"] = {name: fn(at_pass["jax"], pass_iter, topt) for name, fn in
                     (("jax", _jax_pass), ("port", _port_pass))}
    return out


def summarize(res) -> dict:
    """Counts of the comparison (the alive slots at the pass are the JAX run's)."""
    alive = res["jax"]["alive_in"]
    rj, rp = res["jax"]["radii"][alive], res["port"]["radii"][alive]
    s = {
        "alive_at_pass": {n: int(res[n]["alive_in"].sum()) for n in ("jax", "port")},
        "alive_masks_equal_at_pass": bool(np.array_equal(res["jax"]["alive_in"], res["port"]["alive_in"])),
        "radii_over_20px": {"jax": int((rj > SCREEN_PX).sum()), "port": int((rp > SCREEN_PX).sum())},
        "radii_equal": int((rj == rp).sum()),
        "radii_max_abs_diff": float(np.abs(rj - rp).max()) if alive.any() else 0.0,
        "radii_20px_class_differs": int(((rj > SCREEN_PX) != (rp > SCREEN_PX)).sum()),
        "opacity_under_min": {n: int((res[n]["opacity"][res[n]["alive_in"]] < MIN_OPACITY).sum())
                              for n in ("jax", "port")},
        # What the pass's prune rules see, in each package's state at the pass:
        # alive slots by rule, and free slots (where clones and split children
        # land) whose radii, built up while they were free, exceed 20 px.
        "prune_rules": {n: {
            "alive_opacity": int((res[n]["alive_in"] & (res[n]["opacity"] < MIN_OPACITY)).sum()),
            "alive_screen": int((res[n]["alive_in"] & (res[n]["radii"] > SCREEN_PX)).sum()),
            "alive_world": int((res[n]["alive_in"] & res[n]["world_big"]).sum()),
            "alive_any": int((res[n]["alive_in"] & ((res[n]["opacity"] < MIN_OPACITY) | (res[n]["radii"] > SCREEN_PX)
                                                    | res[n]["world_big"])).sum()),
            "free_screen": int((~res[n]["alive_in"] & (res[n]["radii"] > SCREEN_PX)).sum()),
        } for n in ("jax", "port")},
        "report": {n: res[n]["report"] for n in ("jax", "port")},
        "alive_after": {n: int(res[n]["alive_out"].sum()) for n in ("jax", "port")},
        "alive_after_differs": int((res["jax"]["alive_out"] != res["port"]["alive_out"]).sum()),
        "shared_state": {
            "report": {n: res["shared"][n][0] for n in ("jax", "port")},
            "alive_after_differs": int((res["shared"]["jax"][1] != res["shared"]["port"][1]).sum()),
        },
        "seconds": res["seconds"],
    }
    return s


# ------------------------------------------------------------- the test ---


def test_size_prune_pass_matches_the_jax_package(tmp_path):
    """From a JAX-written ``chkpnt3490.npz`` (iteration 3490: past the first
    reset; 200 Gaussians in 800 slots, fresh densify stats), 10 steps on
    three 64x48 views, in which 55 Gaussians reach more than 20 px, then the
    pass at 3,500, which clones, splits and prunes."""
    from tests.test_train import _synthetic_scene_and_cams
    from tests.torch_port_support import torch_camera

    start, cams = _synthetic_scene_and_cams(n=200, n_cams=3, width=64, height=48, seed=5)
    rng = np.random.RandomState(5)
    start = start.replace(scaling=jnp.asarray(rng.uniform(-3.0, -0.3, start.scaling.shape), jnp.float32)).compact(800)
    ckpt = tmp_path / "chkpnt3490.npz"
    np.savez(ckpt, **jax_capture(start, JaxAdam.init(start), JaxStats.init(start.capacity), 3490, 10.0))
    tcams = []
    for cam in cams:
        t = torch_camera(cam)
        t.original_image = torch.tensor(np.asarray(cam.original_image))
        tcams.append(t)
    s = summarize(both_through_the_pass(ckpt, cams, tcams, 3500, tmp_path, densify_grad_threshold=0.003))
    assert s["alive_masks_equal_at_pass"] and s["alive_at_pass"]["jax"] == 200
    n_big = s["radii_over_20px"]["jax"]
    assert 10 <= n_big <= 190, n_big  # the rule has something to prune and something to keep
    assert s["radii_equal"] == 200 and s["radii_over_20px"]["port"] == n_big
    rep = s["report"]["jax"]
    assert rep["n_cloned"] > 0 and rep["n_split"] > 0 and rep["n_pruned"] > 0 and rep["n_dropped"] == 0
    assert s["report"]["port"] == rep and s["alive_after_differs"] == 0
    assert s["shared_state"]["report"]["port"] == s["shared_state"]["report"]["jax"]
    assert s["shared_state"]["alive_after_differs"] == 0


# ------------------------------------------------- the gate's scene (script) ---


def _gate_cameras(scene_dir):
    """The gate's training views (``cli.train --eval``: every 8th view held
    out), for both packages; a view whose image is absent has none (only the
    views a run steps on need one)."""
    from gaussian_transformer_tpu_torch.scene.dataset_readers import read_colmap_scene_info

    info = read_colmap_scene_info(str(scene_dir), "images", eval=True)
    jcams, tcams = [], []
    for i, c in enumerate(info.train_cameras):
        img = None if c.image is None else c.image[..., :3].astype(np.float32).transpose(2, 0, 1) / 255.0
        jcams.append(JaxCamera.create(c.uid, c.R, c.T, c.FovX, c.FovY, img, None, c.image_name, i,
                                      width=c.width, height=c.height))
        tcams.append(Camera.create(c.uid, c.R, c.T, c.FovX, c.FovY, img, None, c.image_name, i,
                                   width=c.width, height=c.height, device="cpu"))
    return jcams, tcams


def projected_radii(payload, jcams) -> np.ndarray:
    """The JAX package's screen radius of each slot, maxed over the views
    (0 where no view sees it)."""
    scene = jax_restore(payload)[0]
    out = np.zeros(scene.capacity, np.float32)
    for cam in jcams:
        proj = project_gaussians(
            scene.get_xyz, scene.get_scaling, scene.get_rotation, scene.get_opacity[:, 0], scene.get_features, None,
            world_view_transform=cam.world_view_transform, full_proj_transform=cam.full_proj_transform,
            camera_center=cam.camera_center, image_width=cam.image_width, image_height=cam.image_height,
            tan_fovx=math.tan(cam.fovx * 0.5), tan_fovy=math.tan(cam.fovy * 0.5),
            active_sh_degree=scene.active_sh_degree)
        out = np.maximum(out, np.asarray(proj.radii, np.float32))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", required=True, help="the gate's COLMAP text dataset")
    ap.add_argument("--checkpoint", required=True,
                    help="chkpnt<s>.npz of the gate's trainer, s + 1 a densify pass")
    ap.add_argument("--work", default=None, help="the two runs' model dirs (default: next to --out)")
    ap.add_argument("--out", default="prune_pass.json")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    payload = dict(np.load(args.checkpoint))
    jcams, tcams = _gate_cameras(args.scene)
    alive = payload["alive"]
    card = payload["stats.max_radii2d"][alive]
    proj = projected_radii(payload, jcams)[alive]
    result = {
        "checkpoint": {"iteration": int(payload["iteration"]), "alive": int(alive.sum()),
                       "capacity": int(alive.size), "extent": float(payload["spatial_lr_scale"])},
        "checkpoint_radii_vs_jax_projection": {
            "over_20px": {"checkpoint": int((card > SCREEN_PX).sum()), "jax_all_views": int((proj > SCREEN_PX).sum())},
            "20px_class_differs": int(((card > SCREEN_PX) != (proj > SCREEN_PX)).sum()),
            # The checkpoint's radii are maxima over the run's past views, so
            # they should sit at or above one state's projection.
            "checkpoint_below_jax": int((card < proj).sum()),
            "checkpoint_below_jax_by_more_than_1px": int((card < proj - 1).sum()),
            "median": {"checkpoint": float(np.median(card)), "jax_all_views": float(np.median(proj))},
        },
    }
    print(json.dumps(result), flush=True)
    work = Path(args.work) if args.work else Path(args.out).resolve().parent / "prune_pass_work"
    res = both_through_the_pass(args.checkpoint, jcams, tcams, int(payload["iteration"]) + 1, work,
                                densify_grad_threshold=GATE_GRAD_THRESHOLD)
    result["through_the_pass"] = summarize(res)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result["through_the_pass"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
