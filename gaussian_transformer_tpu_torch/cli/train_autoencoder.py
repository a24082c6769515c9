"""Autoencoder training CLI, the lr sweep harness (port of the root
``train_autoencoder.py``, single device).

For each lr multiple in [``--lr_sweep_start``, ``--lr_sweep_stop``) (lr =
1e-5 x multiple): load the latest trained scene, box-sort and denormalise it,
and train ``GAutoEncoder`` (``--conv``: ``GConvAutoEncoder``) with Adam(eps
1e-15) on each training camera's visible Gaussians (one visibility render a
step, cameras in a ``RandomState(0)`` order per epoch). The loss is the
token L1 for epochs <= 500 (``token_loss``), then the image loss of renders
of the input and the reconstructed tokens, 0.6 x L1 + 0.2 x (1 - SSIM) + 0.2
x LPIPS(alex) when its weights are present (``image_loss``). A step whose
loss is not finite is skipped, as the reference swallows backward errors.
Runs on the CUDA card unless ``--device cpu`` is given. TensorBoard scalars
go to ``LRruns/gaussian_autoencoder_<multiple>`` when
``torch.utils.tensorboard`` imports. After each step the SIBR remote viewer
at ``--ip``/``--port`` (default 127.0.0.1:6009) is served renders of the
step's reconstruction (``viewer/network_gui.py pump``); when the address is
taken the run prints ``viewer disabled: ...`` and trains on.

    python -m gaussian_transformer_tpu_torch.cli.train_autoencoder -s <data> -m <model> [--epochs N]
"""

from __future__ import annotations

import math
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from gaussian_transformer_tpu_torch.config import ModelParams, OptimizationParams, PipelineParams
from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.eval import lpips as lpips_mod
from gaussian_transformer_tpu_torch.models.autoencoder import GAutoEncoder, GConvAutoEncoder, init_autoencoder
from gaussian_transformer_tpu_torch.models.box_sort import GaussianHandler
from gaussian_transformer_tpu_torch.models.codec import flatten_gaussians, unflatten_gaussians
from gaussian_transformer_tpu_torch.ops.losses import l1_loss, ssim
from gaussian_transformer_tpu_torch.render import RenderConfig, render
from gaussian_transformer_tpu_torch.scene import Scene
from gaussian_transformer_tpu_torch.viewer import network_gui

TOKEN_EPOCHS = 500  # epochs <= this train on the token L1, later ones on the image loss


def token_loss(model, data):
    """L1 between the model's reconstruction of ``data`` [1, L, 26] and
    ``data``. Returns (loss, pred [1, L, 26])."""
    pred = model(data.transpose(1, 2)).transpose(1, 2)
    return l1_loss(pred, data), pred


def image_loss(model, data, cam, render_cfg: RenderConfig = RenderConfig(), use_lpips: bool = False):
    """Renders of ``data`` and of its reconstruction from ``cam``: 0.6 x L1
    + 0.2 x (1 - SSIM) (+ 0.2 x LPIPS(alex) when ``use_lpips``). Returns
    (loss, pred)."""
    pred = model(data.transpose(1, 2)).transpose(1, 2)
    in_im = render(cam, unflatten_gaussians(data[0]), render_cfg)["render"]
    out_im = render(cam, unflatten_gaussians(pred[0]), render_cfg)["render"]
    loss = l1_loss(out_im, in_im) * 0.6 + (1.0 - ssim(in_im, out_im)) * 0.2
    if use_lpips:
        loss = loss + 0.2 * lpips_mod.lpips(torch.clamp(in_im, 0, 1), torch.clamp(out_im, 0, 1), "alex")
    return loss, pred


def _parse(argv):
    parser = ArgumentParser(description="Training script parameters")
    lp = ModelParams(parser)
    OptimizationParams(parser)
    PipelineParams(parser)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--epochs", type=int, default=505)
    parser.add_argument("--lr_sweep_start", type=int, default=20)
    parser.add_argument("--lr_sweep_stop", type=int, default=100)
    parser.add_argument("--conv", action="store_true", help="use the conv autoencoder instead of the scalar stub")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return lp, parser.parse_args(sys.argv[1:] if argv is None else argv)


def main(argv=None, on_step=None):
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``); ``on_step``, if
    given, is called with each step's record as it is made. Returns a
    summary: ``models`` ({lr multiple: model}) and ``history`` (one dict per
    step: lrm, lr, epoch, step, kind ("token" or "image"), n_visible, loss,
    finite, and ``ms`` on the card)."""
    lp, args = _parse(argv)
    device = resolve_device(args.device)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    print("Optimizing " + args.model_path)
    dataset = lp.extract(args)
    render_cfg = RenderConfig()
    viewer_ok = network_gui.bind_viewer(args.ip, args.port)

    use_lpips = lpips_mod.available("alex")
    if not use_lpips:
        print("LPIPS(alex) weights absent — image loss runs without the perceptual term")
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        SummaryWriter = None

    on_card = device.type == "cuda"
    models, history = {}, []
    for lrm in range(args.lr_sweep_start, args.lr_sweep_stop, 1):
        scene = Scene(dataset, load_iteration=-1, sh_degree=dataset.sh_degree, device=device)
        with torch.no_grad():
            handler = GaussianHandler.create(scene.gaussians)
            gaussians = handler.denormalize(unflatten_gaussians(handler.box_sort(scene.gaussians)))
            f_gaussians = flatten_gaussians(gaussians)

        model = GConvAutoEncoder(device=device) if args.conv else GAutoEncoder(device=device)
        init_autoencoder(model, seed=0)
        lr = 0.0000001 * lrm * 100
        optimizer = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-15)
        writer = SummaryWriter(f"LRruns/gaussian_autoencoder_{lrm}") if SummaryWriter else None

        rng = np.random.RandomState(0)
        step = 0
        for epoch in range(0, args.epochs, 1):
            print(epoch)
            viewpoint_stack = list(scene.get_train_cameras())
            for _ in range(len(viewpoint_stack)):
                cam = viewpoint_stack.pop(rng.randint(len(viewpoint_stack)))
                if on_card:
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                with torch.no_grad():
                    vis = render(cam, gaussians, render_cfg)["visibility_filter"]
                data = f_gaussians[vis][None]  # [1, Lv, 26]
                kind = "image" if epoch > TOKEN_EPOCHS else "token"
                optimizer.zero_grad(set_to_none=True)
                if kind == "image":
                    loss, pred = image_loss(model, data, cam, render_cfg, use_lpips)
                else:
                    loss, pred = token_loss(model, data)
                # The reference swallows backward errors: skip a step whose
                # loss is not finite.
                value = float(loss.detach())
                finite = math.isfinite(value)
                if finite:
                    loss.backward()
                    optimizer.step()
                if on_card:
                    ev[1].record()
                if viewer_ok:
                    recon = unflatten_gaussians(pred[0].detach())
                    network_gui.pump(
                        lambda custom_cam, smod: render(custom_cam, recon, render_cfg, scaling_modifier=smod)["render"],
                        dataset.source_path, device=device)
                record = {"lrm": lrm, "lr": lr, "epoch": epoch, "step": step, "kind": kind,
                          "n_visible": data.shape[1], "loss": value, "finite": finite}
                if on_card:
                    torch.cuda.synchronize()
                    record["ms"] = ev[0].elapsed_time(ev[1])
                history.append(record)
                if on_step is not None:
                    on_step(record)
                if writer:
                    writer.add_scalar("loss", value, step)
                    writer.add_scalar("lr", lr, step)
                step += 1
        if writer:
            writer.close()
        models[lrm] = model
        print("\nTraining complete.")
    return {"models": models, "history": history}


if __name__ == "__main__":
    main()
