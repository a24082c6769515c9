"""The camera-batched and sharded 3DGS train steps (port of
``gaussian_transformer_tpu/parallel/step.py``).

``make_sharded_train_step(opt, render_cfg, mesh=None, tile_axis=None)``
builds one step in three forms, all with the batch semantics of B
sequential reference iterations for the densification statistics (gradient
norms and visit counts summed over the cameras, max radii the batch max):

  * ``mesh=None``: every camera of the batch rendered in one process (the
    JAX package's ``vmap`` form);
  * ``mesh`` (a ``("data", "gauss")`` ``DeviceMesh``): the manual form. A
    rank holds its capacity rows of the scene and of Adam's moments
    (``mesh.shard_scene``/``shard_adam``) and its cameras
    (``mesh.camera_batch_sharding``). Per camera it projects its rows,
    all-gathers over ``gauss`` the 7 projected arrays (never a raw
    parameter), bins the whole set, and composites and scores it with the
    unchanged single-device kernels (K1, K2, fused SSIM K3/K4). The loss is
    the mean over the global batch; gradients are summed over ``data``;
    Adam updates the local rows;
  * ``mesh`` and ``tile_axis``: every rank holds the whole scene, and the
    compositing of each camera is tile-sharded over ``tile_axis``
    (``parallel/tile_shard.py``); cameras split over the other axis.

The step's collectives are ``parallel/collectives.py``'s, so every one of
them, backward included, lands in an active ``collectives.recording()``.
"""

from __future__ import annotations

import dataclasses

import torch

from gaussian_transformer_tpu_torch.ops.losses import l1_loss, ssim
from gaussian_transformer_tpu_torch.parallel import collectives as cc
from gaussian_transformer_tpu_torch.render import _auto_chunk, project_view, render
from gaussian_transformer_tpu_torch.render.stream import stream_image
from gaussian_transformer_tpu_torch.render.tiles import bin_stream, num_tiles
from gaussian_transformer_tpu_torch.scene.densify import DensifyStats, ndc_grad_scale
from gaussian_transformer_tpu_torch.scene.gaussians import TensorScene
from gaussian_transformer_tpu_torch.train.optim import PARAM_LEAVES, adam_step, expon_lr, leaf_learning_rates

BATCHED = ("world_view_transform", "full_proj_transform", "camera_center", "original_image")


def stack_cameras(cams):
    """Same-resolution cameras as one camera whose tensors carry a leading
    batch axis (metadata from the first)."""
    c0 = cams[0]
    for c in cams[1:]:
        if (c.image_width, c.image_height) != (c0.image_width, c0.image_height):
            raise ValueError("stack_cameras requires equal resolutions")
    fields = {f: torch.stack([getattr(c, f) for c in cams]) for f in BATCHED[:3]}
    if all(c.original_image is not None for c in cams):
        fields["original_image"] = torch.stack([c.original_image for c in cams])
    return dataclasses.replace(c0, **fields)


def camera_at(batch, i: int):
    """Camera ``i`` of a ``stack_cameras`` batch."""
    return dataclasses.replace(batch, **{f: getattr(batch, f)[i] for f in BATCHED
                                         if getattr(batch, f) is not None})


def cameras_of(batch, rows: slice):
    """A batch cut to ``rows`` (a rank's cameras, ``mesh.local_piece``)."""
    return dataclasses.replace(batch, **{f: getattr(batch, f)[rows] for f in BATCHED
                                         if getattr(batch, f) is not None})


def _manual_render(cam, s_l, offset_l, bg, render_cfg, gauss_group):
    """One camera of the manual form: project the local rows, all-gather the
    projected arrays over ``gauss_group``, bin and composite the whole set.
    Returns (image [3, H, W], local radii)."""
    H, W = cam.image_height, cam.image_width
    proj = project_view(cam, s_l)
    gat = lambda x: cc.all_gather(x, gauss_group)
    m2, dep, radb, con, rgb, opa = (gat(proj.means2d + offset_l), gat(proj.depths), gat(proj.rect_bin),
                                    gat(proj.conics), gat(proj.rgbs), gat(proj.opacities))
    rad = gat(proj.radii)
    gw, gh = num_tiles(W), num_tiles(H)
    include = (rad > 0) & (opa.detach() >= 1.0 / 255.0)
    binned = bin_stream(m2.detach(), dep.detach(), radb, include, grid_w=gw, grid_h=gh,
                        max_tiles_per_gaussian=render_cfg.max_tiles_per_gaussian,
                        max_instances=render_cfg.max_instances, max_stream=render_cfg.max_stream,
                        chunk=_auto_chunk(m2.shape[0], gw * gh, render_cfg))
    img_pad, _ = stream_image(binned, m2, con, rgb, opa, bg, grid_w=gw, grid_h=gh,
                              precision="bf16" if render_cfg.precision == "bf16" else "fp32")
    return img_pad[:, :H, :W], proj.radii


def make_sharded_train_step(opt, render_cfg, mesh=None, tile_axis=None):
    """Returns step(scene, adam, stats, cams, bg, iteration, spatial_lr_scale)
    -> (scene, adam, stats, metrics); the scene is updated in place.
    ``cams`` is this rank's ``stack_cameras`` batch (all of it without a
    mesh); ``scene``, ``adam`` and ``stats`` are this rank's rows (the whole
    scene without a mesh or with ``tile_axis``). ``metrics`` (``loss``,
    ``l1``, ``n_visible``) are the global batch's on every rank."""
    manual = mesh is not None and tile_axis is None
    if tile_axis is not None:
        if mesh is None:
            raise ValueError("tile_axis requires a mesh")
        from gaussian_transformer_tpu_torch.parallel.tile_shard import render_tile_sharded

        tile_group = mesh.get_group(tile_axis)
        data_axis = [n for n in mesh.mesh_dim_names if n != tile_axis]
        data_group = mesh.get_group(data_axis[0]) if data_axis else None
    elif manual:
        gauss_group, data_group = mesh.get_group("gauss"), mesh.get_group("data")
    else:
        data_group = None
    n_data = 1 if data_group is None else cc.size(data_group)

    def step(scene, adam, stats, cams, bg, iteration, spatial_lr_scale):
        params = [getattr(scene, k) for k in PARAM_LEAVES]
        B = cams.world_view_transform.shape[0]
        s = TensorScene.of(scene)
        grads = [torch.zeros_like(p) for p in params]
        goffsets, losses, l1s, radii = [], [], [], []
        # One camera's forward and backward at a time: a backward's
        # collectives then form one chain, issued in the same order on every
        # rank whatever shape each rank's graph has.
        for b in range(B):
            cam = camera_at(cams, b)
            offset = torch.zeros(scene.capacity, 2, dtype=scene.xyz.dtype, device=scene.xyz.device,
                                 requires_grad=True)
            if manual:
                img, rad = _manual_render(cam, s, offset, bg, render_cfg, gauss_group)
            elif tile_axis is not None:
                out = render_tile_sharded(cam, s, render_cfg, tile_group, bg_color=bg, screenspace_offset=offset)
                img, rad = out["render"], out["radii"]
            else:
                out = render(cam, s, render_cfg, bg_color=bg, screenspace_offset=offset)
                img, rad = out["render"], out["radii"]
            gt = cam.original_image
            l1 = l1_loss(img, gt)
            loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - ssim(img, gt))
            if manual:
                # Every rank of the gauss group scored the same image.
                loss = cc.replicated_output(loss, gauss_group)
            g = torch.autograd.grad(loss / (B * n_data), params + [offset], allow_unused=True)
            for acc, gi in zip(grads, g[:-1]):
                if gi is not None:  # SH rest bands above the active degree
                    acc += gi
            goffsets.append(g[-1])
            losses.append(loss.detach())
            l1s.append(l1.detach())
            radii.append(rad)
        if data_group is not None:
            # The parameters enter each data rank whole: their gradient is
            # the sum over the data axis (one all-reduce of the set).
            grads = cc.all_reduce_tensors(grads, data_group)
        grads.append(torch.stack(goffsets))

        xyz_lr = expon_lr(
            iteration,
            torch.tensor(opt.position_lr_init, dtype=torch.float32) * spatial_lr_scale,
            torch.tensor(opt.position_lr_final, dtype=torch.float32) * spatial_lr_scale,
            lr_delay_mult=opt.position_lr_delay_mult,
            max_steps=opt.position_lr_max_steps,
        )
        scene, adam = adam_step(scene, dict(zip(PARAM_LEAVES, grads)), adam, leaf_learning_rates(opt, xyz_lr))

        # Batched densification stats == B sequential reference iterations
        # (pixel gradients -> NDC-half units).
        with torch.no_grad():
            goff = grads[-1] * ndc_grad_scale(cams.image_width, cams.image_height, scene.xyz.device)
            gnorm = torch.linalg.norm(goff, dim=-1)  # [B, C]
            radii = torch.stack(radii)
            vis = radii > 0
            visf = vis.to(torch.float32)
            accum, denom = (gnorm * visf).sum(0), visf.sum(0)
            rmax = torch.where(vis, radii.to(torch.float32), 0.0).amax(0)
            seen = vis.any(0).to(torch.float32)
            l1_sum, loss_sum = torch.stack(l1s).sum(), torch.stack(losses).sum()
            if data_group is not None:
                accum, denom = cc.all_reduce(accum, data_group), cc.all_reduce(denom, data_group)
                rmax, seen = cc.reduce_max(rmax, data_group), cc.reduce_max(seen, data_group)
                l1_sum, loss_sum = cc.all_reduce(l1_sum, data_group), cc.all_reduce(loss_sum, data_group)
            n_visible = seen.sum()
            if manual:
                n_visible = cc.all_reduce(n_visible, gauss_group)
            stats = DensifyStats(xyz_gradient_accum=stats.xyz_gradient_accum + accum,
                                 denom=stats.denom + denom,
                                 max_radii2d=torch.maximum(stats.max_radii2d, rmax))
        metrics = {"loss": loss_sum / (B * n_data), "l1": l1_sum / (B * n_data),
                   "n_visible": n_visible.to(torch.int32)}
        return scene, adam, stats, metrics

    return step
