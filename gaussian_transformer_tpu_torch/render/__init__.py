"""Tile-based Gaussian-splat renderer (port of
``gaussian_transformer_tpu/render/__init__.py``).

``render(camera, scene, ...)`` returns the reference's dict: ``render``
[3, H, W], ``viewspace_points``, ``visibility_filter``, ``radii``, plus the
``final_T``, ``overflow`` and ``n_instances`` diagnostics (and ``n_padded``,
``n_tiles`` on the stream path). Pipeline: project (project.py), then

- ``use_stream=True`` (default): padded-CSR binning (tiles.bin_stream), then
  the stream compositor (stream.py, kernels K1 and K2 on CUDA; with
  ``precision="bf16"`` their bf16 entry points on bf16 tile-local rows);
- ``use_stream=False``: depth sort and per-tile [T, max_per_tile] lists
  (tiles.bin_gaussians), then the table compositor (table_composite.py,
  kernels K5 and K6 on CUDA); ``precision`` is not read there, as in the
  reference;
- ``use_pallas=False``, whatever ``use_stream`` says: the table binning,
  then the reference's non-Pallas compositor (composite.py: tensor ops in
  blocks of ``tile_block`` tiles, differentiated by autograd).

``render`` is differentiable in the scene's parameters and in
``screenspace_offset`` (the screen-space gradient the densification reads).
``render_naive`` is the brute-force golden model the tests hold it against.

``layout="transposed"`` raises on the stream path, as in the reference; that
layout (kernels K7 and K8) is ``attic/stream_t.py stream_image_t``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from gaussian_transformer_tpu_torch.render.composite import composite_image
from gaussian_transformer_tpu_torch.render.project import Projected, project_gaussians
from gaussian_transformer_tpu_torch.render.stream import (
    pack_props,
    stream_gather,
    stream_image,
    tiles_to_image,
    used_stream,
)
from gaussian_transformer_tpu_torch.render.table_composite import build_props_table, composite_table_tiles
from gaussian_transformer_tpu_torch.render.tiles import (
    TILE,
    Binned,
    StreamBinned,
    bin_gaussians,
    bin_stream,
    compute_rects,
    num_tiles,
)
from gaussian_transformer_tpu_torch.utils.profiling import span

__all__ = ["render", "render_naive", "RenderConfig", "TILE", "tune_config", "prepare_stream", "prepare_table"]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rasterizer configuration: the reference's fields (and defaults) that
    the ported paths read."""

    # Static per-tile list capacity of the table path; overflow drops the
    # farthest Gaussians of a tile.
    max_per_tile: int = 256
    # Static cap on tiles covered per Gaussian.
    max_tiles_per_gaussian: int = 1024
    # Exact tile culling in the binning (changes no output bit).
    tile_cull: bool = True
    # Global (Gaussian, tile) instance budget; 0 = auto (16 * capacity).
    max_instances: int = 0
    # Chunk-padded stream budget; 0 = auto estimate.
    max_stream: int = 0
    # Stream layout granularity (rows per chunk); 0 = the reference's policy.
    chunk: int = 0
    # Tiles per block of the use_pallas=False compositor (composite.py).
    tile_block: int = 64
    # Compositor kernels: the padded-CSR stream (True) or the [T, K] table.
    use_stream: bool = True
    # False: the table binning and the reference's non-Pallas compositor
    # (composite.py), whatever use_stream says.
    use_pallas: bool = True
    # The stream compositor's rows: "bf16" (tile-local means rounded to
    # bf16, float32 arithmetic; a lossy mode), else float32. The table paths
    # do not read it.
    precision: str = "fp32"
    # Stream layout: "rows" ([I_pad, 16]). The stream path raises for
    # "transposed" as the reference does; that layout ([16, I_pad], kernels
    # K7 and K8) is reached through attic/stream_t.py stream_image_t.
    layout: str = "rows"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# The reference's chunk policy (its SMEM map cap, then escalation toward a
# chunk-count target). Kept so the stream layout is the reference's.
_MAX_CHUNKS = 65536
_TARGET_CHUNKS = 24576
_TARGET_CHUNK_CAP = 128


def _auto_chunk(n_capacity: int, n_tiles: int, cfg: RenderConfig) -> int:
    """Smallest chunk size (>= 32, power-of-two steps) whose chunk count fits
    _MAX_CHUNKS, then escalated (up to _TARGET_CHUNK_CAP) while the estimated
    chunk count still exceeds _TARGET_CHUNKS."""
    if cfg.chunk:
        return cfg.chunk
    I = cfg.max_instances if cfg.max_instances > 0 else max(8192, 16 * n_capacity)

    def n_chunks(chunk):
        i_pad = cfg.max_stream if cfg.max_stream > 0 else I + (n_tiles // 2 + 256) * chunk
        return (i_pad + chunk - 1) // chunk

    chunk = 32
    while chunk < 1024 and n_chunks(chunk) > _MAX_CHUNKS:
        chunk *= 2
    while chunk < _TARGET_CHUNK_CAP and n_chunks(chunk) > _TARGET_CHUNKS:
        chunk *= 2
    return chunk


def tune_config(cfg: RenderConfig, probe, headroom: float = 0.0, floor: int = 8192) -> RenderConfig:
    """Right-size the static instance budgets from a probe render's counts
    (``n_instances``, and ``n_padded`` + ``n_tiles`` for the stream), on a
    32k grain; the stream budget is capped at the worst-case padding bound
    ``max_instances + n_tiles * chunk`` iterated with the chunk policy.
    ``headroom`` 0.0 = x1.5 up to 512k instances, x1.25 above."""
    grain = 32768

    def bucket(n, hr):
        want = max(floor, int(n * hr))
        return ((want + grain - 1) // grain) * grain

    if isinstance(probe, dict):
        n_true = int(probe["n_instances"])
        n_padded = int(probe.get("n_padded", 0))
        n_tiles = int(probe.get("n_tiles", 0))
    else:
        n_true, n_padded, n_tiles = int(probe), 0, 0
    hr = headroom if headroom > 0.0 else (1.5 if n_true <= 512 * 1024 else 1.25)
    cfg = cfg.replace(max_instances=bucket(n_true, hr))
    if n_padded:
        stream = bucket(n_padded, hr)
        if n_tiles:
            for _ in range(8):
                chunk = _auto_chunk(0, n_tiles, cfg.replace(max_stream=stream))
                bound = cfg.max_instances + n_tiles * chunk
                bound = ((bound + grain - 1) // grain) * grain
                if bound >= stream:
                    break
                stream = bound
        cfg = cfg.replace(max_stream=stream)
    return cfg


def project_view(viewpoint_camera, pc, scaling_modifier=1.0, override_color=None) -> Projected:
    """Project a scene's (activated) Gaussians for one camera."""
    shs = None if override_color is not None else pc.get_features
    return project_gaussians(
        pc.get_xyz,
        pc.get_scaling,
        pc.get_rotation,
        pc.get_opacity[:, 0],
        shs,
        override_color,
        world_view_transform=viewpoint_camera.world_view_transform,
        full_proj_transform=viewpoint_camera.full_proj_transform,
        camera_center=viewpoint_camera.camera_center,
        image_width=viewpoint_camera.image_width,
        image_height=viewpoint_camera.image_height,
        tan_fovx=math.tan(viewpoint_camera.fovx * 0.5),
        tan_fovy=math.tan(viewpoint_camera.fovy * 0.5),
        active_sh_degree=pc.active_sh_degree,
        scaling_modifier=scaling_modifier,
    )


class StreamInputs(NamedTuple):
    """What the compositor of one view consumes (also what K1 and K2 are
    checked on)."""

    proj: Projected
    means2d: torch.Tensor
    binned: StreamBinned
    grid_w: int
    grid_h: int

    def props(self) -> torch.Tensor:
        """The stream's used property rows [n_padded, 16] (K1's input)."""
        p = self.proj
        stream_gauss, _ = used_stream(self.binned)
        return stream_gather(pack_props(self.means2d, p.conics, p.rgbs, p.opacities), self.binned,
                             stream_gauss)

    @property
    def chunk_tile(self) -> torch.Tensor:
        """The chunk->tile map of the used rows (K1's other input)."""
        return used_stream(self.binned)[1]


def _project_for_binning(viewpoint_camera, pc, cfg, scaling_modifier, override_color,
                         screenspace_offset):
    """(proj, screen means with the offset, include mask, grid_w, grid_h)."""
    proj = project_view(viewpoint_camera, pc, scaling_modifier, override_color)
    means2d = proj.means2d
    if screenspace_offset is not None:
        means2d = means2d + screenspace_offset
    grid_w, grid_h = num_tiles(viewpoint_camera.image_width), num_tiles(viewpoint_camera.image_height)
    # Opacity below 1/255 can never pass the alpha skip: keep it out of the lists.
    include = (proj.radii > 0) & (proj.opacities >= 1.0 / 255.0)
    return proj, means2d, include, grid_w, grid_h


def prepare_stream(viewpoint_camera, pc, cfg: RenderConfig = RenderConfig(),
                   scaling_modifier: float = 1.0, override_color=None,
                   screenspace_offset=None) -> StreamInputs:
    """Projection + stream binning of one view: everything before the compositor."""
    if cfg.layout == "transposed":
        raise NotImplementedError(
            "render() runs the row layout; the transposed stream compositor (K7, K8) is "
            "gaussian_transformer_tpu_torch.attic.stream_t.stream_image_t")
    with span("render.project"):
        proj, means2d, include, grid_w, grid_h = _project_for_binning(
            viewpoint_camera, pc, cfg, scaling_modifier, override_color, screenspace_offset)
    with span("render.bin"):
        binned = bin_stream(
            means2d.detach(),
            proj.depths.detach(),
            proj.rect_bin,
            include,
            proj.conics.detach() if cfg.tile_cull else None,
            proj.opacities.detach() if cfg.tile_cull else None,
            grid_w=grid_w,
            grid_h=grid_h,
            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
            max_instances=cfg.max_instances,
            max_stream=cfg.max_stream,
            chunk=_auto_chunk(means2d.shape[0], grid_w * grid_h, cfg),
        )
    return StreamInputs(proj, means2d, binned, grid_w, grid_h)


class TableInputs(NamedTuple):
    """What the table compositor of one view consumes (also what K5 and K6
    are checked on). The property arrays it hands on are depth-sorted."""

    proj: Projected
    means2d: torch.Tensor
    binned: Binned
    grid_w: int
    grid_h: int

    def sorted_props(self):
        """(means2d, conics, rgbs, opacities) in depth order."""
        o = self.binned.order.long()
        p = self.proj
        return self.means2d[o], p.conics[o], p.rgbs[o], p.opacities[o]

    def props(self) -> torch.Tensor:
        """The property table [T, K_pad, 16] (K5's input; ``binned.tile_counts``
        is the other)."""
        return build_props_table(pack_props(*self.sorted_props()), self.binned)


def prepare_table(viewpoint_camera, pc, cfg: RenderConfig = RenderConfig(),
                  scaling_modifier: float = 1.0, override_color=None,
                  screenspace_offset=None) -> TableInputs:
    """Projection + table binning of one view, as the reference bins for its
    table path: circle rects from ``proj.radii``, no tile culling."""
    proj, means2d, include, grid_w, grid_h = _project_for_binning(
        viewpoint_camera, pc, cfg, scaling_modifier, override_color, screenspace_offset)
    binned = bin_gaussians(
        means2d.detach(),
        proj.depths.detach(),
        proj.radii,
        include,
        grid_w=grid_w,
        grid_h=grid_h,
        max_per_tile=cfg.max_per_tile,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        max_instances=cfg.max_instances,
    )
    return TableInputs(proj, means2d, binned, grid_w, grid_h)


def render(
    viewpoint_camera,
    pc,
    cfg: RenderConfig = RenderConfig(),
    bg_color: Optional[torch.Tensor] = None,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    screenspace_offset: Optional[torch.Tensor] = None,
):
    """Render a GaussianScene from a Camera/MiniCam on the scene's device
    (the span ``render``; on the stream path its children ``render.project``,
    ``render.bin``, ``render.gather`` and ``render.composite``)."""
    with span("render"):
        dev = pc.get_xyz.device
        bg = (torch.zeros(3, device=dev) if bg_color is None
              else torch.as_tensor(bg_color, dtype=torch.float32, device=dev))
        args = (viewpoint_camera, pc, cfg, scaling_modifier, override_color, screenspace_offset)
        if cfg.use_pallas and cfg.use_stream:
            s = prepare_stream(*args)
            p = s.proj
            img_pad, t_pad = stream_image(
                s.binned, s.means2d, p.conics, p.rgbs, p.opacities, bg, grid_w=s.grid_w, grid_h=s.grid_h,
                # As in the reference, only "bf16" selects the bf16 rows.
                precision="bf16" if cfg.precision == "bf16" else "fp32",
            )
            extra = {"n_padded": s.binned.n_padded, "n_tiles": s.grid_w * s.grid_h}
        elif cfg.use_pallas:
            # The reference's composite_image_pallas: build the table, K5, blend.
            s = prepare_table(*args)
            color, final_t = composite_table_tiles(s.props(), s.binned.tile_counts, s.grid_w)
            img_pad, t_pad = tiles_to_image(color, final_t, None, bg, grid_w=s.grid_w, grid_h=s.grid_h)
            extra = {}
        else:
            # The reference's composite_image on the same depth-sorted lists.
            s = prepare_table(*args)
            img_pad, t_pad = composite_image(s.binned.tile_lists, *s.sorted_props(), bg, grid_w=s.grid_w,
                                             grid_h=s.grid_h, tile_block=cfg.tile_block)
            extra = {}
        H, W = viewpoint_camera.image_height, viewpoint_camera.image_width
        return {
            "render": img_pad[:, :H, :W],
            "viewspace_points": screenspace_offset,
            "visibility_filter": s.proj.radii > 0,
            "radii": s.proj.radii,
            "final_T": t_pad[:H, :W],
            "overflow": s.binned.overflow,
            "n_instances": s.binned.n_instances,
            **extra,
        }


def render_naive(viewpoint_camera, pc, bg_color=None, scaling_modifier: float = 1.0,
                 override_color=None):
    """Brute-force golden renderer: every pixel composites over ALL Gaussians
    (depth-sorted, same skip/termination rules, no tiling). O(C*H*W) memory —
    for tests and tiny scenes only."""
    H, W = viewpoint_camera.image_height, viewpoint_camera.image_width
    dev = pc.get_xyz.device
    bg = torch.zeros(3, device=dev) if bg_color is None else torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    proj = project_view(viewpoint_camera, pc, scaling_modifier, override_color)

    include = (proj.radii > 0) & (proj.opacities >= 1.0 / 255.0)
    inf = torch.full_like(proj.depths, float("inf"))
    order = torch.argsort(torch.where(include, proj.depths, inf), stable=True)
    xy = proj.means2d[order]
    con = proj.conics[order]
    rgb = proj.rgbs[order]
    op = torch.where(include, proj.opacities, torch.zeros_like(proj.opacities))[order]

    ys = torch.arange(H, dtype=xy.dtype, device=dev)
    xs = torch.arange(W, dtype=xy.dtype, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]

    dx = xy[:, 0, None, None] - px[None]
    dy = xy[:, 1, None, None] - py[None]
    power = (
        -0.5 * (con[:, 0, None, None] * dx * dx + con[:, 2, None, None] * dy * dy)
        - con[:, 1, None, None] * dx * dy
    )
    alpha = torch.clamp(op[:, None, None] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    # A Gaussian touches only the tiles of its radius rect (as the tiled path).
    min_x, min_y, max_x, max_y = compute_rects(xy, proj.radii[order], num_tiles(W), num_tiles(H))
    ptx = torch.div(px, TILE, rounding_mode="floor").to(torch.int32)[None]
    pty = torch.div(py, TILE, rounding_mode="floor").to(torch.int32)[None]
    in_rect = (
        (min_x[:, None, None] <= ptx) & (ptx < max_x[:, None, None])
        & (min_y[:, None, None] <= pty) & (pty < max_y[:, None, None])
    )
    skip = (power > 0.0) | (alpha < 1.0 / 255.0) | (~in_rect)
    alpha = torch.where(skip, torch.zeros_like(alpha), alpha)

    one_minus = 1.0 - alpha
    cp = torch.cumprod(one_minus, dim=0)
    T = torch.cat([torch.ones_like(cp[:1]), cp[:-1]], dim=0)
    trigger = (~skip) & (T * one_minus < 1e-4)
    live = (torch.cumsum(trigger.to(torch.int32), dim=0) == 0).to(alpha.dtype)

    weight = alpha * T * live
    image = torch.einsum("chw,cx->xhw", weight, rgb)
    final_T = torch.prod(1.0 - alpha * live, dim=0)
    image = image + final_T[None] * bg[:, None, None]
    return {"render": image, "radii": proj.radii, "final_T": final_T}
