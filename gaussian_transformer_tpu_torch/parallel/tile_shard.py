"""Tile sharding of the splat compositor (port of
``gaussian_transformer_tpu/parallel/tile_shard.py``).

The padded-CSR instance stream (``render/tiles.bin_stream``) is already the
layout for it: chunks are tile-pure and tile-sorted, so splitting the chunk
axis into contiguous per-rank ranges splits the image into contiguous tile
ranges, and each rank composites its range with the unchanged
``render/stream.py composite_stream_tiles`` (K1 forward, K2 backward on the
card). A tile whose run straddles a rank boundary is handled exactly by the
associative front-to-back operator

    (C, T) o (C', T') = (C + T * C', T * T')

folded over ranks in order (rank order == chunk order == depth order) by
``_butterfly_fold``. The chunk axis is padded to the rank count with
trash-tile chunks, as in the JAX package, so the split points are its own.

What a shard walks: K1 walks only each run's real rows
(``render/stream.py real_row_ranges``). A shard that starts or ends inside
a run holds only part of it, so its counts are the real rows inside its own
rows (``shard_tile_counts``), never the run's global count. A rank whose
range lies past the used stream (``n_padded``) composites nothing and
contributes the operator's identity.

Gradients: the shard's rows are sliced from the replicated stream
(``collectives.replicated_slice``), so their gradient is all-reduced before
``_StreamGather``'s pullback and every rank holds the whole scene's
gradient; the fold's output is replicated (``collectives.replicated_output``).

Early termination (T < 1e-4) is evaluated per shard, so a straddled tile
composites a few instances the single-device walk would have skipped; their
weight is the incoming T < 1e-4, bounding the image delta at ~1e-4.
"""

from __future__ import annotations

import torch

from gaussian_transformer_tpu_torch.parallel import collectives as cc
from gaussian_transformer_tpu_torch.render.stream import (
    composite_stream_tiles,
    pack_props,
    stream_gather,
    tiles_to_image,
)
from gaussian_transformer_tpu_torch.render.tiles import TILE, bin_stream, num_tiles

P = TILE * TILE


def _butterfly_fold(frame, group, D: int):
    """All-reduce of the ordered front-to-back operator over ``group`` on a
    frame [T, 4, P] (color rows 0-2, transmittance row 3): one message per
    exchange, so the backward's collectives form one chain and every rank
    issues them in the same order.

    XOR recursive doubling: at step s each rank exchanges its aligned
    2^s-segment product with partner ``idx ^ 2^s`` (one ``permute`` pair)
    and composes lower-index-first; every rank holds the full ordered
    product after log2(D) steps. A gather fold when D is not a power of
    two."""

    def compose(lo, hi):  # (C, T) o (C', T') = (C + T * C', T * T')
        return torch.cat([lo[:, :3] + lo[:, 3:] * hi[:, :3], lo[:, 3:] * hi[:, 3:]], dim=1)

    if D & (D - 1):
        frames = cc.all_gather(frame[None], group)
        acc = frames[0]
        for d in range(1, D):
            acc = compose(acc, frames[d])
        return acc

    idx = cc.rank(group)
    acc = frame
    s = 1
    while s < D:
        other = cc.permute(acc, [d ^ s for d in range(D)], group)
        # The partner owns the lower-index segment when bit s is set.
        acc = compose(other, acc) if idx & s else compose(acc, other)
        s *= 2
    return acc


def shard_chunk_range(n_chunks: int, D: int, idx: int):
    """[c0, c1) of rank ``idx``'s chunks: the chunk axis padded to a multiple
    of D (trash chunks at the end), then split in D equal ranges."""
    per = -(-n_chunks // D)
    return idx * per, (idx + 1) * per


def shard_tile_counts(chunk_tile, tile_counts, n_tiles: int, chunk: int, row_start: int, row_end: int):
    """The real rows of every tile's run that lie inside rows
    [row_start, row_end): a run's real rows come first, so the count is
    max(0, min(run_start + count, row_end) - max(run_start, row_start))."""
    tiles = torch.arange(n_tiles, dtype=chunk_tile.dtype, device=chunk_tile.device)
    run_start = torch.searchsorted(chunk_tile, tiles).to(torch.int64) * chunk
    real_end = run_start + tile_counts.to(torch.int64)
    lo = torch.clamp(run_start, min=row_start)
    hi = torch.clamp(real_end, max=row_end)
    return torch.clamp(hi - lo, min=0).to(torch.int32)


def stream_image_tile_sharded(binned, means2d_s, conics_s, rgbs_s, opac_s, bg, *, grid_w: int, grid_h: int,
                              group=None):
    """Drop-in for ``render.stream.stream_image`` with the compositing work
    (and its backward) sharded over ``group``."""
    T = grid_w * grid_h
    D, idx = cc.size(group), cc.rank(group)
    G = binned.chunk_tile.shape[0]
    chunk = binned.stream_gauss.shape[0] // G
    n_used = min(max(int(binned.n_padded), chunk), G * chunk) // chunk  # chunks holding every run
    c0, c1 = shard_chunk_range(G, D, idx)
    u1 = min(c1, n_used)
    dev = means2d_s.device
    props_used = stream_gather(pack_props(means2d_s, conics_s, rgbs_s, opac_s), binned,
                               binned.stream_gauss[: n_used * chunk])
    props_l = cc.replicated_slice(props_used, c0 * chunk, max(u1, c0) * chunk, group)
    if u1 > c0:
        ct_l = binned.chunk_tile[c0:u1]
        counts_l = shard_tile_counts(binned.chunk_tile[:n_used], binned.tile_counts, T, chunk,
                                     c0 * chunk, u1 * chunk)
        color, final_t = composite_stream_tiles(props_l, ct_l, counts_l, grid_w, grid_h)
        # Tiles this shard never wrote are identity under the operator.
        covered_l = torch.zeros(T + 1, dtype=torch.bool, device=dev)
        covered_l[ct_l.long()] = True
        covered_l = covered_l[:T, None, None]
        final_t = torch.where(covered_l, final_t, torch.ones_like(final_t))
        color = torch.where(covered_l, color, torch.zeros_like(color))
    else:
        # Nothing of the used stream here: the operator's identity, tied to
        # the (empty) slice so the backward's all-reduce runs on every rank.
        color = torch.zeros(T, 3, P, dtype=torch.float32, device=dev) + props_l.sum()
        final_t = torch.ones(T, 1, P, dtype=torch.float32, device=dev)
    frame = cc.replicated_output(_butterfly_fold(torch.cat([color, final_t], dim=1), group, D), group)
    color, final_t = frame[:, :3], frame[:, 3:]
    return tiles_to_image(color, final_t, binned.covered, bg, grid_w=grid_w, grid_h=grid_h)


def render_tile_sharded(viewpoint_camera, pc, cfg, group=None, bg_color=None, screenspace_offset=None):
    """``render()`` with tile-sharded compositing: every rank projects and
    bins the (replicated) scene once, then composites its share of the
    instance stream over ``group``. Binning without tile culling, as the
    JAX package's tile-sharded render bins."""
    from gaussian_transformer_tpu_torch.render import _auto_chunk
    from gaussian_transformer_tpu_torch.render.project import project_scene, view_args

    H, W = viewpoint_camera.image_height, viewpoint_camera.image_width
    dev = pc.get_xyz.device
    bg = torch.zeros(3, device=dev) if bg_color is None else torch.as_tensor(bg_color, dtype=torch.float32,
                                                                            device=dev)
    proj, include = project_scene(pc, view_args(viewpoint_camera))
    means2d = proj.means2d
    if screenspace_offset is not None:
        means2d = means2d + screenspace_offset
    grid_w, grid_h = num_tiles(W), num_tiles(H)
    binned = bin_stream(
        means2d.detach(), proj.depths.detach(), proj.rect_bin, include,
        grid_w=grid_w, grid_h=grid_h, max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        max_instances=cfg.max_instances, max_stream=cfg.max_stream,
        chunk=_auto_chunk(means2d.shape[0], grid_w * grid_h, cfg),
    )
    img_pad, t_pad = stream_image_tile_sharded(binned, means2d, proj.conics, proj.rgbs, proj.opacities, bg,
                                               grid_w=grid_w, grid_h=grid_h, group=group)
    return {
        "render": img_pad[:, :H, :W],
        "viewspace_points": screenspace_offset,
        "visibility_filter": proj.radii > 0,
        "radii": proj.radii,
        "final_T": t_pad[:H, :W],
        "overflow": binned.overflow,
        "n_instances": binned.n_instances,
        "n_padded": binned.n_padded,
    }
