"""Per-tile front-to-back compositing in tensor ops, differentiated by
autograd (port of ``gaussian_transformer_tpu/render/composite.py``): the
renderer's ``use_pallas=False`` path.

This is the reference's own non-Pallas compositor, not the plain version of
a kernel. Each tile's depth-sorted list of K Gaussians is composited with an
exclusive cumulative product of (1 - alpha) over the list, with the
upstream rules: alpha = min(0.99, opacity exp(min(power, 0))), no
contribution where power > 0, alpha < 1/255 or the list slot is empty, and
a pixel stops before the contribution that would take its transmittance
below 1e-4. The tiles go in blocks of ``tile_block``, each under
``torch.utils.checkpoint``: a block's [tile_block, K, 256] intermediates are
freed after its forward and recomputed one block at a time in the backward,
as the reference's ``jax.checkpoint`` does. On the card it runs only where a
caller asks for ``use_pallas=False``; no path falls back to it.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from gaussian_transformer_tpu_torch.render.tiles import TILE

P = TILE * TILE


def composite_tile_block(lists, tx, ty, means2d_p, conics_p, rgbs_p, opac_p, bg):
    """Composite a block of B tiles: (colors [B, 3, P] over the background,
    final_T [B, P]). ``lists`` [B, K] index the depth-sorted property arrays,
    padded with one zero sentinel row (index C = an empty slot); ``tx``,
    ``ty`` [B] are the tiles' grid coordinates."""
    sentinel = means2d_p.shape[0] - 1
    dtype, dev = means2d_p.dtype, means2d_p.device
    # Pixel centres at integer screen coordinates, as upstream.
    p = torch.arange(P, device=dev)
    row = (p // TILE).to(dtype)
    col = (p % TILE).to(dtype)
    pix_x = tx[:, None].to(dtype) * TILE + col[None, :]  # [B, P]
    pix_y = ty[:, None].to(dtype) * TILE + row[None, :]

    lists = lists.long()
    g_xy = means2d_p[lists]  # [B, K, 2]
    g_conic = conics_p[lists]  # [B, K, 3]
    g_rgb = rgbs_p[lists]  # [B, K, 3]
    g_opac = opac_p[lists]  # [B, K]
    is_pad = lists == sentinel

    dx = g_xy[:, :, 0:1] - pix_x[:, None, :]  # [B, K, P]
    dy = g_xy[:, :, 1:2] - pix_y[:, None, :]
    a, b, c = g_conic[:, :, 0:1], g_conic[:, :, 1:2], g_conic[:, :, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy

    alpha = torch.clamp(g_opac[:, :, None] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    skip = (power > 0.0) | (alpha < 1.0 / 255.0) | is_pad[:, :, None]
    alpha = torch.where(skip, torch.zeros_like(alpha), alpha)

    # Exclusive cumulative transmittance along the depth-ordered list.
    one_minus = 1.0 - alpha
    cp = torch.cumprod(one_minus, dim=1)
    t_in = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)  # [B, K, P]

    # The first unskipped entry that would take T below 1e-4 stops the pixel
    # (and does not contribute itself).
    trigger = ~skip & (t_in * one_minus < 1e-4)
    live = (torch.cumsum(trigger.to(torch.int32), dim=1) == 0).to(dtype)

    weight = alpha * t_in * live
    colors = torch.einsum("bkp,bkc->bcp", weight, g_rgb)
    final_t = torch.prod(1.0 - alpha * live, dim=1)  # [B, P]
    return colors + final_t[:, None, :] * bg[None, :, None], final_t


def composite_image(tile_lists, means2d_s, conics_s, rgbs_s, opac_s, bg, *, grid_w: int, grid_h: int,
                    tile_block: int = 64):
    """(padded image [3, grid_h * 16, grid_w * 16], transmittance map
    [grid_h * 16, grid_w * 16]) from the per-tile lists ``tile_lists`` [T, K]
    (``Binned.tile_lists``: indices into the depth-sorted arrays, C = empty)
    and the depth-sorted properties, composited over ``bg`` in blocks of
    ``tile_block`` tiles."""
    n_tiles = grid_w * grid_h
    C = means2d_s.shape[0]
    dev = means2d_s.device

    def pad1(v):
        return torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))], dim=0)

    props_p = [pad1(v) for v in (means2d_s, conics_s, rgbs_s, opac_s)]
    n_blocks = -(-n_tiles // tile_block)
    pad = n_blocks * tile_block - n_tiles
    # Padded tiles read only the sentinel: background, cropped below.
    lists = torch.cat([tile_lists.long(), tile_lists.new_full((pad, tile_lists.shape[1]), C).long()])
    tile_ids = torch.arange(n_blocks * tile_block, device=dev)
    tile_ids = torch.where(tile_ids < n_tiles, tile_ids, torch.zeros_like(tile_ids))
    tx, ty = tile_ids % grid_w, tile_ids // grid_w

    colors, finals = [], []
    for i in range(n_blocks):
        blk = slice(i * tile_block, (i + 1) * tile_block)
        c, f = checkpoint(composite_tile_block, lists[blk], tx[blk], ty[blk], *props_p, bg,
                          use_reentrant=False, preserve_rng_state=False)
        colors.append(c)
        finals.append(f)
    colors = torch.cat(colors)[:n_tiles]
    final_t = torch.cat(finals)[:n_tiles]

    img = colors.reshape(grid_h, grid_w, 3, TILE, TILE)
    img = img.permute(2, 0, 3, 1, 4).reshape(3, grid_h * TILE, grid_w * TILE)
    t_map = final_t.reshape(grid_h, grid_w, TILE, TILE)
    t_map = t_map.permute(0, 2, 1, 3).reshape(grid_h * TILE, grid_w * TILE)
    return img, t_map
