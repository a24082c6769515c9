"""Tile binning (port of ``gaussian_transformer_tpu/render/tiles.py``:
``bin_stream``, ``bin_gaussians`` and their helpers).

Every (Gaussian, covered 16x16 tile) pair is an instance. ``bin_stream``
sorts instances by (tile, depth) so each tile's run is front to back, and
each run starts at a chunk-aligned row of one [I_pad] stream (the stream
compositor's layout). ``bin_gaussians`` depth-sorts the Gaussians first,
stable-sorts their instances by tile and cuts each run into a row of a
[T, K] table (the table compositor's layout). The outputs are integer-exact
against the reference. The reference's exact-f32 integer tricks and its
TPU-friendly scatter-max/cummax owner search are replaced by plain integer
arithmetic and ``searchsorted``; its ``mode="drop"`` scatters become masked
index writes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE = 16  # pixels per tile side
CHUNK = 32  # rows per compositor chunk (stream layout granularity)


def num_tiles(size: int) -> int:
    return (size + TILE - 1) // TILE


def compute_rects(means2d: torch.Tensor, radii: torch.Tensor, grid_w: int, grid_h: int):
    """Per-Gaussian covered tile range [min, max). ``radii`` is [C] (circle)
    or [C, 2] (per-axis extents)."""
    r = radii.to(means2d.dtype)
    rx = r[:, 0] if r.ndim == 2 else r
    ry = r[:, 1] if r.ndim == 2 else r
    mx, my = means2d[:, 0], means2d[:, 1]
    clip = lambda v, hi: torch.clamp(torch.floor(v), 0, hi).to(torch.int32)
    min_x = clip((mx - rx) / TILE, grid_w)
    min_y = clip((my - ry) / TILE, grid_h)
    max_x = clip((mx + rx + TILE - 1) / TILE, grid_w)
    max_y = clip((my + ry + TILE - 1) / TILE, grid_h)
    return min_x, min_y, max_x, max_y


def _tile_cull_dist2(conics, opacities):
    """Per-Gaussian squared pixel distance beyond which alpha can never reach
    the compositor's 1/255 floor: power <= -0.5 lam_min |d|^2, so alpha <
    1/255 once |d|^2 > 2 ln(255 opac) / lam_min. A 1e-3 relative margin
    absorbs f32 rounding against the kernel's own alpha evaluation. Kept in
    f32 and in the reference's operation order."""
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    lam_min = torch.clamp(0.5 * ((a + c) - torch.sqrt((a - c) * (a - c) + 4.0 * b * b)), min=0.0)
    thr_log = torch.log(torch.clamp(opacities, min=1e-12) * (255.0 / (1.0 - 1e-3)))
    inf = torch.full_like(lam_min, float("inf"))
    d2 = torch.where(lam_min > 0.0, 2.0 * thr_log / torch.clamp(lam_min, min=1e-30), inf)
    return torch.where(thr_log > 0.0, d2, torch.full_like(d2, -1.0)).to(torch.float32)


def _expand_orig(means2d, depths, radii, include, grid_w, grid_h, R, I,
                 conics=None, opacities=None):
    """Instance expansion in ORIGINAL Gaussian order: returns (tile_id [I],
    gauss_i [I], depth_i [I], cap_overflow [], total_raw [], offsets [C],
    cov [C]) with sentinels tile T, Gaussian C, depth +inf. Gaussian i owns
    the instance range [offsets[i], offsets[i] + cov[i]); instance r of it
    covers tile (min_x + r % w, min_y + r // w). With conics/opacities the
    instances whose tile lies wholly beyond ``_tile_cull_dist2`` are dropped
    (exact: they contribute nothing)."""
    C = means2d.shape[0]
    T = grid_w * grid_h
    dev = means2d.device
    i64 = torch.int64

    min_x, min_y, max_x, max_y = (v.to(i64) for v in compute_rects(means2d, radii, grid_w, grid_h))
    w = max_x - min_x
    cov_raw = torch.where(include, w * (max_y - min_y), torch.zeros_like(w))
    cov = torch.clamp(cov_raw, max=R)

    offsets = torch.cumsum(cov, 0) - cov  # exclusive prefix sum
    total = offsets[-1] + cov[-1]
    j = torch.arange(I, dtype=i64, device=dev)
    # Owner of slot j: the last Gaussian whose range starts at or before j.
    gi = torch.searchsorted(offsets, j, right=True) - 1  # >= 0: offsets[0] == 0
    valid = j < total

    r_i = j - offsets[gi]
    w_g = torch.clamp(w, min=1)[gi]
    q = torch.div(r_i, w_g, rounding_mode="floor")
    tx = min_x[gi] + (r_i - q * w_g)
    ty = min_y[gi] + q
    if conics is not None:
        # Nearest pixel CENTER of tile (tx, ty) to the splat center (pixel
        # centers are the integer grid the compositor evaluates).
        cx, cy = means2d[gi, 0], means2d[gi, 1]
        d2_cut = _tile_cull_dist2(conics, opacities)[gi]
        fx, fy = tx.to(torch.float32) * 16.0, ty.to(torch.float32) * 16.0
        qx = torch.minimum(torch.maximum(cx, fx), fx + 15.0)
        qy = torch.minimum(torch.maximum(cy, fy), fy + 15.0)
        ex, ey = cx - qx, cy - qy
        valid = valid & (ex * ex + ey * ey <= d2_cut)
    tile_id = torch.where(valid, ty * grid_w + tx, torch.full_like(j, T))
    gauss_i = torch.where(valid, gi, torch.full_like(j, C))
    depth_i = torch.where(valid, depths[gi], torch.full_like(depths[gi], float("inf")))
    cap_overflow = (cov_raw - cov).sum() + torch.clamp(total - I, min=0)
    return tile_id, gauss_i, depth_i, cap_overflow, cov_raw.sum(), offsets, cov


class Binned(NamedTuple):
    """Per-tile [T, K] lists for the table compositor (the reference's
    fields, plus the pullback layout the port's table gather reads)."""

    order: torch.Tensor  # [C] int32 — Gaussian index by ascending depth
    tile_lists: torch.Tensor  # [T, K] int32 — indices into the depth-sorted arrays, C = empty
    tile_counts: torch.Tensor  # [T] int32 — valid entries per tile (capped at K)
    overflow: torch.Tensor  # [] int32 — instances dropped by any static cap
    inst_tile: torch.Tensor  # [I] int32 — tile of each tile-sorted instance, T = invalid
    inst_rank: torch.Tensor  # [I] int32 — rank within its tile's depth-ordered run
    inst_gauss: torch.Tensor  # [I] int32 — depth-sorted Gaussian index, C = invalid
    n_instances: torch.Tensor  # [] int32 — true (uncapped) instance total
    # Gradient-pullback layout: the tile-sorted position of each unsorted
    # (Gaussian-major) instance, and each depth-sorted Gaussian's range
    # [offset, offset + cov) in that unsorted domain.
    inst_pos: torch.Tensor  # [I] int32
    gauss_offsets: torch.Tensor  # [C] int32
    gauss_cov: torch.Tensor  # [C] int32


def bin_gaussians(
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    include: torch.Tensor,
    *,
    grid_w: int,
    grid_h: int,
    max_per_tile: int,
    max_tiles_per_gaussian: int = 128,
    max_instances: int = 0,
) -> Binned:
    """Depth-ordered per-tile lists: a stable depth sort of the Gaussians
    (excluded ones sort last, on a +inf key), their instances expanded
    Gaussian-major over the depth-sorted arrays, and one stable sort by tile.
    Tile t's list is its run, cut at ``max_per_tile`` = K and padded with
    the sentinel C. ``overflow`` counts the instances lost to the
    per-Gaussian cap, the ``max_instances`` budget (0 = 16*C) and K."""
    C = means2d.shape[0]
    T = grid_w * grid_h
    K = max_per_tile
    dev = means2d.device
    i64 = torch.int64
    I = max_instances if max_instances > 0 else max(8192, 16 * C)

    order = torch.argsort(torch.where(include, depths, torch.full_like(depths, float("inf"))), stable=True)
    tile_id, gauss_i, _, cap_overflow, total_raw, offsets, cov = _expand_orig(
        means2d[order], depths[order], radii[order], include[order], grid_w, grid_h,
        max_tiles_per_gaussian, I,
    )
    inst_tile, perm = torch.sort(tile_id, stable=True)
    inst_gauss = gauss_i[perm]
    # Run starts of tiles 0..T (entry T: the number of valid instances).
    starts_ext = torch.searchsorted(inst_tile, torch.arange(T + 1, dtype=i64, device=dev))
    counts = starts_ext[1:] - starts_ext[:-1]
    inst_rank = torch.arange(I, dtype=i64, device=dev) - starts_ext[inst_tile]

    counts_capped = torch.clamp(counts, max=K)
    k = torch.arange(K, dtype=i64, device=dev)
    idx = torch.clamp(starts_ext[:T, None] + k, max=I - 1)
    tile_lists = torch.where(k < counts_capped[:, None], inst_gauss[idx], torch.full_like(idx, C))
    inst_pos = torch.empty(I, dtype=i64, device=dev)
    inst_pos[perm] = torch.arange(I, dtype=i64, device=dev)

    i32 = lambda t: t.to(torch.int32)
    return Binned(
        order=i32(order),
        tile_lists=i32(tile_lists),
        tile_counts=i32(counts_capped),
        overflow=i32(cap_overflow + torch.clamp(counts - K, min=0).sum()),
        inst_tile=i32(inst_tile),
        inst_rank=i32(inst_rank),
        inst_gauss=i32(inst_gauss),
        n_instances=i32(total_raw),
        inst_pos=i32(inst_pos),
        gauss_offsets=i32(offsets),
        gauss_cov=i32(cov),
    )


class StreamBinned(NamedTuple):
    """Padded-CSR instance stream (field meanings as in the reference).

    Each tile's depth-ordered run starts at a chunk-aligned row and is padded
    to a chunk multiple with the Gaussian sentinel C (an all-zero property
    row). ``chunk_tile`` is non-decreasing, with the trash tile id T on the
    chunks past the last run."""

    stream_gauss: torch.Tensor  # [I_pad] int32 — original Gaussian idx, C = pad
    chunk_tile: torch.Tensor  # [I_pad // chunk] int32 — tile id per chunk, T = trash
    tile_counts: torch.Tensor  # [T] int32 — real instances per tile in the stream
    covered: torch.Tensor  # [T] bool — tile has >= 1 chunk inside the budget
    overflow: torch.Tensor  # [] int32 — instances dropped by any static cap
    n_instances: torch.Tensor  # [] int32 — true (unpadded, uncapped) instance total
    n_padded: torch.Tensor  # [] int32 — padded stream length actually needed
    pos_unsorted: torch.Tensor  # [I] int32 — stream row of each unsorted instance (I_pad = dropped)
    gauss_offsets: torch.Tensor  # [C] int32
    gauss_cov: torch.Tensor  # [C] int32


def _float_order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) ordering float32 x as the reference's sort does:
    -inf < ... < 0 < ... < inf < NaN, with -0.0 == 0.0 and all NaNs equal."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) + (1 << 31)


def bin_stream(
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    include: torch.Tensor,
    conics: Optional[torch.Tensor] = None,
    opacities: Optional[torch.Tensor] = None,
    *,
    grid_w: int,
    grid_h: int,
    max_tiles_per_gaussian: int = 128,
    max_instances: int = 0,
    max_stream: int = 0,
    chunk: int = CHUNK,
) -> StreamBinned:
    """Bin into the padded-CSR stream: tile runs live contiguously in one
    [I_pad] stream at chunk-aligned starts, front to back within each run.

    Budgets as in the reference: ``max_instances`` bounds the true instances
    (0 = 16*C), ``max_stream`` the padded stream (0 = max_instances +
    chunk * (tiles/2 + 256)); what falls outside is dropped and counted in
    ``overflow``."""
    C = means2d.shape[0]
    T = grid_w * grid_h
    dev = means2d.device
    i64 = torch.int64
    I = max_instances if max_instances > 0 else max(8192, 16 * C)
    I_pad = max_stream if max_stream > 0 else I + (T // 2 + 256) * chunk
    I_pad = ((I_pad + chunk - 1) // chunk) * chunk
    G = I_pad // chunk

    tile_id, gauss_i, depth_i, cap_overflow, total_raw, offsets, cov = _expand_orig(
        means2d, depths, radii, include, grid_w, grid_h, max_tiles_per_gaussian, I,
        conics, opacities,
    )
    # One stable sort by (tile, depth): tile ids < 2^31 in the high word.
    key = (tile_id << 32) | _float_order_key(depth_i.to(torch.float32))
    _, perm = torch.sort(key, stable=True)
    sorted_tiles = tile_id[perm]
    sorted_gauss = gauss_i[perm]

    i_iota = torch.arange(I, dtype=i64, device=dev)
    valid = sorted_tiles < T
    boundary = torch.ones(I, dtype=torch.bool, device=dev)
    boundary[1:] = sorted_tiles[1:] != sorted_tiles[:-1]
    # Stream row of element k = k + (tail padding of every earlier run). The
    # run start of a sorted key is its left searchsorted position (the
    # reference's cummax of boundary indices, without a slow 16M-row scan).
    run_start = torch.searchsorted(sorted_tiles, sorted_tiles)
    is_last = torch.ones(I, dtype=torch.bool, device=dev)
    is_last[:-1] = boundary[1:]
    tail_pad = torch.where(
        is_last & valid, torch.remainder(run_start - (i_iota + 1), chunk), torch.zeros_like(i_iota)
    )
    padsum = torch.cumsum(tail_pad, 0)
    n_padded = valid.sum() + padsum[-1]
    pos = i_iota + (padsum - tail_pad)
    in_budget = valid & (pos < I_pad)

    stream_gauss = torch.full((I_pad,), C, dtype=i64, device=dev)
    stream_gauss[pos[in_budget]] = sorted_gauss[in_budget]
    # Chunk -> tile map, seeded by the instances that start a chunk (runs pad
    # only at their tails, so every chunk start inside a run is real).
    is_cs = in_budget & (pos % chunk == 0)
    chunk_tile = torch.full((G,), T, dtype=i64, device=dev)
    chunk_tile[pos[is_cs] // chunk] = sorted_tiles[is_cs]
    # Where each UNSORTED instance landed (I_pad = dropped): invert the sort.
    pos_unsorted = torch.empty(I, dtype=i64, device=dev)
    pos_unsorted[perm] = torch.where(in_budget, pos, torch.full_like(pos, I_pad))

    real_per_chunk = (stream_gauss < C).reshape(G, chunk).sum(1)
    counts = torch.zeros(T + 1, dtype=i64, device=dev).index_add_(0, chunk_tile, real_per_chunk)[:T]
    covered = torch.zeros(T + 1, dtype=torch.bool, device=dev)
    covered[chunk_tile] = True

    i32 = lambda t: t.to(torch.int32)
    overflow = cap_overflow + (valid & ~in_budget).sum()
    return StreamBinned(
        stream_gauss=i32(stream_gauss),
        chunk_tile=i32(chunk_tile),
        tile_counts=i32(counts),
        covered=covered[:T],
        overflow=i32(overflow),
        n_instances=i32(total_raw),
        n_padded=i32(n_padded),
        pos_unsorted=i32(pos_unsorted),
        gauss_offsets=i32(offsets),
        gauss_cov=i32(cov),
    )
