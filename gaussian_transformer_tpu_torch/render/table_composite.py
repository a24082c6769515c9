"""Table compositor: front-to-back compositing of per-tile [T, K] property
tables and its backward (port of
``gaussian_transformer_tpu/render/pallas_composite.py``, the renderer's
``use_stream=False`` path).

Kernel K5: ``csrc/table_fwd.cu`` replaces the TPU kernel
``render/pallas_composite.py:187 _fwd_kernel``. It walks tile t's rows
[0, counts[t]) (in whole chunks of 32, as the reference does) of its
[K, 16] slab and composites every pixel with the upstream rules. Like K1 it is
bound by operations (~14 fp32 operations and one ``expf`` per walked
(row, pixel) pair, ~6 more where the row contributes, the row's 36 useful
bytes shared by 256 pixels); its walk is K1's
(``csrc/stream_common.cuh forward_walk``): one CTA per tile, 8x4-pixel
warps, rows staged in shared memory, a skip test before the ``expf``, a
block-wide exit once every pixel has terminated.

Kernel K6: ``csrc/table_bwd.cu`` replaces the TPU kernel
``render/pallas_composite.py:237 _bwd_kernel``: it replays K5's walk with
the same explicitly rounded alpha and transmittance code
(``csrc/stream_common.cuh``), takes the color suffix sums from the forward's
color (C_total), and writes one gradient row per table row, zero past the
rows it walked. It is bound by operations (K5's walk, ~27 more per
contributing pair, and the 9 per-row sums of the reference's per-pixel
terms over the tile's pixels), and at the training table's size nearly by
the bytes of the [T, K, 16] output it writes whole. Its design is K2's
per-batch shared-memory reduction (``csrc/stream_bwd.cu``), with the
per-pixel terms (``csrc/stream_common.cuh pixel_grad_terms``, which K8
shares) in place of K2's moments: absolute coordinates lose digits in the
moment form. No atomics: a row belongs to one tile.

``composite_table_tiles`` launches K5 (and K6 in its backward) for CUDA
tensors and uses the plain PyTorch versions, ``composite_table_tiles_plain``
and ``composite_table_tiles_bwd_plain``, only for CPU tensors; they walk
rounds of 32 rows with the reference's chunk recurrences, and
``_round_grads`` is the per-round gradient both plain K6 and plain K8
(``attic/stream_t.py``) sum. ``build_props_table``
is the reference's ``_build_props_table``: ``props_full[tile_lists]``,
pulled back deterministically through the binning's instance map
(``stream.instance_pullback``). Unlike the stream layout the table pads
every tile to K rows, so it grows with the densest tile.

Property row layout (PROPS_F = 16) and gradient rows as in stream.py; the
table rows hold ABSOLUTE screen means, evaluated at absolute pixel centers
(the reference's ``_pixel_coords``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from gaussian_transformer_tpu_torch.kernels import CudaKernel
from gaussian_transformer_tpu_torch.render.stream import (
    GRAD_F, PROPS_F, instance_pullback, walked_mask, walked_pairs, warp_lanes, warp_step_counts,
)
from gaussian_transformer_tpu_torch.render.tiles import TILE

P = TILE * TILE
CH = 32  # rows per chunk: K is padded to a multiple of it, walks end on its edges

TABLE_FWD = CudaKernel(
    "table_fwd.cu",
    "table_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
)
TABLE_BWD = CudaKernel(
    "table_bwd.cu",
    "table_bwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)


class _TableBuild(torch.autograd.Function):
    """The table [rows, 16] = props_full[tile_lists] (the reference's
    ``_build_props_table``), written as a zero table (the sentinel row C is
    zero) into which only the valid instances' rows are scattered: the
    padding rows, most of a large table, are never gathered. Unique rows, so
    deterministic. Pulled back by ``stream.instance_pullback`` through the
    table row of each unsorted instance."""

    @staticmethod
    def forward(ctx, props_full, gauss, row, rows, gauss_offsets, gauss_cov):
        ctx.save_for_backward(row, gauss_offsets, gauss_cov)
        ctx.rows = rows
        valid = row < rows
        table = props_full.new_zeros(rows, PROPS_F)
        table[row[valid]] = props_full[gauss[valid]]
        return table

    @staticmethod
    def backward(ctx, g):
        row, offsets, cov = ctx.saved_tensors
        return instance_pullback(g, row, ctx.rows, offsets, cov), None, None, None, None, None


def build_props_table(props_full, binned) -> torch.Tensor:
    """props_full[tile_lists] -> [T, K_pad, 16], K padded to a multiple of CH
    with the (zero) sentinel row C. Instance u of the binning's unsorted
    domain lands at row inst_tile * K_pad + inst_rank of its tile-sorted
    position, if that tile is real and the rank under K (a rank past it is
    an entry the list cap dropped)."""
    T, K = binned.tile_lists.shape
    Kp = -(-K // CH) * CH
    pos = binned.inst_pos.long()
    tile = binned.inst_tile.long()[pos]
    rank = binned.inst_rank.long()[pos]
    row = torch.where((tile < T) & (rank < K), tile * Kp + rank, torch.full_like(tile, T * Kp))
    gauss = binned.inst_gauss.long()[pos]
    table = _TableBuild.apply(props_full, gauss, row, T * Kp, binned.gauss_offsets, binned.gauss_cov)
    return table.reshape(T, Kp, PROPS_F)


def walked_rows(counts, K):
    """Rows of each tile the walks read: counts rounded up to a chunk, at most K."""
    return torch.clamp((counts.long() + CH - 1) // CH * CH, 0, K)


class _Round(NamedTuple):
    """Chunk r of every tile still walking, as [Ta, CH, ...] tensors."""

    tiles: torch.Tensor  # [Ta] tile ids
    start: int  # the chunk's first row
    rows: torch.Tensor  # [Ta, CH, 16]
    dx: torch.Tensor  # [Ta, CH, P] x - px
    dy: torch.Tensor
    alpha_raw: torch.Tensor  # [Ta, CH, P] before the cap
    alpha: torch.Tensor  # [Ta, CH, P] capped, 0 where skipped
    t_in: torch.Tensor  # [Ta, CH, P] transmittance before each row
    live_k: torch.Tensor  # [Ta, CH, P] 1 where the row contributes
    lv: torch.Tensor  # [Ta, 1, P] live before the chunk
    trigger: torch.Tensor  # [Ta, CH, P]
    t_after: torch.Tensor  # [Ta, 1, P] the carried T after the chunk


def _plain_rounds(props, counts, grid_w):
    """The reference kernels' walk (pallas_composite.py:56-78, 194-234) over
    all tiles at once: chunk r of each tile whose count reaches it and that
    still has a live pixel, with an exclusive cumprod for T and an inclusive
    OR-scan for termination, T and the live flags carried per tile-pixel."""
    T, K, _ = props.shape
    dev = props.device
    n_rows = walked_rows(counts, K)
    p = torch.arange(P, device=dev)
    t_idx = torch.arange(T, device=dev)
    # Absolute pixel centers [T, 1, P].
    px = ((t_idx % grid_w) * TILE)[:, None, None].to(torch.float32) + (p % TILE).to(torch.float32)
    py = ((t_idx // grid_w) * TILE)[:, None, None].to(torch.float32) + (p // TILE).to(torch.float32)
    t_run = torch.ones(T, 1, P, dtype=torch.float32, device=dev)
    live = torch.ones(T, 1, P, dtype=torch.float32, device=dev)
    for r in range(K // CH):
        walking = (n_rows > r * CH) & ((t_run * live).amax(dim=(1, 2)) >= 1e-4)
        tiles = torch.nonzero(walking).flatten()
        if tiles.numel() == 0:
            return
        rows = props[tiles, r * CH:(r + 1) * CH]
        a, b, c = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5]
        dx = rows[..., 0:1] - px[tiles]
        dy = rows[..., 1:2] - py[tiles]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha_raw = rows[..., 8:9] * torch.exp(torch.clamp(power, max=0.0))
        alpha = torch.clamp(alpha_raw, max=0.99)
        alpha = torch.where((power > 0.0) | (alpha < 1.0 / 255.0), torch.zeros_like(alpha), alpha)

        t0, lv = t_run[tiles], live[tiles]
        t_in = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]], 1), 1) * t0
        trigger = (alpha > 0.0) & (t_in * (1.0 - alpha) < 1e-4)
        done_inc = torch.cumsum(trigger.to(torch.int32), dim=1) > 0
        live_k = torch.where(done_inc, torch.zeros_like(t_in), lv)
        t_after = t0 * torch.prod(1.0 - alpha * live_k, dim=1, keepdim=True)
        yield _Round(tiles, r * CH, rows, dx, dy, alpha_raw, alpha, t_in, live_k, lv, trigger, t_after)
        t_run[tiles] = t_after
        live[tiles] = lv * (~done_inc[:, -1:]).to(torch.float32)


def table_warp_steps(props, counts, grid_w):
    """(steps, uniform-skip steps) of K5's warps over a table (each tile to
    its ``walked_rows``), counted by the plain walk as
    ``stream.stream_warp_steps`` counts K1's."""
    lanes = warp_lanes(props.device)
    steps = torch.zeros((), dtype=torch.int64, device=props.device)
    uniform = torch.zeros((), dtype=torch.int64, device=props.device)
    for rd in _plain_rounds(props, counts, grid_w):
        s, u = warp_step_counts(walked_mask(rd.lv, rd.trigger), rd.alpha == 0.0, lanes)
        steps += s
        uniform += u
    return int(steps), int(uniform)


def composite_table_tiles_plain(props, counts, grid_w, count_work=False):
    """Plain PyTorch version of K5: props [T, K, 16], counts [T] ->
    (color [T, 3, P], final_T [T, 1, P]), pre-background.

    ``count_work=True`` also returns (walked, contributing) for roofline
    accounting: the (row, pixel) pairs a sequential walk evaluates (real rows
    up to and including each pixel's terminating row), and those of them
    that contribute (not skipped, not the terminating row)."""
    T = props.shape[0]
    color = torch.zeros(T, 3, P, dtype=torch.float32, device=props.device)
    final_t = torch.ones(T, 1, P, dtype=torch.float32, device=props.device)
    walked = torch.zeros((), dtype=torch.int64, device=props.device)
    contributing = torch.zeros((), dtype=torch.int64, device=props.device)
    for rd in _plain_rounds(props, counts, grid_w):
        w = rd.alpha * rd.t_in * rd.live_k
        color[rd.tiles] += torch.einsum("tkc,tkp->tcp", rd.rows[..., 5:8], w)
        final_t[rd.tiles] = rd.t_after
        if count_work:
            walked += walked_pairs(rd.rows, rd.lv, rd.trigger)
            contributing += ((rd.live_k > 0.0) & (rd.alpha > 0.0)).sum()
    if count_work:
        return color, final_t, (int(walked), int(contributing))
    return color, final_t


def _round_grads(rd, color, color_pref, g_color, g_t, final_t):
    """The reference kernels' per-pixel gradient terms of one plain round
    (pallas_composite.py:284-357, attic/stream_t.py:280-337), summed over
    each tile's pixels: (grads [Ta, B, 9], totals [Ta, 3, 1]) from the
    round's ``rd`` (a ``_Round`` of this module or of ``stream``, absolute
    coordinates), the forward's outputs (color = C_total [T, 3, P], final_T
    [T, 1, P]), their cotangents and ``color_pref`` [T, 3, P], the color
    composited before the round; ``totals`` is the round's own color, which
    the caller adds to ``color_pref``."""
    alpha, t_in, dx, dy = rd.alpha, rd.t_in, rd.dx, rd.dy
    a, b, c = rd.rows[..., 2:3], rd.rows[..., 3:4], rd.rows[..., 4:5]
    rgb, opac = rd.rows[..., 5:8], rd.rows[..., 8:9]
    gc, c_total, pref = g_color[rd.tiles], color[rd.tiles], color_pref[rd.tiles]
    rs = lambda v: v.sum(dim=2, keepdim=True)  # [Ta, B, P] -> [Ta, B, 1]
    w = alpha * t_in * rd.live_k
    d_rgb = torch.einsum("tkp,tcp->tkc", w, gc)
    one_minus = torch.clamp(1.0 - alpha, min=1e-6)
    g_alpha = -g_t[rd.tiles] * final_t[rd.tiles] / one_minus
    totals = []
    for ch in range(3):
        prefix = torch.cumsum(w * rgb[..., ch:ch + 1], dim=1)
        suffix = (c_total[:, ch:ch + 1] - pref[:, ch:ch + 1]) - prefix
        g_alpha = g_alpha + gc[:, ch:ch + 1] * (rgb[..., ch:ch + 1] * t_in - suffix / one_minus)
        totals.append(prefix[:, -1:])
    g_alpha = g_alpha * rd.live_k * (alpha > 0.0).to(torch.float32)
    g_alpha = torch.where(rd.alpha_raw > 0.99, torch.zeros_like(g_alpha), g_alpha)
    g_power = g_alpha * alpha
    grads = torch.cat([
        rs(g_power * (-(a * dx) - b * dy)),
        rs(g_power * (-(c * dy) - b * dx)),
        rs(g_power * (-0.5 * dx * dx)),
        rs(g_power * (-(dx * dy))),
        rs(g_power * (-0.5 * dy * dy)),
        d_rgb,
        rs(g_alpha * alpha / torch.clamp(opac, min=1e-12)),
    ], dim=2)
    return grads, torch.cat(totals, dim=1)


def composite_table_tiles_bwd_plain(props, counts, grid_w, color, final_t, g_color, g_t):
    """Plain PyTorch version of K6: dprops [T, K, 16] (columns 0-8) from the
    forward's outputs (color = C_total [T, 3, P], final_T [T, 1, P]) and their
    cotangents, with the reference kernel's formulas
    (pallas_composite.py:284-357); rows not walked stay zero."""
    dprops = torch.zeros_like(props)
    color_pref = torch.zeros_like(color)
    for rd in _plain_rounds(props, counts, grid_w):
        grads, totals = _round_grads(rd, color, color_pref, g_color, g_t, final_t)
        dprops[rd.tiles, rd.start:rd.start + CH, :GRAD_F] = grads
        color_pref[rd.tiles] = color_pref[rd.tiles] + totals
    return dprops


class _TableComposite(torch.autograd.Function):
    """K5 forward and K6 backward on CUDA tensors; the plain versions on CPU
    tensors. Saves the table and the forward's outputs (the backward's
    C_total and T_final)."""

    @staticmethod
    def forward(ctx, props, counts, grid_w):
        if props.is_cuda:
            color, final_t = _launch_table_fwd(props, counts, grid_w)
        else:
            color, final_t = composite_table_tiles_plain(props, counts, grid_w)
        ctx.save_for_backward(props, counts, color, final_t)
        ctx.grid_w = grid_w
        return color, final_t

    @staticmethod
    def backward(ctx, g_color, g_t):
        props, counts, color, final_t = ctx.saved_tensors
        g_color = torch.zeros_like(color) if g_color is None else g_color
        g_t = torch.zeros_like(final_t) if g_t is None else g_t
        if props.is_cuda:
            dprops = _launch_table_bwd(props, counts, ctx.grid_w, color, final_t, g_color, g_t)
        else:
            dprops = composite_table_tiles_bwd_plain(props, counts, ctx.grid_w, color, final_t, g_color, g_t)
        return dprops, None, None


def _check_table_shapes(props, counts):
    """float32 [T, K, 16] with K a positive multiple of CH (the walks end on
    chunk edges), and integer [T] counts on the same device."""
    if props.dtype != torch.float32 or props.ndim != 3 or props.shape[2] != PROPS_F:
        raise ValueError(f"props must be float32 [T, K, {PROPS_F}], got {props.dtype} {tuple(props.shape)}")
    T, K, _ = props.shape
    if K == 0 or K % CH:
        raise ValueError(f"K = {K} must be a positive multiple of {CH}")
    if tuple(counts.shape) != (T,) or counts.device != props.device or counts.is_floating_point():
        raise ValueError(f"counts must be integer [{T}] on {props.device}, got {counts.dtype} {tuple(counts.shape)}")


def _checked_table(props, counts):
    """The table and counts as the kernels read them: the shapes of
    ``_check_table_shapes``, the table contiguous and 16-byte aligned, the
    counts int32."""
    _check_table_shapes(props, counts)
    props = props.contiguous()
    if props.data_ptr() % 16:
        raise ValueError("props must be 16-byte aligned")
    return props, counts.to(torch.int32).contiguous()


def _launch_table_fwd(props, counts, grid_w):
    """K5: (color [T, 3, P], final_T [T, 1, P])."""
    props, counts = _checked_table(props, counts)
    T, K, _ = props.shape
    color = torch.empty(T, 3, P, dtype=torch.float32, device=props.device)
    final_t = torch.empty(T, 1, P, dtype=torch.float32, device=props.device)
    TABLE_FWD.launch(
        props.data_ptr(), counts.data_ptr(), K, grid_w, T, color.data_ptr(), final_t.data_ptr(),
        torch.cuda.current_stream(props.device).cuda_stream,
    )
    return color, final_t


def _launch_table_bwd(props, counts, grid_w, color, final_t, g_color, g_t):
    """K6: dprops [T, K, 16] from K5's outputs and their cotangents."""
    props, counts = _checked_table(props, counts)
    T, K, _ = props.shape
    tile_data = []
    for name, v, rows in (("color", color, 3), ("final_t", final_t, 1), ("g_color", g_color, 3),
                          ("g_t", g_t, 1)):
        if tuple(v.shape) != (T, rows, P) or v.device != props.device:
            raise ValueError(f"{name} must be [{T}, {rows}, {P}] on {props.device}, got {tuple(v.shape)}")
        tile_data.append(v.float().contiguous())
    dprops = torch.empty_like(props)
    TABLE_BWD.launch(
        props.data_ptr(), counts.data_ptr(), *(v.data_ptr() for v in tile_data), K, grid_w, T,
        dprops.data_ptr(), torch.cuda.current_stream(props.device).cuda_stream,
    )
    return dprops


def composite_table_tiles(props, counts, grid_w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(color [T, 3, P], final_T [T, 1, P]) pre-background, differentiable in
    ``props``. CUDA tensors go through kernels K5 and K6; CPU tensors through
    the plain versions. Shapes either device cannot take raise ValueError."""
    if not (props.is_cuda or props.device.type == "cpu"):
        raise ValueError(f"no table compositor for device {props.device}")
    _check_table_shapes(props, counts)
    return _TableComposite.apply(props, counts, grid_w)
