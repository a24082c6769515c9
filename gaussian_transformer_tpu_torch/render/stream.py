"""Stream compositor: front-to-back compositing of the padded-CSR instance
stream and its backward (port of ``gaussian_transformer_tpu/render/stream.py``).

Kernel K1: ``csrc/stream_fwd.cu`` replaces the TPU kernel
``render/stream.py:266 _fwd_kernel``. It is bound by operations (~14 fp32
operations and one ``expf`` per walked (row, pixel) pair, ~6 more where the
row contributes, the row's 36 useful bytes shared by a tile's 256 pixels);
its design answer is one CTA per tile over only its run's real rows
(``real_row_ranges``), warps of 8x4 pixels, rows staged in shared memory, a
skip test before the ``expf`` and a block-wide early exit once every pixel has
terminated (the walk is ``csrc/stream_common.cuh forward_walk``, shared
with K5).

Kernel K2: ``csrc/stream_bwd.cu`` replaces the TPU kernel
``render/stream.py:411 _bwd_kernel``: it replays each tile's run with K1's
own alpha and transmittance code (``csrc/stream_common.cuh``) and writes one
gradient row per stream row. It is bound by operations: K1's walk, ~27 more
per contributing pair, and each row's 9 sums over the tile's 256 pixels.
Its design is K1's geometry with those sums taken once per batch of 32 rows
in shared memory: the walk stores each pixel's (g_power, w) per row, then
(row, 32-pixel segment) jobs add their segment in pixel order, skip
segments without a contributing pixel, and join a row's 8 partials with
three shuffle levels (fixed order, no atomics: a row belongs to one tile).

``precision="bf16"`` (the reference's bf16 property stream,
``render/stream.py:159-165,751-753``): ``kernel_props`` shifts each row's
mean into its tile's frame in float32 (``localize_props``), then rounds the
rows to bf16, so the 8-bit mantissa spans the tile (screen coordinates up
to 1920 would keep whole pixels only). Its entry points
``stream_fwd_bf16`` and ``stream_bwd_bf16`` are K1's and K2's kernels on a
bf16 row stager (``csrc/stream_common.cuh Bf16RowStager``): the rows are
32 bytes instead of 64, the walk, its arithmetic and the accumulators stay
float32. They stay bound by operations (the row's bytes are shared by 256
pixels), so halving the bytes is not expected to make them faster. The
backward replays the bf16 rows the forward saved and returns the float32
rows' gradient (the shift is a translation).

``composite_stream_tiles`` launches K1 (and K2 in its backward) for CUDA
tensors and uses the plain PyTorch versions, ``composite_stream_tiles_plain``
and ``composite_stream_tiles_bwd_plain``, only for CPU tensors. The plain
versions take bf16 rows as tile-local (origin 0) and upcast them.
``stream_gather`` pulls the stream's gradient rows back to the Gaussians by a
deterministic sum over each Gaussian's instance range (a float64 prefix sum).

Property row layout (PROPS_F = 16):
  0: x  1: y  2: conic_a  3: conic_b  4: conic_c  5: r  6: g  7: b  8: opacity
Gradient rows use the same columns (9-15 are zero).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from gaussian_transformer_tpu_torch.kernels import CudaKernel
from gaussian_transformer_tpu_torch.render.tiles import TILE
from gaussian_transformer_tpu_torch.utils.profiling import count, span

P = TILE * TILE
PROPS_F = 16
# Rows per round of the plain version (divides every chunk size, >= 32).
PLAIN_ROWS = 32

STREAM_FWD = CudaKernel(
    "stream_fwd.cu",
    "stream_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
)
STREAM_BWD = CudaKernel(
    "stream_bwd.cu",
    "stream_bwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)
# precision="bf16": the same kernels on bf16 tile-local rows, each with its
# own launch counter.
STREAM_FWD_BF16 = CudaKernel("stream_fwd.cu", "stream_fwd_bf16", STREAM_FWD.argtypes)
STREAM_BWD_BF16 = CudaKernel("stream_bwd.cu", "stream_bwd_bf16", STREAM_BWD.argtypes)
# The kernels' row type by precision.
ROW_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# Columns of a gradient row that can be non-zero (x .. opacity).
GRAD_F = 9


def pack_props(means2d, conics, rgbs, opac):
    """Per-Gaussian screen properties in the kernel layout [C+1, 16]; the
    sentinel row C is all zeros, so padding rows are no-ops."""
    C = means2d.shape[0]
    cols = torch.cat(
        [means2d, conics, rgbs, opac[:, None], means2d.new_zeros(C, PROPS_F - 9)], dim=1
    )
    return torch.cat([cols, cols.new_zeros(1, PROPS_F)], dim=0)


def _local_xy(props, chunk_tile, grid_w: int, chunk: int):
    """[I_pad, 2] columns x, y minus the origin ((t % grid_w) * 16,
    (t // grid_w) * 16) of the tile t of their chunk, in the rows' type."""
    t = chunk_tile.long()[:, None]
    origin = torch.cat([t % grid_w, t // grid_w], dim=1).to(props.dtype) * TILE  # [G, 2]
    return (props[:, :2].reshape(-1, chunk, 2) - origin[:, None, :]).reshape(-1, 2)


def localize_props(props, chunk_tile, grid_w: int, chunk: int):
    """The rows with x, y shifted into their tile's frame, in float32, every
    row (the trash tile's included), as the reference's ``_localize_props``
    does. The shift is a translation: the gradient passes through it
    unchanged."""
    return torch.cat([_local_xy(props, chunk_tile, grid_w, chunk), props[:, 2:]], dim=1)


def kernel_props(props, chunk_tile, grid_w: int, precision: str):
    """The rows as the compositor kernels read them: the float32 rows for
    "fp32"; for "bf16" ``localize_props`` rounded to bf16 (to nearest even,
    as the reference's ``astype``): x and y are shifted in float32 and
    rounded after the shift, never before; the other columns are rounded
    as they are (one cast, then two columns overwritten)."""
    if precision != "bf16":
        return props
    rows = props.to(torch.bfloat16)
    rows[:, :2] = _local_xy(props, chunk_tile, grid_w, props.shape[0] // chunk_tile.shape[0]).to(torch.bfloat16)
    return rows


def instance_pullback(g, pos, rows, gauss_offsets, gauss_cov):
    """The reference's gradient pullback (stream.py:670-689) from gathered
    rows g [rows, 16] to the Gaussians [C+1, 16]: each unsorted instance's
    cotangent row is read at its row ``pos`` (at or past ``rows``: a dropped
    instance), then summed over its Gaussian's contiguous instance range
    [gauss_offsets, gauss_offsets + gauss_cov) as the difference of a
    float64 prefix sum at the range's ends. Deterministic (a scan, no
    atomics), and a Gaussian's small sum survives the subtraction where the
    reference's float32 cumsum loses it. (``torch.segment_reduce`` gives the
    same sums but took 70 ms at 1080p on the H100.)"""
    I = pos.shape[0]
    pos = pos.long()
    in_rows = (pos < rows)[:, None]
    d_unsorted = torch.where(in_rows, g[torch.clamp(pos, max=rows - 1), :GRAD_F], 0.0)
    # One flat scan of the columns laid end to end, column j at [j I,
    # (j + 1) I): a range's sum is still the difference at its ends. (A
    # scan along dim 0 of [I, 9] runs one serial thread per column, and
    # along dim 1 of [9, I] one block per row: 1.3 s and 6.5 ms at 1080p on
    # an H100.)
    flat = d_unsorted.to(torch.float64).t().reshape(-1)
    csum = torch.cat([flat.new_zeros(1), torch.cumsum(flat, dim=0)])  # [k]: the first k values
    col = (torch.arange(GRAD_F, device=g.device) * I)[:, None]
    lo = col + torch.clamp(gauss_offsets.long(), 0, I)[None, :]
    hi = col + torch.clamp(gauss_offsets.long() + gauss_cov.long(), 0, I)[None, :]
    d_full = g.new_zeros(gauss_offsets.shape[0] + 1, PROPS_F)  # sentinel row C stays 0
    d_full[:-1, :GRAD_F] = (csum[hi] - csum[lo]).t().to(g.dtype)
    return d_full


class _StreamGather(torch.autograd.Function):
    """props_full[stream_gauss], pulled back by ``instance_pullback`` through
    the stream row ``pos_unsorted`` of each unsorted instance."""

    @staticmethod
    def forward(ctx, props_full, stream_gauss, pos_unsorted, gauss_offsets, gauss_cov):
        ctx.save_for_backward(pos_unsorted, gauss_offsets, gauss_cov)
        ctx.rows = stream_gauss.shape[0]
        return props_full[stream_gauss.long()]

    @staticmethod
    def backward(ctx, g):
        pos, offsets, cov = ctx.saved_tensors
        return instance_pullback(g, pos, ctx.rows, offsets, cov), None, None, None, None


def stream_gather(props_full, binned, stream_gauss):
    """props_full[stream_gauss] -> the stream's property rows [rows, 16];
    differentiable in ``props_full`` through the binning's instance map."""
    return _StreamGather.apply(props_full, stream_gauss, binned.pos_unsorted,
                               binned.gauss_offsets, binned.gauss_cov)


def used_stream(binned):
    """(stream_gauss, chunk_tile) cut to the rows the compositor can read:
    every tile run lies in the first ``n_padded`` rows, the rest of the
    budget is trash-tile padding. Reads ``n_padded`` on the host."""
    G = binned.chunk_tile.shape[0]
    chunk = binned.stream_gauss.shape[0] // G
    n = min(max(int(binned.n_padded), chunk), G * chunk)  # a chunk multiple
    return binned.stream_gauss[:n], binned.chunk_tile[: n // chunk]


def tile_chunk_ranges(chunk_tile: torch.Tensor, n_tiles: int):
    """[chunk_start, chunk_end) of every tile's run, int32 [T] each.
    ``chunk_tile`` is non-decreasing (trash id T at the end)."""
    tiles = torch.arange(n_tiles, dtype=chunk_tile.dtype, device=chunk_tile.device)
    start = torch.searchsorted(chunk_tile, tiles, out_int32=True)
    end = torch.searchsorted(chunk_tile, tiles, right=True, out_int32=True)
    return start, end


def real_row_ranges(chunk_tile: torch.Tensor, tile_counts: torch.Tensor, n_tiles: int, chunk: int):
    """[row_start, row_end) of the real rows of every tile's run, int32 [T]
    each (K1's walk): a run starts at its first chunk and pads only at its
    tail, so its ``tile_counts`` (``StreamBinned.tile_counts``) real rows
    come first. ``row_end`` is clamped to the run's padded end, so a count
    larger than its run never reaches the next tile's rows. Five small ops, as
    K1's wrapper runs them per launch."""
    tiles = torch.arange(n_tiles + 1, dtype=chunk_tile.dtype, device=chunk_tile.device)
    bounds = torch.searchsorted(chunk_tile, tiles, out_int32=True) * chunk  # run t: [bounds[t], bounds[t + 1])
    row_start = bounds[:-1]
    return row_start, torch.minimum(row_start + tile_counts.to(torch.int32), bounds[1:])


def warp_lanes(device=None) -> torch.Tensor:
    """[8, 32] pixel of each (warp, lane) of a forward block (K1 and K5,
    ``csrc/stream_common.cuh fwd_pixel``): warp w covers columns (w & 1) * 8
    + 0..7, rows (w >> 1) * 4 + 0..3."""
    tid = torch.arange(P, device=device)
    warp, lane = tid // 32, tid % 32
    return (((warp // 2) * 4 + lane // 8) * TILE + (warp % 2) * 8 + lane % 8).reshape(8, 32)


def warp_step_counts(active, skip, lanes):
    """(steps, uniform-skip steps) of one plain round: ``active`` [Ta, B, P]
    marks the (row, pixel) pairs a pixel walks, ``skip`` [Ta, B, P] those
    that fail the alpha test. A warp steps through a row where any of its
    lanes is active; the step is a uniform skip where every active lane
    skips."""
    a = active[..., lanes]  # [Ta, B, 8, 32]
    step = a.any(dim=-1)
    live = (a & ~skip[..., lanes]).any(dim=-1)
    return step.sum(), (step & ~live).sum()


def walked_mask(lv, trigger):
    """[Ta, B, P] pairs a sequential walk reaches: pixels live before the
    round, up to and including each one's first trigger."""
    trig = trigger.to(torch.int32)
    return (lv > 0.0) & ((torch.cumsum(trig, dim=1) - trig) == 0)


def stream_warp_steps(props, chunk_tile, tile_counts, grid_w, grid_h, absolute=False):
    """(steps, uniform-skip steps) of K1's warps over a stream, counted by
    the plain walk: per (row, warp), whether any lane walks the row (up to
    its run's last real row, where K1 ends) and whether every lane that does
    skips it. ``absolute``: K7's walk, in screen coordinates."""
    T = grid_w * grid_h
    chunk = props.shape[0] // chunk_tile.shape[0]
    row_end = real_row_ranges(chunk_tile.to(torch.int32), tile_counts, T, chunk)[1].long()
    lanes = warp_lanes(props.device)
    steps = torch.zeros((), dtype=torch.int64, device=props.device)
    uniform = torch.zeros((), dtype=torch.int64, device=props.device)
    for rd in _plain_rounds(props, chunk_tile, grid_w, grid_h, absolute):
        active = walked_mask(rd.lv, rd.trigger) & (rd.idx < row_end[rd.tiles, None])[..., None]
        s, u = warp_step_counts(active, rd.alpha == 0.0, lanes)
        steps += s
        uniform += u
    return int(steps), int(uniform)


def _termination(alpha, t_in, lv):
    """Scan-free termination (the reference's v5 form): a pixel stops BEFORE
    the contribution that would take T below 1e-4. t_in is monotone, so the
    first trigger and everything after it is ``t_in <= tstar``."""
    trigger = (alpha > 0.0) & (t_in * (1.0 - alpha) < 1e-4)
    tstar = torch.where(trigger, t_in, torch.zeros_like(t_in)).amax(dim=1, keepdim=True)
    live_k = torch.where(t_in <= tstar, torch.zeros_like(t_in), lv)
    return live_k, tstar, trigger


class _Round(NamedTuple):
    """One round of the plain replay: rows [r*B, (r+1)*B) of every tile run
    that reaches them, as [Ta, B, ...] tensors."""

    tiles: torch.Tensor  # [Ta] tile ids
    idx: torch.Tensor  # [Ta, B] stream rows
    rows: torch.Tensor  # [Ta, B, 16]
    x: torch.Tensor  # [Ta, B, 1] means in the walk's frame (tile-local, or absolute)
    y: torch.Tensor
    dx: torch.Tensor  # [Ta, B, P] x - px in that frame
    dy: torch.Tensor
    alpha_raw: torch.Tensor  # [Ta, B, P] before the cap
    alpha: torch.Tensor  # [Ta, B, P] capped, 0 where skipped
    t_in: torch.Tensor  # [Ta, B, P] transmittance before each row
    live_k: torch.Tensor  # [Ta, B, P] 1 where the row contributes
    lv: torch.Tensor  # [Ta, 1, P] live before the round
    tstar: torch.Tensor  # [Ta, 1, P] T at the terminating row (0: none)
    trigger: torch.Tensor  # [Ta, B, P]
    t_after: torch.Tensor  # [Ta, 1, P] the carried T after the round


def _plain_rounds(props, chunk_tile, grid_w, grid_h, absolute=False):
    """The plain versions' walk: rounds of ``PLAIN_ROWS`` rows over every
    tile's run at once, with the reference's scan-free termination, carrying
    T and a live flag per tile-pixel between rounds. Yields a ``_Round``.
    Means and pixel centers are tile-local (K1, K2), or with ``absolute``
    the screen's (the transposed kernels K7, K8). bf16 rows are already
    tile-local (``kernel_props``): upcast, origin 0."""
    local = props.dtype == torch.bfloat16
    props = props.float()
    I_pad = props.shape[0]
    chunk = I_pad // chunk_tile.shape[0]
    T = grid_w * grid_h
    dev = props.device
    B = min(PLAIN_ROWS, chunk)
    start, end = tile_chunk_ranges(chunk_tile, T)
    row0 = start.long() * chunk
    n_rows = (end.long() - start.long()) * chunk

    p = torch.arange(P, device=dev)
    px = (p % TILE).to(torch.float32)
    py = (p // TILE).to(torch.float32)
    t_idx = torch.arange(T, device=dev)
    ox = ((t_idx % grid_w) * TILE).to(torch.float32)
    oy = ((t_idx // grid_w) * TILE).to(torch.float32)

    t_run = torch.ones(T, 1, P, dtype=torch.float32, device=dev)
    live = torch.ones(T, 1, P, dtype=torch.float32, device=dev)
    k_iota = torch.arange(B, device=dev)
    r = 0
    while True:
        tiles = torch.nonzero(n_rows > r * B).flatten()
        if tiles.numel() == 0:
            return
        idx = row0[tiles, None] + r * B + k_iota
        rows = props[idx]
        a, b, c = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5]
        if absolute:
            x, y = rows[..., 0:1], rows[..., 1:2]
            dx = x - (ox[tiles, None, None] + px)
            dy = y - (oy[tiles, None, None] + py)
        elif local:
            x, y = rows[..., 0:1], rows[..., 1:2]
            dx = x - px
            dy = y - py
        else:
            x = rows[..., 0:1] - ox[tiles, None, None]
            y = rows[..., 1:2] - oy[tiles, None, None]
            dx = x - px
            dy = y - py
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha_raw = rows[..., 8:9] * torch.exp(torch.clamp(power, max=0.0))
        alpha = torch.clamp(alpha_raw, max=0.99)
        skip = (power > 0.0) | (alpha < 1.0 / 255.0)
        alpha = torch.where(skip, torch.zeros_like(alpha), alpha)

        t0 = t_run[tiles]
        lv = live[tiles]
        t_in = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]], 1), 1) * t0
        live_k, tstar, trigger = _termination(alpha, t_in, lv)
        # A dead pixel keeps its T; a live one takes T at its terminating
        # row, or the product over the whole round.
        t_full = t_in[:, -1:] * (1.0 - alpha[:, -1:])
        t_after = torch.where(lv > 0.0, torch.where(tstar > 0.0, tstar, t_full), t0)
        yield _Round(tiles, idx, rows, x, y, dx, dy, alpha_raw, alpha, t_in, live_k, lv, tstar, trigger, t_after)
        t_run[tiles] = t_after
        live[tiles] = lv * (tstar <= 0.0).to(torch.float32)
        r += 1


def walked_pairs(rows, lv, trigger):
    """The (row, pixel) pairs of a round that a sequential walk evaluates:
    real rows (opacity > 0) of pixels live before the round, up to and
    including each pixel's first trigger."""
    return ((rows[..., 8:9] > 0.0) & walked_mask(lv, trigger)).sum()


def composite_stream_tiles_plain(props, chunk_tile, grid_w, grid_h, count_work=False, absolute=False):
    """Plain PyTorch version of K1: (color [T, 3, P], final_T [T, 1, P]),
    from float32 rows or, as K1's bf16 entry point, bf16 tile-local rows.

    ``count_work=True`` also returns (walked, contributing) for roofline
    accounting: the (row, pixel) pairs a sequential walk evaluates (real rows
    up to and including each pixel's terminating row), and those of them
    that contribute (not skipped, not the terminating row). ``absolute``
    walks in screen coordinates, as K7 does (``_plain_rounds``)."""
    T = grid_w * grid_h
    color = torch.zeros(T, 3, P, dtype=torch.float32, device=props.device)
    final_t = torch.ones(T, 1, P, dtype=torch.float32, device=props.device)
    walked = torch.zeros((), dtype=torch.int64, device=props.device)
    contributing = torch.zeros((), dtype=torch.int64, device=props.device)
    for rd in _plain_rounds(props, chunk_tile, grid_w, grid_h, absolute):
        w = rd.alpha * rd.t_in * rd.live_k
        color[rd.tiles] += torch.einsum("tkc,tkp->tcp", rd.rows[..., 5:8], w)
        final_t[rd.tiles] = rd.t_after
        if count_work:
            contributing += ((rd.live_k > 0.0) & (rd.alpha > 0.0)).sum()
            walked += walked_pairs(rd.rows, rd.lv, rd.trigger)
    if count_work:
        return color, final_t, (int(walked), int(contributing))
    return color, final_t


def composite_stream_tiles_bwd_plain(props, chunk_tile, grid_w, grid_h, color, final_t,
                                     g_color, g_t):
    """Plain PyTorch version of K2: float32 dprops [I_pad, 16] from float32
    or bf16 tile-local rows (K2's bf16 entry point) and the forward's
    outputs (color = C_total [T, 3, P], final_T [T, 1, P]) and their
    cotangents, replaying the plain forward's rounds with the reference
    kernel's formulas (stream.py:505-621): the suffix sums of the color
    enter through sum_c gC_c S_kc = <gC, C_total> - prefix - P_u(k)."""
    T = grid_w * grid_h
    p = torch.arange(P, device=props.device)
    px = (p % TILE).to(torch.float32)
    py = (p // TILE).to(torch.float32)
    gdot_total = (g_color[:, 0:1] * color[:, 0:1] + g_color[:, 1:2] * color[:, 1:2]
                  + g_color[:, 2:3] * color[:, 2:3])  # [T, 1, P]
    gt_final = g_t * final_t
    pref = torch.zeros(T, 1, P, dtype=torch.float32, device=props.device)
    dprops = torch.zeros(props.shape, dtype=torch.float32, device=props.device)
    rs = lambda v: v.sum(dim=2, keepdim=True)  # [Ta, B, P] -> [Ta, B, 1]
    for rd in _plain_rounds(props, chunk_tile, grid_w, grid_h):
        x, y, alpha, t_in = rd.x, rd.y, rd.alpha, rd.t_in
        a, b, c = rd.rows[..., 2:3], rd.rows[..., 3:4], rd.rows[..., 4:5]
        rgb, opac = rd.rows[..., 5:8], rd.rows[..., 8:9]
        w = alpha * t_in * rd.live_k
        gc = g_color[rd.tiles]  # [Ta, 3, P]
        d_rgb = torch.einsum("tkp,tcp->tkc", w, gc)
        rgb_dot_gc = rgb[..., 0:1] * gc[:, 0:1] + rgb[..., 1:2] * gc[:, 1:2] + rgb[..., 2:3] * gc[:, 2:3]
        p_u = torch.cumsum(w * rgb_dot_gc, dim=1)
        b_row = (gdot_total[rd.tiles] - pref[rd.tiles]) + gt_final[rd.tiles]  # [Ta, 1, P]
        g_alpha = rgb_dot_gc * t_in + (p_u - b_row) / torch.clamp(1.0 - alpha, min=1e-6)
        keep = (alpha > 0.0) & ~(rd.alpha_raw > 0.99)
        g_power = g_alpha * torch.where(keep, rd.live_k, torch.zeros_like(rd.live_k)) * alpha

        m0, m1, m2 = rs(g_power), rs(g_power * px), rs(g_power * py)
        m3, m4, m5 = rs(g_power * (px * px)), rs(g_power * (py * py)), rs(g_power * (px * py))
        s_dx = x * m0 - m1
        s_dy = y * m0 - m2
        grads = torch.cat([
            -(a * s_dx + b * s_dy),
            -(c * s_dy + b * s_dx),
            -0.5 * (x * x * m0 - 2.0 * x * m1 + m3),
            -(x * y * m0 - x * m2 - y * m1 + m5),
            -0.5 * (y * y * m0 - 2.0 * y * m2 + m4),
            d_rgb,
            m0 / torch.clamp(opac, min=1e-12),
        ], dim=2)  # [Ta, B, 9]
        dprops[rd.idx.flatten(), :GRAD_F] = grads.reshape(-1, GRAD_F)
        pref[rd.tiles] = pref[rd.tiles] + p_u[:, -1:]
    return dprops


class _StreamComposite(torch.autograd.Function):
    """K1 forward and K2 backward on CUDA tensors; the plain versions on CPU
    tensors (which walk each run to its padded end: the sentinel rows past
    its real count change nothing). Saves the rows in the kernels' precision
    (bf16: half the bytes; the backward replays exactly the rows the forward
    read) and the forward's outputs (the backward's C_total and T_final)."""

    @staticmethod
    def forward(ctx, props, chunk_tile, tile_counts, grid_w, grid_h, precision):
        props_k = kernel_props(props, chunk_tile, grid_w, precision)
        if props.is_cuda:
            color, final_t = _launch_stream_fwd(props_k, chunk_tile, tile_counts, grid_w, grid_h, precision)
        else:
            color, final_t = composite_stream_tiles_plain(props_k, chunk_tile, grid_w, grid_h)
        ctx.save_for_backward(props_k, chunk_tile, color, final_t)
        ctx.grid = (grid_w, grid_h)
        ctx.precision = precision
        return color, final_t

    @staticmethod
    def backward(ctx, g_color, g_t):
        props_k, chunk_tile, color, final_t = ctx.saved_tensors
        grid_w, grid_h = ctx.grid
        g_color = torch.zeros_like(color) if g_color is None else g_color
        g_t = torch.zeros_like(final_t) if g_t is None else g_t
        if props_k.is_cuda:
            dprops = _launch_stream_bwd(props_k, chunk_tile, grid_w, grid_h, color, final_t, g_color, g_t,
                                        ctx.precision)
        else:
            dprops = composite_stream_tiles_bwd_plain(
                props_k, chunk_tile, grid_w, grid_h, color, final_t, g_color, g_t
            )
        return dprops, None, None, None, None, None


def _checked_props(props, chunk_tile, precision="fp32"):
    """The stream rows as the kernels read them: contiguous, 16-byte aligned
    [I_pad, 16] of the precision's type (float32, or bf16 for "bf16"), a
    whole number of chunks, on chunk_tile's device."""
    G = chunk_tile.shape[0]
    dtype = _row_dtype(precision)
    if props.dtype != dtype or props.ndim != 2 or props.shape[1] != PROPS_F:
        raise ValueError(f"props must be {dtype} [I_pad, {PROPS_F}] for precision={precision!r}, "
                         f"got {props.dtype} {tuple(props.shape)}")
    if G == 0 or props.shape[0] % G:
        raise ValueError(f"{props.shape[0]} stream rows do not split into {G} chunks")
    if chunk_tile.device != props.device:
        raise ValueError("props and chunk_tile must be on the same device")
    props = props.contiguous()
    if props.data_ptr() % 16:
        raise ValueError("props must be 16-byte aligned")
    return props


def _row_dtype(precision):
    if precision not in ROW_DTYPES:
        raise ValueError(f"precision must be one of {sorted(ROW_DTYPES)}, got {precision!r}")
    return ROW_DTYPES[precision]


def _launch_stream_fwd(props, chunk_tile, tile_counts, grid_w, grid_h, precision="fp32"):
    """K1: (color [T, 3, P], final_T [T, 1, P]), each run walked to its last
    real row; ``precision="bf16"``: ``stream_fwd_bf16`` on the bf16
    tile-local rows of ``kernel_props``."""
    T = grid_w * grid_h
    G = chunk_tile.shape[0]
    props = _checked_props(props, chunk_tile, precision)
    _check_counts(tile_counts, T, props.device)
    row_start, row_end = real_row_ranges(chunk_tile.to(torch.int32).contiguous(), tile_counts, T,
                                         props.shape[0] // G)
    color = torch.empty(T, 3, P, dtype=torch.float32, device=props.device)
    final_t = torch.empty(T, 1, P, dtype=torch.float32, device=props.device)
    (STREAM_FWD_BF16 if precision == "bf16" else STREAM_FWD).launch(
        props.data_ptr(), row_start.data_ptr(), row_end.data_ptr(), grid_w, T,
        color.data_ptr(), final_t.data_ptr(), torch.cuda.current_stream(props.device).cuda_stream,
    )
    return color, final_t


def _check_counts(tile_counts, n_tiles, device):
    if tuple(tile_counts.shape) != (n_tiles,) or tile_counts.device != device or tile_counts.is_floating_point():
        raise ValueError(f"tile_counts must be integer [{n_tiles}] on {device}, got "
                         f"{tile_counts.dtype} {tuple(tile_counts.shape)} on {tile_counts.device}")


def _launch_stream_bwd(props, chunk_tile, grid_w, grid_h, color, final_t, g_color, g_t, precision="fp32"):
    """K2: float32 dprops [I_pad, 16] from K1's rows (``kernel_props``), its
    outputs and their cotangents; ``precision="bf16"``: ``stream_bwd_bf16``."""
    T = grid_w * grid_h
    G = chunk_tile.shape[0]
    props = _checked_props(props, chunk_tile, precision)
    for name, v, rows in (("color", color, 3), ("final_t", final_t, 1), ("g_color", g_color, 3),
                          ("g_t", g_t, 1)):
        if tuple(v.shape) != (T, rows, P) or v.device != props.device:
            raise ValueError(f"{name} must be [{T}, {rows}, {P}] on {props.device}, got {tuple(v.shape)}")
    # Per-tile residual/cotangent table [T+1, 8, P] (zero trash row T):
    # C_total 0:3, T_final 3:4, g_color 4:7, g_t 7:8 (stream.py:833-836).
    pad1 = lambda v: torch.cat([v.float(), v.new_zeros(1, *v.shape[1:])], dim=0)
    tiledata = torch.cat([pad1(color), pad1(final_t), pad1(g_color), pad1(g_t)], dim=1).contiguous()
    start, end = tile_chunk_ranges(chunk_tile.to(torch.int32).contiguous(), T + 1)
    dprops = torch.empty(props.shape, dtype=torch.float32, device=props.device)
    (STREAM_BWD_BF16 if precision == "bf16" else STREAM_BWD).launch(
        props.data_ptr(), tiledata.data_ptr(), start.data_ptr(), end.data_ptr(),
        props.shape[0] // G, grid_w, T, dprops.data_ptr(),
        torch.cuda.current_stream(props.device).cuda_stream,
    )
    return dprops


def composite_stream_tiles(props, chunk_tile, tile_counts, grid_w, grid_h,
                           precision: str = "fp32") -> Tuple[torch.Tensor, torch.Tensor]:
    """(color [T, 3, P], final_T [T, 1, P]) pre-background, differentiable in
    the float32 ``props``; ``tile_counts`` [T] are the real rows of each
    tile's run (``StreamBinned.tile_counts``), where K1 ends the run. CUDA
    tensors go through kernels K1 and K2 (``precision="bf16"``: their bf16
    entry points, on ``kernel_props``); CPU tensors through the plain
    versions."""
    if not (props.is_cuda or props.device.type == "cpu"):
        raise ValueError(f"no stream compositor for device {props.device}")
    if props.dtype != torch.float32:
        raise ValueError(f"props must be float32 (precision={precision!r} rounds them itself), got {props.dtype}")
    _row_dtype(precision)
    _check_counts(tile_counts, grid_w * grid_h, props.device)
    return _StreamComposite.apply(props, chunk_tile, tile_counts, grid_w, grid_h, precision)


def stream_image(binned, means2d, conics, rgbs, opac, bg, *, grid_w: int, grid_h: int,
                 precision: str = "fp32"):
    """Padded image [3, H_pad, W_pad] + transmittance map [H_pad, W_pad] from
    the instance stream. The property arrays are in the original per-Gaussian
    order that ``binned.stream_gauss`` indexes; ``precision`` is the
    compositor's row type ("fp32" or "bf16")."""
    with span("render.gather"):
        stream_gauss, chunk_tile = used_stream(binned)
        count("render.rows_used", stream_gauss.shape[0])
        props = stream_gather(pack_props(means2d, conics, rgbs, opac), binned, stream_gauss)
    with span("render.composite"):
        color, final_t = composite_stream_tiles(props, chunk_tile, binned.tile_counts, grid_w, grid_h, precision)
        return tiles_to_image(color, final_t, binned.covered, bg, grid_w=grid_w, grid_h=grid_h)


def tiles_to_image(color, final_t, covered, bg, *, grid_w: int, grid_h: int):
    """The compositor's per-tile outputs -> (padded image [3, H_pad, W_pad],
    transmittance map [H_pad, W_pad]) over the background. ``covered=None``:
    every tile's outputs are read (the table compositor writes them all)."""
    final_t = final_t[:, 0, :]
    if covered is not None:
        # Tiles no chunk reached (empty, or beyond the budget) are background.
        covered = covered[:, None]
        final_t = torch.where(covered, final_t, torch.ones_like(final_t))
        color = torch.where(covered[:, :, None], color, torch.zeros_like(color))
    color = color + final_t[:, None, :] * bg[None, :, None]

    img = color.reshape(grid_h, grid_w, 3, TILE, TILE)
    img = img.permute(2, 0, 3, 1, 4).reshape(3, grid_h * TILE, grid_w * TILE)
    t_map = final_t.reshape(grid_h, grid_w, TILE, TILE)
    t_map = t_map.permute(0, 2, 1, 3).reshape(grid_h * TILE, grid_w * TILE)
    return img, t_map
