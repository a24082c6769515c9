"""Stream compositor forward: front-to-back compositing of the padded-CSR
instance stream (port of ``gaussian_transformer_tpu/render/stream.py``).

Kernel K1: ``csrc/stream_fwd.cu`` replaces the TPU kernel
``render/stream.py:266 _fwd_kernel``. It is bound by operations (~20 fp32
operations and one ``expf`` per evaluated (row, pixel) pair, the row's 36
useful bytes shared by a tile's 256 pixels); its design answer is one CTA
per tile with rows staged in shared memory and a block-wide early exit once
every pixel has terminated (see the source's header).

``composite_stream_tiles`` launches the kernel for CUDA tensors and uses the
plain PyTorch version, ``composite_stream_tiles_plain``, only for CPU
tensors. The backward (the reference's ``_bwd_kernel``) comes with the
training slice: the autograd node raises if a gradient reaches it.

Property row layout (PROPS_F = 16):
  0: x  1: y  2: conic_a  3: conic_b  4: conic_c  5: r  6: g  7: b  8: opacity
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gaussian_transformer_tpu_torch.kernels import CudaKernel
from gaussian_transformer_tpu_torch.render.tiles import TILE

P = TILE * TILE
PROPS_F = 16
# Rows per round of the plain version (divides every chunk size, >= 32).
PLAIN_ROWS = 32

STREAM_FWD = CudaKernel(
    "stream_fwd.cu",
    "stream_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
)


def pack_props(means2d, conics, rgbs, opac):
    """Per-Gaussian screen properties in the kernel layout [C+1, 16]; the
    sentinel row C is all zeros, so padding rows are no-ops."""
    C = means2d.shape[0]
    cols = torch.cat(
        [means2d, conics, rgbs, opac[:, None], means2d.new_zeros(C, PROPS_F - 9)], dim=1
    )
    return torch.cat([cols, cols.new_zeros(1, PROPS_F)], dim=0)


def stream_gather(props_full, stream_gauss):
    """props_full[stream_gauss] -> the stream's property rows [rows, 16]."""
    return props_full[stream_gauss.long()]


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


def _termination(alpha, t_in, lv):
    """Scan-free termination (the reference's v5 form): a pixel stops BEFORE
    the contribution that would take T below 1e-4. t_in is monotone, so the
    first trigger and everything after it is ``t_in <= tstar``."""
    trigger = (alpha > 0.0) & (t_in * (1.0 - alpha) < 1e-4)
    tstar = torch.where(trigger, t_in, torch.zeros_like(t_in)).amax(dim=1, keepdim=True)
    live_k = torch.where(t_in <= tstar, torch.zeros_like(t_in), lv)
    return live_k, tstar, trigger


def composite_stream_tiles_plain(props, chunk_tile, grid_w, grid_h, count_work=False):
    """Plain PyTorch version of K1: (color [T, 3, P], final_T [T, 1, P]).

    Rounds over row blocks: round r composites rows [r*B, (r+1)*B) of every
    tile's run at once as [T_active, B, P] tensors, carrying T and a live
    flag per tile-pixel. ``count_work=True`` also returns the number of
    (row, pixel) pairs a sequential walk evaluates (real rows up to and
    including each pixel's terminating row), for roofline accounting."""
    I_pad = props.shape[0]
    G = chunk_tile.shape[0]
    chunk = I_pad // G
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

    color = torch.zeros(T, 3, P, dtype=torch.float32, device=dev)
    t_run = torch.ones(T, 1, P, dtype=torch.float32, device=dev)
    live = torch.ones(T, 1, P, dtype=torch.float32, device=dev)
    work = torch.zeros((), dtype=torch.int64, device=dev)
    k_iota = torch.arange(B, device=dev)
    r = 0
    while True:
        tiles = torch.nonzero(n_rows > r * B).flatten()
        if tiles.numel() == 0:
            break
        rows = props[row0[tiles, None] + r * B + k_iota]  # [Ta, B, 16]
        x = rows[..., 0:1] - ox[tiles, None, None]
        y = rows[..., 1:2] - oy[tiles, None, None]
        a, b, c = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5]
        opac = rows[..., 8:9]
        dx = x - px
        dy = y - py
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy  # [Ta, B, P]
        alpha = torch.clamp(opac * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
        skip = (power > 0.0) | (alpha < 1.0 / 255.0)
        alpha = torch.where(skip, torch.zeros_like(alpha), alpha)

        t0 = t_run[tiles]
        lv = live[tiles]
        t_in = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]], 1), 1) * t0
        live_k, tstar, trigger = _termination(alpha, t_in, lv)
        w = alpha * t_in * live_k
        color[tiles] += torch.einsum("tkc,tkp->tcp", rows[..., 5:8], w)

        t_full = t_in[:, -1:] * (1.0 - alpha[:, -1:])
        t_new = torch.where(tstar > 0.0, tstar, t_full)
        t_run[tiles] = torch.where(lv > 0.0, t_new, t0)
        live[tiles] = lv * (tstar <= 0.0).to(torch.float32)
        if count_work:
            real = opac > 0.0
            work += ((live_k > 0.0) & real).sum() + (trigger & (t_in == tstar) & (lv > 0.0)).sum()
        r += 1
    if count_work:
        return color, t_run, int(work)
    return color, t_run


class _StreamFwd(torch.autograd.Function):
    """K1 launch; backward arrives with the training slice."""

    @staticmethod
    def forward(ctx, props, chunk_tile, grid_w, grid_h):
        return _launch_stream_fwd(props, chunk_tile, grid_w, grid_h)

    @staticmethod
    def backward(ctx, g_color, g_t):
        raise NotImplementedError(
            "the stream compositor backward (TPU kernel render/stream.py:411) "
            "is ported with the training slice"
        )


def _launch_stream_fwd(props, chunk_tile, grid_w, grid_h):
    T = grid_w * grid_h
    G = chunk_tile.shape[0]
    if props.dtype != torch.float32 or props.ndim != 2 or props.shape[1] != PROPS_F:
        raise ValueError(f"props must be float32 [I_pad, {PROPS_F}], got {props.dtype} {tuple(props.shape)}")
    if G == 0 or props.shape[0] % G:
        raise ValueError(f"{props.shape[0]} stream rows do not split into {G} chunks")
    if chunk_tile.device != props.device:
        raise ValueError("props and chunk_tile must be on the same device")
    props = props.contiguous()
    if props.data_ptr() % 16:
        raise ValueError("props must be 16-byte aligned")
    start, end = tile_chunk_ranges(chunk_tile.to(torch.int32).contiguous(), T)
    color = torch.empty(T, 3, P, dtype=torch.float32, device=props.device)
    final_t = torch.empty(T, 1, P, dtype=torch.float32, device=props.device)
    stream = torch.cuda.current_stream(props.device).cuda_stream
    STREAM_FWD.launch(
        props.data_ptr(), start.data_ptr(), end.data_ptr(), props.shape[0] // G, grid_w, T,
        color.data_ptr(), final_t.data_ptr(), stream,
    )
    return color, final_t


def composite_stream_tiles(props, chunk_tile, grid_w, grid_h) -> Tuple[torch.Tensor, torch.Tensor]:
    """(color [T, 3, P], final_T [T, 1, P]) pre-background. CUDA tensors go
    through kernel K1; CPU tensors through the plain version."""
    if props.is_cuda:
        return _StreamFwd.apply(props, chunk_tile, grid_w, grid_h)
    if props.device.type != "cpu":
        raise ValueError(f"no stream compositor for device {props.device}")
    return composite_stream_tiles_plain(props, chunk_tile, grid_w, grid_h)


def stream_image(binned, means2d, conics, rgbs, opac, bg, *, grid_w: int, grid_h: int):
    """Padded image [3, H_pad, W_pad] + transmittance map [H_pad, W_pad] from
    the instance stream. The property arrays are in the original per-Gaussian
    order that ``binned.stream_gauss`` indexes."""
    stream_gauss, chunk_tile = used_stream(binned)
    props = stream_gather(pack_props(means2d, conics, rgbs, opac), stream_gauss)
    color, final_t = composite_stream_tiles(props, chunk_tile, grid_w, grid_h)
    # Tiles no chunk reached (empty, or beyond the budget) are background.
    covered = binned.covered[:, None]
    final_t = torch.where(covered, final_t[:, 0, :], torch.ones_like(final_t[:, 0, :]))
    color = torch.where(covered[:, :, None], color, torch.zeros_like(color))
    color = color + final_t[:, None, :] * bg[None, :, None]

    img = color.reshape(grid_h, grid_w, 3, TILE, TILE)
    img = img.permute(2, 0, 3, 1, 4).reshape(3, grid_h * TILE, grid_w * TILE)
    t_map = final_t.reshape(grid_h, grid_w, TILE, TILE)
    t_map = t_map.permute(0, 2, 1, 3).reshape(grid_h * TILE, grid_w * TILE)
    return img, t_map
