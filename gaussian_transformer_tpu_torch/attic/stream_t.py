"""Transposed-layout stream compositor (port of ``attic/stream_t.py``).

The same function as ``render/stream.py`` (K1 forward, K2 backward) on the
stream stored as planes, ``props_t [16, I_pad]`` (struct of arrays), where
the row layout is ``[I_pad, 16]``. Means and pixel centers are ABSOLUTE
screen coordinates, as the reference's ``_pixel_coords_cols`` and
``_alpha_math_t`` evaluate them (K1 and K2 use tile-local ones).

Kernel K7: ``csrc/stream_t_fwd.cu`` replaces the TPU kernel
``attic/stream_t.py:134 _fwd_kernel_t``. It is the third entry point of
``csrc/stream_common.cuh forward_walk`` (K1's and K5's walk: 8x4-pixel
warps, an exp-free skip test before ``expf``, a block-wide exit), with a
stager that reads only the 9 planes the walk needs, each coalesced, and it
walks only each run's real rows (``stream.real_row_ranges`` from the tile
counts). Its frame is K5's, so on the same rows its outputs equal K5's bit
for bit. Bound by operations (~14 fp32 operations per walked (row, pixel)
pair, ~6 more where the row contributes).

Kernel K8: ``csrc/stream_t_bwd.cu`` replaces the TPU kernel
``attic/stream_t.py:222 _bwd_kernel_t``: K6's replay and per-batch
shared-memory reduction (per-pixel terms, ``csrc/stream_common.cuh
pixel_grad_terms``, summed in K6's order, so its planes equal K6's rows bit
for bit on the same rows) on the planes, with K7's 8x4-pixel warps and the
exp-free floor before the replay step. It walks only the real rows, writes
each batch's 16 planes as contiguous runs, and zeroes planes 9-15, the rows
past a tile's exit or real end, and the trash chunks. Bound by operations.

``composite_stream_tiles_t`` launches K7 (and K8 in its backward) for CUDA
tensors and uses the plain versions, ``composite_stream_tiles_t_plain`` and
``composite_stream_tiles_t_bwd_plain``, only for CPU tensors; the plain
versions walk each run to its padded end (the sentinel rows past a tile's
count change no output). ``stream_image_t`` is the drop-in for
``stream.stream_image``: the gather, one transposed copy (whose transpose
back is part of autograd), the compositor, and ``stream.tiles_to_image``;
the gradient reaches the Gaussians through ``stream.instance_pullback``.

The reference ran its grid over ``block_rows`` rows at a time and carried T
between grid steps; here, as for K1, each tile is one block over its own
row range, so no ``block_rows`` knob is needed.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gaussian_transformer_tpu_torch.kernels import CudaKernel
from gaussian_transformer_tpu_torch.render.stream import (
    GRAD_F,
    P,
    PROPS_F,
    _check_counts,
    _plain_rounds,
    composite_stream_tiles_plain,
    pack_props,
    real_row_ranges,
    stream_gather,
    tiles_to_image,
    used_stream,
)
from gaussian_transformer_tpu_torch.render.table_composite import _round_grads

STREAM_T_FWD = CudaKernel(
    "stream_t_fwd.cu",
    "stream_t_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
)
STREAM_T_BWD = CudaKernel(
    "stream_t_bwd.cu",
    "stream_t_bwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p],
)


def composite_stream_tiles_t_plain(props_t, chunk_tile, grid_w, grid_h, count_work=False):
    """Plain PyTorch version of K7: (color [T, 3, P], final_T [T, 1, P]) from
    ``props_t [16, I_pad]``; K1's plain walk in absolute coordinates.
    ``count_work`` as ``stream.composite_stream_tiles_plain``."""
    return composite_stream_tiles_plain(props_t.t(), chunk_tile, grid_w, grid_h, count_work, absolute=True)


def composite_stream_tiles_t_bwd_plain(props_t, chunk_tile, grid_w, grid_h, color, final_t, g_color, g_t):
    """Plain PyTorch version of K8: dprops_t [16, I_pad] (planes 0-8) from the
    forward's outputs (color = C_total [T, 3, P], final_T [T, 1, P]) and their
    cotangents, with the reference kernel's per-pixel terms
    (attic/stream_t.py:280-337, ``table_composite._round_grads``) summed over
    each tile's pixels; rows no pixel reaches stay zero."""
    props = props_t.t()
    dprops = torch.zeros(props.shape, dtype=props.dtype, device=props.device)
    color_pref = torch.zeros_like(color)
    for rd in _plain_rounds(props, chunk_tile, grid_w, grid_h, absolute=True):
        grads, totals = _round_grads(rd, color, color_pref, g_color, g_t, final_t)
        dprops[rd.idx.flatten(), :GRAD_F] = grads.reshape(-1, GRAD_F)
        color_pref[rd.tiles] = color_pref[rd.tiles] + totals
    return dprops.t()


class _StreamCompositeT(torch.autograd.Function):
    """K7 forward and K8 backward on CUDA tensors; the plain versions on CPU
    tensors. Saves the planes, the tile counts and the forward's outputs
    (the backward's C_total and T_final)."""

    @staticmethod
    def forward(ctx, props_t, chunk_tile, tile_counts, grid_w, grid_h):
        if props_t.is_cuda:
            color, final_t = _launch_stream_t_fwd(props_t, chunk_tile, tile_counts, grid_w, grid_h)
        else:
            color, final_t = composite_stream_tiles_t_plain(props_t, chunk_tile, grid_w, grid_h)
        ctx.save_for_backward(props_t, chunk_tile, tile_counts, color, final_t)
        ctx.grid = (grid_w, grid_h)
        return color, final_t

    @staticmethod
    def backward(ctx, g_color, g_t):
        props_t, chunk_tile, tile_counts, color, final_t = ctx.saved_tensors
        grid_w, grid_h = ctx.grid
        g_color = torch.zeros_like(color) if g_color is None else g_color
        g_t = torch.zeros_like(final_t) if g_t is None else g_t
        if props_t.is_cuda:
            dprops_t = _launch_stream_t_bwd(props_t, chunk_tile, tile_counts, grid_w, grid_h, color, final_t,
                                            g_color, g_t)
        else:
            dprops_t = composite_stream_tiles_t_bwd_plain(
                props_t, chunk_tile, grid_w, grid_h, color, final_t, g_color, g_t
            )
        return dprops_t, None, None, None, None


def _checked_planes(props_t, chunk_tile):
    """The planes as the kernels read them: contiguous float32 [16, I_pad],
    a whole number of chunks, on chunk_tile's device."""
    G = chunk_tile.shape[0]
    if props_t.dtype != torch.float32 or props_t.ndim != 2 or props_t.shape[0] != PROPS_F:
        raise ValueError(f"props_t must be float32 [{PROPS_F}, I_pad], got {props_t.dtype} {tuple(props_t.shape)}")
    if G == 0 or props_t.shape[1] % G:
        raise ValueError(f"{props_t.shape[1]} stream rows do not split into {G} chunks")
    if chunk_tile.device != props_t.device:
        raise ValueError("props_t and chunk_tile must be on the same device")
    return props_t.contiguous()


def _launch_stream_t_fwd(props_t, chunk_tile, tile_counts, grid_w, grid_h):
    """K7: (color [T, 3, P], final_T [T, 1, P]), each run walked to its last
    real row."""
    T = grid_w * grid_h
    G = chunk_tile.shape[0]
    props_t = _checked_planes(props_t, chunk_tile)
    _check_counts(tile_counts, T, props_t.device)
    row_start, row_end = real_row_ranges(chunk_tile.to(torch.int32).contiguous(), tile_counts, T,
                                         props_t.shape[1] // G)
    color = torch.empty(T, 3, P, dtype=torch.float32, device=props_t.device)
    final_t = torch.empty(T, 1, P, dtype=torch.float32, device=props_t.device)
    STREAM_T_FWD.launch(
        props_t.data_ptr(), row_start.data_ptr(), row_end.data_ptr(), props_t.shape[1], grid_w, T,
        color.data_ptr(), final_t.data_ptr(), torch.cuda.current_stream(props_t.device).cuda_stream,
    )
    return color, final_t


def _launch_stream_t_bwd(props_t, chunk_tile, tile_counts, grid_w, grid_h, color, final_t, g_color, g_t):
    """K8: dprops_t [16, I_pad] from K7's outputs and their cotangents; each
    run replayed to its last real row."""
    T = grid_w * grid_h
    G = chunk_tile.shape[0]
    props_t = _checked_planes(props_t, chunk_tile)
    _check_counts(tile_counts, T, props_t.device)
    tile_data = []
    for name, v, rows in (("color", color, 3), ("final_t", final_t, 1), ("g_color", g_color, 3),
                          ("g_t", g_t, 1)):
        if tuple(v.shape) != (T, rows, P) or v.device != props_t.device:
            raise ValueError(f"{name} must be [{T}, {rows}, {P}] on {props_t.device}, got {tuple(v.shape)}")
        tile_data.append(v.float().contiguous())
    # T + 1 runs: the trash run last, with no real rows (block T zeroes it).
    counts = torch.nn.functional.pad(tile_counts.to(torch.int32), (0, 1))
    row_start, row_end = real_row_ranges(chunk_tile.to(torch.int32).contiguous(), counts, T + 1,
                                         props_t.shape[1] // G)
    dprops_t = torch.empty_like(props_t)
    STREAM_T_BWD.launch(
        props_t.data_ptr(), row_start.data_ptr(), row_end.data_ptr(), *(v.data_ptr() for v in tile_data),
        props_t.shape[1], grid_w, T, dprops_t.data_ptr(), torch.cuda.current_stream(props_t.device).cuda_stream,
    )
    return dprops_t


def composite_stream_tiles_t(props_t, chunk_tile, tile_counts, grid_w, grid_h) -> Tuple[torch.Tensor, torch.Tensor]:
    """(color [T, 3, P], final_T [T, 1, P]) pre-background from the planes
    ``props_t [16, I_pad]``, differentiable in ``props_t``; ``tile_counts``
    [T] are the real rows of each tile's run (``StreamBinned.tile_counts``),
    where K7 and K8 end the run. CUDA tensors go through kernels K7 and K8;
    CPU tensors through the plain versions."""
    if not (props_t.is_cuda or props_t.device.type == "cpu"):
        raise ValueError(f"no stream compositor for device {props_t.device}")
    _check_counts(tile_counts, grid_w * grid_h, props_t.device)
    return _StreamCompositeT.apply(props_t, chunk_tile, tile_counts, grid_w, grid_h)


def stream_image_t(binned, means2d, conics, rgbs, opac, bg, *, grid_w: int, grid_h: int):
    """Drop-in for ``stream.stream_image`` through the transposed kernels:
    padded image [3, H_pad, W_pad] + transmittance map [H_pad, W_pad]."""
    stream_gauss, chunk_tile = used_stream(binned)
    props = stream_gather(pack_props(means2d, conics, rgbs, opac), binned, stream_gauss)
    props_t = props.t().contiguous()  # the one transposed copy
    color, final_t = composite_stream_tiles_t(props_t, chunk_tile, binned.tile_counts, grid_w, grid_h)
    return tiles_to_image(color, final_t, binned.covered, bg, grid_w=grid_w, grid_h=grid_h)
