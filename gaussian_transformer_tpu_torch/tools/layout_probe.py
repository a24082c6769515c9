"""Layout probe: how fast the card reads a 1M-Gaussian-scale stream in each
of four layouts (port of ``tools/layout_probe.py``).

    python -m gaussian_transformer_tpu_torch.tools.layout_probe [--rows N] [--device cpu]

The TPU probe compiled, for each layout, a kernel that sums one block of
the stream per grid step into one f32 cell, and read the compiler's staging
allocation. Here the same function runs on the card and is timed. Layouts,
N = 3,232,768 rows by default:

    [N, 16] f32      blocks (2048, 16)   the row stream (K1, K2)
    [N, 16] bf16     blocks (2048, 16)
    [N/8, 128] bf16  blocks (256, 128)
    [16, N] f32      blocks (16, 2048)   the planes (K7, K8)

Kernel K9: ``csrc/layout_probe.cu`` replaces the TPU kernel
``tools/layout_probe.py:47 kernel`` (inside ``probe :46``, launched by
``pl.pallas_call :51``). ``block_sums`` returns every block's sum [n_blocks]
f32; the TPU kernel overwrote its one cell at each grid step, so what it
left is the last entry. One CTA per block, 16-byte vector loads (bf16 read
two at a time and widened exactly to f32), four f32 accumulators a thread,
then a fixed-order reduction: deterministic. It is bound by bytes (one f32
add per 4 or 2 bytes read), and its design answer is to read every byte
once, coalesced, with no staging copy: the card's counterpart of the TPU
probe's "temp MB" is the extra device memory allocated during a pass, which
``main`` reports.

A quirk of the reference, written down and not copied: its grid is
``shape[0] // blk[0]``. For the three row-blocked layouts that is 1,578 of
1,578.5 blocks, so the last 1,024 rows (128 of [N/8, 128]) are never read;
for [16, N] it is ``16 // 16 = 1`` program with index map ``(g, 0)``, so it
reads only the first 2,048 columns. The port reads the same whole row
blocks, and all N // 2048 column blocks of [16, N], since reading the stream
in that layout is what the probe is for.

``main`` prints one JSON line per layout: on the card the warm and L2-cold
times, GB/s and its share of 3.35 TB/s, the time of one PyTorch call
computing the same sums, and the extra bytes each allocates; on the CPU
(``--device cpu``, the plain version) only the sizes and the last block's
sum.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from typing import List, Optional

import torch

from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.kernels import CudaKernel

ROWS = 3_232_768  # the ~1M-Gaussian padded stream of the reference's probe
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, the data sheet's rate
REPS = 20  # timed launches per layout
LAYOUTS = (  # (name, shape of N rows, dtype, block)
    ("[N,16] f32", lambda n: (n, 16), torch.float32, (2048, 16)),
    ("[N,16] bf16", lambda n: (n, 16), torch.bfloat16, (2048, 16)),
    ("[N/8,128] bf16", lambda n: (n // 8, 128), torch.bfloat16, (256, 128)),
    ("[16,N] f32", lambda n: (16, n), torch.float32, (16, 2048)),
)

LAYOUT_PROBE = CudaKernel(
    "layout_probe.cu",
    "block_sums",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
)


def _geometry(x, block):
    """(n_blocks, segments per block, segment length, segment stride, block
    stride), in elements, of a float32 or bfloat16 array. Row blocks
    (block[1] == x.shape[1]) are one contiguous segment; column blocks
    (block[0] == x.shape[0]) are one segment per row, ``x.shape[1]`` apart.
    A partial last block is not read."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 2 or len(block) != 2 or min(block) < 1:
        raise ValueError(f"need a 2-D array and a 2-D block, got {tuple(x.shape)} and {tuple(block)}")
    rows, cols = x.shape
    br, bc = block
    if bc == cols:
        return rows // br, 1, br * bc, 0, br * bc
    if br == rows:
        return cols // bc, rows, bc, cols, bc
    raise ValueError(f"block {tuple(block)} spans neither the rows nor the columns of {tuple(x.shape)}")


def block_sums_plain(x, block) -> torch.Tensor:
    """Plain PyTorch version of K9: each whole block's sum, taken in float64
    and rounded to float32 [n_blocks]."""
    nb, n_seg, seg, _, _ = _geometry(x, block)
    if n_seg == 1:
        blocks = x[: nb * block[0]].reshape(nb, seg)
    else:
        blocks = x[:, : nb * seg].reshape(n_seg, nb, seg).transpose(0, 1)
    return blocks.to(torch.float64).sum(dim=tuple(range(1, blocks.ndim))).to(torch.float32)


def library_sums(x, block) -> torch.Tensor:
    """One PyTorch call computing the same sums (the card's yardstick; the
    port never calls it): ``x.view(nb, -1).sum(1)``, and for column blocks
    ``x.view(16, nb, 2048).sum((0, 2))``, accumulated and returned in f32."""
    nb, n_seg, seg, _, _ = _geometry(x, block)
    if n_seg == 1:
        return x[: nb * block[0]].view(nb, -1).sum(1, dtype=torch.float32)
    return x[:, : nb * seg].view(n_seg, nb, seg).sum((0, 2), dtype=torch.float32)


def block_sums(x, block) -> torch.Tensor:
    """[n_blocks] f32 block sums of ``x`` (K9 on CUDA tensors, the plain
    version on CPU tensors); the last entry is what the TPU kernel left in
    its cell."""
    if x.device.type == "cpu":
        return block_sums_plain(x, block)
    if not x.is_cuda:
        raise ValueError(f"no block sums for device {x.device}")
    nb, n_seg, seg, seg_stride, block_stride = _geometry(x, block)
    x = x.contiguous()
    vec = 16 // x.element_size()  # elements per 16-byte load
    if seg % vec or seg_stride % vec or block_stride % vec or x.data_ptr() % 16:
        raise ValueError(f"segments of {tuple(x.shape)} in blocks {tuple(block)} are not 16-byte aligned")
    out = torch.empty(nb, dtype=torch.float32, device=x.device)
    if nb:
        LAYOUT_PROBE.launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), nb, n_seg, seg // vec, seg_stride // vec,
            block_stride // vec, out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    return out


def make_layout(name: str, rows: int, device, seed: int = 0) -> torch.Tensor:
    """A seeded uniform [0, 1) stream of ``rows`` rows in layout ``name``."""
    _, shape, dtype, _ = next(layout for layout in LAYOUTS if layout[0] == name)
    gen = torch.Generator(device).manual_seed(seed)
    return torch.rand(shape(rows), generator=gen, device=device).to(dtype)


def _timed_ms(fn, device, before=None) -> float:
    """Mean ms of ``REPS`` calls of ``fn`` on ``device``'s current stream,
    after one untimed call: one event pair around them all, or, with
    ``before``, one pair around each call with ``before()`` run first and
    left out of the time."""
    stream = torch.cuda.current_stream(device)
    event = lambda: torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize(device)
    if before is None:
        start, end = event(), event()
        start.record(stream)
        for _ in range(REPS):
            fn()
        end.record(stream)
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / REPS
    total = 0.0
    for _ in range(REPS):
        before()
        start, end = event(), event()
        start.record(stream)
        fn()
        end.record(stream)
        torch.cuda.synchronize(device)
        total += start.elapsed_time(end)
    return total / REPS


def _cold_ms(fn, device) -> float:
    """Mean ms of single launches, each after writing 256 MB on ``device``
    so that its 50 MB L2 holds none of the input."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device)
    return _timed_ms(fn, device, before=flush.zero_)


def _extra_bytes(fn, device) -> int:
    """Memory of ``device`` allocated during one call beyond what was held
    before."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - held


def probe(name: str, rows: int, device) -> dict:
    """One layout's record (times only on the card)."""
    _, _, _, block = next(layout for layout in LAYOUTS if layout[0] == name)
    x = make_layout(name, rows, device)
    nb, n_seg, seg, _, _ = _geometry(x, block)
    nbytes = nb * n_seg * seg * x.element_size() + nb * 4
    sums = block_sums(x, block)
    rec = {"layout": name, "shape": list(x.shape), "dtype": str(x.dtype).removeprefix("torch."),
           "block": list(block), "blocks": nb, "bytes": nbytes, "last_block_sum": float(sums[-1]) if nb else None,
           "device": str(device)}
    if x.is_cuda:
        ms = _timed_ms(lambda: block_sums(x, block), x.device)
        rec.update(
            ms=ms, ms_l2_cold=_cold_ms(lambda: block_sums(x, block), x.device),
            gb_per_s=nbytes / ms / 1e6, share_of_peak=nbytes / ms * 1e3 / PEAK_BYTES_PER_S,
            bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
            library_ms=_timed_ms(lambda: library_sums(x, block), x.device),
            extra_bytes=_extra_bytes(lambda: block_sums(x, block), x.device),
            library_extra_bytes=_extra_bytes(lambda: library_sums(x, block), x.device),
        )
    return rec


def main(argv: Optional[List[str]] = None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=ROWS, help="stream rows N (a multiple of 8)")
    parser.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs the plain version")
    args = parser.parse_args(argv)
    if args.rows <= 0 or args.rows % 8:
        parser.error("--rows must be a positive multiple of 8")
    device = resolve_device(args.device)
    records = []
    for name, *_ in LAYOUTS:
        rec = probe(name, args.rows, device)
        print(json.dumps(rec))
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
