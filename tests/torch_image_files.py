"""Image files for the port's PNG and JPEG tests, written by libpng and
libjpeg through ``tests/torch_image_writer.c`` (built here with ``cc``,
once per process, into a temporary directory), and the references they are
held to: the JAX tier's libpng/libjpeg decode and Pillow's."""

from __future__ import annotations

import atexit
import hashlib
import os
import subprocess
import tempfile
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "torch_image_writer.c"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
ALL_FILTERS = 0xF8  # PNG_ALL_FILTERS
FILTER_MASKS = {"none": 0x08, "sub": 0x10, "up": 0x20, "avg": 0x40, "paeth": 0x80, "all": ALL_FILTERS}
STRATEGIES = {"default": zlib.Z_DEFAULT_STRATEGY, "filtered": zlib.Z_FILTERED,
              "huffman_only": zlib.Z_HUFFMAN_ONLY, "rle": zlib.Z_RLE, "fixed": zlib.Z_FIXED}

_writer: Optional[Path] = None


def writer() -> Path:
    """The writer binary, built at the first call."""
    global _writer
    if _writer is None:
        src = SOURCE.read_bytes()
        out = Path(tempfile.gettempdir()) / f"torch_image_writer-{hashlib.sha256(src).hexdigest()[:12]}-{os.getpid()}"
        if not out.exists():
            subprocess.run(["cc", "-O2", str(SOURCE), "-o", str(out), "-lpng", "-ljpeg"], check=True)
            atexit.register(out.unlink, missing_ok=True)
        _writer = out
    return _writer


def pack_rows(samples: np.ndarray, depth: int) -> bytes:
    """[H, W, C] sample values -> PNG rows (packed below 8 bits, big-endian 16)."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").tobytes()
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    per = 8 // depth
    flat = samples.reshape(h, w * c).astype(np.uint8)
    pad = (-flat.shape[1]) % per
    flat = np.concatenate([flat, np.zeros((h, pad), np.uint8)], 1).reshape(h, -1, per)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return (flat << shifts).sum(-1).astype(np.uint8).tobytes()


def write_png(path, samples: np.ndarray, color_type: int, depth: int, interlace: bool = False,
              filters: int = ALL_FILTERS, level: int = 6, strategy: int = zlib.Z_DEFAULT_STRATEGY,
              plte: Optional[bytes] = None, trns: Optional[bytes] = None) -> str:
    """Write ``samples`` [H, W, C] (values below 2 ** depth) with libpng."""
    h, w, _ = samples.shape
    cmd = [str(writer()), "png", str(path), str(w), str(h), str(color_type), str(depth), str(int(interlace)),
           str(filters), str(level), str(strategy), plte.hex() if plte else "-", trns.hex() if trns else "-"]
    subprocess.run(cmd, input=pack_rows(samples, depth), check=True)
    return str(path)


def write_jpeg(path, pixels: np.ndarray, quality: int = 90, sampling: Sequence[str] = ("2x2", "1x1", "1x1"),
               progressive: bool = False, arith: bool = False, optimize: bool = False, restart_rows: int = 0,
               restart_blocks: int = 0, scans: Optional[Sequence] = None) -> str:
    """Write uint8 ``pixels`` [H, W] (gray) or [H, W, 3] with libjpeg;
    ``scans``: a progressive scan script, [(components, Ss, Se, Ah, Al)]."""
    px = pixels if pixels.ndim == 3 else pixels[..., None]
    h, w, c = px.shape
    cmd = [str(writer()), "jpeg", str(path), str(w), str(h), str(c), str(quality), ",".join(sampling),
           str(int(progressive)), str(int(arith)), str(int(optimize)), str(restart_rows), str(restart_blocks)]
    if scans:
        cmd.append(";".join(",".join(map(str, comps)) + "/" + "/".join(map(str, rest)) for comps, *rest in scans))
    subprocess.run(cmd, input=np.ascontiguousarray(px, np.uint8).tobytes(), check=True)
    return str(path)


def strip_dht(path_in, path_out) -> str:
    """The JPEG with its DHT segments cut out (a Motion-JPEG-style file)."""
    data = Path(path_in).read_bytes()
    out, p = bytearray(data[:2]), 2
    while p < len(data):
        if data[p] != 0xFF or data[p + 1] == 0xDA:
            out += data[p:]
            break
        length = int.from_bytes(data[p + 2:p + 4], "big")
        if data[p + 1] != 0xC4:
            out += data[p:p + 2 + length]
        p += 2 + length
    Path(path_out).write_bytes(bytes(out))
    return str(path_out)


def samples(h: int, w: int, color_type: int, depth: int, seed: int, palette_size: int = 0) -> np.ndarray:
    """Seeded samples of every value range: a gradient under noise, with
    flat runs (so every filter and every match length shows up)."""
    rng = np.random.RandomState(seed)
    c = CHANNELS[color_type]
    top = (palette_size or 256) - 1 if color_type == 3 else (1 << depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 7 + yy * 3)[..., None] * (np.arange(c) + 1) * max(top // 97, 1)) % (top + 1)
    noise = rng.randint(0, top + 1, (h, w, c))
    flat = (rng.rand(h, 1, 1) < 0.3) | ((xx // 5) % 3 == 0)[..., None]
    return np.where(flat, base, noise).astype(np.int64)
