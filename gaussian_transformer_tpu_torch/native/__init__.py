"""ctypes bindings for the port's native IO tier (``native/gt_native.cpp``).

COLMAP binary parsers, float32 PLY vertex tables and a thread-pool
JPEG/PNG decoder with a bilinear resize: the same C ABI and the same
Python functions as the JAX package's native tier, in the port's own copy,
plus an RGBA output (``load_images(..., rgba=True)``), the samples a file
holds in the mode Pillow opens it in (``image_samples``) and a JPEG
encoder (``encode_jpeg``).

Images decode with the tier's own decoders, so they need no library (no
libjpeg, libpng or zlib): wherever the tier builds, ``codecs()`` holds
``"jpeg"`` and ``"png"``.
* ``jpeg.cpp``: baseline, progressive and arithmetic-coded files, restart
  markers, every sampling that libjpeg-turbo decodes, Annex K's tables
  where a file has no DHT, block smoothing, bit for bit with libjpeg-turbo
  2.1.5's defaults.
* ``png.cpp``: every colour type and bit depth, all filters, Adam7, PLTE
  and tRNS, with its own inflate. Its RGB output is the JAX tier's libpng
  path; its RGBA output is Pillow's ``convert("RGBA")``.
* ``jpeg_encode.cpp``: Pillow's ``save`` of an "L" or "RGB" JPEG with no
  options (libjpeg-turbo's baseline path: quality 75, 4:2:0, the islow
  DCT, Annex K's Huffman tables), byte for byte.
A file it cannot decode raises ``IOError`` naming the file and the feature
or fault (for a JPEG: 12-bit, lossless, hierarchical, 2 or 4 components,
fractional sampling, as the JAX tier's libjpeg refuses them).

At first use the library is built with ``g++ -O3 -fPIC -std=c++17 -shared
gt_native.cpp jpeg.cpp png.cpp jpeg_encode.cpp -lpthread`` into
``build/torch_native/`` at the repository root, under a name keyed by a
hash of the sources, the header they share (``jpeg_tables.h``) and the
flags. The build writes a temporary file and renames it into place, so
processes that build at once never load a half-written library. Without a
compiler the tier is unavailable (``available()`` is False,
``unavailable_reason()`` says why): the callers use their Python readers
for the bins and PNGs (``utils/png.py``), and a JPEG raises
``CodecUnavailable`` naming that reason.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = [_HERE / name for name in ("gt_native.cpp", "jpeg.cpp", "png.cpp", "jpeg_encode.cpp")]
HEADERS = [_HERE / "jpeg_tables.h"]
BUILD_DIR = _HERE.parent.parent / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
CODECS = ("jpeg", "png")


class CodecUnavailable(RuntimeError):
    """An image needs a codec the native tier was built without (or the
    tier could not be built at all)."""


_lib = None
_tried = False
_why: Optional[str] = None


def compiler() -> Optional[str]:
    """``$CXX`` or ``g++``, resolved on PATH (None when absent)."""
    return shutil.which(os.environ.get("CXX") or "g++")


def library_path() -> Path:
    key = b"".join(src.read_bytes() for src in SOURCES + HEADERS) + " ".join(CXX_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"libgt_native-{digest}.so"


def _first_error(stderr: str) -> str:
    lines = [ln.strip() for ln in stderr.splitlines() if ln.strip()]
    errors = [ln for ln in lines if "error" in ln]
    line = (errors or lines or ["failed"])[0]
    return line.split("error: ", 1)[-1]


def build_command(cxx: str, out) -> List[str]:
    """The compiler's command line: the sources and pthreads, no library."""
    return [cxx, *CXX_FLAGS, "-o", str(out), *map(str, SOURCES), "-lpthread"]


def build(verbose: bool = False) -> bool:
    """(Re)build the library now. Returns ``available()``."""
    global _lib, _tried, _why
    _lib, _tried, _why = None, True, None
    cxx = compiler()
    if cxx is None:
        _why = f"no C++ compiler ({os.environ.get('CXX') or 'g++'} not found)"
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path()
    tmp = out.with_name(f"{out.name}.{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp")
    proc = subprocess.run(build_command(cxx, tmp), capture_output=not verbose, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        _why = f"{cxx} exit {proc.returncode}: {_first_error(proc.stderr or '')}"
        return False
    # Loaded under its temporary name: a process that rebuilds gets the new
    # library, where the final name would return the one loaded before.
    ok = _open(tmp)
    os.replace(tmp, out)
    return ok


def _open(path: Path) -> bool:
    global _lib, _why
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        _why = f"{path}: {e}"
        return False
    _bind(lib)
    _lib = lib
    return True


def _load():
    """The library, built at the first call of a process if it is missing;
    None when it cannot be built."""
    global _tried
    if not _tried:
        _tried = True
        path = library_path()
        if not (path.exists() and _open(path)):
            build()
    return _lib


def _bind(lib) -> None:
    c = ctypes
    lib.gt_free.argtypes = [c.c_void_p]
    lib.gt_codecs.restype = c.c_int
    lib.gt_read_points3d_bin.argtypes = [
        c.c_char_p, c.POINTER(c.POINTER(c.c_double)), c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.POINTER(c.c_double)), c.POINTER(c.c_uint64),
    ]
    lib.gt_read_images_bin.argtypes = [
        c.c_char_p, c.POINTER(c.POINTER(c.c_int32)), c.POINTER(c.POINTER(c.c_double)),
        c.POINTER(c.POINTER(c.c_double)), c.POINTER(c.POINTER(c.c_int32)),
        c.POINTER(c.c_char_p), c.POINTER(c.c_uint64), c.POINTER(c.c_uint64),
    ]
    lib.gt_read_ply_f32.argtypes = [
        c.c_char_p, c.POINTER(c.POINTER(c.c_float)), c.POINTER(c.c_char_p),
        c.POINTER(c.c_uint64), c.POINTER(c.c_uint32),
    ]
    lib.gt_write_ply_f32.argtypes = [c.c_char_p, c.c_char_p, c.POINTER(c.c_float), c.c_uint64, c.c_uint32]
    for fn in (lib.gt_load_images, lib.gt_load_images_rgba):
        fn.argtypes = [
            c.c_char_p, c.c_int, c.c_int, c.c_int, c.c_int,
            c.POINTER(c.c_uint8), c.POINTER(c.c_int32),
        ]
    lib.gt_image_size.argtypes = [c.c_char_p, c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.gt_image_error.argtypes = [c.c_char_p, c.c_char_p, c.c_int]
    lib.gt_image_samples.argtypes = [c.c_char_p, c.POINTER(c.c_int32), c.POINTER(c.c_void_p), c.c_char_p, c.c_int]
    lib.gt_jpeg_encode.argtypes = [
        c.POINTER(c.c_uint8), c.c_int, c.c_int, c.c_int, c.c_char_p, c.c_int,
        c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_uint64),
    ]


def available() -> bool:
    """The library is built and loaded (its parsers at least)."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built or loaded (None when it was)."""
    _load()
    return None if _lib is not None else _why


def codecs() -> Tuple[str, ...]:
    """The image codecs built into the library (none without it)."""
    lib = _load()
    if lib is None:
        return ()
    bits = lib.gt_codecs()
    return tuple(c for i, c in enumerate(CODECS) if bits >> i & 1)


def missing() -> Dict[str, str]:
    """{codec: why it is missing}: every codec when the tier is
    unavailable, none when it is built."""
    if _load() is None:
        return {c: f"native IO tier unavailable: {_why}" for c in CODECS}
    return {}


def codec_of(path: str) -> str:
    """The codec the library decodes ``path`` with: PNG by extension, JPEG
    otherwise."""
    return "png" if path.lower().endswith(".png") else "jpeg"


def require_codec(path: str) -> None:
    """Raise ``CodecUnavailable`` when the tier cannot decode ``path``'s
    codec, that is when the tier itself is unavailable (its reason)."""
    codec = codec_of(path)
    if codec not in codecs():
        raise CodecUnavailable(f"{path}: decoding a {codec.upper()} needs the native IO tier's "
                               f"{codec.upper()} decoder (gaussian_transformer_tpu_torch/native): "
                               f"{missing()[codec]}")


def decode_error(path: str) -> str:
    """Why ``path`` does not decode ("" when it does): the feature the
    tier's decoder lacks or the fault it found."""
    msg = ctypes.create_string_buffer(512)
    _lib_or_raise().gt_image_error(path.encode(), msg, len(msg))
    return msg.value.decode(errors="replace")


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO tier unavailable: {_why}")
    return lib


def _take(ptr, shape, dtype, lib):
    """Copy a malloc'd C buffer into numpy and free it."""
    n = int(np.prod(shape))
    ctype = np.ctypeslib.as_array(ptr, shape=(n,)) if n else np.zeros(0, dtype)
    out = np.array(ctype, dtype=dtype, copy=True).reshape(shape)
    lib.gt_free(ctypes.cast(ptr, ctypes.c_void_p))
    return out


def read_points3d_bin(path: str):
    """COLMAP points3D.bin -> (xyz [N,3] f64, rgb [N,3] u8, err [N] f64)."""
    lib = _lib_or_raise()
    xyz_p = ctypes.POINTER(ctypes.c_double)()
    rgb_p = ctypes.POINTER(ctypes.c_uint8)()
    err_p = ctypes.POINTER(ctypes.c_double)()
    n = ctypes.c_uint64()
    rc = lib.gt_read_points3d_bin(path.encode(), xyz_p, rgb_p, err_p, n)
    if rc != 0:
        raise IOError(f"gt_read_points3d_bin({path}) failed: {rc}")
    n = int(n.value)
    return (
        _take(xyz_p, (n, 3), np.float64, lib),
        _take(rgb_p, (n, 3), np.uint8, lib),
        _take(err_p, (n,), np.float64, lib),
    )


def read_images_bin(path: str):
    """COLMAP images.bin -> (ids [N], qvecs [N,4], tvecs [N,3], cam_ids [N],
    names list[str])."""
    lib = _lib_or_raise()
    ids_p = ctypes.POINTER(ctypes.c_int32)()
    q_p = ctypes.POINTER(ctypes.c_double)()
    t_p = ctypes.POINTER(ctypes.c_double)()
    cam_p = ctypes.POINTER(ctypes.c_int32)()
    names_p = ctypes.c_char_p()
    names_len = ctypes.c_uint64()
    n = ctypes.c_uint64()
    rc = lib.gt_read_images_bin(path.encode(), ids_p, q_p, t_p, cam_p, names_p, names_len, n)
    if rc != 0:
        raise IOError(f"gt_read_images_bin({path}) failed: {rc}")
    n = int(n.value)
    names = names_p.value.decode().split("\n")[:n]
    lib.gt_free(ctypes.cast(names_p, ctypes.c_void_p))
    return (
        _take(ids_p, (n,), np.int32, lib),
        _take(q_p, (n, 4), np.float64, lib),
        _take(t_p, (n, 3), np.float64, lib),
        _take(cam_p, (n,), np.int32, lib),
        names,
    )


def read_ply_f32(path: str) -> Tuple[np.ndarray, List[str]]:
    """float32 vertex PLY -> (data [rows, cols] f32, property names)."""
    lib = _lib_or_raise()
    data_p = ctypes.POINTER(ctypes.c_float)()
    names_p = ctypes.c_char_p()
    rows = ctypes.c_uint64()
    cols = ctypes.c_uint32()
    rc = lib.gt_read_ply_f32(path.encode(), data_p, names_p, rows, cols)
    if rc != 0:
        raise IOError(f"gt_read_ply_f32({path}) failed: {rc}")
    names = names_p.value.decode().rstrip("\n").split("\n")
    lib.gt_free(ctypes.cast(names_p, ctypes.c_void_p))
    return _take(data_p, (int(rows.value), int(cols.value)), np.float32, lib), names


def write_ply_f32(path: str, names: List[str], data: np.ndarray) -> None:
    lib = _lib_or_raise()
    data = np.ascontiguousarray(data, np.float32)
    rows, cols = data.shape
    if len(names) != cols:
        raise ValueError(f"{len(names)} names for {cols} columns")
    rc = lib.gt_write_ply_f32(
        path.encode(), "\n".join(names).encode(),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols,
    )
    if rc != 0:
        raise IOError(f"gt_write_ply_f32({path}) failed: {rc}")


def image_size(path: str) -> Tuple[int, int]:
    lib = _lib_or_raise()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.gt_image_size(path.encode(), w, h)
    if rc != 0:
        raise IOError(f"gt_image_size({path}) failed: {rc}")
    return int(w.value), int(h.value)


def load_images(paths: List[str], width: int, height: int, threads: int = 0, rgba: bool = False) -> np.ndarray:
    """Decode + resize a batch of JPEG/PNG files on a thread pool ->
    [N, height, width, 3] uint8 as the JAX tier's libpng/libjpeg give it
    (an RGBA PNG loses its alpha), or with ``rgba`` [N, height, width, 4]
    as Pillow's ``convert("RGBA")`` gives it. A file that does not decode
    raises ``IOError`` naming it and why."""
    lib = _lib_or_raise()
    for p in paths:
        require_codec(p)
    n = len(paths)
    out = np.empty((n, height, width, 4 if rgba else 3), np.uint8)
    status = np.zeros(n, np.int32)
    rc = (lib.gt_load_images_rgba if rgba else lib.gt_load_images)(
        "\n".join(paths).encode(), n, width, height, threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise IOError(f"gt_load_images failed (rc={rc})")
    bad = np.nonzero(status)[0]
    if len(bad):
        why = [f"{paths[i]}: {decode_error(paths[i]) or 'decode failed'}" for i in bad[:3]]
        raise IOError(f"gt_load_images: {len(bad)} image(s) did not decode: " + "; ".join(why))
    return out


def decode_folder(paths: List[str], threads: int = 0, rgba: bool = False) -> Dict[str, np.ndarray]:
    """Decode every image of ``paths`` at its own size, grouped by size on
    the thread pool: {path: uint8 [H, W, 3]} (``rgba``: [H, W, 4])."""
    by_size: Dict[Tuple[int, int], List[str]] = {}
    for p in paths:
        require_codec(p)
        by_size.setdefault(image_size(p), []).append(p)
    out = {}
    for (w, h), group in by_size.items():
        for p, arr in zip(group, load_images(group, w, h, threads, rgba)):
            out[p] = arr
    return out


def image_samples(path: str) -> Tuple[str, np.ndarray]:
    """The samples of a JPEG or PNG (told by its content) in the mode Pillow
    opens it in: ("JPEG", uint8 [H, W, 1 or 3]) for a grayscale or colour
    JPEG, or ("PNG", [H, W, C]) at the file's own depth: C by its colour
    type, uint8 values below 2 ** depth for depths 1-8 (palette indices for
    colour type 3), uint16 for 16. A file the tier cannot decode raises
    ``IOError`` naming it and why; the tier unavailable raises
    ``CodecUnavailable`` naming its reason."""
    lib = _load()
    if lib is None:
        raise CodecUnavailable(f"{path}: decoding an image needs the native IO tier "
                               f"(gaussian_transformer_tpu_torch/native): unavailable: {_why}")
    info = (ctypes.c_int32 * 5)()
    buf = ctypes.c_void_p()
    msg = ctypes.create_string_buffer(512)
    rc = lib.gt_image_samples(path.encode(), info, ctypes.byref(buf), msg, len(msg))
    if rc != 0:
        raise IOError(f"{path}: {msg.value.decode(errors='replace') or 'decode failed'} (status {rc})")
    fmt, w, h, c, depth = (int(v) for v in info)
    dtype = np.uint16 if depth == 16 else np.uint8
    ptr = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint16 if depth == 16 else ctypes.c_uint8))
    return ("PNG" if fmt else "JPEG"), _take(ptr, (h, w, c), dtype, lib)


def encode_jpeg(samples: np.ndarray, comment: bytes = b"") -> bytes:
    """uint8 [H, W] or [H, W, 1] ("L") or [H, W, 3] ("RGB") -> the JPEG file
    Pillow's ``Image.save(path)`` writes for it with no options (quality 75,
    4:2:0 for RGB), with ``comment`` as its COM segment where given, as
    Pillow writes the comment an opened JPEG carried. Byte for byte with
    Pillow 12.1.0's libjpeg-turbo 3.1.3."""
    lib = _lib_or_raise()
    arr = np.ascontiguousarray(samples)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (1, 3):
        raise ValueError(f"encode_jpeg takes uint8 [H, W] or [H, W, 1 or 3], got {arr.dtype} {arr.shape}")
    h, w, c = arr.shape
    if not (0 < w <= 65535 and 0 < h <= 65535) or len(comment) > 65533:
        raise ValueError(f"a JPEG holds 1..65535 pixels a side and a comment of up to 65533 bytes: "
                         f"{w}x{h}, {len(comment)} B")
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64()
    rc = lib.gt_jpeg_encode(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, c, comment or None,
                            len(comment), ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise MemoryError(f"gt_jpeg_encode failed (rc={rc})")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.gt_free(ctypes.cast(out, ctypes.c_void_p))
