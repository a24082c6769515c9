"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source exposes a plain ``extern "C"`` interface and is
compiled by ``nvcc`` into its own shared library at first use, then loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds, and no
``ninja``). Libraries land in ``build/torch_kernels/`` at the repository root,
keyed by a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source or header rebuilds.
``build()`` starts one ``nvcc`` per missing library, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrapper raises on a non-zero code, so a refused launch (too many threads,
too much shared memory) never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# No --use_fast_math: expf must stay expf (the compositor's alpha depends on it).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError("nvcc not found on PATH or under CUDA_HOME")
    return path


def library_path(source: str) -> Path:
    """The library of ``source``, keyed by its text, every shared header in
    ``csrc/`` and the flags."""
    text = (CSRC / source).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(sources: Iterable[str]) -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together. Returns {source: library path}. The
    compiler's resource report (``-Xptxas -v``) is kept beside each library
    as ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: library_path(s) for s in sources}
    procs = []
    for src, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def all_sources() -> List[str]:
    return sorted(p.name for p in CSRC.glob("*.cu"))


class CudaKernel:
    """One ``extern "C"`` entry point of a ``csrc`` source.

    ``launches`` counts successful launches made through ``launch`` — the
    only place it changes, so a caller can zero it, run a path, and see which
    kernels that path launched."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._errstr = None

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            errstr = lib.gt_cuda_error_string
            errstr.argtypes = [ctypes.c_int]
            errstr.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, errstr
        return self._fn

    def launch(self, *args) -> None:
        code = self.load()(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {code} ({self._errstr(code).decode()})"
            )
        self.launches += 1
