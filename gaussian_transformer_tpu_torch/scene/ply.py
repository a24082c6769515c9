"""Minimal PLY reader/writer (port of ``gaussian_transformer_tpu/scene/ply.py``).

Handles point-cloud PLYs (float xyz/normals + uchar rgb) and all-float32
Gaussian checkpoint PLYs. Reads binary_little_endian 1.0 and ascii 1.0;
always writes binary_little_endian. All-float32 vertex tables go through
the native IO tier (``native/``) when it is built; ``native_io=False``, or
any other layout, takes the Python path (same bytes, same arrays).
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from gaussian_transformer_tpu_torch import native
from gaussian_transformer_tpu_torch.utils.graphics import BasicPointCloud

_PLY_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "ushort": "<u2",
    "uint16": "<u2",
    "short": "<i2",
    "int16": "<i2",
    "uint": "<u4",
    "uint32": "<u4",
    "int": "<i4",
    "int32": "<i4",
}


def read_ply_vertex_table(path: str, native_io: bool = True) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element of a PLY file into {property: 1-D array}."""
    if native_io and native.available():
        try:
            data, names = native.read_ply_f32(path)
        except OSError:
            pass  # not an all-float32 binary table: the Python reader takes it
        else:
            return {name: data[:, i] for i, name in enumerate(names)}
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop, dtype), ...])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur[2].append((tokens[-1], "list"))
                else:
                    cur[2].append((tokens[-1], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if any(p[1] == "list" for p in props):
                raise ValueError(f"{path}: list properties unsupported (element {name})")
            dtype = np.dtype([(p, d) for p, d in props])
            if fmt == "binary_little_endian":
                rec = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
            else:
                rows = [f.readline().split() for _ in range(count)]
                rec = np.array([tuple(r) for r in rows], dtype=dtype)
            if name == "vertex":
                for p, _ in props:
                    out[p] = np.ascontiguousarray(rec[p])
        if not out:
            raise ValueError(f"{path}: no vertex element")
        return out


def write_ply_vertex_table(path: str, names: Sequence[str], attributes: np.ndarray,
                           native_io: bool = True) -> None:
    """Write an all-float32 vertex table: attributes [N, len(names)]."""
    n = attributes.shape[0]
    if attributes.shape[1] != len(names):
        raise ValueError(f"{attributes.shape[1]} columns for {len(names)} names")
    if native_io and attributes.dtype == np.float32 and native.available():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        native.write_ply_f32(path, list(names), attributes)
        return
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header", ""]
    rec = np.ascontiguousarray(attributes.astype("<f4"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def fetch_point_cloud(path: str) -> BasicPointCloud:
    """Read a point-cloud PLY -> BasicPointCloud."""
    data = read_ply_vertex_table(path)
    positions = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)
    colors = np.stack([data["red"], data["green"], data["blue"]], axis=1).astype(np.float32) / 255.0
    if "nx" in data:
        normals = np.stack([data["nx"], data["ny"], data["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(positions)
    return BasicPointCloud(points=positions, colors=colors, normals=normals)


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write a point-cloud PLY with float xyz+normals and uchar rgb."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = xyz.shape[0]
    dtype = np.dtype(
        [(k, "<f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
        + [(k, "u1") for k in ("red", "green", "blue")]
    )
    rec = np.zeros(n, dtype=dtype)
    for i, k in enumerate(("x", "y", "z")):
        rec[k] = xyz[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        rec[k] = rgb[:, i].astype(np.uint8)
    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
        "property float nx",
        "property float ny",
        "property float nz",
        "property uchar red",
        "property uchar green",
        "property uchar blue",
        "end_header",
        "",
    ]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())
