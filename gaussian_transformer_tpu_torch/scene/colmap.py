"""COLMAP sparse-reconstruction parsers (cameras/images/points3D, .bin and .txt).

Port of ``gaussian_transformer_tpu/scene/colmap.py``: ``images.bin`` and
``points3D.bin`` go through the native IO tier (``native/``) when it is
built, else (or with ``native_io=False``) through the Python parsers.

Pure-Python reimplementation of the standard COLMAP formats: dicts keyed by id
holding NamedTuple records, with the API shape of the upstream 3DGS loader.
"""

from __future__ import annotations

import struct
from typing import Dict, NamedTuple

import numpy as np

from gaussian_transformer_tpu_torch import native


class CameraModel(NamedTuple):
    model_id: int
    model_name: str
    num_params: int


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


CAMERA_MODELS = {
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    """COLMAP (w,x,y,z) quaternion -> 3x3 rotation (colmap_loader.py:43-55)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
        ]
    )


def rotmat2qvec(R):
    """3x3 rotation -> COLMAP (w,x,y,z) quaternion (colmap_loader.py:57-66)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read_next_bytes(fid, num_bytes, format_char_sequence, endian="<"):
    data = fid.read(num_bytes)
    return struct.unpack(endian + format_char_sequence, data)


# ---------------------------------------------------------------- binary ----


def read_intrinsics_binary(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as fid:
        (num_cameras,) = _read_next_bytes(fid, 8, "Q")
        for _ in range(num_cameras):
            cam_id, model_id, width, height = _read_next_bytes(fid, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read_next_bytes(fid, 8 * model.num_params, "d" * model.num_params))
            cameras[cam_id] = ColmapCamera(
                id=cam_id, model=model.model_name, width=width, height=height, params=params
            )
    return cameras


def read_extrinsics_binary(path: str, native_io: bool = True) -> Dict[int, ColmapImage]:
    """images.bin -> {image_id: ColmapImage}. The native parser skips the
    track observations (empty ``xys``/``point3D_ids``): no call site reads
    them."""
    if native_io and native.available():
        try:
            ids, qvecs, tvecs, cam_ids, names = native.read_images_bin(path)
        except OSError:
            pass  # the Python parser says what is wrong with the file
        else:
            empty_xys, empty_ids = np.zeros((0, 2)), np.zeros((0,), dtype=np.int64)
            return {
                int(i): ColmapImage(id=int(i), qvec=q, tvec=t, camera_id=int(c), name=nm,
                                    xys=empty_xys, point3D_ids=empty_ids)
                for i, q, t, c, nm in zip(ids, qvecs, tvecs, cam_ids, names)
            }
    images = {}
    with open(path, "rb") as fid:
        (num_images,) = _read_next_bytes(fid, 8, "Q")
        for _ in range(num_images):
            vals = _read_next_bytes(fid, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name_bytes = b""
            while True:
                c = fid.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            (num_points,) = _read_next_bytes(fid, 8, "Q")
            rec = np.frombuffer(
                fid.read(24 * num_points),
                dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]),
                count=num_points,
            )
            xys = np.column_stack([rec["x"], rec["y"]])
            point3D_ids = rec["id"].copy()
            images[image_id] = ColmapImage(
                id=image_id,
                qvec=qvec,
                tvec=tvec,
                camera_id=camera_id,
                name=name_bytes.decode("utf-8"),
                xys=xys,
                point3D_ids=point3D_ids,
            )
    return images


def read_points3D_binary(path: str, native_io: bool = True):
    """Returns (xyz [N,3] f64, rgb [N,3] u8, error [N,1] f64)."""
    if native_io and native.available():
        try:
            xyz, rgb, err = native.read_points3d_bin(path)
        except OSError:
            pass  # the Python parser says what is wrong with the file
        else:
            return xyz, rgb, err[:, None]
    with open(path, "rb") as fid:
        (num_points,) = _read_next_bytes(fid, 8, "Q")
        xyzs = np.empty((num_points, 3))
        rgbs = np.empty((num_points, 3), dtype=np.uint8)
        errors = np.empty((num_points, 1))
        for i in range(num_points):
            vals = _read_next_bytes(fid, 43, "QdddBBBd")
            xyzs[i] = vals[1:4]
            rgbs[i] = vals[4:7]
            errors[i] = vals[7]
            (track_len,) = _read_next_bytes(fid, 8, "Q")
            fid.seek(8 * track_len, 1)
    return xyzs, rgbs, errors


# ------------------------------------------------------------------ text ----


def read_intrinsics_text(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cam_id = int(elems[0])
            model = elems[1]
            assert model in CAMERA_MODEL_NAMES, f"unknown camera model {model}"
            cameras[cam_id] = ColmapCamera(
                id=cam_id,
                model=model,
                width=int(elems[2]),
                height=int(elems[3]),
                params=np.array(tuple(map(float, elems[4:]))),
            )
    return cameras


def read_extrinsics_text(path: str) -> Dict[int, ColmapImage]:
    """Sequential two-line records like COLMAP itself: a header line followed
    by its observations line, which MAY be empty (read unconditionally:
    dropping blank lines would desynchronize the pairing)."""
    images = {}
    with open(path) as fid:
        while True:
            line = fid.readline()
            if not line:
                break
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            image_id = int(elems[0])
            qvec = np.array(tuple(map(float, elems[1:5])))
            tvec = np.array(tuple(map(float, elems[5:8])))
            camera_id = int(elems[8])
            name = elems[9]
            pts = fid.readline().split()
            xys = (
                np.column_stack([tuple(map(float, pts[0::3])), tuple(map(float, pts[1::3]))])
                if pts
                else np.zeros((0, 2))
            )
            ids = np.array(tuple(map(int, pts[2::3]))) if pts else np.zeros((0,), dtype=np.int64)
            images[image_id] = ColmapImage(
                id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id, name=name, xys=xys, point3D_ids=ids
            )
    return images


def read_points3D_text(path: str):
    xyzs, rgbs, errors = [], [], []
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            xyzs.append(tuple(map(float, elems[1:4])))
            rgbs.append(tuple(map(int, elems[4:7])))
            errors.append(float(elems[7]))
    return (
        np.array(xyzs),
        np.array(rgbs, dtype=np.uint8),
        np.array(errors)[:, None],
    )
