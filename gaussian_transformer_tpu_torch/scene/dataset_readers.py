"""Scene-info readers: COLMAP sparse reconstructions and Blender/NeRF-synthetic
transforms (port of ``gaussian_transformer_tpu/scene/dataset_readers.py``).

Same behaviours: bin-with-txt fallback, train/test split every ``llffhold``-th
camera under --eval, points3D.bin -> PLY conversion on first load, NeRF++
camera-extent normalization, random 100k-point init for Blender scenes.

Images are decoded into uint8 [H, W, C] arrays (no Pillow), by the native
IO tier (``native/``) on a thread pool, grouped by size, with the tier's
own JPEG and PNG decoders:
* a COLMAP image folder as RGB, bit for bit with the JAX package's native
  tier (libjpeg, libpng): an RGBA PNG loses its alpha there, as it does in
  the JAX tier;
* a Blender scene as RGBA, bit for bit with the JAX reader's
  ``Image.open(p).convert("RGBA")``, whose alpha is composited over the
  background here as there.
A file the tier cannot decode raises ``IOError`` naming the file and the
feature or fault; nothing falls back to another reader then. Only where
the tier is unavailable (no C++ compiler, as for the bins) PNGs go through
``utils/png.py`` (a COLMAP PNG with its channels as stored, alpha kept; a
Blender PNG as Pillow's RGBA), and a JPEG raises
``native.CodecUnavailable`` naming why.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from gaussian_transformer_tpu_torch import native
from gaussian_transformer_tpu_torch.scene import colmap as colmap_loader
from gaussian_transformer_tpu_torch.scene.ply import fetch_point_cloud, store_point_cloud
from gaussian_transformer_tpu_torch.utils.graphics import (
    BasicPointCloud,
    focal2fov,
    fov2focal,
    get_world2view,
)
from gaussian_transformer_tpu_torch.utils.png import read_png, read_png_rgba
from gaussian_transformer_tpu_torch.utils.sh import sh_to_rgb


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image: Optional[np.ndarray]  # uint8 [H, W, C], or None when the file is missing
    image_path: str
    image_name: str
    width: int
    height: int


class SceneInfo(NamedTuple):
    point_cloud: Optional[BasicPointCloud]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_info: List[CameraInfo]) -> dict:
    """Camera-extent radius + recentering translate."""
    cam_centers = []
    for cam in cam_info:
        W2C = get_world2view(cam.R, cam.T)
        C2W = np.linalg.inv(W2C)
        cam_centers.append(C2W[:3, 3:4])
    cam_centers = np.hstack(cam_centers)
    avg = np.mean(cam_centers, axis=1, keepdims=True)
    dist = np.linalg.norm(cam_centers - avg, axis=0, keepdims=True)
    diagonal = float(np.max(dist))
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def decode_images(paths, rgba: bool = False) -> dict:
    """{path: uint8 [H, W, C]} for a list of images, on the native tier's
    thread pool: RGB (C = 3), or with ``rgba`` Pillow's RGBA (C = 4).
    Without the tier, PNGs go through ``utils/png.py`` (``read_png``, or
    ``read_png_rgba``) and a JPEG raises ``native.CodecUnavailable``."""
    if native.available():
        return native.decode_folder(list(paths), rgba=rgba)
    out = {}
    for p in paths:
        if native.codec_of(p) != "png":
            native.require_codec(p)  # raises, naming why the tier is unavailable
        out[p] = read_png_rgba(p) if rgba else read_png(p)
    return out


def _read_colmap_cameras(cam_extrinsics, cam_intrinsics, images_folder, load_images=True):
    decoded = {}
    if load_images:
        paths = [os.path.join(images_folder, os.path.basename(e.name)) for e in cam_extrinsics.values()]
        decoded = decode_images([p for p in paths if os.path.exists(p)])
    cam_infos = []
    for key in cam_extrinsics:
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        height, width = intr.height, intr.width
        uid = intr.id
        R = np.transpose(colmap_loader.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)

        if intr.model == "SIMPLE_PINHOLE":
            focal_length_x = intr.params[0]
            FovY = focal2fov(focal_length_x, height)
            FovX = focal2fov(focal_length_x, width)
        elif intr.model == "PINHOLE":
            FovY = focal2fov(intr.params[1], height)
            FovX = focal2fov(intr.params[0], width)
        else:
            raise ValueError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE cameras) supported!"
            )

        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        image_name = os.path.basename(image_path).split(".")[0]
        image = decoded.get(image_path)

        cam_infos.append(
            CameraInfo(
                uid=uid,
                R=R,
                T=T,
                FovY=FovY,
                FovX=FovX,
                image=image,
                image_path=image_path,
                image_name=image_name,
                width=width,
                height=height,
            )
        )
    return cam_infos


def read_colmap_scene_info(path, images, eval, llffhold=8, load_images=True) -> SceneInfo:
    try:
        cam_extrinsics = colmap_loader.read_extrinsics_binary(os.path.join(path, "sparse/0", "images.bin"))
        cam_intrinsics = colmap_loader.read_intrinsics_binary(os.path.join(path, "sparse/0", "cameras.bin"))
    except (OSError, KeyError, ValueError):
        cam_extrinsics = colmap_loader.read_extrinsics_text(os.path.join(path, "sparse/0", "images.txt"))
        cam_intrinsics = colmap_loader.read_intrinsics_text(os.path.join(path, "sparse/0", "cameras.txt"))

    reading_dir = "images" if images is None else images
    cam_infos_unsorted = _read_colmap_cameras(
        cam_extrinsics, cam_intrinsics, os.path.join(path, reading_dir), load_images=load_images
    )
    cam_infos = sorted(cam_infos_unsorted, key=lambda x: x.image_name)

    if eval:
        train_cam_infos = [c for idx, c in enumerate(cam_infos) if idx % llffhold != 0]
        test_cam_infos = [c for idx, c in enumerate(cam_infos) if idx % llffhold == 0]
    else:
        train_cam_infos = cam_infos
        test_cam_infos = []

    nerf_normalization = get_nerfpp_norm(train_cam_infos)

    ply_path = os.path.join(path, "sparse/0/points3D.ply")
    bin_path = os.path.join(path, "sparse/0/points3D.bin")
    txt_path = os.path.join(path, "sparse/0/points3D.txt")
    if not os.path.exists(ply_path):
        print("Converting point3d.bin to .ply, will happen only the first time you open the scene.")
        try:
            xyz, rgb, _ = colmap_loader.read_points3D_binary(bin_path)
        except OSError:
            xyz, rgb, _ = colmap_loader.read_points3D_text(txt_path)
        store_point_cloud(ply_path, xyz, rgb)
    try:
        pcd = fetch_point_cloud(ply_path)
    except (OSError, KeyError, ValueError):
        pcd = None

    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train_cam_infos,
        test_cameras=test_cam_infos,
        nerf_normalization=nerf_normalization,
        ply_path=ply_path,
    )


def _read_cameras_from_transforms(path, transformsfile, white_background, extension=".png"):
    cam_infos = []
    with open(os.path.join(path, transformsfile)) as json_file:
        contents = json.load(json_file)
    fovx = contents["camera_angle_x"]
    frames = contents["frames"]
    image_paths = [os.path.join(path, os.path.join(path, f["file_path"] + extension)) for f in frames]
    decoded = decode_images(image_paths, rgba=True)

    for idx, frame in enumerate(frames):
        cam_name = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward).
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        image_path = image_paths[idx]
        image_name = Path(cam_name).stem
        im_data = decoded[image_path]
        bg = np.array([1, 1, 1]) if white_background else np.array([0, 0, 0])
        norm_data = im_data / 255.0
        arr = norm_data[:, :, :3] * norm_data[:, :, 3:4] + bg * (1 - norm_data[:, :, 3:4])
        image = np.array(arr * 255.0, dtype=np.uint8)
        height, width = image.shape[:2]

        fovy = focal2fov(fov2focal(fovx, width), height)
        cam_infos.append(
            CameraInfo(
                uid=idx,
                R=R,
                T=T,
                FovY=fovy,
                FovX=fovx,
                image=image,
                image_path=image_path,
                image_name=image_name,
                width=width,
                height=height,
            )
        )
    return cam_infos


def read_nerf_synthetic_info(path, white_background, eval, extension=".png") -> SceneInfo:
    print("Reading Training Transforms")
    train_cam_infos = _read_cameras_from_transforms(path, "transforms_train.json", white_background, extension)
    print("Reading Test Transforms")
    test_cam_infos = _read_cameras_from_transforms(path, "transforms_test.json", white_background, extension)

    if not eval:
        train_cam_infos.extend(test_cam_infos)
        test_cam_infos = []

    nerf_normalization = get_nerfpp_norm(train_cam_infos)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        print(f"Generating random point cloud ({num_pts})...")
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        store_point_cloud(ply_path, xyz, np.asarray(sh_to_rgb(shs)) * 255)
    try:
        pcd = fetch_point_cloud(ply_path)
    except (OSError, KeyError, ValueError):
        pcd = None

    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train_cam_infos,
        test_cameras=test_cam_infos,
        nerf_normalization=nerf_normalization,
        ply_path=ply_path,
    )


scene_load_type_callbacks = {
    "Colmap": read_colmap_scene_info,
    "Blender": read_nerf_synthetic_info,
}
