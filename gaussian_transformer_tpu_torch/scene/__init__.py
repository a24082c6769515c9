"""Scene orchestrator: loads a COLMAP or Blender dataset, builds cameras, and
initializes or restores the GaussianScene (port of
``gaussian_transformer_tpu/scene/__init__.py``).

A fresh scene (no ``load_iteration``) initializes the Gaussians from the
dataset's point cloud (3-NN seed scales, ``ops/knn.py``) and writes
``input.ply`` and ``cameras.json`` into the model dir; a resumed one loads
``point_cloud/iteration_N/point_cloud.ply`` (N = -1 picks the latest).
"""

from __future__ import annotations

import json
import os
import random
import shutil

from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.scene.camera_utils import camera_list_from_cam_infos, camera_to_json
from gaussian_transformer_tpu_torch.scene.cameras import Camera, MiniCam
from gaussian_transformer_tpu_torch.scene.dataset_readers import scene_load_type_callbacks
from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
from gaussian_transformer_tpu_torch.utils.system import search_for_max_iteration

__all__ = ["Scene", "GaussianScene", "Camera", "MiniCam"]


def _load_scene_info(source_path: str, images: str, white_background: bool, eval_split: bool):
    """Autodetect the dataset flavor: ``sparse/`` means COLMAP,
    ``transforms_train.json`` means Blender/NeRF-synthetic."""
    if os.path.isdir(os.path.join(source_path, "sparse")):
        return scene_load_type_callbacks["Colmap"](source_path, images, eval_split)
    if os.path.isfile(os.path.join(source_path, "transforms_train.json")):
        print("transforms_train.json present -> loading as a Blender data set")
        return scene_load_type_callbacks["Blender"](source_path, white_background, eval_split)
    raise ValueError(f"unrecognized scene layout at {source_path!r}")


def _export_model_dir_inputs(model_path: str, scene_info) -> None:
    """First-run exports the downstream tools rely on: the initial point cloud
    as ``input.ply`` and all cameras (test first, then train: the id order
    the SIBR viewer expects) as ``cameras.json``."""
    os.makedirs(model_path, exist_ok=True)
    shutil.copyfile(scene_info.ply_path, os.path.join(model_path, "input.ply"))
    cams = list(scene_info.test_cameras or []) + list(scene_info.train_cameras or [])
    payload = [camera_to_json(i, cam) for i, cam in enumerate(cams)]
    with open(os.path.join(model_path, "cameras.json"), "w") as f:
        json.dump(payload, f)


class Scene:
    """Dataset + GaussianScene pair rooted at a model directory. Fresh runs
    (``load_iteration=None``) initialize the Gaussians from the point cloud;
    resumed runs load ``point_cloud/iteration_N/point_cloud.ply``."""

    gaussians: GaussianScene

    def __init__(
        self,
        args,
        load_iteration=None,
        shuffle=True,
        resolution_scales=(1.0,),
        capacity=None,
        sh_degree=None,
        device=None,
    ):
        """args needs: model_path, source_path, images, eval, white_background,
        resolution (the ModelParams group)."""
        device = resolve_device(device)
        self.model_path = args.model_path
        self.source_path = args.source_path  # the viewer's reply names it
        if sh_degree is None:
            sh_degree = getattr(args, "sh_degree", 3)

        self.loaded_iter = None
        if load_iteration:
            self.loaded_iter = (
                search_for_max_iteration(os.path.join(self.model_path, "point_cloud"))
                if load_iteration == -1
                else load_iteration
            )
            if self.loaded_iter is None:
                raise FileNotFoundError(f"no trained iteration under {self.model_path}/point_cloud")
            print(f"Loading trained model at iteration {self.loaded_iter}")

        scene_info = _load_scene_info(
            args.source_path, args.images, args.white_background, args.eval
        )
        if not self.loaded_iter:
            _export_model_dir_inputs(self.model_path, scene_info)
        if shuffle:
            random.shuffle(scene_info.train_cameras)
            random.shuffle(scene_info.test_cameras)

        self.cameras_extent = scene_info.nerf_normalization["radius"]

        self.train_cameras = {}
        self.test_cameras = {}
        for scale in resolution_scales:
            print("Loading Training Cameras")
            self.train_cameras[scale] = camera_list_from_cam_infos(
                scene_info.train_cameras, scale, args, device
            )
            print("Loading Test Cameras")
            self.test_cameras[scale] = camera_list_from_cam_infos(
                scene_info.test_cameras, scale, args, device
            )

        if self.loaded_iter:
            ply = os.path.join(
                self.model_path, "point_cloud", f"iteration_{self.loaded_iter}", "point_cloud.ply"
            )
            self.gaussians = GaussianScene.load_ply(
                ply, max_sh_degree=sh_degree, capacity=capacity, device=device
            )
        else:
            if scene_info.point_cloud is None:
                raise ValueError(f"{args.source_path}: the scene has no initial point cloud")
            self.gaussians = GaussianScene.from_pcd(
                scene_info.point_cloud, max_sh_degree=sh_degree, capacity=capacity, device=device
            )

    def save(self, iteration: int) -> None:
        out = os.path.join(self.model_path, f"point_cloud/iteration_{iteration}")
        self.gaussians.save_ply(os.path.join(out, "point_cloud.ply"))

    def get_train_cameras(self, scale=1.0):
        return self.train_cameras[scale]

    def get_test_cameras(self, scale=1.0):
        return self.test_cameras[scale]
