"""Cameras as small dataclasses of tensors (port of
``gaussian_transformer_tpu/scene/cameras.py``).

Matrix convention (identical to the reference): matrices are stored
TRANSPOSED so ``p_cam = [p_world, 1] @ world_view_transform`` and
``p_clip = [p_world, 1] @ full_proj_transform``. The matrices are built in
numpy exactly as the reference builds them, then moved to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.utils.graphics import get_projection_matrix, get_world2view


@dataclasses.dataclass
class Camera:
    uid: int
    colmap_id: int
    image_name: str
    image_width: int
    image_height: int
    fovx: float
    fovy: float
    znear: float = 0.01
    zfar: float = 100.0
    world_view_transform: torch.Tensor = None  # [4,4] transposed W2C
    full_proj_transform: torch.Tensor = None  # [4,4] transposed W2C@P
    camera_center: torch.Tensor = None  # [3]
    original_image: Optional[torch.Tensor] = None  # [3,H,W] in [0,1]

    @staticmethod
    def create(
        colmap_id: int,
        R: np.ndarray,
        T: np.ndarray,
        fovx: float,
        fovy: float,
        image: Optional[np.ndarray],
        gt_alpha_mask: Optional[np.ndarray],
        image_name: str,
        uid: int,
        width: Optional[int] = None,
        height: Optional[int] = None,
        trans=None,
        scale: float = 1.0,
        znear: float = 0.01,
        zfar: float = 100.0,
        device=None,
    ) -> "Camera":
        device = resolve_device(device)
        if image is not None:
            image = np.clip(np.asarray(image, dtype=np.float32), 0.0, 1.0)
            if gt_alpha_mask is not None:
                image = image * np.asarray(gt_alpha_mask, dtype=np.float32)
            height, width = image.shape[1], image.shape[2]
        if width is None or height is None:
            raise ValueError("a camera without an image needs width and height")

        w2c = get_world2view(R, T, trans if trans is not None else np.zeros(3), scale)
        world_view = w2c.T  # transposed storage
        proj = get_projection_matrix(znear, zfar, fovx, fovy).T
        full_proj = world_view @ proj
        cam_center = np.linalg.inv(world_view)[3, :3]

        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
        return Camera(
            uid=uid,
            colmap_id=colmap_id,
            image_name=image_name,
            image_width=int(width),
            image_height=int(height),
            fovx=float(fovx),
            fovy=float(fovy),
            znear=znear,
            zfar=zfar,
            world_view_transform=as_t(world_view),
            full_proj_transform=as_t(full_proj),
            camera_center=as_t(cam_center),
            original_image=as_t(image) if image is not None else None,
        )

    # Reference-attribute aliases.
    @property
    def FoVx(self):
        return self.fovx

    @property
    def FoVy(self):
        return self.fovy

    @property
    def R(self) -> np.ndarray:
        """The rotation the reference stores (the transposed world-to-camera
        rotation), recovered from the view matrix."""
        return self.world_view_transform[:3, :3].detach().cpu().numpy()

    @property
    def T(self) -> np.ndarray:
        return self.world_view_transform[3, :3].detach().cpu().numpy()


@dataclasses.dataclass
class MiniCam:
    """Lightweight camera built from the viewer wire protocol."""

    image_width: int
    image_height: int
    fovx: float
    fovy: float
    znear: float
    zfar: float
    world_view_transform: torch.Tensor = None
    full_proj_transform: torch.Tensor = None
    camera_center: torch.Tensor = None

    @staticmethod
    def create(width, height, fovy, fovx, znear, zfar, world_view_transform, full_proj_transform,
               device=None) -> "MiniCam":
        device = resolve_device(device)
        view_inv = np.linalg.inv(np.asarray(world_view_transform))
        as_t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32), device=device)
        return MiniCam(
            image_width=int(width),
            image_height=int(height),
            fovx=float(fovx),
            fovy=float(fovy),
            znear=float(znear),
            zfar=float(zfar),
            world_view_transform=as_t(world_view_transform),
            full_proj_transform=as_t(full_proj_transform),
            camera_center=as_t(view_inv[3, :3]),
        )

    @property
    def FoVx(self):
        return self.fovx

    @property
    def FoVy(self):
        return self.fovy
