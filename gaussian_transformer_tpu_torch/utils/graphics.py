"""Camera / geometry math (port of ``gaussian_transformer_tpu/utils/graphics.py``).

Conventions are the reference's: matrices handed to the renderer are stored
TRANSPOSED (row-vector convention, ``p_cam = [p_world, 1] @ world_view``), the
projection is the z in [0, zfar/(zfar-znear)] variant, and quaternions are
(w, x, y, z). The host-side builders stay numpy so both packages produce
bit-identical camera matrices; ``build_rotation`` (densification's split
sampling) and the covariance functions work on tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


def get_world2view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """World->camera 4x4 (numpy). R is the camera-to-world rotation as stored
    by the COLMAP reader (transposed world-to-camera), t the world-to-camera
    translation."""
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0

    C2W = np.linalg.inv(Rt)
    cam_center = C2W[:3, 3]
    cam_center = (cam_center + translate) * scale
    C2W[:3, 3] = cam_center
    Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def get_projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection 4x4 (pre-transpose layout)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)

    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right

    P = np.zeros((4, 4), dtype=np.float32)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (w, x, y, z) -> rotation matrices [..., 3, 3]; normalizes
    first (the reference's ``build_rotation``)."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    q = q / torch.clamp(norm, min=1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R(q) diag(s) [..., 3, 3], so that the covariance is L L^T."""
    return build_rotation(q) * s[..., None, :]


def build_covariance_3d(scaling: torch.Tensor, rotation: torch.Tensor, scaling_modifier: float = 1.0) -> torch.Tensor:
    """The full 3D covariance [..., 3, 3] from activated scales and a quaternion."""
    L = build_scaling_rotation(scaling_modifier * scaling, rotation)
    return L @ L.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> its upper triangle [..., 6] (xx, xy, xz, yy, yz, zz)."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)
