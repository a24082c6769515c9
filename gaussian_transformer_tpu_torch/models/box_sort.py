"""Box-sort spatial ordering + normalization (port of
``gaussian_transformer_tpu/models/box_sort.py``).

Capture world xyz and log-scaling min/max once (alive slots only),
affine-normalize both into [0, 1], and order Gaussians by voxel in an
``interval_num``^3 grid scanned x-fastest, keeping the original order within
each voxel: one stable argsort by voxel id. Gaussians exactly on the upper
boundary are clamped into the last voxel.
"""

from __future__ import annotations

import dataclasses

import torch

from gaussian_transformer_tpu_torch.models.codec import flatten_gaussians
from gaussian_transformer_tpu_torch.scene.gaussians import TensorScene


@dataclasses.dataclass(frozen=True)
class GaussianHandler:
    """Normalization constants captured from a scene."""

    world_min: torch.Tensor  # [3]
    world_max: torch.Tensor  # [3]
    scaling_min: torch.Tensor  # []
    scaling_max: torch.Tensor  # []
    interval_num: int = 10

    @staticmethod
    @torch.no_grad()
    def create(scene, interval_num: int = 10) -> "GaussianHandler":
        alive = scene.alive[:, None]
        coords, scalings = scene.get_xyz, scene.scaling
        inf = torch.tensor(float("inf"), device=coords.device)
        # Dead slots must not pollute the ranges.
        return GaussianHandler(
            world_min=torch.where(alive, coords, inf).amin(0),
            world_max=torch.where(alive, coords, -inf).amax(0),
            scaling_min=torch.where(alive, scalings, inf).amin(),
            scaling_max=torch.where(alive, scalings, -inf).amax(),
            interval_num=interval_num,
        )

    @property
    def box_num(self) -> int:
        return self.interval_num**3

    def normalize(self, scene) -> TensorScene:
        """Affine-map xyz and log-scaling into [0, 1]."""
        scene = TensorScene.of(scene)
        return scene.replace(
            xyz=(scene.get_xyz - self.world_min) / (self.world_max - self.world_min),
            scaling=(scene.scaling - self.scaling_min) / (self.scaling_max - self.scaling_min),
        )

    def denormalize(self, scene) -> TensorScene:
        """Inverse affine map."""
        scene = TensorScene.of(scene)
        return scene.replace(
            xyz=scene.get_xyz * (self.world_max - self.world_min) + self.world_min,
            scaling=scene.scaling * (self.scaling_max - self.scaling_min) + self.scaling_min,
        )

    def voxel_ids(self, xyz_norm: torch.Tensor) -> torch.Tensor:
        """Linear voxel id with x-fastest scan order."""
        n = self.interval_num
        cell = torch.clamp((xyz_norm * n).to(torch.int32), 0, n - 1)
        return cell[:, 0] + n * cell[:, 1] + n * n * cell[:, 2]

    def box_sort(self, scene) -> torch.Tensor:
        """Normalize, flatten to tokens, order by voxel (stable: original
        order within a voxel). Returns [C, 26] sorted tokens; dead slots sort
        to the end."""
        normalized = self.normalize(scene)
        tokens = flatten_gaussians(normalized)
        ids = self.voxel_ids(normalized.xyz)
        ids = torch.where(scene.alive, ids, torch.full_like(ids, self.box_num))
        order = torch.sort(ids, stable=True).indices
        return tokens[order]
