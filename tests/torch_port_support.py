"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
carry JAX scenes and cameras into the port."""

import numpy as np
from gaussian_transformer_tpu_torch.convert import camera_from_numpy, scene_from_numpy

SCENE_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "alive")


def torch_scene(jax_scene, device="cpu"):
    fields = {k: np.asarray(getattr(jax_scene, k)) for k in SCENE_FIELDS}
    return scene_from_numpy(fields, jax_scene.active_sh_degree, device)


def torch_camera(cam, device="cpu"):
    return camera_from_numpy(
        np.asarray(cam.world_view_transform), np.asarray(cam.full_proj_transform),
        np.asarray(cam.camera_center), cam.fovx, cam.fovy, cam.image_width,
        cam.image_height, device,
    )

