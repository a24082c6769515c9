"""Carry a scene, a camera and the training state across from the JAX
package's layouts.

The inputs are numpy arrays exactly as the JAX ``GaussianScene`` fields,
``Camera`` arrays, ``AdamState`` and ``DensifyStats`` hold them, so both
packages render, and train, the same scene from the same camera and state.
No JAX import: the caller converts with ``np.asarray``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.scene.cameras import Camera
from gaussian_transformer_tpu_torch.scene.gaussians import FIELDS, GaussianScene


def scene_from_numpy(fields: Dict[str, np.ndarray], active_sh_degree: int, device=None) -> GaussianScene:
    """``fields``: xyz [C,3], features_dc [C,1,3], features_rest [C,R,3],
    scaling [C,3] (log), rotation [C,4], opacity [C,1] (logit), alive [C]."""
    missing = [k for k in FIELDS + ("alive",) if k not in fields]
    if missing:
        raise KeyError(f"missing scene fields: {missing}")
    capacity = np.asarray(fields["xyz"]).shape[0]
    rest = np.asarray(fields["features_rest"]).shape[1]
    max_sh_degree = int(round(np.sqrt(rest + 1))) - 1
    if (max_sh_degree + 1) ** 2 - 1 != rest:
        raise ValueError(f"{rest} SH rest coefficients match no degree")
    scene = GaussianScene(capacity, max_sh_degree, device)
    scene.set_fields(fields)
    scene.active_sh_degree = active_sh_degree
    return scene


def camera_from_numpy(world_view_transform, full_proj_transform, camera_center, fovx: float,
                      fovy: float, image_width: int, image_height: int, device=None,
                      image_name: str = "", uid: int = 0, original_image=None) -> Camera:
    """A camera from the JAX ``Camera``'s arrays (transposed row-vector
    matrices), unchanged."""
    device = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32), device=device)
    return Camera(
        uid=uid,
        colmap_id=uid,
        image_name=image_name,
        image_width=int(image_width),
        image_height=int(image_height),
        fovx=float(fovx),
        fovy=float(fovy),
        world_view_transform=as_t(world_view_transform),
        full_proj_transform=as_t(full_proj_transform),
        camera_center=as_t(camera_center),
        original_image=None if original_image is None else as_t(original_image),
    )


def adam_from_numpy(mu: Dict[str, np.ndarray], nu: Dict[str, np.ndarray],
                    counts: Dict[str, np.ndarray], device=None):
    """An ``AdamState`` from the JAX one's mu, nu and per-leaf counts."""
    from gaussian_transformer_tpu_torch.train.optim import AdamState

    device = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32), device=device)
    return AdamState(mu={k: as_t(v) for k, v in mu.items()},
                     nu={k: as_t(v) for k, v in nu.items()},
                     counts={k: as_t(v).reshape(()) for k, v in counts.items()})


def stats_from_numpy(xyz_gradient_accum, denom, max_radii2d, device=None):
    """``DensifyStats`` from the JAX one's three [C] arrays."""
    from gaussian_transformer_tpu_torch.scene.densify import DensifyStats

    device = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32), device=device)
    return DensifyStats(xyz_gradient_accum=as_t(xyz_gradient_accum), denom=as_t(denom),
                        max_radii2d=as_t(max_radii2d))
