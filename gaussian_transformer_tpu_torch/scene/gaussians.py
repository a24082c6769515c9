"""GaussianScene as an ``nn.Module`` (port of
``gaussian_transformer_tpu/scene/gaussians.py``).

Same learnable tensors and activation pairs as the reference (exp/log
scaling, sigmoid opacity, normalized quaternion rotation, SH features split
DC/rest), held as ``nn.Parameter``s at a static ``capacity`` with an ``alive``
buffer, so densify slot edits and optimizer state map one to one onto the
JAX layout. PLY save/load keeps the reference's field order.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from gaussian_transformer_tpu_torch.device import resolve_device
from gaussian_transformer_tpu_torch.scene.ply import read_ply_vertex_table, write_ply_vertex_table

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


class GaussianScene(nn.Module):
    """Per-Gaussian parameters at fixed capacity.

    Shapes (C = capacity, R = (max_sh_degree+1)^2 - 1 rest coefficients):
      xyz [C,3], features_dc [C,1,3], features_rest [C,R,3], scaling [C,3] (log),
      rotation [C,4] (unnormalized wxyz), opacity [C,1] (logit), alive [C] bool.
    A fresh scene is the reference's ``GaussianScene.empty``: every slot dead.
    """

    def __init__(self, capacity: int, max_sh_degree: int, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        rest = (max_sh_degree + 1) ** 2 - 1
        kw = dict(device=device, dtype=dtype)
        self.xyz = nn.Parameter(torch.zeros(capacity, 3, **kw))
        self.features_dc = nn.Parameter(torch.zeros(capacity, 1, 3, **kw))
        self.features_rest = nn.Parameter(torch.zeros(capacity, rest, 3, **kw))
        self.scaling = nn.Parameter(torch.full((capacity, 3), -10.0, **kw))
        rotation = torch.zeros(capacity, 4, **kw)
        rotation[:, 0] = 1.0
        self.rotation = nn.Parameter(rotation)
        self.opacity = nn.Parameter(torch.full((capacity, 1), -10.0, **kw))
        self.register_buffer("alive", torch.zeros(capacity, dtype=torch.bool, device=device))
        self.active_sh_degree = 0
        self.max_sh_degree = max_sh_degree

    @classmethod
    def empty(cls, capacity: int, max_sh_degree: int, device=None) -> "GaussianScene":
        return cls(capacity, max_sh_degree, device)

    # ---- derived quantities (activation pairs) ----

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_alive(self):
        return int(self.alive.sum())

    @property
    def get_scaling(self):
        return torch.exp(self.scaling)

    @property
    def get_rotation(self):
        n = torch.linalg.vector_norm(self.rotation, dim=-1, keepdim=True)
        return self.rotation / torch.clamp(n, min=1e-12)

    @property
    def get_xyz(self):
        return self.xyz

    @property
    def get_features(self):
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    @property
    def get_opacity(self):
        # Dead slots contribute zero opacity so they never render.
        return torch.sigmoid(self.opacity) * self.alive[:, None].to(self.opacity.dtype)

    @torch.no_grad()
    def set_fields(self, fields: Dict[str, np.ndarray], n: Optional[int] = None) -> "GaussianScene":
        """Write the first ``n`` slots of each given field (numpy arrays in the
        JAX package's layouts) and mark them alive; ``alive`` may be given
        explicitly instead."""
        for name in FIELDS:
            if name in fields:
                src = torch.as_tensor(np.array(fields[name]), dtype=self.xyz.dtype)
                getattr(self, name)[: src.shape[0]] = src.to(self.xyz.device)
                n = src.shape[0] if n is None else n
        if "alive" in fields:
            alive = torch.as_tensor(np.array(fields["alive"]), dtype=torch.bool)
            self.alive[: alive.shape[0]] = alive.to(self.alive.device)
        elif n is not None:
            self.alive[:n] = True
        return self

    # ---- PLY interop (field order parity with the reference) ----

    def ply_attribute_names(self):
        names = ["x", "y", "z", "nx", "ny", "nz"]
        names += [f"f_dc_{i}" for i in range(self.features_dc.shape[1] * self.features_dc.shape[2])]
        names += [f"f_rest_{i}" for i in range(self.features_rest.shape[1] * self.features_rest.shape[2])]
        names += ["opacity"]
        names += [f"scale_{i}" for i in range(self.scaling.shape[1])]
        names += [f"rot_{i}" for i in range(self.rotation.shape[1])]
        return names

    @torch.no_grad()
    def save_ply(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        idx = torch.nonzero(self.alive).flatten()
        host = lambda t: t[idx].detach().cpu().numpy()
        n = idx.numel()
        xyz = host(self.xyz)
        normals = np.zeros_like(xyz)
        # Reference layout: [N, 3, K] transposed flatten => channel-major.
        f_dc = host(self.features_dc).transpose(0, 2, 1).reshape(n, -1)
        f_rest = host(self.features_rest).transpose(0, 2, 1).reshape(n, -1)
        attributes = np.concatenate(
            [xyz, normals, f_dc, f_rest, host(self.opacity), host(self.scaling), host(self.rotation)],
            axis=1,
        )
        write_ply_vertex_table(path, self.ply_attribute_names(), attributes.astype(np.float32))

    @classmethod
    def load_ply(cls, path: str, max_sh_degree: int, capacity: Optional[int] = None,
                 device=None) -> "GaussianScene":
        data = read_ply_vertex_table(path)
        n = len(data["x"])
        xyz = np.stack([data["x"], data["y"], data["z"]], axis=1)
        opacity = data["opacity"][:, None]

        f_dc = np.zeros((n, 3, 1), dtype=np.float32)
        for i in range(3):
            f_dc[:, i, 0] = data[f"f_dc_{i}"]

        by_index = lambda prefix: sorted(
            [k for k in data if k.startswith(prefix)], key=lambda s: int(s.split("_")[-1])
        )
        rest_names = by_index("f_rest_")
        if len(rest_names) != 3 * (max_sh_degree + 1) ** 2 - 3:
            raise ValueError(
                f"{path}: {len(rest_names)} f_rest fields do not match SH degree {max_sh_degree}"
            )
        f_rest = np.stack([data[k] for k in rest_names], axis=1).reshape(
            n, 3, (max_sh_degree + 1) ** 2 - 1
        )
        scaling = np.stack([data[k] for k in by_index("scale_")], axis=1)
        rotation = np.stack([data[k] for k in by_index("rot_")], axis=1)

        if capacity is not None and capacity < n:
            raise ValueError(f"{path}: {n} Gaussians exceed capacity {capacity}")
        scene = cls(capacity or n, max_sh_degree, device)
        # Stored channel-major [N, 3, K]; in-memory layout is [N, K, 3].
        scene.set_fields({
            "xyz": xyz,
            "features_dc": f_dc.transpose(0, 2, 1),
            "features_rest": f_rest.transpose(0, 2, 1),
            "opacity": opacity,
            "scaling": scaling,
            "rotation": rotation,
        })
        scene.active_sh_degree = max_sh_degree
        return scene
