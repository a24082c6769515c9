"""Process groups, the device mesh and which rows and cameras a rank holds
(port of ``gaussian_transformer_tpu/parallel/mesh.py``).

One process per card, launched by ``torchrun``: ``init_distributed`` joins
the process group (NCCL for a CUDA device, gloo for the CPU), and
``make_mesh`` lays the world out as a ``DeviceMesh`` with dims
``("data", "gauss")``:

  * ``data``  -- cameras (losses averaged over the global batch, gradients
    summed),
  * ``gauss`` -- the Gaussian capacity axis: a rank holds a contiguous 1/n of
    every per-Gaussian leaf and of its Adam moments.

The shardings are ``DTensor`` placements over the mesh's two dims; a rank's
piece of a tensor is ``local_piece`` (contiguous rows of dim 0 per
``Shard(0)``), and tensors stay ordinary tensors: the step's collectives
are explicit (``parallel/collectives.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from gaussian_transformer_tpu_torch.train.optim import PARAM_LEAVES, AdamState

SCENE_LEAVES = PARAM_LEAVES + ("alive",)


def init_distributed(device=None, init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, timeout_s: float = 600.0) -> None:
    """Join the default process group: NCCL when ``device`` is a CUDA device
    (after ``torch.cuda.set_device(LOCAL_RANK)``), gloo otherwise. Without
    ``init_method`` the ``torchrun`` environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) is read. A no-op when the
    group is already initialised. NCCL failing raises: there is no fallback
    to gloo on a card."""
    if dist.is_initialized():
        return
    device = torch.device(device if device is not None else "cuda")
    if init_method is None and "WORLD_SIZE" not in os.environ:
        # A plain one-process run (no torchrun): a world of one.
        init_method, world_size, rank = f"tcp://localhost:{free_port()}", 1, 0
    kw = {}
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", device.index or 0))
        torch.cuda.set_device(local)
        backend = "nccl"
        kw["device_id"] = torch.device("cuda", local)
    else:
        backend = "gloo"
    if init_method is not None:
        kw.update(init_method=init_method, world_size=world_size, rank=rank)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def world_size() -> int:
    """The world's size: the group's once initialised, else torchrun's
    ``WORLD_SIZE`` (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))


def is_lead() -> bool:
    """Rank 0, or no process group: the process that writes files and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def seed_host_random_alike() -> int:
    """Seed Python's ``random`` on every rank with one seed drawn on rank 0,
    so host-side shuffles (the ``Scene``'s camera order) agree across ranks
    and still differ from run to run. Returns the seed."""
    import random

    seed = torch.tensor([random.randrange(2**62) if dist.get_rank() == 0 else 0], dtype=torch.int64,
                        device=world_device_type())
    dist.broadcast(seed, src=0)
    random.seed(int(seed.item()))
    return int(seed.item())


def world_device_type() -> str:
    """"cuda" under NCCL, "cpu" under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(data: int = 1, gauss: Optional[int] = None) -> DeviceMesh:
    """A ``("data", "gauss")`` mesh over the whole world (``gauss`` defaults
    to world / data)."""
    n = dist.get_world_size()
    if gauss is None:
        if n % data:
            raise ValueError(f"{n} ranks not divisible by data={data}")
        gauss = n // data
    if data * gauss != n:
        raise ValueError(f"mesh {data} x {gauss} does not cover {n} ranks")
    return init_device_mesh(world_device_type(), (data, gauss), mesh_dim_names=("data", "gauss"))


def coordinate(mesh: DeviceMesh, dim: str) -> int:
    """This rank's index along mesh dim ``dim``."""
    return mesh.get_local_rank(dim)


def replicated(mesh: DeviceMesh) -> tuple:
    """Placements of a tensor every rank holds whole."""
    return (Replicate(),) * mesh.ndim


def scene_sharding(mesh: DeviceMesh) -> dict:
    """Placements of a scene's leaves: every per-Gaussian leaf sharded on its
    capacity axis over ``gauss``, replicated over ``data``."""
    return {k: (Replicate(), Shard(0)) for k in SCENE_LEAVES}


def camera_batch_sharding(mesh: DeviceMesh) -> tuple:
    """Placements of a camera batch: its leading axis over ``data``."""
    return (Shard(0), Replicate())


def camera_rows(n_cams: int, mesh: DeviceMesh) -> slice:
    """The rows of a camera batch of ``n_cams`` this rank holds
    (``camera_batch_sharding``)."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    if n_cams % n:
        raise ValueError(f"camera batch {n_cams} not divisible by the data axis ({n})")
    k, i = n_cams // n, coordinate(mesh, "data")
    return slice(i * k, (i + 1) * k)


def local_piece(x: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's piece of a global tensor: contiguous, equal rows of dim 0
    per ``Shard(0)`` mesh dim (the outer dim's split first)."""
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            if p.dim != 0:
                raise ValueError(f"only dim-0 sharding is supported, got {p}")
            n = mesh.size(mesh.mesh_dim_names.index(name))
            if x.shape[0] % n:
                raise ValueError(f"{x.shape[0]} rows are not divisible by the {name} axis ({n})")
            k = x.shape[0] // n
            i = coordinate(mesh, name)
            x = x[i * k:(i + 1) * k]
    return x


def shard_scene(scene, mesh: DeviceMesh):
    """A new ``GaussianScene`` of this rank's capacity rows (``scene_sharding``).
    The capacity must be divisible by the gauss axis (capacity padding
    makes that free)."""
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene

    sh = scene_sharding(mesh)
    pieces = {k: local_piece(getattr(scene, k).detach(), mesh, sh[k]) for k in SCENE_LEAVES}
    out = GaussianScene(pieces["xyz"].shape[0], scene.max_sh_degree, device=scene.xyz.device)
    with torch.no_grad():
        for k in PARAM_LEAVES:
            getattr(out, k).copy_(pieces[k])
        out.alive.copy_(pieces["alive"])
    out.active_sh_degree = scene.active_sh_degree
    return out


def adam_sharding(mesh: DeviceMesh, adam: AdamState) -> AdamState:
    """Placements of the Adam state: moments as the parameters, counts
    replicated."""
    gauss = (Replicate(), Shard(0))
    return AdamState(mu={k: gauss for k in PARAM_LEAVES}, nu={k: gauss for k in PARAM_LEAVES},
                     counts={k: replicated(mesh) for k in PARAM_LEAVES})


def shard_adam(adam: AdamState, mesh: DeviceMesh) -> AdamState:
    """This rank's piece of the Adam state (``adam_sharding``)."""
    sh = adam_sharding(mesh, adam)
    return AdamState(mu={k: local_piece(v, mesh, sh.mu[k]).clone() for k, v in adam.mu.items()},
                     nu={k: local_piece(v, mesh, sh.nu[k]).clone() for k, v in adam.nu.items()},
                     counts={k: v.clone() for k, v in adam.counts.items()})
