"""FSDP sharding of the transformer trainers' parameters and optimizer
state (port of ``gaussian_transformer_tpu/parallel/fsdp.py``).

``leaf_spec`` is the JAX package's rule: a parameter is sharded along its
LARGEST dimension divisible by the axis size, and leaves under ``min_size``
elements (norm scales, biases) stay replicated. ``shard_model`` applies it
with FSDP2: ``fully_shard`` on every ``EncoderLayer``/``DecoderLayer`` and
on the root, ``leaf_spec``'s dimension through ``shard_placement_fn``, and
the replicated leaves passed as ``ignored_params`` (their gradients are
averaged by ``reduce_replicated_grads``). On a ``("data", "fsdp")`` mesh
FSDP2 shards over ``fsdp`` and replicates over ``data`` (its HSDP form):
the gradients are averaged over the whole mesh, which is the mean over the
data axis's windows.

The optimizer's state follows the parameters: torch's Adam and Adamax keep
their moments as DTensors beside the shards (``foreach=False``, since the
replicated leaves are plain tensors). The campaign's Adafactor is never
sharded, in the JAX package or here. ``full_tensor`` gathers a shard into
the whole tensor (a collective: every rank calls it), which is how the
trainers write checkpoints that the unsharded trainers read.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from gaussian_transformer_tpu_torch.parallel.mesh import world_device_type

FSDP_AXIS = "fsdp"


def make_fsdp_mesh(n: Optional[int] = None, axis: str = FSDP_AXIS) -> DeviceMesh:
    """A one-dim mesh over the world (``n`` must be the world size)."""
    n = dist.get_world_size() if n is None else n
    if n != dist.get_world_size():
        raise ValueError(f"an fsdp mesh of {n} over a world of {dist.get_world_size()} ranks")
    return init_device_mesh(world_device_type(), (n,), mesh_dim_names=(axis,))


def leaf_spec(x, axis_size: int, axis: str, min_size: int = 1 << 16) -> tuple:
    """The partition spec of one array, as a tuple (the JAX package's
    ``PartitionSpec``): ``axis`` on the largest divisible dim, or () for a
    replicated (small or indivisible) leaf."""
    shape = tuple(getattr(x, "shape", ()))
    if not shape or int(np.prod(shape)) < min_size:
        return ()
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % axis_size == 0 and shape[d] >= axis_size:
            spec = [None] * len(shape)
            spec[d] = axis
            return tuple(spec)
    return ()


def shard_model(model: nn.Module, mesh: DeviceMesh, axis: str = FSDP_AXIS, min_size: int = 1 << 16) -> nn.Module:
    """FSDP2 on ``model`` in place (``leaf_spec`` per parameter). Returns the
    model; ``model.fsdp_replicated`` lists the leaves left whole."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    from gaussian_transformer_tpu_torch.models.transformer import DecoderLayer, EncoderLayer

    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if mesh.size() != dist.get_world_size():
        raise ValueError("the fsdp mesh must cover every rank")
    spec = {p: leaf_spec(p, n, axis, min_size) for p in model.parameters()}
    replicated = [p for p, s in spec.items() if not s]

    def placement(p):
        return Shard(spec[p].index(axis))

    def wrap(module):
        own = set(module.parameters())
        fully_shard(module, mesh=mesh, shard_placement_fn=placement,
                    ignored_params={p for p in replicated if p in own})

    for layer in [m for m in model.modules() if isinstance(m, (EncoderLayer, DecoderLayer))]:
        wrap(layer)
    wrap(model)
    # The trainers call these, not forward: each gathers the root's own
    # shards (embeddings, final norms, head) as forward would.
    for name in ("encode", "decode", "generator"):
        if hasattr(model, name):
            register_fsdp_forward_method(model, name)
    model.fsdp_replicated = replicated
    return model


def is_sharded(model: nn.Module) -> bool:
    return hasattr(model, "fsdp_replicated")


@torch.no_grad()
def reduce_replicated_grads(model: nn.Module) -> None:
    """Average the gradients of the leaves ``shard_model`` left whole over
    every rank (FSDP2 averages the sharded ones)."""
    from gaussian_transformer_tpu_torch.parallel import collectives as cc

    grads = [p.grad for p in model.fsdp_replicated if p.grad is not None]
    if grads:
        for g, mean in zip(grads, cc.all_reduce_tensors(grads, None, "mean")):
            g.copy_(mean)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor shard (a collective), else ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def like(full: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as ``ref``: this rank's shard when ``ref`` is a
    DTensor, else ``full`` itself."""
    if isinstance(ref, DTensor):
        return distribute_tensor(full.to(ref.device), ref.device_mesh, ref.placements)
    return full
