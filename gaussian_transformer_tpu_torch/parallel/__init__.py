"""The multi-device tier (port of ``gaussian_transformer_tpu/parallel/``).

The JAX package annotates shardings and lets XLA place the collectives; the
port runs one process per card (``torchrun``), with explicit
``torch.distributed`` process groups and autograd-aware collectives whose
backwards are the transposes ``shard_map`` uses (``collectives.py``). The
backend follows the device: NCCL for CUDA tensors, gloo for CPU tensors
(the tests and ``--device cpu``).

  * ``mesh.py`` -- ``init_distributed``, the ``("data", "gauss")`` mesh and
    which capacity rows and cameras a rank holds;
  * ``step.py`` -- the camera-batched, Gaussian-sharded and tile-sharded
    3DGS train steps; ``tile_shard.py`` -- the tile-sharded compositor;
  * ``ring.py``, ``ulysses.py`` -- sequence-parallel attention;
  * ``fsdp.py`` -- FSDP2 sharding of the transformer trainers;
  * ``health.py`` -- heartbeat, crash save, NaN guard; ``audit.py`` -- the
    collectives a step issued.
"""

from gaussian_transformer_tpu_torch.parallel.mesh import (
    camera_batch_sharding,
    make_mesh,
    replicated,
    scene_sharding,
)
from gaussian_transformer_tpu_torch.parallel.step import make_sharded_train_step, stack_cameras

__all__ = [
    "make_mesh",
    "scene_sharding",
    "camera_batch_sharding",
    "replicated",
    "stack_cameras",
    "make_sharded_train_step",
]
