"""The multi-device layer on ``torch.distributed``.

Port of easygaussiansplatting_tpu/parallel/: a (data, gs) mesh of ranks
(``mesh.py``), cameras over ``data`` and the gaussian pool over ``gs``, with
the collectives JAX's GSPMD inserted written out (``collectives.py``); the
batched and banded training steps and the sharded render (``train.py``),
the epoch loop (``loop.py``) and multi-process start-up
(``distributed.py``).
"""

from easygaussiansplatting_tpu_torch.parallel.mesh import make_mesh
from easygaussiansplatting_tpu_torch.parallel.train import (
    make_sharded_train_step,
    pool_shardings,
    shard_pool,
    stack_cameras,
)

__all__ = [
    "make_mesh",
    "make_sharded_train_step",
    "pool_shardings",
    "shard_pool",
    "stack_cameras",
]
