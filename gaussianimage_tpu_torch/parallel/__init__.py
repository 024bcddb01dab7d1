"""Sharded fitting over a (data, gauss, tile) process mesh on
``torch.distributed`` (counterpart of gaussianimage_tpu/parallel)."""

from gaussianimage_tpu_torch.parallel.mesh import (
    make_mesh,
    maybe_initialize_distributed,
    mesh_axes_for,
)
from gaussianimage_tpu_torch.parallel.fit import (
    init_sharded_fit,
    make_sharded_train_step,
    sharded_render,
)

__all__ = [
    "make_mesh",
    "maybe_initialize_distributed",
    "mesh_axes_for",
    "init_sharded_fit",
    "make_sharded_train_step",
    "sharded_render",
]
