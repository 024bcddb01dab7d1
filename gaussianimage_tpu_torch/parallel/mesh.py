"""The (data, gauss, tile) process mesh over ``torch.distributed``
(counterpart of gaussianimage_tpu/parallel/mesh.py).

One process drives one card (or the CPU). Axes:

- ``data``  one image per shard: independent fits, no collective a step;
- ``gauss`` the N Gaussians split in N/g rows; the partial images combine
            with one all-reduce a render (blending is a commutative sum);
- ``tile``  the image's rows split in H/t slices; the gradients combine
            with one all-reduce (or, under ``shard_opt``, a reduce-scatter
            and an all-gather) a step.

``maybe_initialize_distributed`` starts the process group when a launcher
advertises more than one process (torchrun's ``WORLD_SIZE`` / ``RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT``, or SLURM with more than one task), and
ignores single-worker environments. ``make_mesh`` lays the ranks out
row-major over (data, gauss, tile), so a rank's data index is the slowest
to vary and the ranks of one (gauss, tile) block are neighbours: launched
host by host, the per-step collectives stay within a host. With one
process and no launcher the mesh is 1 x 1 x 1; an axis of size 1 gets no
process group, and every collective over it is skipped.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

AXES = ("data", "gauss", "tile")


def _count(value: Optional[str]) -> int:
    """A launcher's process count from its environment variable (0 when
    unset or not a number)."""
    try:
        return int(value) if value else 0
    except ValueError:
        return 0


def maybe_initialize_distributed(backend: Optional[str] = None) -> bool:
    """Start the default process group when a launcher advertises more than
    one process: torchrun (``WORLD_SIZE`` > 1 with ``RANK``, and
    ``MASTER_ADDR`` / ``MASTER_PORT``) or SLURM (``SLURM_NTASKS`` > 1 with
    ``SLURM_PROCID``; the rendezvous address from ``MASTER_ADDR`` /
    ``MASTER_PORT``). A single-worker environment (``WORLD_SIZE=1``,
    ``SLURM_NTASKS=1``, one SLURM node) starts nothing. The backend is
    NCCL where CUDA is available and gloo otherwise, unless named; under
    NCCL the process takes the card of its local rank (``LOCAL_RANK`` or
    ``SLURM_LOCALID``). Safe to call again.

    Returns True if a process group is (now) initialized."""
    if dist.is_initialized():
        return True
    env = os.environ
    if _count(env.get("WORLD_SIZE")) > 1 and "RANK" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local = _count(env.get("LOCAL_RANK"))
    elif _count(env.get("SLURM_NTASKS")) > 1 and "SLURM_PROCID" in env:
        world, rank = int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"])
        local = _count(env.get("SLURM_LOCALID"))
    else:
        return False
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if not env.get(k)]
    if missing:
        raise RuntimeError(
            f"a launch of {world} processes needs {' and '.join(missing)} "
            "for the rendezvous (torchrun sets them)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank)
    return True


def mesh_axes_for(n_devices: int, want_data: bool = True,
                  want_gauss: bool = True, want_tile: bool = True
                  ) -> Dict[str, int]:
    """Factor n_devices into (data, gauss, tile) axis sizes, preferring to
    give the compute axes (gauss/tile) the small fast dimensions."""
    sizes = {"data": 1, "gauss": 1, "tile": 1}
    rem = n_devices
    if want_tile and rem % 2 == 0:
        sizes["tile"] = 2
        rem //= 2
    if want_gauss and rem % 2 == 0:
        sizes["gauss"] = 2
        rem //= 2
    if want_data:
        sizes["data"] = rem
        rem = 1
    elif want_gauss:
        sizes["gauss"] *= rem
        rem = 1
    if rem != 1 and (want_data or want_gauss):
        raise ValueError(f"cannot factor {n_devices} devices")
    return sizes


class Mesh:
    """This process's place in the (data, gauss, tile) mesh: the axis sizes
    (``shape``), its index on each axis and the process group of each axis
    it shares with other ranks (None for an axis of size 1)."""

    def __init__(self, shape: Dict[str, int], rank: int, groups: Dict):
        self.shape = dict(shape)
        self.rank = rank
        t, g = shape["tile"], shape["gauss"]
        self.coords = {"data": rank // (g * t), "gauss": (rank // t) % g,
                       "tile": rank % t}
        self.groups = groups

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def _rank_of(coords, shape) -> int:
    return ((coords["data"] * shape["gauss"] + coords["gauss"])
            * shape["tile"] + coords["tile"])


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """The (data, gauss, tile) mesh over the default process group (a
    1 x 1 x 1 mesh when there is none), ranks row-major: rank = (d g + gi)
    t + ti. Builds one process group for each line of ranks along each axis
    of size > 1 (every rank takes part in every ``new_group`` call, in the
    same order) and keeps the ones this rank is on."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if axis_sizes is None:
        axis_sizes = mesh_axes_for(world)
    shape = {k: int(axis_sizes.get(k, 1)) for k in AXES}
    unknown = set(axis_sizes) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; axes: {AXES}")
    need = shape["data"] * shape["gauss"] * shape["tile"]
    if need != world:
        raise ValueError(f"mesh {shape} needs {need} processes, the launch "
                         f"has {world}")
    groups = {k: None for k in AXES}
    for axis in AXES:
        if shape[axis] == 1:
            continue
        others = [k for k in AXES if k != axis]
        for a in range(shape[others[0]]):
            for b in range(shape[others[1]]):
                ranks = [_rank_of({others[0]: a, others[1]: b, axis: i},
                                  shape) for i in range(shape[axis])]
                pg = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = pg
    return Mesh(shape, rank, groups)
