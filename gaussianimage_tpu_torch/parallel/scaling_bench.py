"""Sharded-fit scaling probe (counterpart of
gaussianimage_tpu/parallel/scaling_bench.py): pixels/s of the sharded
train step on the ranks it is launched on, against one rank.

Three measurements, each running the full sharded step (all-reduced
renders and gradients), each against the same one-rank baseline (rank 0
alone, a 1 x 1 x 1 mesh, no collective):

- **strong**: one image, one point count; the ranks split the work over
  the (gauss, tile) axes. Efficiency = pixels/s / (one-rank pixels/s * n).
- **strong_tile_fused**: the same image over the tile axis alone (gauss
  1: the fused K3 step on each row slice), with replicated and with
  tile-sharded (ZeRO-1, ``shard_opt``) optimizer state.
- **weak_data**: n independent images over the data axis.

The meshes are the one-rank baseline and the launch's world size (launch
with 2, 4, ... processes for the sizes between). Steps are timed with CUDA
events on the card (the host clock under ``--device cpu``), the slowest
rank's time counting. One JSON line on rank 0 names the backend, the
device and the world size. ``comm_accounting`` gives each mesh's analytic
collective bytes a step.

    python -m gaussianimage_tpu_torch.parallel.scaling_bench
    torchrun --nproc_per_node 4 -m gaussianimage_tpu_torch.parallel.scaling_bench
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from gaussianimage_tpu_torch import resolve_device

PARAM_COLS = 8  # per-gaussian trainable columns (xyz 2 + cholesky 3 + color 3)


def _axes_compute(nd: int):
    """Split nd devices over (gauss, tile) only: strong scaling."""
    tile = 1
    gauss = nd
    if nd % 2 == 0:
        tile, gauss = 2, nd // 2
    return {"data": 1, "gauss": gauss, "tile": tile}


def comm_accounting(H: int, W: int, num_points: int, param_cols: int,
                    axes: dict, shard_opt: bool = False) -> dict:
    """Analytic per-step collective volume (bytes) for the sharded train
    step — what actually rides the links each iteration.

    - ``gauss`` axis (size g>1): ONE image psum per render; each shard
      contributes its [H/t, W, 3] f32 partial. Ring all-reduce wire cost =
      2(g-1)/g x logical bytes.
    - ``tile`` axis (size t>1): ONE gradient combine per backward over the
      local parameter leaves ([N/g, cols] f32). Replicated-opt all-reduce
      = 2(t-1)/t x B; shard_opt = reduce_scatter (t-1)/t x B + params
      all_gather (t-1)/t x B (same wire bytes, t-fold less optimizer math
      and moment memory).
    """
    g, t = axes.get("gauss", 1), axes.get("tile", 1)
    out = {}
    h_loc = H // max(t, 1)
    img_bytes = h_loc * W * 3 * 4
    out["gauss_psum_logical_bytes"] = img_bytes if g > 1 else 0
    out["gauss_psum_wire_bytes"] = (
        int(2 * (g - 1) / g * img_bytes) if g > 1 else 0)
    grad_bytes = (num_points // max(g, 1)) * param_cols * 4
    out["tile_grad_logical_bytes"] = grad_bytes if t > 1 else 0
    if t > 1:
        if shard_opt:
            wire = int((t - 1) / t * grad_bytes) * 2  # scatter + gather
        else:
            wire = int(2 * (t - 1) / t * grad_bytes)
    else:
        wire = 0
    out["tile_grad_wire_bytes"] = wire
    out["total_wire_bytes_per_step"] = (
        out["gauss_psum_wire_bytes"] + out["tile_grad_wire_bytes"])
    return out


def _seconds(device, fn) -> float:
    """Seconds of ``fn()``: CUDA events on the card, the host clock on the
    CPU."""
    if device.type == "cuda":
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def run(n_steps: int = 20, H: int = 256, W: int = 256, N: int = 4096,
        device=None, reps: int = 3) -> dict:
    """The three measurements over the launch's ranks; returns the result
    (printed as one JSON line by rank 0)."""
    from gaussianimage_tpu_torch.models import make_model
    from gaussianimage_tpu_torch.ops import RasterizeConfig
    from gaussianimage_tpu_torch.parallel import (
        init_sharded_fit, make_mesh, make_sharded_train_step)
    from gaussianimage_tpu_torch.parallel.mesh import AXES, Mesh
    from gaussianimage_tpu_torch.utils.image_io import synthetic_image

    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    raster = RasterizeConfig(tile_px=16)

    def best_px(axes, D, shard_opt=False, alone=False):
        """Pixels/s of the best of ``reps`` chunks of ``n_steps`` steps on
        the mesh ``axes`` (``alone``: rank 0 by itself), the slowest
        rank's time counting."""
        mesh = (Mesh({k: 1 for k in AXES}, 0, {k: None for k in AXES})
                if alone else make_mesh(dict(axes)))
        model = make_model("GaussianImage_Cholesky", device=device,
                           num_points=N, H=H, W=W, raster=raster,
                           block_h=16, block_w=16)
        images = np.concatenate(
            [synthetic_image(H, W, seed=i) for i in range(D)], axis=0)
        state = init_sharded_fit(model, mesh, images, shard_opt=shard_opt)
        step = make_sharded_train_step(model, mesh, n_steps=n_steps,
                                       shard_opt=shard_opt)
        step(state)  # warm-up: the kernels' first launches
        best = min(_seconds(device, lambda: step(state))
                   for _ in range(reps))
        if not alone and world > 1:
            t = torch.tensor([best], dtype=torch.float64, device=device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            best = float(t)
        return D * H * W * n_steps / best

    def row(axes, px, shard_opt=False):
        nd = int(np.prod(list(axes.values())))
        return {"devices": nd, "mesh": dict(axes), "pixels_per_s": px,
                "comm_per_step": comm_accounting(H, W, N, PARAM_COLS, axes,
                                                 shard_opt)}

    one = {"data": 1, "gauss": 1, "tile": 1}
    base = best_px(one, 1, alone=True) if rank == 0 else 0.0
    base_so = best_px(one, 1, shard_opt=True, alone=True) if rank == 0 \
        else 0.0
    if world > 1:  # rank 0's baseline to every rank
        t = torch.tensor([base, base_so], dtype=torch.float64, device=device)
        dist.all_reduce(t)
        base, base_so = (float(v) for v in t)
    strong = [row(one, base)]
    tile_row = row(one, base)
    tile_row.update(pixels_per_s_shard_opt=base_so,
                    comm_per_step_shard_opt=comm_accounting(
                        H, W, N, PARAM_COLS, one, True))
    strong_tile, weak = [tile_row], [row(one, base)]
    if world > 1:
        axes = _axes_compute(world)
        strong.append(row(axes, best_px(axes, 1)))
        if H // (world * 16) >= 1 and (H // world) % 16 == 0:
            axes = {"data": 1, "gauss": 1, "tile": world}
            r = row(axes, best_px(axes, 1))
            so = best_px(axes, 1, shard_opt=True)
            r.update(pixels_per_s_shard_opt=so,
                     comm_per_step_shard_opt=comm_accounting(
                         H, W, N, PARAM_COLS, axes, True))
            strong_tile.append(r)
        axes = {"data": world, "gauss": 1, "tile": 1}
        weak.append(row(axes, best_px(axes, world)))
    for rows in (strong, strong_tile, weak):
        for r in rows:
            r["efficiency"] = r["pixels_per_s"] / (base * r["devices"])
    result = {"backend": dist.get_backend() if dist.is_initialized()
              else "none (one process)",
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "world_size": world,
              "problem": {"H": H, "W": W, "num_points": N,
                          "steps_timed": n_steps, "tile_px": 16},
              "strong": strong, "strong_tile_fused": strong_tile,
              "weak_data": weak}
    if rank == 0:
        print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    from gaussianimage_tpu_torch.parallel import maybe_initialize_distributed

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu (the plain kernels, gloo)")
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.device)
    maybe_initialize_distributed("gloo" if device.type == "cpu" else None)
    run(device=device)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
