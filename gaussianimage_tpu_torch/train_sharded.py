"""Sharded dataset fitting CLI, the multi-process counterpart of train.py
(counterpart of gaussianimage_tpu/train_sharded.py).

One process a shard of a (data, gauss, tile) mesh over
``torch.distributed`` (parallel/): each data shard fits its own image,
the Gaussians split over the gauss axis and the image rows over the tile
axis, combined with all-reduces (parallel/fit.py). Images are fitted in
groups of the data-axis size, of one shape each (the dataset is bucketed
by shape first, so datasets with both orientations fit every image), the
last group of a shape padded by repeating its last image. Per image:
``gaussian_model.npz`` (the JAX package's checkpoint format) and
``training.npy`` with the JAX sharded CLI's keys; ``train.txt`` in the
run's folder with its lines, and after each image's line the PSNR of its
final state (a render of the gathered parameters on rank 0), which a
reader can hold a render of the checkpoint to.

Launch:
    # one process (a 1 x 1 x 1 mesh), on the card:
    python -m gaussianimage_tpu_torch.train_sharded --data_name photos \\
        -d data --num_points 10000
    # several, one a card, e.g. (data, gauss, tile) = (2, 1, 2):
    torchrun --nproc_per_node 4 -m gaussianimage_tpu_torch.train_sharded \\
        --data_name kodak -d datasets/kodak --mesh 2,1,2

The process group starts when the launcher advertises more than one
process (``maybe_initialize_distributed``): NCCL on the card, gloo under
``--device cpu``. Rank 0 writes every file. ``--resume`` skips finished
groups and continues a group from its snapshot ``resume_<image>.pt``,
written by rank 0 every ``--ckpt_every`` iterations from the gathered
shards (parameters, Adan's moments and counts, the iteration).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from gaussianimage_tpu_torch import resolve_device
from gaussianimage_tpu_torch.datasets import iterate_dataset
from gaussianimage_tpu_torch.models import make_model
from gaussianimage_tpu_torch.ops import RasterizeConfig
from gaussianimage_tpu_torch.parallel import (
    init_sharded_fit, make_mesh, make_sharded_train_step,
    maybe_initialize_distributed, mesh_axes_for)
from gaussianimage_tpu_torch.parallel.fit import (gather_fit, image_metrics,
                                                  load_fit)
from gaussianimage_tpu_torch.utils.checkpoint import save_checkpoint
from gaussianimage_tpu_torch.utils.logwriter import LogWriter


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", "--dataset", type=str, default="./datasets/kodak/")
    p.add_argument("--data_name", type=str, default="synthetic")
    p.add_argument("--model_name", type=str,
                   default="GaussianImage_Cholesky",
                   help="any 2D model exposing splat() (Cholesky, RS, "
                        "wMask): the sharded step is model-agnostic")
    p.add_argument("--iterations", type=int, default=50000)
    p.add_argument("--num_points", type=int, default=10000)
    p.add_argument("--chunk_size", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--checkpoint_root", type=str, default="./checkpoints")
    p.add_argument("--ckpt_every", type=int, default=10000,
                   help="save a mid-fit resume snapshot per image group "
                        "every N iterations; 0 = off")
    p.add_argument("--resume", action="store_true",
                   help="skip finished groups / continue interrupted ones "
                        "from their resume snapshots")
    p.add_argument("--mesh", type=str, default=None,
                   help="data,gauss,tile axis sizes (default: auto from "
                        "the process count)")
    p.add_argument("--tile_px", type=int, default=16,
                   help="raster tile (16 keeps small row-shards whole)")
    p.add_argument("--init_mode", type=str, default="adaptive",
                   choices=["uniform", "adaptive"],
                   help="per-image Gaussian init (core/init.py); 'uniform' "
                        "is the reference behavior")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; each process takes the card of its "
                        "local rank) or cpu (the plain kernels, gloo)")
    return p.parse_args(argv)


def save_resume(path: Path, params, opt, iteration: int) -> None:
    """The group's resume snapshot: the gathered parameters and Adan state
    ([D, N, ...] each) and the iteration, in the port's ``.pt`` form
    (``utils.checkpoint.save_train_state``'s keys), written atomically."""
    snap = {"model": {k: v.cpu() for k, v in params.items()},
            "optimizer": {k: ({n: t.cpu() for n, t in v.items()}
                              if isinstance(v, dict) else v)
                          for k, v in opt.items()},
            "iteration": int(iteration), "aux": {}, "generator": None}
    tmp = str(path) + ".tmp"
    torch.save(snap, tmp)
    os.replace(tmp, str(path))


@torch.no_grad()
def final_psnr(model_name: str, params, images, cfg_kw, device) -> list:
    """Each image's PSNR of its gathered final parameters: a render of
    the whole model (K1), clamped, against the image."""
    out = []
    for di in range(images.shape[0]):
        m = make_model(model_name, device=device, **cfg_kw)
        m.load_state_dict({k: v[di] for k, v in params.items()},
                          strict=False)
        img = m.render()["render"][0]
        gt = torch.as_tensor(images[di], device=device)
        mse = torch.mean((img - gt) ** 2)
        out.append(float(10.0 * torch.log10(1.0 / torch.clamp(mse,
                                                               min=1e-12))))
    return out


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.device)
    maybe_initialize_distributed("gloo" if device.type == "cpu" else None)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.mesh:
        d, g, t = (int(x) for x in args.mesh.split(","))
        axes = {"data": d, "gauss": g, "tile": t}
    else:
        axes = mesh_axes_for(world)
    mesh = make_mesh(axes)
    lead = mesh.rank == 0
    D = axes["data"]

    folder = f"sharded_{args.iterations}_{args.num_points}"
    root = Path(args.checkpoint_root) / args.data_name / folder
    logwriter = LogWriter(root) if lead else None

    def log(text):
        if lead:
            logwriter.write(text)

    log(f"mesh axes: {axes} over {world} processes")

    # group the dataset into data-axis-sized batches of equal-shape images;
    # bucket by shape first so mixed-orientation datasets (kodak has both
    # 768x512 and 512x768) still fit every image
    items = list(iterate_dataset(args.data_name, args.dataset))
    by_shape = {}
    for name, im in items:
        by_shape.setdefault(im.shape, []).append((name, im))
    groups = []
    for shape_items in by_shape.values():
        for base in range(0, len(shape_items), D):
            groups.append(shape_items[base:base + D])
    stats = []
    for group in groups:
        group = list(group)
        while len(group) < D:  # pad the tail group by repeating its last
            group.append(group[-1])
        names = [n for n, _ in group]
        if args.resume and all(
                (root / n / "training.npy").exists() for n in set(names)):
            continue  # whole group already fitted
        images = np.concatenate([im for _, im in group], axis=0)
        H, W = images.shape[2], images.shape[3]
        cfg_kw = dict(num_points=args.num_points, H=H, W=W, lr=args.lr,
                      raster=RasterizeConfig(tile_px=args.tile_px),
                      block_h=args.tile_px, block_w=args.tile_px,
                      init_mode=args.init_mode)
        model = make_model(args.model_name, device=device, **cfg_kw)
        state = init_sharded_fit(model, mesh, images, seed=args.seed)
        it = 0
        resume_path = root / f"resume_{names[0]}.pt"
        if args.resume and resume_path.exists():
            snap = torch.load(str(resume_path), map_location="cpu",
                              weights_only=False)
            load_fit(state, mesh, snap["model"], snap["optimizer"])
            it = snap["iteration"]
            log(f"resumed group {names} at iteration {it}")
        step = make_sharded_train_step(model, mesh, n_steps=args.chunk_size)
        t0 = time.time()
        loss = psnr = None
        warned_overflow = False
        while it < args.iterations:
            loss, psnr, nd = step(state)
            it += args.chunk_size
            lv, pv, ndv = image_metrics(mesh, loss, psnr, nd)
            nd_max = int(ndv.max())
            if nd_max > 0 and not warned_overflow:
                warned_overflow = True
                log(f"WARNING: iter {it}: rasterizer dropped up to {nd_max} "
                    "gaussian-tile instances this chunk (raise "
                    "RasterizeConfig.max_instances / max_tiles_per_gauss)")
            if it % 5000 < args.chunk_size:
                log(f"iter {it}: loss {lv.mean():.7f} psnr/image "
                    f"{np.round(pv, 3).tolist()}")
            if (args.ckpt_every and it < args.iterations
                    and it % args.ckpt_every < args.chunk_size):
                params, opt = gather_fit(state, mesh)
                if lead:
                    save_resume(resume_path, params, opt, it)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        pv = image_metrics(mesh, psnr)[0]
        params, _ = gather_fit(state, mesh)  # every rank takes part
        if not lead:
            continue
        n_img = len(set(names))
        finals = final_psnr(args.model_name, params, images[:n_img], cfg_kw,
                            device)
        for di, name in enumerate(names[:n_img]):
            img_dir = root / name
            img_dir.mkdir(parents=True, exist_ok=True)
            save_checkpoint(img_dir / "gaussian_model.npz",
                            {k: v[di] for k, v in params.items()}, {})
            np.save(img_dir / "training.npy",
                    {"iterations": args.iterations,
                     "training_time": dt, "psnr": float(pv[di]),
                     "initial_points": args.num_points})
            log(f"{name}: {H}x{W}, PSNR:{pv[di]:.4f}, "
                f"Training(group):{dt:.1f}s")
            log(f"{name}: final state PSNR:{finals[di]:.4f}")
            stats.append(pv[di])
    if stats:
        log(f"Average PSNR: {np.mean(stats):.4f} over {len(stats)} images")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
