"""Evaluate and serve a fitted checkpoint — the ``--iterations 0`` path of the
JAX package's trainer (gaussianimage_tpu/train.py:479-511): load the
checkpoint, run ``test()`` (n_dropped warning, PSNR, MS-SSIM, the
``*_fitting.png`` under ``--save_imgs``), run the 100-frame FPS probe, and
write ``train.txt`` lines in the JAX package's format.

Fitting (``--iterations > 0``) is the training slice of ROADMAP.md and is not
ported yet.

Run:  python -m gaussianimage_tpu_torch.train --data_name photos \\
        --dataset data/ --model_path <checkpoint file or dir> \\
        --iterations 0 --num_points 10000 [--device cpu]

A ``--model_path`` directory is searched for ``<image>/gaussian_model.npz``,
then ``gaussian_model.npz``.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gaussianimage_tpu_torch import resolve_device
from gaussianimage_tpu_torch.datasets import iterate_dataset
from gaussianimage_tpu_torch.models import make_model
from gaussianimage_tpu_torch.utils import LogWriter, ms_ssim, ssim
from gaussianimage_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    params_from_numpy,
    save_checkpoint,
)
from gaussianimage_tpu_torch.utils.image_io import save_image_array

TRAINING_NOT_PORTED = (
    "fitting (--iterations > 0) is not ported yet: it is the training slice "
    "of ROADMAP.md (kernels K3 and K2, Adan, init, reseed); run with "
    "--iterations 0 to evaluate a fitted checkpoint")
FPS_FRAMES = 100  # renders per FPS probe, as in the JAX package


def render_burst(model):
    """Queue ``FPS_FRAMES`` renders back to back, each on sub-ulp-perturbed
    ``_xyz`` (the image is unchanged), without synchronising; returns a
    device scalar that depends on every frame."""
    xyz = model._xyz
    acc = torch.zeros((), device=xyz.device)
    for i in range(1, FPS_FRAMES + 1):
        acc += model.render(xyz=xyz + 1e-30 * i)["render"][0, 0, 0, 0]
    return acc


def checkpoint_file(model_path, image_name: str) -> Path:
    """A checkpoint file, or ``<dir>/<image>/gaussian_model.npz`` /
    ``<dir>/gaussian_model.npz`` for a directory."""
    p = Path(model_path)
    if not p.is_dir():
        return p
    for cand in (p / image_name / "gaussian_model.npz",
                 p / "gaussian_model.npz"):
        if cand.is_file():
            return cand
    raise FileNotFoundError(
        f"no {image_name}/gaussian_model.npz or gaussian_model.npz in {p}")


class SimpleTrainer2d:
    """Evaluates one fitted image representation on one device."""

    def __init__(self, gt_image: np.ndarray, image_name: str,
                 num_points: int = 2000,
                 model_name: str = "GaussianImage_Cholesky",
                 iterations: int = 0, model_path=None, args=None,
                 log_dir: Path | None = None, device=None):
        if iterations > 0:
            raise NotImplementedError(TRAINING_NOT_PORTED)
        if model_path is None:
            raise ValueError("--iterations 0 evaluates a fitted checkpoint: "
                             "pass --model_path")
        self.device = resolve_device(device)
        self.gt_image = torch.as_tensor(gt_image, dtype=torch.float32,
                                        device=self.device)  # [1,3,H,W]
        self.image_name = image_name
        self.num_points = num_points
        self.iterations = iterations
        self.H, self.W = int(gt_image.shape[2]), int(gt_image.shape[3])
        self.save_imgs = bool(getattr(args, "save_imgs", False))
        self.model = make_model(
            model_name, device=self.device, num_points=num_points, H=self.H,
            W=self.W, no_clamp=bool(getattr(args, "no_clamp", False)))

        self.log_dir = Path(log_dir) if log_dir is not None else Path(
            f"./checkpoints/run/{model_name}_{iterations}_{num_points}/"
            f"{image_name}")
        self.logwriter = LogWriter(self.log_dir)

        path = checkpoint_file(model_path, image_name)
        self.logwriter.write(f"loading model path:{path}")
        params = load_checkpoint(path)["params"]
        own = self.model.state_dict()
        for k, v in own.items():
            if k not in params or tuple(params[k].shape) != tuple(v.shape):
                raise ValueError(
                    f"checkpoint {path} has no {k} of shape {tuple(v.shape)} "
                    f"(found {getattr(params.get(k), 'shape', None)}); "
                    "check --num_points and --model_name")
        self.model.load_state_dict(
            params_from_numpy({k: params[k] for k in own}, self.device))

    @torch.no_grad()
    def test(self):
        """(psnr, ms_ssim, final_points, n_dropped) of the clamped render."""
        full = self.model.render()
        n_dropped = int(full["raster_aux"]["n_dropped"])
        if n_dropped > 0:
            self.logwriter.write(
                "WARNING: rasterizer dropped {} gaussian-tile instances "
                "(raise RasterizeConfig.max_instances / max_tiles_per_gauss)"
                .format(n_dropped))
        out, gt = full["render"], self.gt_image
        mse = float(torch.mean((out - gt) ** 2))
        psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
        # MS-SSIM needs >= 161 px per side (5 scales x 11-tap window);
        # smaller images fall back to single-scale SSIM
        if min(self.H, self.W) >= 161:
            msv = float(ms_ssim(out, gt, data_range=1.0))
        else:
            msv = float(ssim(out, gt, data_range=1.0))
        num_points_final = int(self.model._xyz.shape[0])
        self.logwriter.write(
            "Test PSNR:{:.4f}, MS_SSIM:{:.6f}, Final_points:{:d}".format(
                psnr, msv, num_points_final))
        if self.save_imgs:
            save_image_array(out.cpu().numpy(),
                             self.log_dir / f"{self.image_name}_fitting.png")
        return psnr, msv, num_points_final, n_dropped

    @torch.no_grad()
    def fps_probe(self) -> float:
        """Seconds per frame over one ``render_burst``, synchronised once at
        the end, after one untimed warm-up burst."""
        render_burst(self.model)
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            render_burst(self.model)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1000.0 / FPS_FRAMES
        t0 = time.perf_counter()
        render_burst(self.model)
        return (time.perf_counter() - t0) / FPS_FRAMES

    def train(self):
        """The JAX trainer's epilogue with no iterations: test, FPS probe,
        artifacts. Returns a dict of the image's results."""
        start_time = time.time()
        end_time = time.time() - start_time
        psnr_value, ms_ssim_value, num_points_final, n_dropped = self.test()
        test_end_time = self.fps_probe()
        self.logwriter.write(
            "Training Complete in {:.4f}s, Eval time:{:.8f}s, FPS:{:.4f}"
            .format(end_time, test_end_time, 1 / test_end_time))
        save_checkpoint(self.log_dir / "gaussian_model.npz",
                        dict(self.model.state_dict()))
        np.save(self.log_dir / "training.npy",
                {"iterations": [], "training_psnr": [],
                 "training_time": end_time, "psnr": psnr_value,
                 "ms-ssim": ms_ssim_value, "rendering_time": test_end_time,
                 "rendering_fps": 1 / test_end_time,
                 "initial_points": self.num_points,
                 "final_points": num_points_final})
        return {"image": self.image_name, "H": self.H, "W": self.W,
                "psnr": psnr_value, "ms_ssim": ms_ssim_value,
                "training_time": end_time, "eval_time": test_end_time,
                "fps": 1 / test_end_time, "n_dropped": n_dropped}


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="GaussianImage (PyTorch + CUDA port): evaluate and serve "
                    "a fitted checkpoint")
    p.add_argument("-d", "--dataset", type=str, default="./datasets/kodak/")
    p.add_argument("--data_name", type=str, default="kodak")
    p.add_argument("--iterations", type=int, default=50000)
    p.add_argument("--model_name", type=str, default="GaussianImage_Cholesky")
    p.add_argument("--num_points", type=int, default=50000)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--save_imgs", action="store_true")
    p.add_argument("--no_clamp", action="store_true")
    p.add_argument("--checkpoint_root", type=str, default="./checkpoints")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv):
    """Runs the CLI; returns the per-image result dicts."""
    args = parse_args(argv)
    if args.iterations > 0:
        raise NotImplementedError(TRAINING_NOT_PORTED)
    device = resolve_device(args.device)
    folder = f"{args.model_name}_{args.iterations}_{args.num_points}"
    root = Path(args.checkpoint_root) / args.data_name / folder
    logwriter = LogWriter(root)

    results = []
    for image_name, img in iterate_dataset(args.data_name, args.dataset):
        trainer = SimpleTrainer2d(
            img, image_name, num_points=args.num_points,
            iterations=args.iterations, model_name=args.model_name,
            model_path=args.model_path, args=args,
            log_dir=root / image_name, device=device)
        r = trainer.train()
        results.append(r)
        logwriter.write(
            "{}: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, Training:{:.4f}s, "
            "Eval:{:.8f}s, FPS:{:.4f}".format(
                image_name, r["H"], r["W"], r["psnr"], r["ms_ssim"],
                r["training_time"], r["eval_time"], r["fps"]))
    n = len(results)
    logwriter.write(
        "Average: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, Training:{:.4f}s, "
        "Eval:{:.8f}s, FPS:{:.4f}".format(
            sum(r["H"] for r in results) // n,
            sum(r["W"] for r in results) // n,
            *(sum(r[k] for r in results) / n
              for k in ("psnr", "ms_ssim", "training_time", "eval_time",
                        "fps"))))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
