"""Quantization-aware training CLI (counterpart of
gaussianimage_tpu/train_quantize.py; reference train_quantize.py:40-97):
load a fitted (stage-1) checkpoint, set the uniform quantizers' ranges and
the VQ codebooks from its weights, train QAT iterations (float16 means,
6-bit uniform quantizers on the covariance parameters: the Cholesky
elements, or RS's raw scaling and activated rotation; 2x8 residual VQ on
the colors), keep the parameters of the
step with the best training PSNR on the device, and write the last and the
best checkpoints, ``training.npy`` with the bpp, and ``train.txt``.

Each QAT step renders through the generic differentiable rasterizer (K1
forward, K2 backward; ``quantize=True`` opts out of the fused L2 kernel)
and then installs the VQ state its forward computed. Step j of a chunk
that starts after iteration ``it`` runs at iteration it + 1 + j with the
trainer's generator, as in the JAX package: the wMask model (its default
``MaskConfig``, as there) renders with its deterministic mask and adds its
regularizer in its mask phase. Steps run as a plain
Python loop; the chunk is bookkeeping only: the per-step metrics and the
stream overflow are read back once per chunk, and the best-PSNR snapshot
is taken on the device with ``torch.where``, without a host read per step.
The last chunk runs only the iterations left (the JAX package scans a whole
chunk there).

Run:  python -m gaussianimage_tpu_torch.train_quantize -d data/ \\
        --data_name photos --num_points 10000 --iterations 50000 \\
        --model_path results/photos/GaussianImage_Cholesky_50000_10000 \\
        --checkpoint_root <out> [--model_name GaussianImage_RS] \\
        [--device cpu]

``--model_path`` is the stage-1 checkpoint root, with one
``<image>/gaussian_model.npz`` per image.
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
from gaussianimage_tpu_torch.train import FPS_FRAMES, timed_bursts
from gaussianimage_tpu_torch.utils import LogWriter, ms_ssim, ssim
from gaussianimage_tpu_torch.utils.checkpoint import (checkpoint_trees,
                                                      load_checkpoint,
                                                      merge_matching,
                                                      save_checkpoint)
from gaussianimage_tpu_torch.utils.image_io import save_image_array


class QuantizeTrainer2d:
    """QAT of one image's fitted Gaussians on one device."""

    def __init__(self, gt_image, image_name, num_points=2000,
                 model_name="GaussianImage_Cholesky", iterations=30000,
                 model_path=None, args=None, log_dir=None, chunk_size=100,
                 device=None):
        self.device = resolve_device(device)
        self.gt_image = torch.as_tensor(gt_image, dtype=torch.float32,
                                        device=self.device)
        self.image_name = image_name
        self.num_points = num_points
        self.iterations = iterations
        self.chunk_size = (min(chunk_size, iterations) if iterations
                           else chunk_size)
        self.H, self.W = int(gt_image.shape[2]), int(gt_image.shape[3])
        self.save_imgs = bool(getattr(args, "save_imgs", False))
        self.model = make_model(
            model_name, device=self.device, num_points=num_points, H=self.H,
            W=self.W, loss_type="L2", lr=getattr(args, "lr", 1e-3),
            opt_type=getattr(args, "opt_type", "adan"), quantize=True)
        self.log_dir = Path(log_dir) if log_dir is not None else Path(
            f"./checkpoints_quant/run/{model_name}_{iterations}_{num_points}/"
            f"{image_name}")
        self.logwriter = LogWriter(self.log_dir)
        seed = int(getattr(args, "seed", 1) or 1)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer = self.model.init_state(self.generator)
        if model_path is not None:
            self.logwriter.write(f"loading model path:{model_path}")
            # the parameters whose name and shape match (a pruned wMask fit
            # needs --num_points at its pruned count)
            merge_matching(self.model, load_checkpoint(model_path)["params"])
            # two-stage warm start: quantizer ranges and codebooks from the
            # loaded weights
            self.model.init_quantizer_data()
        self.chunk_dropped = []  # n_dropped, the worst step of each chunk
        self.losses = []  # every step's loss, read once per chunk
        self.best_training_psnr = None

    def _eval_render(self) -> torch.Tensor:
        return self.model.render_quantize(training=False)["render"]

    def fit(self):
        """The QAT loop. Returns (iterations, training PSNRs, best
        parameters by name)."""
        model = self.model
        params = dict(model.named_parameters())
        best = {k: p.detach().clone() for k, p in params.items()}
        best_psnr = torch.full((), -1.0, device=self.device)
        psnr_list, iter_list = [], []
        it, cs = 0, self.chunk_size
        while it < self.iterations:
            n = min(cs, self.iterations - it)
            ms = []
            for j in range(n):
                m = model.train_step(self.optimizer, self.gt_image,
                                     iteration=it + 1 + j,
                                     generator=self.generator)
                with torch.no_grad():
                    better = m["psnr"] > best_psnr
                    for k, p in params.items():
                        best[k] = torch.where(better, p, best[k])
                    best_psnr = torch.where(better, m["psnr"], best_psnr)
                ms.append(torch.stack([m["loss"].float(), m["psnr"].float(),
                                       m["n_dropped"].float()]))
            losses, psnrs, dropped = torch.stack(ms, dim=1).cpu().numpy()
            self.losses.extend(losses.tolist())
            psnr_list.extend(psnrs.tolist())
            iter_list.extend(range(it + 1, it + n + 1))
            it += n
            self.chunk_dropped.append(int(dropped.max()))
            if it % 5000 < cs:
                self.logwriter.write(
                    f"iter {it}: psnr {psnrs[n - 1]:.4f} "
                    f"best {float(best_psnr):.4f}")
        self.best_training_psnr = float(best_psnr)
        return iter_list, psnr_list, best

    def train(self) -> dict:
        """QAT, then the tests of the last and the best state, their
        checkpoints, the FPS probe and the artifacts. Returns a dict of the
        image's results."""
        start_time = time.time()
        iter_list, psnr_list, best = self.fit()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        end_time = time.time() - start_time

        psnr_value, ms_ssim_value, bpp = self.test()
        save_checkpoint(self.log_dir / "gaussian_model.npz",
                        *checkpoint_trees(self.model))
        # the best step's parameters with the last VQ state, as in the JAX
        # package
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(best[k])
        best_psnr_value, best_ms_ssim_value, best_bpp = self.test(best=True)
        save_checkpoint(self.log_dir / "gaussian_model.best.npz",
                        *checkpoint_trees(self.model))
        test_end_time = self.fps_probe()
        self.logwriter.write(
            "Training Complete in {:.4f}s, Eval time:{:.8f}s, FPS:{:.4f}"
            .format(end_time, test_end_time, 1 / test_end_time))
        np.save(self.log_dir / "training.npy",
                {"iterations": iter_list, "training_psnr": psnr_list,
                 "training_time": end_time, "psnr": psnr_value,
                 "ms-ssim": ms_ssim_value, "rendering_time": test_end_time,
                 "rendering_fps": 1 / test_end_time, "bpp": bpp,
                 "best_psnr": best_psnr_value,
                 "best_ms-ssim": best_ms_ssim_value, "best_bpp": best_bpp})
        return {"image": self.image_name, "H": self.H, "W": self.W,
                "psnr": psnr_value, "ms_ssim": ms_ssim_value, "bpp": bpp,
                "best_psnr": best_psnr_value,
                "best_ms_ssim": best_ms_ssim_value, "best_bpp": best_bpp,
                "best_training_psnr": self.best_training_psnr,
                "training_time": end_time, "eval_time": test_end_time,
                "fps": 1 / test_end_time, "iterations": self.iterations}

    @torch.no_grad()
    def test(self, best: bool = False):
        """(psnr, ms_ssim, bpp) of the evaluation render, with the bpp of a
        real rANS probe (measure_unit_bits)."""
        out = self._eval_render()
        mse = float(torch.mean((out - self.gt_image) ** 2))
        psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
        metric = ms_ssim if min(self.H, self.W) >= 161 else ssim
        msv = float(metric(out, self.gt_image, data_range=1.0))
        m, s, r, c = self.model.measure_unit_bits()
        bpp = (m + s + r + c) / self.H / self.W
        tag = "Best Test" if best else "Test"
        self.logwriter.write("{} PSNR:{:.4f}, MS_SSIM:{:.6f}, bpp:{:.4f}"
                             .format(tag, psnr, msv, bpp))
        if self.save_imgs:
            name = self.image_name + ("_codec_best.png" if best
                                      else "_codec.png")
            save_image_array(out.cpu().numpy(), self.log_dir / name)
        return psnr, msv, bpp

    @torch.no_grad()
    def fps_probe(self) -> float:
        """Seconds per evaluation render: ``timed_bursts`` of
        ``FPS_FRAMES`` renders queued back to back."""
        def burst():
            acc = torch.zeros((), device=self.device)
            for _ in range(FPS_FRAMES):
                acc += self._eval_render()[0, 0, 0, 0]
            return acc

        return timed_bursts(burst, self.device)


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="GaussianImage quantization-aware training (PyTorch + "
                    "CUDA port)")
    p.add_argument("-d", "--dataset", type=str, default="./dataset/kodak/")
    p.add_argument("--data_name", type=str, default="kodak")
    p.add_argument("--iterations", type=int, default=50000)
    p.add_argument("--model_name", type=str, default="GaussianImage_Cholesky")
    p.add_argument("--num_points", type=int, default=50000)
    p.add_argument("--model_path", type=str, default=None,
                   help="stage-1 checkpoint root (per-image subdirs)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save_imgs", action="store_true")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--opt_type", type=str, default="adan")
    p.add_argument("--chunk_size", type=int, default=100)
    p.add_argument("--checkpoint_root", type=str, default="./checkpoints_quant")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv):
    """Runs the CLI; returns the per-image result dicts."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    folder = f"{args.model_name}_{args.iterations}_{args.num_points}"
    root = Path(args.checkpoint_root) / args.data_name / folder
    logwriter = LogWriter(root)
    results = []
    for image_name, img in iterate_dataset(args.data_name, args.dataset):
        model_path = (Path(args.model_path) / image_name / "gaussian_model.npz"
                      if args.model_path else None)
        tr = QuantizeTrainer2d(
            img, image_name, num_points=args.num_points,
            iterations=args.iterations, model_name=args.model_name,
            model_path=model_path, args=args, log_dir=root / image_name,
            chunk_size=args.chunk_size, device=device)
        r = tr.train()
        results.append(r)
        logwriter.write(
            "{}: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, bpp:{:.4f}, Best "
            "PSNR:{:.4f}, Best MS-SSIM:{:.4f}, Best bpp:{:.4f}, "
            "Training:{:.4f}s, Eval:{:.8f}s, FPS:{:.4f}".format(
                image_name, r["H"], r["W"], r["psnr"], r["ms_ssim"], r["bpp"],
                r["best_psnr"], r["best_ms_ssim"], r["best_bpp"],
                r["training_time"], r["eval_time"], r["fps"]))
    logwriter.write(
        "Average: PSNR:{:.4f}, MS-SSIM:{:.4f}, Bpp:{:.4f}, Best PSNR:{:.4f}, "
        "Best MS-SSIM:{:.4f}, Best bpp:{:.4f}, Training:{:.4f}s, FPS:{:.4f}"
        .format(*(float(np.mean([r[k] for r in results]))
                  for k in ("psnr", "ms_ssim", "bpp", "best_psnr",
                            "best_ms_ssim", "best_bpp", "training_time",
                            "fps"))))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
