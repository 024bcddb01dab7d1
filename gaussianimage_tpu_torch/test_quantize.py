"""Codec evaluation CLI (counterpart of gaussianimage_tpu/test_quantize.py;
reference test_quantize.py:66-90): load each image's best QAT checkpoint,
compress it once, decode it, and report PSNR, MS-SSIM and the bpp
breakdown, with and without entropy coding; write ``test.npy`` and
``test.txt`` with the JAX package's keys and lines.

- The image and its PSNR come from the default model's decode (the generic
  path), as in the JAX package.
- The decode probe runs on the ``RasterizeConfig.serving`` twin, whose
  decode is the fused splat prep (K4 for Cholesky, K6a for RS) and then
  K1, unless that twin drops
  instances on this scene (its ``n_dropped`` is read first); then on the
  default model, as the JAX package routes it. It queues ``FPS_FRAMES``
  decodes back to back, twice after a warm-up burst, and divides by 200,
  timed with CUDA events. Eager PyTorch folds nothing across frames, so
  unlike the JAX probe no frame perturbs the quantizer scale.
- The entropy-coded path: compress with rANS, the bpp of the real streams,
  decompress and the round-trip error against the decode above, and the
  time of 20 entropy-coded decodes in three parts: the host rANS decode,
  the host-to-device copy of the code arrays and the device decode.

- The whole-dataset decode probe (``batched_dataset_decode_fps``): every
  image of the largest same-size group stacked, ``scan_len`` dataset
  decodes a burst, routed by ``batched.prefer_batched`` (one stacked pass,
  through K7 for Cholesky and the generic stacked decode for RS, or a loop
  of single-frame decodes through K4 or K6a; the loop
  wherever the stacked stream would pass the flat layout), on the
  default config with the fused prep on, as in the JAX package. Each
  decode adds a sub-ulp amount to the quantizer scale, as the JAX probe
  does, so that no two are the same computation.

Run:  python -m gaussianimage_tpu_torch.test_quantize -d data/ \\
        --data_name photos --model_path <QAT checkpoint root> \\
        --num_points 10000 [--model_name GaussianImage_RS] [--device cpu]

The lines report the covariance's bits as ``cholesky_bpp``, as the JAX
package does for both models; ``test.npy`` also holds RS's ``scaling_bpp``
and ``rotation_bpp``.
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
from gaussianimage_tpu_torch.batched import decode_many, prefer_batched
from gaussianimage_tpu_torch.codec import ResidualVQState
from gaussianimage_tpu_torch.datasets import iterate_dataset
from gaussianimage_tpu_torch.models import make_model
from gaussianimage_tpu_torch.ops import RasterizeConfig
from gaussianimage_tpu_torch.train import FPS_FRAMES, timed_bursts
from gaussianimage_tpu_torch.utils import LogWriter, ms_ssim, ssim
from gaussianimage_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      merge_matching)

EC_FRAMES = 20  # entropy-coded decodes timed, as in the JAX package


def decode_burst(model, enc_dev):
    """Queue ``FPS_FRAMES`` decodes back to back without synchronising;
    returns a device scalar that depends on every frame."""
    acc = torch.zeros((), device=model._xyz.device)
    for _ in range(FPS_FRAMES):
        acc += model.decompress_wo_ec(enc_dev)["render"][0, 0, 0, 0]
    return acc


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CodecEvaluator2d:
    def __init__(self, gt_image, image_name, num_points=2000,
                 model_name="GaussianImage_Cholesky", model_path=None,
                 args=None, log_dir=None, device=None):
        self.device = resolve_device(device)
        self.gt_image = torch.as_tensor(gt_image, dtype=torch.float32,
                                        device=self.device)
        self.image_name = image_name
        self.H, self.W = int(gt_image.shape[2]), int(gt_image.shape[3])
        self.model = make_model(
            model_name, device=self.device, num_points=num_points, H=self.H,
            W=self.W, loss_type="L2", quantize=True)
        # the serving twin: fused splat prep, the tight 3N stream and the
        # forward-only flat-stream ceiling (RasterizeConfig.serving)
        self.model_s = make_model(
            model_name, device=self.device, num_points=num_points, H=self.H,
            W=self.W, loss_type="L2", quantize=True,
            raster=RasterizeConfig.serving(num_points))
        self.log_dir = Path(log_dir) if log_dir is not None else Path("./eval")
        self.logwriter = LogWriter(self.log_dir, train=False)
        seed = int(getattr(args, "seed", 1) or 1)
        self.model.init_params(
            torch.Generator(device=self.device).manual_seed(seed))
        if model_path is not None:
            self.logwriter.write(f"loading model path:{model_path}")
            ckpt = load_checkpoint(model_path)
            merge_matching(self.model, ckpt["params"], ckpt["extra"])
        self.model_s.load_state_dict(self.model.state_dict())

    @torch.no_grad()
    def evaluate(self):
        """The evaluation without its timed probes: compress once, decode
        (the default model), and return the bpp breakdown
        (``analysis_wo_ec``) with psnr, ms-ssim, bpp_ec (the real rANS
        streams), ec_roundtrip_err (the entropy-coded decode against the
        decode) and serving_n_dropped (the serving twin's overflow on this
        scene). Keeps the code arrays (``enc``, ``enc_dev``, ``enc_ec``)
        for the probes."""
        model, dev = self.model, self.device
        self.enc = enc = model.compress_wo_ec()
        self.enc_dev = {k: torch.as_tensor(v, device=dev)
                        for k, v in enc.items()}
        out = model.decompress_wo_ec(self.enc_dev)["render"]
        nd = int(self.model_s.decompress_wo_ec(self.enc_dev)["raster_aux"]
                 ["n_dropped"])
        data = model.analysis_wo_ec(enc)
        self.enc_ec = model.compress()
        data_ec = model.analysis(self.enc_ec)
        out_ec = model.decompress(self.enc_ec)["render"]
        mse = float(torch.mean((out - self.gt_image) ** 2))
        metric = ms_ssim if min(self.H, self.W) >= 161 else ssim
        data.update({"psnr": 10 * math.log10(1.0 / max(mse, 1e-12)),
                     "ms-ssim": float(metric(out, self.gt_image,
                                             data_range=1.0)),
                     "bpp_ec": data_ec["bpp"],
                     "ec_roundtrip_err": float((out_ec - out).abs().max()),
                     "serving_n_dropped": nd})
        return data

    @torch.no_grad()
    def test(self):
        """``evaluate``, then the decode probe (on the serving twin unless
        it drops instances) and the entropy-coded decode's timed parts;
        writes test.npy and the test.txt lines."""
        model, dev = self.model, self.device
        data = self.evaluate()
        nd = data["serving_n_dropped"]
        probe_model = self.model_s if nd == 0 else model
        end_time = timed_bursts(
            lambda: decode_burst(probe_model, self.enc_dev), dev)

        # the entropy-coded decode in three parts, synchronised between them
        parts = np.zeros(3)
        for _ in range(EC_FRAMES):
            t0 = time.perf_counter()
            dec = model.entropy_decode(self.enc_ec)
            t1 = time.perf_counter()
            dec_dev = {k: torch.as_tensor(v, device=dev)
                       for k, v in dec.items()}
            _sync(dev)
            t2 = time.perf_counter()
            model.decompress_wo_ec(dec_dev)
            _sync(dev)
            parts += (t1 - t0, t2 - t1, time.perf_counter() - t2)
        parts /= EC_FRAMES
        ec_time = float(parts.sum())

        data.update({"rendering_time": end_time,
                     "rendering_fps": 1 / end_time,
                     "rendering_time_ec": ec_time,
                     "rendering_fps_ec": 1 / ec_time,
                     "rendering_time_ec_rans": float(parts[0]),
                     "rendering_time_ec_h2d": float(parts[1]),
                     "rendering_time_ec_device": float(parts[2]),
                     "probe_model": "serving" if nd == 0 else "default"})
        np.save(self.log_dir / "test.npy", data)
        self.logwriter.write(
            "Eval time:{:.8f}s, FPS:{:.4f}, EC-decode FPS:{:.4f}".format(
                end_time, 1 / end_time, 1 / ec_time))
        self.logwriter.write("PSNR:{:.4f}, MS_SSIM:{:.6f}, bpp:{:.4f}".format(
            data["psnr"], data["ms-ssim"], data["bpp"]))
        self.logwriter.write(
            "position_bpp:{:.4f}, cholesky_bpp:{:.4f}, feature_dc_bpp:{:.4f}, "
            "entropy-coded bpp:{:.4f}".format(
                data["position_bpp"], data["cholesky_bpp"],
                data["feature_dc_bpp"], data["bpp_ec"]))
        self.logwriter.write(
            "EC-decode parts: rANS {:.8f}s, host-to-device {:.8f}s, "
            "device decode {:.8f}s; decode probe on the {} model "
            "(serving twin n_dropped {})".format(
                *parts, data["probe_model"], nd))
        return data


def stack_frames(models, encs, device):
    """The (params_b, extra_b, enc_b) of batched.py's decodes: each quantize
    model's parameters and VQ state and each frame's code arrays stacked on
    dim 0, on ``device``."""
    named = [dict(m.named_parameters()) for m in models]
    params_b = {k: torch.stack([p[k].detach() for p in named])
                for k in named[0]}
    extra_b = {"vq": ResidualVQState(*(torch.stack(leaves) for leaves in zip(
        *(m.vq_state() for m in models))))}
    enc_b = {k: torch.as_tensor(np.stack([np.asarray(e[k]) for e in encs]),
                                device=device)
             for k in encs[0]}
    return params_b, extra_b, enc_b


@torch.no_grad()
def batched_dataset_decode_fps(evaluators, reps: int = 3,
                               scan_len: int = 16):
    """Whole-dataset decode: every image of the largest same-size group
    stacked and decoded by ``decode_many`` (the strategy ``prefer_batched``
    picks), ``scan_len`` dataset decodes queued per burst,
    one untimed burst and then ``reps`` timed with CUDA events (the host
    clock on the CPU). Returns (frames per pass, frames per second,
    strategy); (n, None, None) for a group of fewer than two."""
    groups = {}
    for ev in evaluators:
        groups.setdefault((ev.H, ev.W), []).append(ev)
    evs = max(groups.values(), key=len)
    if len(evs) < 2:
        return len(evs), None, None
    ev0 = evs[0]
    model = ev0.model
    model_f = make_model(
        model.name, device=ev0.device, num_points=model.cfg.num_points,
        H=ev0.H, W=ev0.W, loss_type="L2", quantize=True,
        raster=model.cfg.raster._replace(fused_prep=True))
    params_b, extra_b, enc_b = stack_frames([ev.model for ev in evs],
                                            [ev.enc for ev in evs], ev0.device)
    scale_key = next(k for k in params_b if k.endswith("_quant_scale"))
    strategy = ("batched" if prefer_batched(ev0.H, ev0.W, len(evs),
                                            model.cfg.num_points)
                else "scan")

    def burst():
        acc = torch.zeros((), device=ev0.device)
        for i in range(1, scan_len + 1):
            p = dict(params_b)
            p[scale_key] = p[scale_key] + 1e-30 * i
            img = decode_many(model_f, p, extra_b, enc_b,
                              force=strategy)["render"]
            acc += img[:, 0, 0, 0].sum()
        return acc

    burst()
    dev = ev0.device
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            burst()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1000.0
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            burst()
        seconds = time.perf_counter() - t0
    dt = seconds / (reps * scan_len)
    return len(evs), len(evs) / dt, strategy


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="GaussianImage codec evaluation (PyTorch + CUDA port)")
    p.add_argument("-d", "--dataset", type=str, default="./dataset/kodak/")
    p.add_argument("--data_name", type=str, default="kodak")
    p.add_argument("--model_name", type=str, default="GaussianImage_Cholesky")
    p.add_argument("--num_points", type=int, default=50000)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save_imgs", action="store_true")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--checkpoint_root", type=str, default="./checkpoints_quant")
    p.add_argument("--iterations", type=int, default=50000)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv):
    """Runs the CLI; returns the per-image result dicts (with "image")."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    folder = f"{args.model_name}_{args.iterations}_{args.num_points}"
    root = Path(args.checkpoint_root) / args.data_name / folder
    logwriter = LogWriter(root, train=False)
    rows, results, evaluators = [], [], []
    for image_name, img in iterate_dataset(args.data_name, args.dataset):
        model_path = (Path(args.model_path) / image_name /
                      "gaussian_model.best.npz" if args.model_path else None)
        ev = CodecEvaluator2d(img, image_name, num_points=args.num_points,
                              model_name=args.model_name,
                              model_path=model_path, args=args,
                              log_dir=root / image_name, device=device)
        d = ev.test()
        evaluators.append(ev)
        results.append({"image": image_name, **d})
        rows.append([d["psnr"], d["ms-ssim"], d["bpp"], d["rendering_fps"],
                     d["position_bpp"], d["cholesky_bpp"],
                     d["feature_dc_bpp"]])
        logwriter.write(
            "{}: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, bpp:{:.4f}, FPS:{:.4f}, "
            "position_bpp:{:.4f}, cholesky_bpp:{:.4f}, feature_dc_bpp:{:.4f}"
            .format(image_name, ev.H, ev.W, *rows[-1]))
    logwriter.write(
        "Average: PSNR:{:.4f}, MS-SSIM:{:.4f}, bpp:{:.4f}, FPS:{:.4f}, "
        "position_bpp:{:.4f}, cholesky_bpp:{:.4f}, feature_dc_bpp:{:.4f}"
        .format(*np.asarray(rows).mean(axis=0)))
    b, fps, strategy = batched_dataset_decode_fps(evaluators)
    if fps is not None:
        logwriter.write(
            "Dataset decode ({} frames/pass, {} strategy): {:.1f} FPS"
            .format(b, strategy, fps))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
