"""Fit an image with 2D Gaussians, or evaluate a fitted checkpoint — the
trainer and CLI (counterpart of gaussianimage_tpu/train.py:60-372,479-511).

A fit (``--iterations > 0``) initialises the model (adaptive by default),
optionally warm-starts from ``--model_path`` or resumes from the image's
``resume.pt``, and runs a plain Python loop of training steps on the card:
for GaussianImage_Cholesky and GaussianImage_RS (``--model_name``) under
L2 each step is the model's projection, one fused render + L2 + backward
kernel (K3) and one Adan update; the 3DGS baseline (``--model_name 3DGS``,
``--sh_degree``) trains under Fusion2, as the JAX trainer does, through
the depth-sorted blend (K8 forward, K9 backward). The JAX package scans
250 steps per compiled call; here the chunk is bookkeeping only: reseed
rounds fire at the first chunk boundary at or after each scheduled
iteration, the stream overflow (``n_dropped``) is read once per chunk, and
the per-step metrics are read back once per chunk. Step j of a chunk that
starts after iteration ``it`` runs at iteration it + 1 + j with the
trainer's generator, which only the wMask model
(``--model_name GaussianImage_Cholesky_wMask`` and its ten mask flags)
reads: its mask phase, temperature and Gumbel noise. ``scalars.jsonl`` gets
every ``--log_every``-th step (with the model's step metrics, wMask's
sparsity), viz PNGs come every ``--viz_every`` iterations, and a resume
snapshot every ``--ckpt_every``. ``--profile <dir>`` writes a
``torch.profiler`` Chrome trace of the second chunk and 10 evaluation
renders into ``<dir>``, as the JAX trainer traces those.

Every run ends as the JAX trainer's does: a model that prunes (wMask)
drops its masked Gaussians, then ``test()`` (n_dropped warning, PSNR,
MS-SSIM, ``*_fitting.png`` under ``--save_imgs``), the 100-frame FPS
probe, ``train.txt`` lines in the JAX package's format,
``gaussian_model.npz`` in its checkpoint format and ``training.npy`` with
its keys. Every evaluation render runs at iteration ``EVAL_ITERATION``, as
in the JAX trainer, where wMask takes its deterministic mask.
``--iterations 0 --model_path <checkpoint>`` evaluates a fitted
checkpoint.

Run:  python -m gaussianimage_tpu_torch.train --data_name photos \\
        --dataset data/ --iterations 50000 --num_points 10000 \\
        [--model_name GaussianImage_RS | --model_name 3DGS --sh_degree 3]
        [--device cpu]

A ``--model_path`` directory is searched for ``<image>/gaussian_model.npz``,
then ``gaussian_model.npz``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gaussianimage_tpu_torch import resolve_device
from gaussianimage_tpu_torch.core.reseed import default_schedule, reseed_state
from gaussianimage_tpu_torch.datasets import iterate_dataset
from gaussianimage_tpu_torch.models import MODEL_REGISTRY, make_model
from gaussianimage_tpu_torch.models.base import GaussianModelBase, MaskConfig
from gaussianimage_tpu_torch.utils import LogWriter, ms_ssim, ssim
from gaussianimage_tpu_torch.utils.checkpoint import (
    checkpoint_trees,
    load_checkpoint,
    load_train_state,
    merge_matching,
    params_from_numpy,
    save_checkpoint,
    save_train_state,
)
from gaussianimage_tpu_torch.utils.image_io import save_image_array

FPS_FRAMES = 100  # renders per FPS probe, as in the JAX package
# the iteration of every evaluation render, as in the JAX trainer: a
# phase-scheduled model (wMask) takes its deterministic mask there
EVAL_ITERATION = 1 << 30
PROFILE_RENDERS = 10  # evaluation renders in the --profile trace
MASK_FLAGS = ("start_mask_training", "stop_mask_training", "reg_type",
              "target_sparsity", "lambda_reg", "init_mask_logit", "use_ema",
              "use_score", "temp_init", "temp_final")
# the chunk metrics every model reports (``train_chunk``); the rest
# (wMask's) go to scalars.jsonl beside loss and psnr
BASE_METRICS = ("loss", "psnr", "n_dropped_max")


def render_burst(model):
    """Queue ``FPS_FRAMES`` evaluation renders back to back, each on
    sub-ulp-perturbed ``_xyz`` (the image is unchanged), without
    synchronising; returns a device scalar that depends on every frame."""
    xyz = model._xyz
    acc = torch.zeros((), device=xyz.device)
    for i in range(1, FPS_FRAMES + 1):
        acc += model.render(xyz=xyz + 1e-30 * i, iteration=EVAL_ITERATION
                            )["render"][0, 0, 0, 0]
    return acc


TIMED_BURSTS = 2  # bursts per probe after the warm-up, as in the JAX package


def timed_bursts(burst, device) -> float:
    """Seconds per frame of ``burst`` (``FPS_FRAMES`` frames queued without
    synchronising): one untimed warm-up burst, then ``TIMED_BURSTS`` bursts
    back to back, timed with CUDA events (the host clock on the CPU) and
    synchronised once at the end."""
    burst()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED_BURSTS):
            burst()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1000.0
    else:
        t0 = time.perf_counter()
        for _ in range(TIMED_BURSTS):
            burst()
        seconds = time.perf_counter() - t0
    return seconds / (TIMED_BURSTS * FPS_FRAMES)


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


def reseed_seed(seed: int, iteration: int) -> int:
    """The seed of the reseed round at ``iteration``: a function of the run's
    seed and the iteration only, so ``--resume`` replays the rounds of the
    uninterrupted run."""
    return (seed + 17) * 1_000_003 + iteration


def _colormap_viridis(x: np.ndarray) -> np.ndarray:
    """[H,W] in [0,1] -> [H,W,3] viridis-like heat map (fixed stops)."""
    stops = np.array([[0.267, 0.005, 0.329], [0.283, 0.141, 0.458],
                      [0.254, 0.265, 0.530], [0.207, 0.372, 0.553],
                      [0.164, 0.471, 0.558], [0.128, 0.567, 0.551],
                      [0.135, 0.659, 0.518], [0.267, 0.749, 0.441],
                      [0.478, 0.821, 0.318], [0.741, 0.873, 0.150],
                      [0.993, 0.906, 0.144]], np.float32)
    x = np.clip(x, 0.0, 1.0) * (len(stops) - 1)
    i = np.minimum(x.astype(np.int32), len(stops) - 2)
    f = (x - i)[..., None]
    return stops[i] * (1 - f) + stops[i + 1] * f


class SimpleTrainer2d:
    """Fits one image with 2D Gaussians on one device, or evaluates a fitted
    checkpoint (``iterations=0``)."""

    def __init__(self, gt_image: np.ndarray, image_name: str,
                 num_points: int = 2000,
                 model_name: str = "GaussianImage_Cholesky",
                 iterations: int = 30000, model_path=None, args=None,
                 log_dir: Path | None = None, chunk_size: int = 250,
                 device=None):
        if iterations == 0 and model_path is None:
            raise ValueError("--iterations 0 evaluates a fitted checkpoint: "
                             "pass --model_path")
        self.device = resolve_device(device)
        # shape bucketing: pad H/W up to a multiple with edge replication;
        # metrics and artifacts use the original crop
        bucket = int(getattr(args, "shape_bucket", 0) or 0)
        self.crop_h, self.crop_w = int(gt_image.shape[2]), int(gt_image.shape[3])
        if bucket > 1:
            ph, pw = (-self.crop_h) % bucket, (-self.crop_w) % bucket
            if ph or pw:
                gt_image = np.pad(gt_image, ((0, 0), (0, 0), (0, ph), (0, pw)),
                                  mode="edge")
        self.gt_image = torch.as_tensor(gt_image, dtype=torch.float32,
                                        device=self.device)  # [1,3,H,W]
        self.image_name = image_name
        self.num_points = num_points
        self.iterations = iterations
        self.chunk_size = (min(chunk_size, iterations) if iterations
                           else chunk_size)
        self.H, self.W = int(gt_image.shape[2]), int(gt_image.shape[3])
        self.save_imgs = bool(getattr(args, "save_imgs", False))
        self.profile_dir = getattr(args, "profile", None)
        mask = None
        if model_name == "GaussianImage_Cholesky_wMask":
            mask = MaskConfig(**{f: getattr(args, f) for f in MASK_FLAGS
                                 if hasattr(args, f)})
        self.model = make_model(
            model_name, device=self.device, num_points=num_points, H=self.H,
            W=self.W,
            loss_type=MODEL_REGISTRY.get(model_name, GaussianModelBase)
            .train_loss,
            lr=getattr(args, "lr", 1e-3),
            opt_type=getattr(args, "opt_type", "adan"),
            no_clamp=bool(getattr(args, "no_clamp", False)),
            sh_degree=getattr(args, "sh_degree", 3),
            mask=mask, init_mode=getattr(args, "init_mode", "adaptive"))

        self.log_dir = Path(log_dir) if log_dir is not None else Path(
            f"./checkpoints/run/{model_name}_{iterations}_{num_points}/"
            f"{image_name}")
        self.logwriter = LogWriter(self.log_dir)

        self.seed = int(getattr(args, "seed", 1) or 1)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self.optimizer = self.model.init_state(self.generator,
                                               gt_image=self.gt_image)
        if model_path is not None:
            self._load(checkpoint_file(model_path, image_name), strict=
                       iterations == 0)

        # mid-fit resume (snapshots every ckpt_every iterations)
        self.ckpt_every = int(getattr(args, "ckpt_every", 10000) or 0)
        self.start_iter = 0
        self.chunk_dropped = []  # n_dropped, the worst step of each chunk
        self._hist = {"iter": [], "loss": [], "psnr": []}
        self.resume_path = self.log_dir / "resume.pt"
        if bool(getattr(args, "resume", False)) and self.resume_path.exists():
            self.start_iter, aux = load_train_state(
                self.resume_path, self.model, self.optimizer, self.generator)
            for k in self._hist:
                if f"hist_{k}" in aux:
                    self._hist[k] = np.asarray(aux[f"hist_{k}"]).tolist()
            self.logwriter.write(
                f"resumed from {self.resume_path} at iteration "
                f"{self.start_iter}")

        # error-driven relocation rounds (core/reseed.py): on by default for
        # reseed-capable models on fresh (non-warm-start) fits
        self._reseed_iters = ()
        self.reseed_frac = float(getattr(args, "reseed_frac", 0.05) or 0.0)
        if (self.model.reseed_ok and model_path is None
                and not bool(getattr(args, "no_reseed", False))):
            rounds = int(getattr(args, "reseed_rounds", 6) or 0)
            if rounds > 0 and self.reseed_frac > 0:
                self._reseed_iters = default_schedule(iterations,
                                                      rounds=rounds)
        self.log_every = int(getattr(args, "log_every", 100) or 0)
        self.viz_every = int(getattr(args, "viz_every", 5000) or 0)
        self._wandb = None
        if bool(getattr(args, "wandb", False)):
            try:
                import wandb  # optional; scalars/images mirror jsonl/png
                self._wandb = wandb.init(
                    project=getattr(args, "wandb_project",
                                    "gaussianimage_tpu"),
                    name=f"{model_name}_{num_points}_{image_name}",
                    reinit=True)
            except Exception as e:  # wandb missing: jsonl/png remain
                self.logwriter.write(
                    f"wandb unavailable ({e}); file logging only")

    def _load(self, path: Path, strict: bool) -> None:
        """Load a checkpoint: all of the model's parameters and carried
        state (``strict``, for evaluation), or the parameters whose name
        and shape match (a warm start, as JAX's ``merge_matching``)."""
        self.logwriter.write(f"loading model path:{path}")
        ck = load_checkpoint(path)
        if not strict:
            merge_matching(self.model, ck["params"])
            return
        state = params_from_numpy(ck["params"], self.device, ck["extra"])
        own = self.model.state_dict()
        for k, v in own.items():
            if k not in state or tuple(state[k].shape) != tuple(v.shape):
                raise ValueError(
                    f"checkpoint {path} has no {k} of shape {tuple(v.shape)} "
                    f"(found {getattr(state.get(k), 'shape', None)}); "
                    "check --num_points and --model_name")
        self.model.load_state_dict({k: state[k] for k in own})

    # -- run observability ---------------------------------------------------
    def _log_scalars(self, it0: int, losses, psnrs, n: int,
                     extra_series=None) -> None:
        """Append every ``log_every``-th step (and step 1) to
        scalars.jsonl, one JSON object per line, with the model's step
        metrics (``extra_series``: name -> per-step array; integer ones
        stay integers)."""
        if not self.log_every:
            return
        with open(self.log_dir / "scalars.jsonl", "a") as fh:
            for j in range(n):
                step = it0 + j + 1
                if step % self.log_every == 0 or step == 1:
                    rec = {"iteration": step, "loss": float(losses[j]),
                           "psnr": float(psnrs[j])}
                    for k, v in (extra_series or {}).items():
                        rec[k] = (int(v[j]) if np.issubdtype(v.dtype,
                                                             np.integer)
                                  else float(v[j]))
                    fh.write(json.dumps(rec) + "\n")
                    if self._wandb is not None:
                        self._wandb.log(rec, step=step)

    @torch.no_grad()
    def _dump_viz(self, it: int) -> None:
        """Render and alpha heat map PNGs under ``viz/``, and where the
        model's render gives them the Gaussian-shape render (Cholesky) and
        the center overlay."""
        out = self.model.render(render_viz=True, iteration=EVAL_ITERATION)
        viz_dir = self.log_dir / "viz"
        viz_dir.mkdir(parents=True, exist_ok=True)
        ch, cw = self.crop_h, self.crop_w
        render = out["render"].cpu().numpy()[..., :ch, :cw]
        save_image_array(render, viz_dir / f"iter_{it:06d}_render.png")
        alpha = out["alpha_map"].cpu().numpy()[0, 0, :ch, :cw]
        heat = _colormap_viridis(alpha / max(float(alpha.max()), 1e-6))
        save_image_array(heat.transpose(2, 0, 1)[None],
                         viz_dir / f"iter_{it:06d}_alpha.png")
        if "gauss_render" in out:
            save_image_array(
                out["gauss_render"].cpu().numpy()[..., :ch, :cw],
                viz_dir / f"iter_{it:06d}_gauss.png")
        if "xys" in out:
            overlay = render[0].transpose(1, 2, 0).copy()
            xy = out["xys"].cpu().numpy().astype(np.int32)
            ok = ((xy[:, 0] >= 0) & (xy[:, 0] < overlay.shape[1])
                  & (xy[:, 1] >= 0) & (xy[:, 1] < overlay.shape[0]))
            overlay[xy[ok, 1], xy[ok, 0]] = np.array([1.0, 0.0, 0.0])
            save_image_array(overlay.transpose(2, 0, 1)[None],
                             viz_dir / f"iter_{it:06d}_overlay.png")

    # -- the fit -------------------------------------------------------------
    def _chunk(self, it: int, n: int):
        """Steps it + 1 .. it + n through ``train_chunk``; their metrics
        stacked on the device."""
        return self.model.train_chunk(self.optimizer, self.gt_image, it + 1,
                                      n, self.generator)

    def _traced_chunk(self, it: int, n: int):
        """``_chunk`` and ``PROFILE_RENDERS`` evaluation renders under
        torch.profiler (CUDA activity on the card), its Chrome trace
        written into ``profile_dir`` as ``<image>.pt.trace.json``."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            ms = self._chunk(it, n)
            with torch.no_grad():
                for _ in range(PROFILE_RENDERS):
                    self.model.render(iteration=EVAL_ITERATION)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"{self.image_name}.pt.trace.json"))
        self.logwriter.write(f"profiler trace written to {out}")
        return ms

    def fit(self) -> None:
        """Run the training loop from ``start_iter`` to ``iterations``."""
        hist = self._hist
        it = self.start_iter
        cs = self.chunk_size
        reseed_bounds = sorted({-(-r // cs) * cs for r in self._reseed_iters
                                if -(-r // cs) * cs < self.iterations})
        warned_overflow = False
        while it < self.iterations:
            if it in reseed_bounds:
                gen = torch.Generator(device=self.device).manual_seed(
                    reseed_seed(self.seed, it))
                reseed_state(self.model, self.optimizer, self.gt_image, gen,
                             frac=self.reseed_frac)
            n = min(cs, self.iterations - it)
            # the second chunk (the first where there is one) is traced
            if self.profile_dir and (it == cs or (it == 0 and
                                                  self.iterations <= cs)):
                ms = self._traced_chunk(it, n)
                self.profile_dir = None
            else:
                ms = self._chunk(it, n)
            # one read-back per chunk
            head = torch.cat([ms["loss"].float(), ms["psnr"].float(),
                              ms["n_dropped_max"].float()[None]]
                             ).cpu().numpy()
            losses, psnrs = head[:n], head[n:2 * n]
            extra = {k: v.cpu().numpy() for k, v in ms.items()
                     if k not in BASE_METRICS}
            hist["loss"].extend(losses.tolist())
            hist["psnr"].extend(psnrs.tolist())
            hist["iter"].extend(range(it + 1, it + n + 1))
            self._log_scalars(it, losses, psnrs, n, extra)
            it += n
            nd = int(head[-1])
            self.chunk_dropped.append(nd)
            if nd > 0 and not warned_overflow:
                warned_overflow = True
                self.logwriter.write(
                    f"WARNING: iter {it}: rasterizer dropped up to {nd} "
                    "gaussian-tile instances this chunk (raise "
                    "RasterizeConfig.max_instances / max_tiles_per_gauss)")
            if it % 5000 < cs:
                self.logwriter.write(
                    f"iter {it}: loss {losses[n - 1]:.7f} "
                    f"psnr {psnrs[n - 1]:.4f}")
            if self.viz_every and (it % self.viz_every < cs
                                   or it >= self.iterations):
                self._dump_viz(it)
            if (self.ckpt_every and it < self.iterations
                    and it % self.ckpt_every < cs):
                save_train_state(
                    self.resume_path, self.model, self.optimizer, it,
                    {f"hist_{k}": np.asarray(v) for k, v in hist.items()},
                    self.generator)

    def train(self):
        """Fit (if ``iterations`` > 0), then ``finish``. Returns a dict of
        the image's results."""
        start_time = time.time()
        self.fit()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.finish(time.time() - start_time)

    def finish(self, end_time: float):
        """After the fit (``end_time`` seconds): the prune of a model that
        prunes (wMask, before the test, as in the JAX trainer), then test,
        FPS probe and artifacts. Returns a dict of the image's results."""
        if hasattr(self.model, "prune_points"):
            self.optimizer = self.model.prune_points(threshold=0.5)
        psnr_value, ms_ssim_value, num_points_final, n_dropped = self.test()
        test_end_time = self.fps_probe()
        self.logwriter.write(
            "Training Complete in {:.4f}s, Eval time:{:.8f}s, FPS:{:.4f}"
            .format(end_time, test_end_time, 1 / test_end_time))
        save_checkpoint(self.log_dir / "gaussian_model.npz",
                        *checkpoint_trees(self.model))
        np.save(self.log_dir / "training.npy",
                {"iterations": self._hist["iter"],
                 "training_psnr": self._hist["psnr"],
                 "training_time": end_time, "psnr": psnr_value,
                 "ms-ssim": ms_ssim_value, "rendering_time": test_end_time,
                 "rendering_fps": 1 / test_end_time,
                 "initial_points": self.num_points,
                 "final_points": num_points_final})
        return {"image": self.image_name, "H": self.H, "W": self.W,
                "psnr": psnr_value, "ms_ssim": ms_ssim_value,
                "training_time": end_time, "eval_time": test_end_time,
                "fps": 1 / test_end_time, "n_dropped": n_dropped,
                "iterations": self.iterations}

    @torch.no_grad()
    def test(self):
        """(psnr, ms_ssim, final_points, n_dropped) of the clamped
        evaluation render, on the original crop."""
        full = self.model.render(iteration=EVAL_ITERATION)
        n_dropped = int(full["raster_aux"]["n_dropped"])
        if n_dropped > 0:
            self.logwriter.write(
                "WARNING: rasterizer dropped {} gaussian-tile instances "
                "(raise RasterizeConfig.max_instances / max_tiles_per_gauss)"
                .format(n_dropped))
        out = full["render"][..., :self.crop_h, :self.crop_w]
        gt = self.gt_image[..., :self.crop_h, :self.crop_w]
        mse = float(torch.mean((out - gt) ** 2))
        psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
        # MS-SSIM needs >= 161 px per side (5 scales x 11-tap window);
        # smaller images fall back to single-scale SSIM
        if min(self.crop_h, self.crop_w) >= 161:
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
        """Seconds per frame over two ``render_burst``s queued back to back
        and synchronised once at the end, after one untimed warm-up burst
        (the JAX package times two bursts and divides by 200)."""
        return timed_bursts(lambda: render_burst(self.model), self.device)


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="GaussianImage (PyTorch + CUDA port): fit an image with "
                    "2D Gaussians, or evaluate a fitted checkpoint")
    p.add_argument("-d", "--dataset", type=str, default="./datasets/kodak/")
    p.add_argument("--data_name", type=str, default="kodak")
    p.add_argument("--iterations", type=int, default=50000)
    p.add_argument("--model_name", type=str, default="GaussianImage_Cholesky")
    p.add_argument("--sh_degree", type=int, default=3,
                   help="SH degree of the 3DGS colors (0-4)")
    p.add_argument("--num_points", type=int, default=50000)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save_imgs", action="store_true")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--opt_type", type=str, default="adan",
                   choices=["adan", "adam"])
    p.add_argument("--init_mode", type=str, default="adaptive",
                   choices=["uniform", "adaptive"],
                   help="Gaussian init: 'uniform' random (reference "
                        "behavior) or 'adaptive' GT-gradient-density "
                        "positions + GT colors (core/init.py)")
    p.add_argument("--chunk_size", type=int, default=250,
                   help="iterations per chunk: reseed rounds fire at the "
                        "first chunk boundary at or after each scheduled "
                        "iteration, and metrics are read once per chunk")
    p.add_argument("--checkpoint_root", type=str, default="./checkpoints")
    p.add_argument("--ckpt_every", type=int, default=10000,
                   help="save a mid-fit resume snapshot every N "
                        "iterations; 0 = off")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted fit from the image's "
                        "resume.pt snapshot if present")
    p.add_argument("--shape_bucket", type=int, default=0,
                   help="pad images up to a multiple of this many pixels "
                        "(metrics use the original crop); 0 = off")
    p.add_argument("--profile", type=str, default=None,
                   help="directory for a torch.profiler Chrome trace of the "
                        "second training chunk and 10 evaluation renders")
    p.add_argument("--log_every", type=int, default=100,
                   help="append loss/psnr to scalars.jsonl every N iters; "
                        "0 = off")
    p.add_argument("--viz_every", type=int, default=5000,
                   help="dump render/alpha-heatmap/gaussian-viz/center-"
                        "overlay PNGs every N iters; 0 = off")
    p.add_argument("--wandb", action="store_true",
                   help="mirror scalars to wandb if installed")
    p.add_argument("--wandb_project", type=str, default="gaussianimage_tpu")
    # wMask options (reference train.py:310-326), JAX's defaults
    p.add_argument("--start_mask_training", type=int, default=0)
    p.add_argument("--stop_mask_training", type=int, default=50000)
    p.add_argument("--reg_type", type=str, default="kl")
    p.add_argument("--target_sparsity", type=float, default=0.7)
    p.add_argument("--lambda_reg", type=float, default=0.005)
    p.add_argument("--no_reseed", action="store_true",
                   help="disable error-driven relocation rounds "
                        "(core/reseed.py; reference behavior)")
    p.add_argument("--reseed_rounds", type=int, default=6)
    p.add_argument("--reseed_frac", type=float, default=0.05)
    p.add_argument("--init_mask_logit", type=float, default=2.0)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--use_score", action="store_true")
    p.add_argument("--no_clamp", action="store_true")
    p.add_argument("--temp_init", type=float, default=0.5)
    p.add_argument("--temp_final", type=float, default=0.5)
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
        trainer = SimpleTrainer2d(
            img, image_name, num_points=args.num_points,
            iterations=args.iterations, model_name=args.model_name,
            model_path=args.model_path, args=args,
            log_dir=root / image_name, chunk_size=args.chunk_size,
            device=device)
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
