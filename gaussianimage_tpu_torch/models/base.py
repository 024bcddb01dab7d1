"""Model base (counterpart of gaussianimage_tpu/models/base.py): the
configuration, the render protocol, the loss with its fused branch, the
optimizer and the training step.

A model is an ``nn.Module`` that holds its parameters; the optimizer holds
its moments. ``train_step`` runs one update and returns its metrics as
device scalars, so a loop of steps synchronises only where it reads them.

``render``, ``loss`` and ``train_step`` take the step's ``iteration`` and a
``torch.Generator`` (JAX: ``key``), which only a model whose forward
depends on them reads (wMask's scheduled, sampled mask); ``None`` stands
for a generator seeded 0, as JAX's ``key=None`` for ``PRNGKey(0)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from gaussianimage_tpu_torch.ops import (RasterizeConfig,
                                         rasterize_gaussians_sum_l2)
from gaussianimage_tpu_torch.ops.splat_prep import fused_decode_supported
from gaussianimage_tpu_torch.opt import Adan, step_lr
from gaussianimage_tpu_torch.utils.losses import loss_fn


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Learnable-pruning-mask options of the wMask model (a copy of the JAX
    package's; reference gaussianimage_cholesky_wMask.py:24-58 /
    train.py:310-326)."""
    start_mask_training: int = 0
    stop_mask_training: int = 50000
    reg_type: str = "kl"  # kl | ada_kl | l1 | l1sq
    target_sparsity: float = 0.7
    lambda_reg: float = 0.005
    init_mask_logit: float = 2.0
    use_ema: bool = False
    use_score: bool = False
    temp_init: float = 0.5
    temp_final: float = 0.5
    ema_decay: float = 0.99
    mask_lr: float = 0.005


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_points: int
    H: int
    W: int
    block_h: int = 16
    block_w: int = 16
    loss_type: str = "L2"
    lambda_value: float = 0.7
    lr: float = 1e-3
    opt_type: str = "adan"  # "adan" | "adam"
    lr_step_size: int = 20000
    lr_gamma: float = 0.5
    quantize: bool = False  # the codec's quantizers and VQ state (QAT)
    no_clamp: bool = False
    init_mode: str = "uniform"  # "uniform" (reference) | "adaptive"
    sh_degree: int = 3  # 3DGS only
    mask: Optional[MaskConfig] = None  # wMask only
    raster: RasterizeConfig = RasterizeConfig()

    @property
    def tile_bounds(self) -> Tuple[int, int, int]:
        return (-(-self.W // self.block_w), -(-self.H // self.block_h), 1)


class GaussianModelBase(nn.Module):
    """Subclasses define ``init_params`` and ``render`` (and ``splat`` to
    take the fused L2 step)."""

    # the fused render + L2 + backward (K3) is valid only when splat()
    # captures the whole forward
    fused_l2 = True
    # error-driven relocation support (core/reseed.py)
    reseed_ok = False
    # render_fast / the decode may take the fused splat prep, which fixes
    # opacity at 1; a model whose splat changes the opacity leaves it off
    fused_prep_ok = False
    # the loss the trainer fits this model under
    train_loss = "L2"
    # parameters given zero gradients where the loss does not reach them,
    # so that the optimizer steps them as under jax.value_and_grad
    zero_grad_params: Tuple[str, ...] = ()

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.cfg = config

    def init_params(self, generator: torch.Generator, gt_image=None) -> None:
        raise NotImplementedError

    def render(self, **kw) -> dict:
        raise NotImplementedError

    @torch.no_grad()
    def render_fast(self, with_aux: bool = False):
        """Inference-only render returning [1, 3, H, W] (and with
        ``with_aux`` the rasterizer's aux) — the serving entry. Default:
        render()'s image; a model may take a faster path to the same
        image."""
        pkg = self.render()
        img = pkg["render"]
        return (img, pkg["raster_aux"]) if with_aux else img

    def _fused_ok(self) -> bool:
        """The model takes the fused splat prep, and its gate
        (``fused_decode_supported``) allows it at this size and config."""
        cfg = self.cfg
        return self.fused_prep_ok and fused_decode_supported(
            self._xyz.shape[0], cfg.H, cfg.W, cfg.raster)

    def forward(self, **kw):
        return self.render(**kw)

    def loss(self, gt_image: torch.Tensor, *, iteration: int = 0,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict]:
        """(scalar loss, aux with "mse"), the JAX package's branch: L2 on a
        model whose splat() is its whole forward, and which does not
        quantize, takes the fused K3 pass; anything else renders (at
        ``iteration``, with ``generator``) and applies ``loss_fn``."""
        cfg = self.cfg
        if (cfg.loss_type == "L2" and self.fused_l2 and not cfg.quantize
                and hasattr(self, "splat")):
            xys, radii, conics, colors, opac = self.splat()
            mse, raux = rasterize_gaussians_sum_l2(
                xys, conics, colors, opac, gt_image[0], cfg.H, cfg.W,
                radii=radii, config=cfg.raster, clamp=not cfg.no_clamp)
            return mse, {"mse": mse, "pkg": {"raster_aux": raux}}
        pkg = self.render(iteration=iteration, generator=generator)
        img = pkg["render"]
        loss = loss_fn(img, gt_image, cfg.loss_type, cfg.lambda_value)
        mse = torch.mean((img.float() - gt_image.float()) ** 2)
        return loss, {"mse": mse, "render": img, "pkg": pkg}

    def update_extra(self, aux: Dict, iteration: int = 0) -> None:
        """After the optimizer step, on the updated parameters: install the
        carried state the step's forward computed (the VQ codebooks under
        QAT, wMask's EMA). Default: none."""

    def post_update(self, iteration: int) -> None:
        """After ``update_extra``: rewrite parameters in place (wMask's
        logit finalization at its stop iteration). Default: none."""

    def step_metrics(self) -> Dict[str, torch.Tensor]:
        """Per-step scalars beside loss and PSNR, on the parameters after
        the step (wMask's sparsity). Default: none."""
        return {}

    # -- optimizer -----------------------------------------------------------
    def lr_schedule(self):
        return step_lr(self.cfg.lr, self.cfg.lr_step_size, self.cfg.lr_gamma)

    def lr_groups(self) -> Dict[str, float]:
        """Parameters trained at their own learning rate, by name (JAX:
        ``_lr_groups``), each on StepLR from that rate with the model's step
        size and gamma. Default: none."""
        return {}

    def _param_groups(self):
        """[(parameters, schedule)]: every parameter not in ``lr_groups``
        on the model's schedule, then one group per named parameter."""
        cfg = self.cfg
        own = self.lr_groups()
        named = dict(self.named_parameters())
        groups = [([p for k, p in named.items() if k not in own],
                   self.lr_schedule())]
        for name, lr in own.items():
            groups.append(([named[name]],
                           step_lr(lr, cfg.lr_step_size, cfg.lr_gamma)))
        return groups

    def make_optimizer(self) -> torch.optim.Optimizer:
        """Adan, each group on its schedule, or Adam, whose groups'
        learning rates ``train_step`` sets from their schedules
        (``lr_fns``) before each update."""
        groups = self._param_groups()
        if self.cfg.opt_type == "adan":
            return Adan([{"params": ps, "lr": fn} for ps, fn in groups])
        if self.cfg.opt_type == "adam":
            opt = torch.optim.Adam([{"params": ps, "lr": fn(0)}
                                    for ps, fn in groups])
            opt.lr_fns = [fn for _, fn in groups]
            for group in opt.param_groups:
                group["count"] = 0
            return opt
        raise ValueError(f"unknown opt_type {self.cfg.opt_type}; options: "
                         "adan, adam")

    def init_state(self, generator: torch.Generator, gt_image=None
                   ) -> torch.optim.Optimizer:
        """Initialise the parameters in place; returns a fresh optimizer."""
        self.init_params(generator, gt_image=gt_image)
        return self.make_optimizer()

    # -- training ------------------------------------------------------------
    def train_step(self, optimizer: torch.optim.Optimizer,
                   gt_image: torch.Tensor, *, iteration: int = 0,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One update at ``iteration``, then ``update_extra``,
        ``post_update`` and ``step_metrics`` on the updated parameters (the
        JAX package's order, models/base.py:185-207 there). Returns device
        scalars: loss, psnr (of the step's mse), n_dropped (the
        instance-stream overflow) and the step metrics."""
        optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss(gt_image, iteration=iteration,
                              generator=generator)
        loss.backward()
        for name in self.zero_grad_params:
            p = getattr(self, name)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if not isinstance(optimizer, Adan):  # Adam: schedule at the count
            for group, fn in zip(optimizer.param_groups, optimizer.lr_fns):
                group["lr"] = fn(group["count"])
                group["count"] += 1
        optimizer.step()
        self.update_extra(aux, iteration)
        self.post_update(iteration)
        mse = aux["mse"].detach()
        psnr = 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))
        raux = aux.get("pkg", {}).get("raster_aux")
        n_dropped = (raux["n_dropped"] if raux is not None
                     else torch.zeros((), dtype=torch.int32,
                                      device=mse.device))
        return {"loss": loss.detach(), "psnr": psnr, "n_dropped": n_dropped,
                **self.step_metrics()}

    def train_chunk(self, optimizer: torch.optim.Optimizer,
                    gt_image: torch.Tensor, start_iteration: int,
                    n_steps: int,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """``n_steps`` calls of ``train_step`` at iterations
        ``start_iteration`` + 0 .. n_steps - 1 (the JAX package scans
        them in one jit call; here a plain loop). Returns the steps'
        ``loss``, ``psnr`` and step metrics stacked on the device, [n_steps]
        each, and ``n_dropped_max``, the chunk's worst instance-stream
        overflow, so that a fit that outgrows its stream cap warns during
        training."""
        ms = [self.train_step(optimizer, gt_image,
                              iteration=start_iteration + i,
                              generator=generator)
              for i in range(n_steps)]
        out = {k: torch.stack([m[k] for m in ms])
               for k in ms[0] if k != "n_dropped"}
        out["n_dropped_max"] = torch.stack(
            [m["n_dropped"] for m in ms]).max()
        return out
