"""Model base (counterpart of gaussianimage_tpu/models/base.py): the
configuration, the render protocol, the loss with its fused branch, the
optimizer and the training step.

A model is an ``nn.Module`` that holds its parameters; the optimizer holds
its moments. ``train_step`` runs one update and returns its metrics as
device scalars, so a loop of steps synchronises only where it reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from gaussianimage_tpu_torch.ops import (RasterizeConfig,
                                         rasterize_gaussians_sum_l2)
from gaussianimage_tpu_torch.ops.splat_prep import fused_decode_supported
from gaussianimage_tpu_torch.opt import Adan, step_lr
from gaussianimage_tpu_torch.utils.losses import loss_fn


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

    def loss(self, gt_image: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """(scalar loss, aux with "mse"), the JAX package's branch: L2 on a
        model whose splat() is its whole forward, and which does not
        quantize, takes the fused K3 pass; anything else renders and
        applies ``loss_fn``."""
        cfg = self.cfg
        if (cfg.loss_type == "L2" and self.fused_l2 and not cfg.quantize
                and hasattr(self, "splat")):
            xys, radii, conics, colors, opac = self.splat()
            mse, raux = rasterize_gaussians_sum_l2(
                xys, conics, colors, opac, gt_image[0], cfg.H, cfg.W,
                radii=radii, config=cfg.raster, clamp=not cfg.no_clamp)
            return mse, {"mse": mse, "pkg": {"raster_aux": raux}}
        pkg = self.render()
        img = pkg["render"]
        loss = loss_fn(img, gt_image, cfg.loss_type, cfg.lambda_value)
        mse = torch.mean((img.float() - gt_image.float()) ** 2)
        return loss, {"mse": mse, "render": img, "pkg": pkg}

    def update_extra(self, aux: Dict) -> None:
        """After the optimizer step: install the carried state the step's
        forward computed (the VQ codebooks under QAT). Default: none."""

    # -- optimizer -----------------------------------------------------------
    def lr_schedule(self):
        return step_lr(self.cfg.lr, self.cfg.lr_step_size, self.cfg.lr_gamma)

    def make_optimizer(self) -> torch.optim.Optimizer:
        """Adan on the StepLR schedule, or Adam, whose learning rate
        ``train_step`` sets from the schedule before each update."""
        if self.cfg.opt_type == "adan":
            return Adan(self.parameters(), lr=self.lr_schedule())
        if self.cfg.opt_type == "adam":
            opt = torch.optim.Adam(self.parameters(), lr=self.cfg.lr)
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
                   gt_image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One update, then ``update_extra`` (the JAX package's order,
        models/base.py:199 there). Returns device scalars: loss, psnr (of
        the step's mse) and n_dropped (the instance-stream overflow)."""
        optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss(gt_image)
        loss.backward()
        if not isinstance(optimizer, Adan):  # Adam: schedule at the count
            sched = self.lr_schedule()
            for group in optimizer.param_groups:
                group["lr"] = sched(group["count"])
                group["count"] += 1
        optimizer.step()
        self.update_extra(aux)
        mse = aux["mse"].detach()
        psnr = 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))
        raux = aux.get("pkg", {}).get("raster_aux")
        n_dropped = (raux["n_dropped"] if raux is not None
                     else torch.zeros((), dtype=torch.int32,
                                      device=mse.device))
        return {"loss": loss.detach(), "psnr": psnr, "n_dropped": n_dropped}
