"""GaussianImage-Cholesky with a learnable pruning mask, the reference
fork's research model (counterpart of
gaussianimage_tpu/models/cholesky_mask.py; reference
gaussianimage_cholesky_wMask.py). Each Gaussian carries a mask logit that
gates its opacity, scheduled by iteration through three phases:

- 0, before ``start_mask_training``: no mask (opacity 1);
- 1, up to ``stop_mask_training``: a Gumbel-sigmoid sample of the logits
  (or, under ``use_score``, of logit x |L00 L22|) at an annealed
  temperature, with a sparsity regularizer (kl, ada_kl, l1 or l1sq) on
  sigmoid(logits) in the loss;
- 2, after: the deterministic mask sigmoid(logits) > 0.5.

Under ``use_ema`` an EMA of sigmoid(logits) is kept through phase 1, and at
the stop iteration the logits are set to +-10 by it. After a fit
``prune_points`` drops every Gaussian whose mask is off. The logits train
at their own learning rate (``MaskConfig.mask_lr``). The opacity differs
from 1, so the fused splat prep (K4-K7) and the fused L2 kernel (K3) stay
off: the model trains, evaluates and decodes through K1 and K2, with the
mask's gradient reaching the logits through autograd of the premultiplied
colors (``stream_common.pack_feat``).

``generator`` replaces JAX's ``key``; torch cannot draw ``jax.random``'s
numbers, so the noise differs from JAX's for the same seed, and tests hand
both packages the same uniforms through ``uniforms``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch import nn

from gaussianimage_tpu_torch.core import clip01
from gaussianimage_tpu_torch.models.base import MaskConfig, ModelConfig
from gaussianimage_tpu_torch.models.cholesky import GaussianImageCholesky
from gaussianimage_tpu_torch.ops import rasterize_gaussians_sum

REG_TYPES = ("kl", "ada_kl", "l1", "l1sq")
KL_EPS = 1e-5  # the KL's clip of the rates and targets away from 0 and 1
ADA_TILE = 16  # ada_kl's tile side in pixels
ADA_SPARSITY_MAX = 0.9  # ada_kl's target at the most varied GT tile
FINAL_LOGIT = 10.0  # |logit| set by the EMA at the stop iteration
NOISE_SEED = 0  # the generator of a call without one (JAX: PRNGKey(0))


def gumbel_sigmoid(logits: torch.Tensor, uniforms, temperature: float = 0.5,
                   hard: bool = False, eps: float = 1e-10) -> torch.Tensor:
    """sigmoid((logits + g) / temperature) with the reference's two-uniform
    logistic noise g = -log(log(u1 + eps) / log(u2 + eps) + eps) of
    ``uniforms`` (u1, u2); ``hard`` returns the 0/1 sample with the soft
    sample's gradient (straight through)."""
    u1, u2 = uniforms
    noise = -torch.log(torch.log(u1 + eps) / torch.log(u2 + eps) + eps)
    y_soft = torch.sigmoid((logits + noise) / temperature)
    if hard:
        y_hard = (y_soft > 0.5).to(y_soft.dtype)
        return y_soft + (y_hard - y_soft).detach()
    return y_soft


def _kl(tgt: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    return (tgt * torch.log(tgt / rho)
            + (1 - tgt) * torch.log((1 - tgt) / (1 - rho)))


def tile_sums(lin: torch.Tensor, values: torch.Tensor, n_bins: int):
    """(sums, counts) of ``values`` [N] over the bins ``lin`` [N] (int32 in
    [0, n_bins)), each bin summed in index order: a stable sort by bin, then
    one reduction per bin's run, with no float atomics (``index_add_`` on
    CUDA adds in arrival order), so two evaluations agree bit for bit."""
    order = torch.argsort(lin, stable=True)
    keys = lin[order]
    bounds = torch.searchsorted(keys, torch.arange(
        n_bins + 1, dtype=keys.dtype, device=keys.device))
    lengths = bounds[1:] - bounds[:-1]
    sums = torch.segment_reduce(values[order], "sum", lengths=lengths,
                                unsafe=True)
    return sums, lengths


class GaussianImageCholeskyMask(GaussianImageCholesky):
    name = "GaussianImage_Cholesky_wMask"
    # the opacity is the mask: the fused prep (opacity 1) and the fused L2
    # (the forward depends on the iteration and the noise) stay off;
    # relocation would fight the mask, which learns to remove Gaussians
    fused_prep_ok = False
    fused_l2 = False
    reseed_ok = False
    # outside phase 1 the loss does not reach the logits; JAX's gradient
    # there is zero and its optimizer still steps them
    zero_grad_params = ("_mask_logits",)

    def __init__(self, config: ModelConfig, device=None):
        super().__init__(config, device=device)
        mc = self.mask_cfg
        if mc.reg_type not in REG_TYPES:
            raise ValueError(f"unknown reg_type {mc.reg_type}; options: "
                             f"{REG_TYPES}")
        self._mask_logits = nn.Parameter(torch.full(
            (config.num_points, 1), mc.init_mask_logit,
            device=self._xyz.device))
        if mc.use_ema:
            self.register_buffer("mask_ema",
                                 torch.sigmoid(self._mask_logits.detach()))

    @property
    def mask_cfg(self) -> MaskConfig:
        return self.cfg.mask or MaskConfig()

    def lr_groups(self) -> Dict[str, float]:
        return {"_mask_logits": self.mask_cfg.mask_lr}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator, gt_image=None) -> None:
        """The Cholesky initialisation, every logit at
        ``init_mask_logit`` and the EMA at their sigmoid."""
        super().init_params(generator, gt_image=gt_image)
        self._mask_logits.fill_(self.mask_cfg.init_mask_logit)
        if self.mask_cfg.use_ema:
            self.mask_ema.copy_(torch.sigmoid(self._mask_logits))

    # -- schedule ------------------------------------------------------------
    def phase(self, iteration: int) -> int:
        """0 = no mask, 1 = soft (Gumbel), 2 = deterministic."""
        mc = self.mask_cfg
        if iteration < mc.start_mask_training:
            return 0
        return 1 if iteration < mc.stop_mask_training else 2

    def temperature(self, iteration: int) -> float:
        """The Gumbel temperature, annealed exponentially from temp_init to
        temp_final over the mask phase, in float32 as JAX computes it;
        constant when temp_init <= temp_final."""
        mc = self.mask_cfg
        if mc.temp_init <= mc.temp_final:
            return float(torch.tensor(mc.temp_init, dtype=torch.float32))
        duration = max(mc.stop_mask_training - mc.start_mask_training, 1)
        r = -math.log(mc.temp_final / mc.temp_init) / duration
        t = torch.tensor(min(max(iteration - mc.start_mask_training, 0),
                             duration), dtype=torch.float32)
        return float(torch.clamp(mc.temp_init * torch.exp(-r * t),
                                 min=mc.temp_final))

    def importance_score(self) -> torch.Tensor:
        """[N, 1] |L00 * L22|, detached (the opacity is fixed at 1)."""
        chol = self.get_cholesky_elements()
        return torch.abs(chol[:, 0] * chol[:, 2])[:, None].detach()

    def uniforms(self, generator: Optional[torch.Generator] = None):
        """(u1, u2), the [N, 1] uniforms of one Gumbel sample (JAX:
        uniform(key) and uniform(fold_in(key, 1))), drawn from
        ``generator``, or from one seeded NOISE_SEED."""
        logits = self._mask_logits
        if generator is None:
            generator = torch.Generator(device=logits.device).manual_seed(
                NOISE_SEED)
        return tuple(torch.rand(logits.shape, generator=generator,
                                device=logits.device) for _ in range(2))

    def mask_value(self, iteration: int = 0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """The [N, 1] mask of ``iteration``'s phase."""
        logits = self._mask_logits
        ph = self.phase(iteration)
        if ph == 0:
            return torch.ones_like(logits)
        if ph == 2:
            return (torch.sigmoid(logits) > 0.5).float()
        x = (logits * self.importance_score() if self.mask_cfg.use_score
             else logits)
        return gumbel_sigmoid(x, self.uniforms(generator),
                              self.temperature(iteration))

    # -- rendering -----------------------------------------------------------
    def render(self, xyz=None, iteration: int = 0,
               generator: Optional[torch.Generator] = None, **kw) -> dict:
        """The render [1, 3, H, W] at the mask of ``iteration`` (the
        evaluation renders at 1 << 30, the deterministic mask), clipped to
        [0, 1] as ``jnp.clip`` clips (the gradient splits at a tie), the
        alpha map, the opacities, the projected centers and the
        rasterizer's aux. ``xyz`` stands in for ``_xyz``; other keywords
        (``render_viz``) are ignored, as the JAX model ignores them."""
        cfg = self.cfg
        xys, radii, conics, colors, _ = self.splat(xyz)
        opac = self.mask_value(iteration, generator)
        img, alpha, aux = rasterize_gaussians_sum(
            xys, conics, colors, opac, cfg.H, cfg.W, radii=radii,
            config=cfg.raster)
        if not cfg.no_clamp:
            img = clip01(img)
        return {"render": img.permute(2, 0, 1)[None],
                "alpha_map": alpha[None, None], "final_opacities": opac,
                "xys": xys, "raster_aux": aux}

    # -- loss with the sparsity regularizer ----------------------------------
    def loss(self, gt_image, *, iteration: int = 0,
             generator: Optional[torch.Generator] = None):
        """The render's loss (or the QAT loss) plus lambda_reg times the
        regularizer, which counts in phase 1 only."""
        mc = self.mask_cfg
        if mc.reg_type == "ada_kl" and self.cfg.quantize:
            raise ValueError(
                "reg_type ada_kl reads the render's projected centers "
                "(aux['pkg']['xys']), which the quantized render has not; "
                "the JAX package raises a KeyError there")
        loss, aux = super().loss(gt_image, iteration=iteration,
                                 generator=generator)
        if self.phase(iteration) != 1:
            return loss, aux
        reg = self.regularizer(torch.sigmoid(self._mask_logits), gt_image,
                               aux)
        return loss + mc.lambda_reg * reg, aux

    def regularizer(self, probs, gt_image, aux) -> torch.Tensor:
        """The sparsity regularizer of the mask probabilities ``probs``
        [N, 1]: kl (KL of their mean against target_sparsity), ada_kl
        (``_adaptive_kl``, which reads the render's centers in ``aux``),
        l1 (their mean) or l1sq (its square)."""
        mc = self.mask_cfg
        if mc.reg_type == "ada_kl":
            return self._adaptive_kl(gt_image, probs, aux)
        if mc.reg_type == "kl":
            rho = torch.clamp(probs.mean(), KL_EPS, 1 - KL_EPS)
            tgt = min(max(mc.target_sparsity, KL_EPS), 1 - KL_EPS)
            return _kl(torch.full_like(rho, tgt), rho)
        if mc.reg_type == "l1":
            return probs.mean()
        return probs.mean() ** 2  # l1sq

    def _adaptive_kl(self, gt_image, probs, aux) -> torch.Tensor:
        """Mean over the GT's 16-px tiles of the KL between each tile's
        mean mask probability (of the Gaussians centred in it) and a target
        sparsity that rises with the tile's log-variance, from
        target_sparsity to ADA_SPARSITY_MAX (reference
        calc_adaptive_sparsity_scatter, :320-390)."""
        mc = self.mask_cfg
        H, W, tile = self.cfg.H, self.cfg.W, ADA_TILE
        ty, tx = H // tile, W // tile
        gt = gt_image.reshape(-1, H, W)[:, :ty * tile, :tx * tile]
        tiles = gt.reshape(-1, ty, tile, tx, tile).permute(1, 3, 0, 2, 4)
        tile_var = torch.var(tiles.reshape(ty * tx, -1), dim=1,
                             correction=0)
        logv = torch.log(torch.clamp(tile_var, min=1e-6))
        c_min = logv.min()
        c_max = torch.quantile(logv, 0.95)
        norm = torch.clamp((logv - c_min) / (c_max - c_min + 1e-5), 0.0,
                           1.0)
        target = (mc.target_sparsity
                  + (ADA_SPARSITY_MAX - mc.target_sparsity) * norm).detach()

        xys = aux["pkg"]["xys"].detach()
        # truncation toward zero, as astype(int32): x in (-16, 0) is tile 0
        ix = (xys[:, 0] / tile).to(torch.int32)
        iy = (xys[:, 1] / tile).to(torch.int32)
        on = (ix >= 0) & (ix < tx) & (iy >= 0) & (iy < ty)
        lin = torch.where(on, iy * tx + ix, ty * tx)  # overflow bucket
        p = torch.where(on, probs[:, 0], torch.zeros_like(probs[:, 0]))
        sums, cnts = tile_sums(lin, p, ty * tx + 1)
        sums, cnts = sums[:-1], cnts[:-1].float()
        rho = torch.where(cnts > 0, sums / torch.clamp(cnts, min=1),
                          target)
        rho = torch.clamp(rho, KL_EPS, 1 - KL_EPS)
        tgt = torch.clamp(target, KL_EPS, 1 - KL_EPS)
        return _kl(tgt, rho).mean()

    # -- QAT / codec ---------------------------------------------------------
    def _quantized_splat(self, params, means, geo, colors):
        """The Cholesky splat of the dequantized values with the
        deterministic mask of the model's logits, or the frame's
        (``params["_mask_logits"]``), as the opacity: the decode renders
        the image the fit evaluated."""
        xys, radii, conics, colors, _ = super()._quantized_splat(
            params, means, geo, colors)
        logits = (self._mask_logits if params is None
                  else params["_mask_logits"])
        return xys, radii, conics, colors, (torch.sigmoid(logits)
                                            > 0.5).float()

    # -- after each step -----------------------------------------------------
    @torch.no_grad()
    def update_extra(self, aux: Dict, iteration: int = 0) -> None:
        """Under ``use_ema``, in phase 1: ema <- d ema + (1 - d)
        sigmoid(logits) on the updated logits. As in the JAX model, the
        QAT mixin's update (the VQ state) is not called, so under QAT the
        codebooks stay at their k-means start."""
        mc = self.mask_cfg
        if mc.use_ema and self.phase(iteration) == 1:
            probs = torch.sigmoid(self._mask_logits)
            self.mask_ema.copy_(mc.ema_decay * self.mask_ema
                                + (1 - mc.ema_decay) * probs)

    @torch.no_grad()
    def post_update(self, iteration: int) -> None:
        """Under ``use_ema``, at ``stop_mask_training``: every logit to +10
        where the EMA is above 0.5, else -10."""
        mc = self.mask_cfg
        if mc.use_ema and iteration == mc.stop_mask_training:
            self._mask_logits.copy_(torch.where(
                self.mask_ema > 0.5, FINAL_LOGIT, -FINAL_LOGIT))

    @torch.no_grad()
    def step_metrics(self) -> Dict[str, torch.Tensor]:
        """sparsity_hard = mean(prob > 0.5), sparsity_soft = mean(prob),
        num_points_active = N * sparsity_hard (int32) (reference
        train.py:153-161)."""
        probs = torch.sigmoid(self._mask_logits)
        hard = (probs > 0.5).float().mean()
        return {"sparsity_hard": hard, "sparsity_soft": probs.mean(),
                "num_points_active": (hard * probs.shape[0]).to(torch.int32)}

    # -- hard pruning, after the fit -----------------------------------------
    @torch.no_grad()
    def prune_points(self, threshold: float = 0.5) -> torch.optim.Optimizer:
        """Keep the Gaussians with sigmoid(logit) > ``threshold``: every
        parameter and buffer of the model whose leading dimension is N (the
        EMA among them) shrinks to the kept rows; the rest (the quantizers'
        scale and beta, the VQ state) pass through. ``cfg.num_points``
        becomes the kept count. Prints ``Pruned points: N to N' points.``
        and returns a fresh optimizer."""
        keep = torch.sigmoid(self._mask_logits)[:, 0] > threshold
        n = keep.shape[0]
        for name, t in list(self.state_dict(keep_vars=True).items()):
            if "." in name or tuple(t.shape[:1]) != (n,):
                continue
            rows = t.detach()[keep]
            setattr(self, name, nn.Parameter(rows)
                    if isinstance(t, nn.Parameter) else rows)
        kept = int(self._mask_logits.shape[0])
        print(f"Pruned points: {n} to {kept} points.")
        self.cfg = dataclasses.replace(self.cfg, num_points=kept)
        return self.make_optimizer()
