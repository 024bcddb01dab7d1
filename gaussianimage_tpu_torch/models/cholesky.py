"""GaussianImage-Cholesky, the flagship 2D Gaussian image model (counterpart
of gaussianimage_tpu/models/cholesky.py; reference
gaussianimage_cholesky.py):

 - _xyz [N,2] in atanh space, means = tanh(_xyz) in (-1,1)
 - _cholesky [N,3] raw; L elements = _cholesky + (0.5, 0, 0.5)
 - _features_dc [N,3] colors (raw, no activation)
 - opacity fixed at 1
 - render: project + accumulated-sum rasterize, clip to [0, 1] as
   ``jnp.clip`` (``core.clip01``)

The parameters start at zero; ``init_params`` initialises them for a fit
(grid when N = H*W, adaptive from the GT, or uniform), and a fitted
checkpoint loads with ``load_state_dict(params_from_numpy(...))``. Under
``quantize`` the model also holds the codec's quantizer parameters and VQ
state (models/quantize_mixin.py), trains them (QAT: the quantized render
goes through the generic differentiable rasterizer, K1 forward and K2
backward, never the fused L2 kernel K3) and decodes code arrays.
``render_fast`` and the decode take the fused splat prep (K5, K4; K7 for a
batch of frames, ``fused_decode_batch``) where ``fused_decode_supported``
allows it, else the generic path.
"""

from __future__ import annotations

import torch
from torch import nn

from gaussianimage_tpu_torch import resolve_device
from gaussianimage_tpu_torch.core import clip01, project_gaussians_2d
from gaussianimage_tpu_torch.core.init import (adaptive_init_sigma,
                                               adaptive_init_xyz,
                                               init_colors_from_gt)
from gaussianimage_tpu_torch.models.base import GaussianModelBase, ModelConfig
from gaussianimage_tpu_torch.models.quantize_mixin import QuantizeMixin
from gaussianimage_tpu_torch.ops import rasterize_gaussians_sum
from gaussianimage_tpu_torch.ops.splat_prep import (
    fused_decode_cholesky, fused_decode_cholesky_batch, fused_decode_supported,
    fused_render_cholesky)

CHOLESKY_BOUND = (0.5, 0.0, 0.5)
VIZ_SEED = 1234  # fixed random colors of the Gaussian-shape visualization


class GaussianImageCholesky(QuantizeMixin, GaussianModelBase):
    name = "GaussianImage_Cholesky"
    fused_prep_ok = True

    def __init__(self, config: ModelConfig, device=None):
        super().__init__(config)
        device = resolve_device(device)
        N = config.num_points
        self._xyz = nn.Parameter(torch.zeros(N, 2, device=device))
        self._cholesky = nn.Parameter(torch.zeros(N, 3, device=device))
        self._features_dc = nn.Parameter(torch.zeros(N, 3, device=device))
        self.register_buffer(
            "cholesky_bound",
            torch.tensor(CHOLESKY_BOUND, dtype=torch.float32, device=device),
            persistent=False)
        if config.quantize:
            self.quantize_param_init(device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator, gt_image=None) -> None:
        """Initialise the parameters in place: a pixel grid when N = H*W;
        adaptive (GT gradient-density positions, GT colors, sigma from the
        point spacing; core/init.py) under init_mode "adaptive" with a GT;
        else uniform means. Colors and Cholesky elements the branch does not
        set are uniform on [0, 1)."""
        cfg = self.cfg
        N, H, W = cfg.num_points, cfg.H, cfg.W
        dev = self._xyz.device
        colors = chol0 = None
        if N == H * W:
            ys = torch.linspace(-1.0, 1.0, H, device=dev)
            xs = torch.linspace(-1.0, 1.0, W, device=dev)
            grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
            xyz = torch.atanh(grid.reshape(-1, 2) * (1 - 1e-4))
        elif cfg.init_mode == "adaptive" and gt_image is not None:
            gt = gt_image.to(dev)
            xyz = adaptive_init_xyz(generator, gt, N, H, W)
            colors = init_colors_from_gt(gt, xyz, H, W)
            sig = adaptive_init_sigma(gt, xyz, N, H, W)
            chol0 = torch.stack([sig - CHOLESKY_BOUND[0], torch.zeros_like(sig),
                                 sig - CHOLESKY_BOUND[2]], dim=1)
        else:
            u = torch.rand(N, 2, generator=generator, device=dev)
            xyz = torch.atanh((2.0 * u - 1.0) * (1 - 1e-6))
        if colors is None:
            colors = torch.rand(N, 3, generator=generator, device=dev)
        if chol0 is None:
            chol0 = torch.rand(N, 3, generator=generator, device=dev)
        self._xyz.copy_(xyz)
        self._cholesky.copy_(chol0)
        self._features_dc.copy_(colors)

    # -- reseeding hooks (core/reseed.py) ------------------------------------
    reseed_ok = True

    def importance(self) -> torch.Tensor:
        """[N] contribution proxy: color energy x footprint area
        (|L11 * L22| = sqrt(det cov))."""
        l = self._cholesky
        area = torch.abs((l[:, 0] + CHOLESKY_BOUND[0])
                         * (l[:, 2] + CHOLESKY_BOUND[2]))
        return torch.abs(self._features_dc).sum(dim=1) * area

    @torch.no_grad()
    def relocate(self, victims, new_xyz, new_colors, sigma) -> None:
        """Rewrite the victims' rows in place: position and color from the
        reseed targets, an isotropic sigma-px covariance (raw = sigma -
        bound)."""
        self._xyz[victims] = new_xyz
        self._features_dc[victims] = new_colors
        self._cholesky[victims] = torch.stack(
            [sigma - CHOLESKY_BOUND[0], torch.zeros_like(sigma),
             sigma - CHOLESKY_BOUND[2]], dim=1)

    # quantization hooks (QuantizeMixin) -------------------------------------
    def _uq_channels(self):
        return {"cholesky": 3}

    def _uq_raw_values(self):
        return {"cholesky": self._cholesky}

    def _quantized_splat(self, params, means, geo, colors):
        """Dequantized values -> the splat tuple (xys, radii, conics,
        colors, opacities): the generic decode's projection half. ``params``
        (a frame's parameters, or None) is read by a model whose opacity is
        a parameter (wMask's mask)."""
        cfg = self.cfg
        xys, _, radii, conics, _ = project_gaussians_2d(
            means, geo["cholesky"] + self.cholesky_bound, cfg.H, cfg.W,
            cfg.tile_bounds)
        opac = torch.ones(means.shape[0], 1, dtype=torch.float32,
                          device=means.device)
        return xys, radii, conics, colors, opac

    @torch.no_grad()
    def decompress_wo_ec(self, enc, params=None, vq=None):
        """The decode, with the model's quantizer and VQ state or a frame's
        (``params``, ``vq``). Where the fused prep's gate allows it, the
        dequantization, projection, packing and binning keys are one K4
        launch, then the sort and K1; otherwise the generic path runs."""
        if not self._fused_ok():
            return super().decompress_wo_ec(enc, params, vq)
        cfg = self.cfg
        uq = self._uq_state("cholesky", params)
        img, _, aux = fused_decode_cholesky(
            self._on_device(enc["xyz"]),
            self._on_device(enc["quant_cholesky"]), uq.scale, uq.beta,
            CHOLESKY_BOUND, self._on_device(enc["feature_dc_index"]),
            self.features_vq.combined_codebook(
                self.vq_state() if vq is None else vq), cfg.H, cfg.W,
            cfg.raster)
        img = clip01(img)
        return {"render": img[None], "raster_aux": aux}

    @torch.no_grad()
    def fused_decode_batch(self, params_b, extra_b, enc_b):
        """The batched decode (batched.py's contract: a leading [B] frame
        dimension on every leaf) through one K7 launch, one sort and one
        K1 on the stacked canvas. Returns {"render": [B, 3, H, W],
        "raster_aux": ...}, or None where the fused batch is not supported
        (the flag off, H not a multiple of the tile, or the stream past the
        flat limit); the caller then takes the generic stacked path."""
        cfg = self.cfg
        xyz = self._on_device(enc_b["xyz"])
        B, n = xyz.shape[0], xyz.shape[1]
        bcfg = cfg.raster.stacked(cfg.num_points, B)
        if (not self.fused_prep_ok or cfg.H % bcfg.tile_px
                or not fused_decode_supported(B * n, cfg.H * B, cfg.W,
                                              bcfg)):
            return None
        embed = extra_b["vq"].embed  # [B, Q, K, 3]
        comb = (embed[:, 0][:, :, None, :] + embed[:, 1][:, None, :, :]
                ).reshape(B, -1, embed.shape[-1])
        img, _, aux = fused_decode_cholesky_batch(
            xyz, self._on_device(enc_b["quant_cholesky"]),
            params_b["cholesky_quant_scale"], params_b["cholesky_quant_beta"],
            CHOLESKY_BOUND, self._on_device(enc_b["feature_dc_index"]), comb,
            cfg.H, cfg.W, bcfg)
        img = clip01(img)
        img = img.reshape(3, B, cfg.H, cfg.W).permute(1, 0, 2, 3)
        return {"render": img, "raster_aux": aux}

    @torch.no_grad()
    def render_fast(self, with_aux: bool = False):
        """The serving render [1, 3, H, W], and with ``with_aux`` the
        rasterizer's aux (n_dropped). Where the fused prep's gate allows
        it, tanh, the bound, the projection, the packing and the binning
        keys are one K5 launch, then the sort and K1; otherwise
        ``render()``. The image equals render()'s."""
        if not self._fused_ok():
            return super().render_fast(with_aux)
        cfg = self.cfg
        img, _, aux = fused_render_cholesky(
            self._xyz, self._cholesky, self._features_dc, CHOLESKY_BOUND,
            cfg.H, cfg.W, cfg.raster)
        if not cfg.no_clamp:
            img = clip01(img)
        return (img[None], aux) if with_aux else img[None]

    # activations ----------------------------------------------------------
    def get_xyz(self, xyz=None):
        return torch.tanh(self._xyz if xyz is None else xyz)

    def get_cholesky_elements(self):
        return self._cholesky + self.cholesky_bound

    def get_features(self):
        return self._features_dc

    # rendering -------------------------------------------------------------
    def splat(self, xyz=None, params=None):
        """Projected splat tuple (xys, radii, conics, colors, opacities).
        ``xyz`` stands in for ``_xyz`` (the FPS probe perturbs it);
        ``params`` (``_xyz``, ``_cholesky``, ``_features_dc``) for all
        three, as batched.py's frames do."""
        cfg = self.cfg
        if params is None:
            means = self.get_xyz(xyz)
            chol = self.get_cholesky_elements()
            colors = self.get_features()
        else:
            means = torch.tanh(params["_xyz"])
            chol = params["_cholesky"] + self.cholesky_bound
            colors = params["_features_dc"]
        xys, _, radii, conics, _ = project_gaussians_2d(
            means, chol, cfg.H, cfg.W, cfg.tile_bounds)
        opac = torch.ones(means.shape[0], 1, dtype=torch.float32,
                          device=xys.device)
        return xys, radii, conics, colors, opac

    def render(self, xyz=None, render_viz: bool = False, **kw) -> dict:
        """The clipped render [1, 3, H, W], the alpha map, the projected
        centers and the rasterizer's aux. ``render_viz`` adds
        ``gauss_render``, the Gaussians' shapes in fixed random colors."""
        cfg = self.cfg
        xys, radii, conics, colors, opac = self.splat(xyz)
        img, alpha, aux = rasterize_gaussians_sum(
            xys, conics, colors, opac, cfg.H, cfg.W, radii=radii,
            config=cfg.raster)
        if not cfg.no_clamp:
            img = clip01(img)
        out = {
            "render": img.permute(2, 0, 1)[None],   # [1,3,H,W]
            "alpha_map": alpha[None, None],         # [1,1,H,W]
            "final_opacities": opac,
            "xys": xys,
            "raster_aux": aux,
        }
        if render_viz:
            gen = torch.Generator(device=xys.device).manual_seed(VIZ_SEED)
            viz_colors = 0.5 * torch.rand(xys.shape[0], 3, generator=gen,
                                          device=xys.device)
            gimg, _, _ = rasterize_gaussians_sum(
                xys.detach(), conics.detach(), viz_colors, opac, cfg.H,
                cfg.W, radii=radii, config=cfg.raster)
            out["gauss_render"] = clip01(gimg).permute(2, 0, 1)[None]
        return out
