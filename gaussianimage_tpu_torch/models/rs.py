"""GaussianImage-RS, the rotation-scale covariance variant (counterpart of
gaussianimage_tpu/models/rs.py; reference gaussianimage_rs.py):

 - _xyz [N,2] in atanh space, means = tanh(_xyz) in (-1,1)
 - _scaling [N,2] raw; scales = |_scaling + 0.5|
 - _rotation [N,1] raw; theta = sigmoid(_rotation) * 2 pi
 - _features_dc [N,3] colors (raw, no activation); opacity fixed at 1
 - render: project + accumulated-sum rasterize, always clipped to [0, 1]
   as ``jnp.clip``

Under ``quantize`` the codec quantizes the raw scaling and the *activated*
rotation (radians) with 6-bit uniform quantizers, the means to float16 and
the colors with the residual VQ (models/quantize_mixin.py). ``render_fast``
takes the fused RS raw front K6b and the decode the RS decode front K6a
where ``fused_decode_supported`` allows it, else the generic path. There is
no batched decode kernel for RS: batched.py's generic stacked path decodes
a stack of RS frames.
"""

from __future__ import annotations

import torch
from torch import nn

from gaussianimage_tpu_torch import resolve_device
from gaussianimage_tpu_torch.core import (clip01,
                                         project_gaussians_2d_scale_rot)
from gaussianimage_tpu_torch.core.init import (adaptive_init_sigma,
                                               adaptive_init_xyz,
                                               init_colors_from_gt)
from gaussianimage_tpu_torch.models.base import GaussianModelBase, ModelConfig
from gaussianimage_tpu_torch.models.quantize_mixin import QuantizeMixin
from gaussianimage_tpu_torch.ops import rasterize_gaussians_sum
from gaussianimage_tpu_torch.ops.splat_prep import (TWO_PI, fused_decode_rs,
                                                    fused_render_rs)

SCALING_BOUND = (0.5, 0.5)


class GaussianImageRS(QuantizeMixin, GaussianModelBase):
    name = "GaussianImage_RS"
    fused_prep_ok = True
    reseed_ok = True

    def __init__(self, config: ModelConfig, device=None):
        super().__init__(config)
        device = resolve_device(device)
        N = config.num_points
        self._xyz = nn.Parameter(torch.zeros(N, 2, device=device))
        self._scaling = nn.Parameter(torch.zeros(N, 2, device=device))
        self._rotation = nn.Parameter(torch.zeros(N, 1, device=device))
        self._features_dc = nn.Parameter(torch.zeros(N, 3, device=device))
        self.register_buffer(
            "scaling_bound",
            torch.tensor(SCALING_BOUND, dtype=torch.float32, device=device),
            persistent=False)
        if config.quantize:
            self.quantize_param_init(device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator, gt_image=None) -> None:
        """Initialise the parameters in place: adaptive (GT gradient-density
        positions, GT colors, an isotropic sigma from the point spacing, so
        raw scaling = sigma - bound; core/init.py) under init_mode
        "adaptive" with a GT, else uniform means, colors and raw scaling on
        [0, 1). The raw rotation is uniform on [0, 1) in both branches; the
        JAX model has no pixel-grid branch."""
        cfg = self.cfg
        N, H, W = cfg.num_points, cfg.H, cfg.W
        dev = self._xyz.device
        if cfg.init_mode == "adaptive" and gt_image is not None:
            gt = gt_image.to(dev)
            xyz = adaptive_init_xyz(generator, gt, N, H, W)
            colors = init_colors_from_gt(gt, xyz, H, W)
            sig = adaptive_init_sigma(gt, xyz, N, H, W)
            scaling0 = torch.stack([sig - SCALING_BOUND[0],
                                    sig - SCALING_BOUND[1]], dim=1)
        else:
            u = torch.rand(N, 2, generator=generator, device=dev)
            xyz = torch.atanh((2.0 * u - 1.0) * (1 - 1e-6))
            colors = torch.rand(N, 3, generator=generator, device=dev)
            scaling0 = torch.rand(N, 2, generator=generator, device=dev)
        self._xyz.copy_(xyz)
        self._scaling.copy_(scaling0)
        self._rotation.copy_(torch.rand(N, 1, generator=generator,
                                        device=dev))
        self._features_dc.copy_(colors)

    # -- reseeding hooks (core/reseed.py) ------------------------------------
    def importance(self) -> torch.Tensor:
        """[N] contribution proxy: color energy x footprint area
        (|sx * sy| = sqrt(det cov))."""
        s = self.get_scaling()
        return torch.abs(self._features_dc).sum(dim=1) * s[:, 0] * s[:, 1]

    @torch.no_grad()
    def relocate(self, victims, new_xyz, new_colors, sigma) -> None:
        """Rewrite the victims' rows in place: position and color from the
        reseed targets, an isotropic sigma-px footprint (raw scaling =
        sigma - bound); the rotation stays as it is."""
        self._xyz[victims] = new_xyz
        self._features_dc[victims] = new_colors
        self._scaling[victims] = torch.stack(
            [sigma - SCALING_BOUND[0], sigma - SCALING_BOUND[1]], dim=1)

    # quantization hooks (QuantizeMixin): the raw scaling, but the
    # *activated* rotation (reference gaussianimage_rs.py:50-52,100-102) ----
    def _uq_channels(self):
        return {"scaling": 2, "rotation": 1}

    def _uq_raw_values(self):
        return {"scaling": self._scaling, "rotation": self.get_rotation()}

    def _quantized_splat(self, params, means, geo, colors):
        """Dequantized values -> the splat tuple (xys, radii, conics,
        colors, opacities): scales |scaling + bound|, the rotation in
        radians as it stands."""
        cfg = self.cfg
        xys, _, radii, conics, _ = project_gaussians_2d_scale_rot(
            means, torch.abs(geo["scaling"] + self.scaling_bound),
            geo["rotation"], cfg.H, cfg.W, cfg.tile_bounds)
        opac = torch.ones(means.shape[0], 1, dtype=torch.float32,
                          device=means.device)
        return xys, radii, conics, colors, opac

    @torch.no_grad()
    def decompress_wo_ec(self, enc, params=None, vq=None):
        """The decode, with the model's quantizer and VQ state or a frame's
        (``params``, ``vq``). Where the fused prep's gate allows it, the
        dequantization, projection, packing and binning keys are one K6a
        launch, then the sort and K1; otherwise the generic path runs."""
        if not self._fused_ok():
            return super().decompress_wo_ec(enc, params, vq)
        cfg = self.cfg
        s = self._uq_state("scaling", params)
        r = self._uq_state("rotation", params)
        img, _, aux = fused_decode_rs(
            self._on_device(enc["xyz"]),
            self._on_device(enc["quant_scaling"]),
            self._on_device(enc["quant_rotation"]), s.scale, s.beta,
            r.scale, r.beta, SCALING_BOUND,
            self._on_device(enc["feature_dc_index"]),
            self.features_vq.combined_codebook(
                self.vq_state() if vq is None else vq), cfg.H, cfg.W,
            cfg.raster)
        img = clip01(img)
        return {"render": img[None], "raster_aux": aux}

    @torch.no_grad()
    def render_fast(self, with_aux: bool = False):
        """The serving render [1, 3, H, W], and with ``with_aux`` the
        rasterizer's aux (n_dropped). Where the fused prep's gate allows
        it, one K6b launch, the sort and K1; otherwise ``render()``."""
        if not self._fused_ok():
            return super().render_fast(with_aux)
        cfg = self.cfg
        img, _, aux = fused_render_rs(
            self._xyz, self._scaling, self._rotation, self._features_dc,
            SCALING_BOUND, cfg.H, cfg.W, cfg.raster)
        if not cfg.no_clamp:
            img = clip01(img)
        return (img[None], aux) if with_aux else img[None]

    # activations ----------------------------------------------------------
    def get_xyz(self, xyz=None):
        return torch.tanh(self._xyz if xyz is None else xyz)

    def get_scaling(self):
        return torch.abs(self._scaling + self.scaling_bound)

    def get_rotation(self):
        return torch.sigmoid(self._rotation) * TWO_PI

    def get_features(self):
        return self._features_dc

    # rendering -------------------------------------------------------------
    def splat(self, xyz=None, params=None):
        """Projected splat tuple (xys, radii, conics, colors, opacities).
        ``xyz`` stands in for ``_xyz`` (the FPS probe perturbs it);
        ``params`` (``_xyz``, ``_scaling``, ``_rotation``,
        ``_features_dc``) for all four, as batched.py's frames do."""
        cfg = self.cfg
        if params is None:
            means = self.get_xyz(xyz)
            scales = self.get_scaling()
            theta = self.get_rotation()
            colors = self.get_features()
        else:
            means = torch.tanh(params["_xyz"])
            scales = torch.abs(params["_scaling"] + self.scaling_bound)
            theta = torch.sigmoid(params["_rotation"]) * TWO_PI
            colors = params["_features_dc"]
        xys, _, radii, conics, _ = project_gaussians_2d_scale_rot(
            means, scales, theta, cfg.H, cfg.W, cfg.tile_bounds)
        opac = torch.ones(means.shape[0], 1, dtype=torch.float32,
                          device=xys.device)
        return xys, radii, conics, colors, opac

    def render(self, xyz=None, **kw) -> dict:
        """The render [1, 3, H, W], clipped to [0, 1] always (the JAX model
        ignores ``no_clamp`` here), the alpha map, the projected centers and
        the rasterizer's aux. Other keywords (``render_viz``) are accepted
        and ignored: there is no Gaussian-shape visualization."""
        cfg = self.cfg
        xys, radii, conics, colors, opac = self.splat(xyz)
        img, alpha, aux = rasterize_gaussians_sum(
            xys, conics, colors, opac, cfg.H, cfg.W, radii=radii,
            config=cfg.raster)
        img = clip01(img)
        return {
            "render": img.permute(2, 0, 1)[None],   # [1,3,H,W]
            "alpha_map": alpha[None, None],         # [1,1,H,W]
            "final_opacities": opac,
            "xys": xys,
            "raster_aux": aux,
        }
