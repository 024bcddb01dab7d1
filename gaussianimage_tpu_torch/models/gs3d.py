"""The 3D Gaussian splatting baseline: fits an image through a fixed camera
with sorted alpha-blend compositing (counterpart of gaussianimage_tpu/
models/gs3d.py; reference gaussiansplatting_3d.py):

 - _xyz [N,3] uniform in [-1, 1]^3; _scaling [N,3] log scales from the mean
   distance to the 3 nearest neighbours
 - _opacity [N,1] logit, init logit(0.1); _rotation [N,4] random unit
   quaternions
 - colors from SH of degree sh_degree: _features_dc [N,1,3] and
   _features_rest [N,K-1,3] (zero at init); sigmoid of the DC term at
   degree 0
 - fixed camera: viewmat z += 8, 90 degree field of view, focal W/2
 - render: project -> SH -> depth-sorted alpha blend (K8 forward, K9
   backward) on a white background, clamped at 1 from above; trained under
   Fusion2 (the trainer's choice for 3DGS)

``init_params`` ignores the GT image, as the JAX model does: 3DGS starts
from uniform positions, not from the image. No fused L2 and no reseeding.
``render_fast`` under ``BlendConfig.fused_prep`` (``make_model("3DGS",
raster=RasterizeConfig(fused_prep=True))``) serves through the fused 3DGS
prep: the depth order, one K10 launch over the depth-ordered rows, one sort
of its keys and K8 (ops/splat_prep3d.py); without the flag, or where the
gate refuses, it is ``render()``'s image.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gaussianimage_tpu_torch import resolve_device
from gaussianimage_tpu_torch.core import clip01
from gaussianimage_tpu_torch.core.camera3d import project_gaussians
from gaussianimage_tpu_torch.core.sh import num_sh_bases, spherical_harmonics
from gaussianimage_tpu_torch.models.base import GaussianModelBase, ModelConfig
from gaussianimage_tpu_torch.ops import stream_common as sc
from gaussianimage_tpu_torch.ops.rasterize_blend import (
    BlendConfig, _depth_order, rasterize_blend_from_keys_chw,
    rasterize_gaussians_blend)
from gaussianimage_tpu_torch.ops.splat_prep3d import (camera,
                                                      fused_blend_supported,
                                                      fused_prep_blend3d)

# the fixed camera: the view moved 8 back along z, the SH origin there
VIEWMAT = ((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 8.0),
           (0.0, 0.0, 0.0, 1.0))
TRANSLATION = (0.0, 0.0, -8.0)


def random_quat(generator: torch.Generator, N: int, device=None
                ) -> torch.Tensor:
    """[N, 4] uniformly random unit quaternions (Shoemake)."""
    u, v, w = torch.rand(N, 3, generator=generator, device=device).unbind(1)
    tp = 2.0 * math.pi
    return torch.stack([
        torch.sqrt(1 - u) * torch.sin(tp * v),
        torch.sqrt(1 - u) * torch.cos(tp * v),
        torch.sqrt(u) * torch.sin(tp * w),
        torch.sqrt(u) * torch.cos(tp * w),
    ], dim=1)


def knn_mean_dist(x: torch.Tensor, k: int = 3, chunk: int = 256
                  ) -> torch.Tensor:
    """[N] mean distance to the k nearest neighbours (excluding self), in
    chunks of ``chunk`` query points."""
    out = []
    for s in range(0, x.shape[0], chunk):
        d2 = ((x[s:s + chunk, None, :] - x[None, :, :]) ** 2).sum(dim=-1)
        # the k+1 smallest include self (distance 0)
        near = torch.topk(d2, k + 1, dim=1, largest=False).values
        out.append(torch.sqrt(torch.clamp(near[:, 1:], min=0.0)).mean(dim=1))
    return torch.cat(out)


class Gaussian3D(GaussianModelBase):
    name = "3DGS"
    fused_l2 = False  # no splat(): the loss renders and applies loss_fn
    train_loss = "Fusion2"  # the JAX trainer's loss for 3DGS

    def __init__(self, config: ModelConfig, device=None):
        super().__init__(config)
        device = resolve_device(device)
        N = config.num_points
        K = num_sh_bases(config.sh_degree)
        self._xyz = nn.Parameter(torch.zeros(N, 3, device=device))
        self._scaling = nn.Parameter(torch.zeros(N, 3, device=device))
        self._opacity = nn.Parameter(torch.zeros(N, 1, device=device))
        self._rotation = nn.Parameter(torch.zeros(N, 4, device=device))
        self._features_dc = nn.Parameter(torch.zeros(N, 1, 3, device=device))
        self._features_rest = nn.Parameter(
            torch.zeros(N, K - 1, 3, device=device))
        self.focal = 0.5 * float(config.W) / math.tan(0.5 * math.pi / 2.0)
        # device buffers, so no render copies host data to the card; the
        # fused prep takes the same camera as host floats
        self.register_buffer("viewmat", torch.tensor(VIEWMAT, device=device),
                             persistent=False)
        self.register_buffer("translation", torch.tensor(
            [TRANSLATION], device=device), persistent=False)
        self.cam = camera(VIEWMAT, self.focal, self.focal, config.W / 2,
                          config.H / 2, TRANSLATION)
        self.register_buffer("background", torch.ones(3, device=device),
                             persistent=False)
        self.blend_cfg = BlendConfig(tile_px=32, max_tiles_per_gauss=36,
                                     fused_prep=config.raster.fused_prep)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator, gt_image=None) -> None:
        """Initialise the parameters in place: means uniform in [-1, 1]^3,
        isotropic log scales from the 3-NN mean distance, opacity
        logit(0.1), random rotations, DC colors uniform on [0, 1), the
        higher SH bands zero. ``gt_image`` is not used."""
        N = self.cfg.num_points
        dev = self._xyz.device
        xyz = 2.0 * (torch.rand(N, 3, generator=generator, device=dev) - 0.5)
        avg_dist = knn_mean_dist(xyz, k=3)
        self._xyz.copy_(xyz)
        self._scaling.copy_(torch.log(avg_dist[:, None].expand(N, 3)))
        self._opacity.fill_(math.log(0.1 / 0.9))
        self._rotation.copy_(random_quat(generator, N, dev))
        self._features_dc.copy_(
            torch.rand(N, 1, 3, generator=generator, device=dev))
        self._features_rest.zero_()

    def get_scaling(self):
        return torch.exp(self._scaling)

    def get_opacity(self):
        return torch.sigmoid(self._opacity)

    def get_features(self):
        return torch.cat([self._features_dc, self._features_rest], dim=1)

    def project(self, xyz=None):
        """(xys, depths, radii, conics, colors, opacities): the projection,
        the SH colors and the opacity the blend takes. ``xyz`` stands in for
        ``_xyz`` (the FPS probe perturbs it)."""
        cfg = self.cfg
        xyz = self._xyz if xyz is None else xyz
        quats = self._rotation / torch.linalg.norm(self._rotation, dim=-1,
                                                   keepdim=True)
        xys, depths, radii, conics, _, _ = project_gaussians(
            xyz, self.get_scaling(), 1.0, quats, self.viewmat, self.viewmat,
            self.focal, self.focal, cfg.W / 2, cfg.H / 2, cfg.H, cfg.W,
            cfg.tile_bounds)
        if cfg.sh_degree > 0:
            viewdirs = xyz.detach() - self.translation
            viewdirs = viewdirs / torch.linalg.norm(viewdirs, dim=-1,
                                                    keepdim=True)
            rgbs = spherical_harmonics(cfg.sh_degree, viewdirs,
                                       self.get_features())
            # torch.maximum against a tensor splits a tie's gradient as
            # jnp.maximum does (clamp would pass all of it)
            rgbs = torch.maximum(rgbs + 0.5, rgbs.new_zeros(()))
        else:
            rgbs = torch.sigmoid(self._features_dc[:, 0, :])
        return xys, depths, radii, conics, rgbs, self.get_opacity()

    def render(self, xyz=None, **kw) -> dict:
        """The render [1, 3, H, W] on a white background, clamped at 1
        from above (the reference clamps the max only), the alpha map, the
        projected centers and the rasterizer's aux. Other keywords
        (``render_viz``) are accepted and ignored."""
        cfg = self.cfg
        xys, depths, radii, conics, rgbs, opac = self.project(xyz)
        img, alpha, aux = rasterize_gaussians_blend(
            xys, depths, radii, conics, rgbs, opac, cfg.H, cfg.W,
            background=self.background, config=self.blend_cfg)
        img = clip01(img, lower=False)
        return {
            "render": img.permute(2, 0, 1)[None],   # [1,3,H,W]
            "alpha_map": alpha[None, None],         # [1,1,H,W]
            "xys": xys,
            "raster_aux": aux,
        }

    @torch.no_grad()
    def prep_rows(self):
        """(order [N] int64, [xyz, scaling, rotation, opacity, coeffs]):
        the depth order, render()'s, and K10's raw row inputs gathered into
        it; coeffs [N, 3K] basis-major, the DC colors [N, 3] at degree 0."""
        N = self._xyz.shape[0]
        # t[:, 2] as camera3d.project_gaussians computes it (each product
        # and sum rounded in its order), so the order is render()'s
        xyz, V = self._xyz, self.viewmat
        depth = (xyz[:, 0] * V[2, 0] + xyz[:, 1] * V[2, 1]
                 + xyz[:, 2] * V[2, 2]) + V[2, 3]
        order = _depth_order(depth).long()
        if self.cfg.sh_degree > 0:
            coeffs = self.get_features().reshape(N, -1)
        else:
            coeffs = self._features_dc[:, 0, :]
        return order, [x[order] for x in (xyz, self._scaling, self._rotation,
                                          self._opacity, coeffs)]

    @torch.no_grad()
    def render_fast(self, with_aux: bool = False):
        """The serving render [1, 3, H, W], and with ``with_aux`` the
        rasterizer's aux (n_dropped, max_count). Under ``fused_prep``,
        where ``fused_blend_supported`` allows it: the depth order, the
        rows gathered into it, one K10 launch, one sort of its keys and K8,
        clamped at 1 as ``render()`` is. Its image equals render()'s up to
        isolated pixels at a gate or a tile edge: render() normalises the
        quaternion twice and the view direction with ``linalg.norm``, K10
        as the JAX kernel does, so a few values differ in the last ulp.
        Otherwise ``render()``."""
        cfg = self.cfg
        N = self._xyz.shape[0]
        bcfg = self.blend_cfg
        if not fused_blend_supported(N, cfg.H, cfg.W, bcfg):
            return super().render_fast(with_aux)
        I0, m_span, _ = sc.stream_caps(N, bcfg)
        feat, keys, trunc, n_total = fused_prep_blend3d(
            *self.prep_rows()[1], self.cam, cfg.sh_degree, cfg.H, cfg.W,
            bcfg, m_span)
        img, _, aux = rasterize_blend_from_keys_chw(
            feat, keys, trunc, n_total, cfg.H, cfg.W, self.background, bcfg,
            I0)
        img = clip01(img, lower=False)[None]
        return (img, aux) if with_aux else img
