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
``render_fast`` under ``BlendConfig.fused_prep`` needs the fused 3DGS prep
(K10), which is not ported yet: it raises there.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gaussianimage_tpu_torch import resolve_device
from gaussianimage_tpu_torch.core.camera3d import project_gaussians
from gaussianimage_tpu_torch.core.sh import num_sh_bases, spherical_harmonics
from gaussianimage_tpu_torch.models.base import GaussianModelBase, ModelConfig
from gaussianimage_tpu_torch.ops.rasterize_blend import (
    BlendConfig, rasterize_gaussians_blend)

K10_NOT_PORTED = (
    "3DGS render_fast under fused_prep needs the fused 3DGS prep K10 "
    "(ops/splat_prep3d.py), which is not ported yet (ROADMAP.md); render() "
    "and render_fast without fused_prep work")


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
        # device buffers, so no render copies host data to the card
        self.register_buffer("viewmat", torch.tensor(
            [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 8.0],
             [0, 0, 0, 1.0]], device=device), persistent=False)
        self.register_buffer("translation", torch.tensor(
            [[0.0, 0.0, -8.0]], device=device), persistent=False)
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
        img = torch.minimum(img, img.new_ones(()))
        return {
            "render": img.permute(2, 0, 1)[None],   # [1,3,H,W]
            "alpha_map": alpha[None, None],         # [1,1,H,W]
            "xys": xys,
            "raster_aux": aux,
        }

    @torch.no_grad()
    def render_fast(self, with_aux: bool = False):
        """render()'s image; under ``fused_prep`` it raises until the fused
        3DGS prep (K10) is ported."""
        if self.blend_cfg.fused_prep:
            raise NotImplementedError(K10_NOT_PORTED)
        return super().render_fast(with_aux)
