"""GaussianImage-Cholesky, the flagship 2D Gaussian image model (counterpart
of gaussianimage_tpu/models/cholesky.py; reference
gaussianimage_cholesky.py):

 - _xyz [N,2] in atanh space, means = tanh(_xyz) in (-1,1)
 - _cholesky [N,3] raw; L elements = _cholesky + (0.5, 0, 0.5)
 - _features_dc [N,3] colors (raw, no activation)
 - opacity fixed at 1
 - render: project + accumulated-sum rasterize, clamp [0,1]

The parameters start at zero: this slice evaluates fitted checkpoints
(``load_state_dict(params_from_numpy(...))``); initialization comes with the
training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from gaussianimage_tpu_torch import resolve_device
from gaussianimage_tpu_torch.core import project_gaussians_2d
from gaussianimage_tpu_torch.models.base import GaussianModelBase, ModelConfig
from gaussianimage_tpu_torch.ops import rasterize_gaussians_sum

CHOLESKY_BOUND = (0.5, 0.0, 0.5)


class GaussianImageCholesky(GaussianModelBase):
    name = "GaussianImage_Cholesky"

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

    # activations ----------------------------------------------------------
    def get_xyz(self, xyz=None):
        return torch.tanh(self._xyz if xyz is None else xyz)

    def get_cholesky_elements(self):
        return self._cholesky + self.cholesky_bound

    def get_features(self):
        return self._features_dc

    # rendering -------------------------------------------------------------
    def splat(self, xyz=None):
        """Projected splat tuple (xys, radii, conics, colors, opacities).
        ``xyz`` stands in for ``_xyz`` (the FPS probe perturbs it)."""
        cfg = self.cfg
        xys, _, radii, conics, _ = project_gaussians_2d(
            self.get_xyz(xyz), self.get_cholesky_elements(), cfg.H, cfg.W,
            cfg.tile_bounds)
        N = self._xyz.shape[0]
        opac = torch.ones(N, 1, dtype=torch.float32, device=xys.device)
        return xys, radii, conics, self.get_features(), opac

    def render(self, xyz=None, **kw) -> dict:
        cfg = self.cfg
        xys, radii, conics, colors, opac = self.splat(xyz)
        img, alpha, aux = rasterize_gaussians_sum(
            xys, conics, colors, opac, cfg.H, cfg.W, radii=radii,
            config=cfg.raster)
        if not cfg.no_clamp:
            img = torch.clamp(img, 0.0, 1.0)
        return {
            "render": img.permute(2, 0, 1)[None],   # [1,3,H,W]
            "alpha_map": alpha[None, None],         # [1,1,H,W]
            "final_opacities": opac,
            "xys": xys,
            "raster_aux": aux,
        }
