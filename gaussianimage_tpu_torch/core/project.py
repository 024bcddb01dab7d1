"""Gaussian projection (counterpart of gaussianimage_tpu/core/project.py:
10-90, itself the equivalent of gsplat's ``project_gaussians_2d``).

A small elementwise map in plain PyTorch. Returns the reference's 5-tuple
``(xys [N,2] px, depths [N], radii [N], conics [N,3], num_tiles_hit [N])``:
``depths`` are zeros (no z in 2D) and ``num_tiles_hit`` counts tile-bbox
overlaps.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaussianimage_tpu_torch.core.covariance import (
    conic_from_cov2d,
    cov2d_from_cholesky,
    cov2d_from_scale_rot,
    ndc_to_pixel,
    radius_from_cov2d,
)

Projected = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor]


def _finish_projection(means, cov, H: int, W: int,
                       tile_bounds: Tuple[int, int, int],
                       block: Tuple[int, int] = (16, 16)) -> Projected:
    xys = ndc_to_pixel(means, H, W)
    conics = conic_from_cov2d(cov)
    radii = radius_from_cov2d(cov)
    depths = torch.zeros(means.shape[:-1], dtype=means.dtype,
                         device=means.device)
    # tile-overlap count of BLOCK x BLOCK tiles (performance metadata only)
    bh, bw = block
    tx, ty = tile_bounds[0], tile_bounds[1]
    x0 = torch.clamp(torch.floor((xys[..., 0] - radii) / bw), 0, tx)
    x1 = torch.clamp(torch.floor((xys[..., 0] + radii) / bw) + 1, 0, tx)
    y0 = torch.clamp(torch.floor((xys[..., 1] - radii) / bh), 0, ty)
    y1 = torch.clamp(torch.floor((xys[..., 1] + radii) / bh) + 1, 0, ty)
    num_tiles_hit = ((x1 - x0) * (y1 - y0)).to(torch.int32)
    return xys, depths, radii, conics, num_tiles_hit


def project_gaussians_2d(means: torch.Tensor, cholesky: torch.Tensor,
                         H: int, W: int,
                         tile_bounds: Tuple[int, int, int]) -> Projected:
    """means [N, 2] in NDC; cholesky [N, 3] = (l11, l21, l22), already offset
    by the model's cholesky bound."""
    return _finish_projection(means, cov2d_from_cholesky(cholesky), H, W,
                              tile_bounds)


def project_gaussians_2d_scale_rot(means: torch.Tensor, scales: torch.Tensor,
                                   rotation: torch.Tensor, H: int, W: int,
                                   tile_bounds: Tuple[int, int, int]
                                   ) -> Projected:
    """means [N, 2] in NDC; scales [N, 2] (positive); rotation [N, 1] or [N]
    in radians."""
    return _finish_projection(means, cov2d_from_scale_rot(scales, rotation),
                              H, W, tile_bounds)
