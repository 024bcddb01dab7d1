from gaussianimage_tpu_torch.core.clip import clip01
from gaussianimage_tpu_torch.core.covariance import (
    conic_from_cov2d,
    cov2d_from_cholesky,
    cov2d_from_scale_rot,
    ndc_to_pixel,
    radius_from_cov2d,
)
from gaussianimage_tpu_torch.core.project import (
    project_gaussians_2d,
    project_gaussians_2d_scale_rot,
)
from gaussianimage_tpu_torch.core.render_ref import render_sum_dense

__all__ = [
    "clip01",
    "cov2d_from_cholesky",
    "cov2d_from_scale_rot",
    "conic_from_cov2d",
    "radius_from_cov2d",
    "ndc_to_pixel",
    "project_gaussians_2d",
    "project_gaussians_2d_scale_rot",
    "render_sum_dense",
]
