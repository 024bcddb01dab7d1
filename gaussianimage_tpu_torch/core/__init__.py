from gaussianimage_tpu_torch.core.covariance import (
    conic_from_cov2d,
    cov2d_from_cholesky,
    ndc_to_pixel,
    radius_from_cov2d,
)
from gaussianimage_tpu_torch.core.project import project_gaussians_2d
from gaussianimage_tpu_torch.core.render_ref import render_sum_dense

__all__ = [
    "cov2d_from_cholesky",
    "conic_from_cov2d",
    "radius_from_cov2d",
    "ndc_to_pixel",
    "project_gaussians_2d",
    "render_sum_dense",
]
