from gaussianimage_tpu_torch.ops.rasterize_sum import (
    RasterizeConfig,
    rasterize_gaussians_sum,
    rasterize_gaussians_sum_chw,
    rasterize_gaussians_sum_l2,
)

__all__ = ["RasterizeConfig", "rasterize_gaussians_sum",
           "rasterize_gaussians_sum_chw", "rasterize_gaussians_sum_l2"]
