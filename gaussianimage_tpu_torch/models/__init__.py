from gaussianimage_tpu_torch.models.base import MaskConfig, ModelConfig
from gaussianimage_tpu_torch.models.cholesky import GaussianImageCholesky
from gaussianimage_tpu_torch.models.cholesky_mask import (
    GaussianImageCholeskyMask)
from gaussianimage_tpu_torch.models.gs3d import Gaussian3D
from gaussianimage_tpu_torch.models.rs import GaussianImageRS

MODEL_REGISTRY = {"GaussianImage_Cholesky": GaussianImageCholesky,
                  "GaussianImage_Cholesky_wMask": GaussianImageCholeskyMask,
                  "GaussianImage_RS": GaussianImageRS,
                  "3DGS": Gaussian3D}


def make_model(model_name: str, device=None, **config_kwargs):
    """Factory: model name (reference naming) + ModelConfig fields, on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {model_name}; options: "
                         f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[model_name](ModelConfig(**config_kwargs),
                                      device=device)


__all__ = ["MaskConfig", "ModelConfig", "GaussianImageCholesky",
           "GaussianImageCholeskyMask", "GaussianImageRS", "Gaussian3D",
           "make_model", "MODEL_REGISTRY"]
