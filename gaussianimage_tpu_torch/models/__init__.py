from gaussianimage_tpu_torch.models.base import ModelConfig
from gaussianimage_tpu_torch.models.cholesky import GaussianImageCholesky
from gaussianimage_tpu_torch.models.gs3d import Gaussian3D
from gaussianimage_tpu_torch.models.rs import GaussianImageRS

MODEL_REGISTRY = {"GaussianImage_Cholesky": GaussianImageCholesky,
                  "GaussianImage_RS": GaussianImageRS,
                  "3DGS": Gaussian3D}

# models of the JAX package that the port does not have yet (ROADMAP.md)
NOT_PORTED = ("GaussianImage_Cholesky_wMask",)


def make_model(model_name: str, device=None, **config_kwargs):
    """Factory: model name (reference naming) + ModelConfig fields, on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    if model_name in NOT_PORTED:
        raise NotImplementedError(
            f"{model_name} is not ported to gaussianimage_tpu_torch yet "
            "(see ROADMAP.md, modules to port)")
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {model_name}; options: "
                         f"{sorted(MODEL_REGISTRY) + list(NOT_PORTED)}")
    return MODEL_REGISTRY[model_name](ModelConfig(**config_kwargs),
                                      device=device)


__all__ = ["ModelConfig", "GaussianImageCholesky", "GaussianImageRS",
           "Gaussian3D", "make_model", "MODEL_REGISTRY"]
