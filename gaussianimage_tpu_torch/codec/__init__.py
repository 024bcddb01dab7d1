from gaussianimage_tpu_torch.codec.quantizers import (
    UniformQuantizer,
    UniformQuantizerState,
    fake_quantize_half,
)
from gaussianimage_tpu_torch.codec.vq import ResidualVQ, ResidualVQState

__all__ = [
    "fake_quantize_half",
    "UniformQuantizer",
    "UniformQuantizerState",
    "ResidualVQ",
    "ResidualVQState",
]
