"""Model base (counterpart of the render part of gaussianimage_tpu/models/
base.py): the configuration and the render protocol. The training step,
optimizer and loss come with the training slice (ROADMAP.md)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from gaussianimage_tpu_torch.ops import RasterizeConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_points: int
    H: int
    W: int
    block_h: int = 16
    block_w: int = 16
    no_clamp: bool = False
    raster: RasterizeConfig = RasterizeConfig()

    @property
    def tile_bounds(self) -> Tuple[int, int, int]:
        return (-(-self.W // self.block_w), -(-self.H // self.block_h), 1)


class GaussianModelBase(nn.Module):
    """A model is an nn.Module holding its parameters; subclasses define
    ``render``."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.cfg = config

    def render(self, **kw) -> dict:
        raise NotImplementedError

    def render_fast(self) -> torch.Tensor:
        """Inference-only render returning [1, 3, H, W] — the FPS-probe /
        serving entry."""
        return self.render()["render"]

    def forward(self, **kw):
        return self.render(**kw)
