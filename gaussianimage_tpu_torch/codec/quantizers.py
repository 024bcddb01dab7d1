"""Scalar quantizers of the codec (counterpart of
gaussianimage_tpu/codec/quantizers.py; reference quantize.py):

- ``fake_quantize_half``: a float16 round trip with an identity gradient
  (reference FakeQuantizationHalf, quantize.py:15-24);
- ``UniformQuantizer``: asymmetric uniform quantization with a learned
  per-channel scale and offset (quantize.py:26-87). The reference computes
  an LSQ gradient scale and then discards it (:53-56), so its effective
  behaviour is a plain straight-through round with analytic gradients for
  scale and beta; this is that behaviour.

The quantizer objects are stateless; their state (scale, beta) is passed
in, and the model holds it as parameters.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class _STERound(torch.autograd.Function):
    """round() forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _FakeQuantizeHalf(torch.autograd.Function):
    """Round trip through float16, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return x.half().float()

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quantize_half(x: torch.Tensor) -> torch.Tensor:
    return _FakeQuantizeHalf.apply(x)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip as minimum(maximum(x, lo), hi): at a tie with a bound it
    splits the gradient as JAX does, where torch.clamp passes all of it."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


class UniformQuantizerState(NamedTuple):
    scale: torch.Tensor  # [num_channels]
    beta: torch.Tensor   # [num_channels]


class UniformQuantizer:
    """b-bit asymmetric uniform quantizer with learned scale/offset."""

    def __init__(self, bits: int = 6, signed: bool = False,
                 num_channels: int = 1):
        if signed:
            self.qmin = -(2 ** (bits - 1))
            self.qmax = 2 ** (bits - 1) - 1
        else:
            self.qmin = 0
            self.qmax = 2 ** bits - 1
        self.bits = bits
        self.num_channels = num_channels

    def init_state(self, device=None) -> UniformQuantizerState:
        v = torch.full((self.num_channels,), 1.0 / self.qmax,
                       dtype=torch.float32, device=device)
        return UniformQuantizerState(scale=v, beta=v.clone())

    def init_from_data(self, x: torch.Tensor) -> UniformQuantizerState:
        """Data-driven (min, max) range init, the two-stage warm start
        (reference _init_data, quantize.py:44-49)."""
        t_min = x.min(dim=0).values
        t_max = x.max(dim=0).values
        scale = (t_max - t_min) / (self.qmax - self.qmin)
        return UniformQuantizerState(scale=scale.float(),
                                     beta=t_min.float())

    def __call__(self, state: UniformQuantizerState, x: torch.Tensor
                 ) -> torch.Tensor:
        """Fake-quantize [N, C] with the straight-through round;
        differentiable with respect to x and the state."""
        code = _clip((x - state.beta) / state.scale, self.qmin, self.qmax)
        return _STERound.apply(code) * state.scale + state.beta

    def compress(self, state: UniformQuantizerState, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(integer codes as floats, dequantized values)."""
        code = _clip((x - state.beta) / state.scale, self.qmin, self.qmax)
        q = torch.round(code)
        return q, q * state.scale + state.beta

    def decompress(self, state: UniformQuantizerState, codes: torch.Tensor
                   ) -> torch.Tensor:
        return codes * state.scale + state.beta
