"""The clip of every render to [0, 1], as the JAX package's ``jnp.clip``
clips it, gradient included.

``jnp.clip(x, 0, 1)`` is ``minimum(maximum(x, 0), 1)``. At a tie of the max
or the min (x exactly 0 or exactly 1) each passes half the cotangent, and
so do ``torch.maximum`` / ``torch.minimum``; ``torch.clamp`` passes all of
it. Ties are common: adaptive init gives a Gaussian on a black pixel a
color of exactly 0, and regions that only such Gaussians cover render
exactly 0. Where no gradient is taken, one ``torch.clamp`` gives the same
values in one launch.
"""

from __future__ import annotations

import torch


def clip01(x: torch.Tensor, lower: bool = True) -> torch.Tensor:
    """``x`` clipped to [0, 1], or only to at most 1 where ``lower`` is
    False (the 3DGS render clips the max only, as ``jnp.minimum``)."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, min=0.0 if lower else None, max=1.0)
    if lower:
        x = torch.maximum(x, x.new_zeros(()))
    return torch.minimum(x, x.new_ones(()))
