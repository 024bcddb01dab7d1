"""Error-driven Gaussian relocation ("reseeding") during a fit (counterpart
of gaussianimage_tpu/core/reseed.py:40-89), a constant-N analog of 3DGS
densification that the JAX package adds over the reference. At a few early
iterations the lowest-importance Gaussians move to the pixels the current
render reproduces worst:

- victims: the bottom ``frac`` of ``model.importance()`` (color energy x
  footprint area);
- targets: Gumbel-top-k samples, without replacement, from the squared
  per-pixel error density of the current render;
- new rows: position at the target pixel (jittered), color 0.7 x the GT
  residual there, isotropic sigma 1.5 px;
- the victims' rows of every optimizer moment (Adan's ``prev_grad``
  included) are zeroed in place, so stale momentum does not drag them
  back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaussianimage_tpu_torch.core.init import jittered_atanh, sample_pixels

# fractions of the fit at which rounds fire (the JAX package's ladder)
RESEED_FRACTIONS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.6)
# shorter fits do not reseed (gaussianimage_tpu/core/reseed.py:40-46)
MIN_RESEED_ITERS = 5000


def default_schedule(iterations: int, rounds: int = 6) -> Tuple[int, ...]:
    """Reseed iterations at fixed fractions of the fit; fits shorter than
    ``MIN_RESEED_ITERS`` do not reseed."""
    if iterations < MIN_RESEED_ITERS:
        return ()
    return tuple(int(f * iterations) for f in RESEED_FRACTIONS[:rounds])


def zero_optimizer_rows(optimizer: torch.optim.Optimizer, rows: torch.Tensor,
                        n: int) -> None:
    """Zero ``rows`` of every per-parameter optimizer tensor whose leading
    dimension is ``n``, in place in the optimizer's own state."""
    for state in optimizer.state.values():
        for v in state.values():
            if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == n:
                v[rows] = 0.0


@torch.no_grad()
def reseed_state(model, optimizer: torch.optim.Optimizer,
                 gt_image: torch.Tensor, generator: torch.Generator,
                 frac: float = 0.05) -> torch.Tensor:
    """One relocation round on ``model``'s parameters and ``optimizer``'s
    state, in place. Returns the victims' indices. ``model`` must set
    ``reseed_ok`` and provide ``importance`` and ``relocate``."""
    cfg = model.cfg
    H, W, N = cfg.H, cfg.W, cfg.num_points
    k = max(int(N * frac), 1)

    render = torch.clamp(model.render()["render"], 0.0, 1.0)  # [1,3,H,W]
    gt = gt_image.float().reshape(render.shape)
    err = ((render - gt) ** 2).sum(dim=(0, 1)).reshape(-1)     # [H*W]

    victims = torch.topk(-model.importance(), k).indices

    pe = err / torch.clamp(err.sum(), min=1e-12)
    pix = sample_pixels(torch.log(torch.clamp(pe, min=1e-20)), k, generator)
    new_xyz = jittered_atanh(pix, H, W, generator)
    resid = (gt - render)[0][:, torch.div(pix, W, rounding_mode="floor"),
                             pix % W].T                          # [k, 3]
    sigma = torch.full((k,), 1.5, dtype=torch.float32, device=render.device)

    model.relocate(victims, new_xyz, 0.7 * resid, sigma)
    zero_optimizer_rows(optimizer, victims, N)
    return victims
