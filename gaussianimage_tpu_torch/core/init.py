"""Content-adaptive Gaussian initialization (counterpart of
gaussianimage_tpu/core/init.py:23-103): positions sampled from the GT's
gradient density, sigma from the local point spacing, colors from the GT
pixels. The random numbers come from a ``torch.Generator``, so a fit does
not start from the JAX package's points; the tests compare structure and
distribution."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the JAX package's defaults, the only values any caller uses
# (gaussianimage_tpu/core/init.py:23-24, :70-73, :93-94)
DENSITY_POWER = 0.5       # gradient magnitude exponent
DENSITY_MIX = 0.3         # share of the uniform floor in the density
SIGMA_COEF = 0.35         # sigma / expected local point spacing
SIGMA_RANGE = (0.7, 12.0)  # clip of the initial sigma, pixels
COLOR_SCALE = 0.5         # initial color / GT pixel


def _gray_planes(gt_image: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return gt_image.float().reshape(-1, H, W)


def gradient_density(gt_image: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[H*W] sampling probabilities from the GT's local gradient magnitude:
    luminance forward differences, a 3x3 box blur (edge-replicated), raised
    to ``DENSITY_POWER`` and mixed with a uniform floor ``DENSITY_MIX``."""
    gray = _gray_planes(gt_image, H, W).mean(dim=0)
    gx = torch.diff(gray, dim=1, append=gray[:, -1:])
    gy = torch.diff(gray, dim=0, append=gray[-1:, :])
    gm = torch.sqrt(gx * gx + gy * gy)
    p = F.pad(gm[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gm = (p[:-2, 1:-1] + p[1:-1, 1:-1] + p[2:, 1:-1]) / 3.0
    p = F.pad(gm[None, None], (1, 1, 0, 0), mode="replicate")[0, 0]
    gm = (p[:, :-2] + p[:, 1:-1] + p[:, 2:]) / 3.0
    w = torch.pow(torch.clamp(gm, min=0.0), DENSITY_POWER)
    w = w / torch.clamp(w.sum(), min=1e-12)
    return ((1.0 - DENSITY_MIX) * w + DENSITY_MIX / (H * W)).reshape(-1)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform on (tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_pixels(log_p: torch.Tensor, k: int, generator: torch.Generator
                  ) -> torch.Tensor:
    """k distinct indices drawn without replacement with probabilities
    exp(log_p) (Gumbel top-k)."""
    scores = log_p + gumbel(log_p.shape, generator, log_p.device)
    return torch.topk(scores, k).indices


def jittered_atanh(idx: torch.Tensor, H: int, W: int,
                   generator: torch.Generator) -> torch.Tensor:
    """[k, 2] atanh-space positions uniformly jittered within the pixel
    cells ``idx`` (row-major), clipped inside (-1, 1)."""
    y = torch.div(idx, W, rounding_mode="floor").float()
    x = (idx % W).float()
    u = torch.rand(idx.shape[0], 2, generator=generator, device=idx.device)
    xn = (x + u[:, 0]) / W * 2.0 - 1.0
    yn = (y + u[:, 1]) / H * 2.0 - 1.0
    pts = torch.clamp(torch.stack([xn, yn], dim=-1), -(1 - 1e-6), 1 - 1e-6)
    return torch.atanh(pts)


def adaptive_init_xyz(generator: torch.Generator, gt_image: torch.Tensor,
                      n: int, H: int, W: int) -> torch.Tensor:
    """[n, 2] positions in atanh space, sampled without replacement from the
    gradient density and jittered within each chosen pixel."""
    p = gradient_density(gt_image, H, W)
    idx = sample_pixels(torch.log(p), n, generator)
    return jittered_atanh(idx, H, W, generator)


def _pixel_of(xyz_atanh: torch.Tensor, H: int, W: int):
    pos = torch.tanh(xyz_atanh)
    x = torch.clamp(((pos[:, 0] + 1) * 0.5 * W).int(), 0, W - 1).long()
    y = torch.clamp(((pos[:, 1] + 1) * 0.5 * H).int(), 0, H - 1).long()
    return x, y


def adaptive_init_sigma(gt_image: torch.Tensor, xyz_atanh: torch.Tensor,
                        n: int, H: int, W: int) -> torch.Tensor:
    """[n] isotropic initial sigma in pixels: ``SIGMA_COEF`` x the expected
    local point spacing 1 / sqrt(n p) under the sampling density, clipped to
    ``SIGMA_RANGE``."""
    p = gradient_density(gt_image, H, W)
    x, y = _pixel_of(xyz_atanh, H, W)
    lam = n * p.reshape(H, W)[y, x]
    return torch.clamp(SIGMA_COEF / torch.sqrt(torch.clamp(lam, min=1e-12)),
                       *SIGMA_RANGE).float()


def init_colors_from_gt(gt_image: torch.Tensor, xyz_atanh: torch.Tensor,
                        H: int, W: int) -> torch.Tensor:
    """[n, 3] colors: the GT pixel under each position, times
    ``COLOR_SCALE``."""
    img = _gray_planes(gt_image, H, W)[:3]
    x, y = _pixel_of(xyz_atanh, H, W)
    return (img[:, y, x].T * COLOR_SCALE).float()
