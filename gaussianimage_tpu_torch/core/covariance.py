"""2D Gaussian covariance math on tensors (counterpart of gaussianimage_tpu/
core/covariance.py:23-90).

- ``cov2d_from_cholesky`` consumes lower-triangular Cholesky elements
  ``(l11, l21, l22)`` (raw params plus the model's ``[0.5, 0, 0.5]`` bound)
  and treats the covariance as being in *pixel* units;
  ``cov2d_from_scale_rot`` builds it from two scales and a rotation angle
  (the RS model).
- Means live in NDC ``[-1, 1]`` and map to pixel centers with the gsplat
  convention ``px = 0.5 * ((x + 1) * W - 1)``.

All functions are elementwise over the leading N axis, in the order of
operations of the JAX package so float32 results agree to the ulp.
"""

from __future__ import annotations

import torch


def ndc_to_pixel(means: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """NDC means [N, 2] (x, y in [-1, 1]) -> pixel coordinates [N, 2].

    Pixel centers sit at integer coordinates 0 .. W-1 / 0 .. H-1; NDC -1 maps
    to -0.5 (left edge of pixel 0) and +1 to W-0.5 (right edge of pixel W-1).
    """
    # per-axis scalars, not a [W, H] tensor: building a device tensor from
    # host data would synchronise the stream on every render
    x = 0.5 * ((means[..., 0] + 1.0) * W - 1.0)
    y = 0.5 * ((means[..., 1] + 1.0) * H - 1.0)
    return torch.stack([x, y], dim=-1)


def cov2d_from_cholesky(chol: torch.Tensor) -> torch.Tensor:
    """Covariance [N, 3] = (s11, s12, s22) from Cholesky elements [N, 3]:
    L = [[l11, 0], [l21, l22]], Sigma = L L^T."""
    l11, l21, l22 = chol[..., 0], chol[..., 1], chol[..., 2]
    return torch.stack([l11 * l11, l11 * l21, l21 * l21 + l22 * l22], dim=-1)


def cov2d_from_scale_rot(scales: torch.Tensor, theta: torch.Tensor
                         ) -> torch.Tensor:
    """Covariance [N, 3] from scales [N, 2] and a rotation angle [N] or
    [N, 1]: Sigma = R diag(s)^2 R^T with R = [[cos, -sin], [sin, cos]],
    each product left to right as in the JAX package."""
    if theta.dim() == scales.dim():
        theta = theta[..., 0]
    c, s = torch.cos(theta), torch.sin(theta)
    sx2 = scales[..., 0] * scales[..., 0]
    sy2 = scales[..., 1] * scales[..., 1]
    s11 = c * c * sx2 + s * s * sy2
    s12 = c * s * (sx2 - sy2)
    s22 = s * s * sx2 + c * c * sy2
    return torch.stack([s11, s12, s22], dim=-1)


def conic_from_cov2d(cov: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Conic (inverse covariance) [N, 3] = (a, b, c) from covariance [N, 3].

    q(d) = a dx^2 + 2 b dx dy + c dy^2. ``eps`` floors the determinant at
    1e-6, as the JAX package does: a Cholesky diagonal quantized to ~0 must
    not blow the conic (and its gradient chain) up to f32 overflow.
    """
    s11, s12, s22 = cov[..., 0], cov[..., 1], cov[..., 2]
    det = s11 * s22 - s12 * s12
    # torch.maximum, not clamp: at det == eps it splits the gradient between
    # its two arguments, as jnp.maximum does (clamp passes all of it to det)
    inv_det = 1.0 / torch.maximum(det, det.new_full((), eps))
    return torch.stack([s22 * inv_det, -s12 * inv_det, s11 * inv_det], dim=-1)


def radius_from_cov2d(cov: torch.Tensor, sigma_mult: float = 3.0
                      ) -> torch.Tensor:
    """Conservative pixel radius [N] = ceil(sigma_mult * sqrt(lambda_max))."""
    s11, s12, s22 = cov[..., 0], cov[..., 1], cov[..., 2]
    mid = 0.5 * (s11 + s22)
    det = s11 * s22 - s12 * s12
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    lam_max = torch.clamp(mid + disc, min=1e-12)
    return torch.ceil(sigma_mult * torch.sqrt(lam_max))
