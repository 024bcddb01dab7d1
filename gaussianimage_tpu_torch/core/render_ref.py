"""Dense oracle renderer (counterpart of gaussianimage_tpu/core/render_ref.py:
30-97): for every pixel p and Gaussian i,

    out[p] = sum_i color_i * opacity_i * exp(-0.5 * d^T conic_i d),  d = p - xy_i

with no depth sort, no transmittance and no clamping. Every rasterizer of
the port is tested against it. It computes in float64 unless the inputs
are of a wider type, and walks the Gaussians in chunks to bound memory.
"""

from __future__ import annotations

from typing import Optional

import torch


def _pixel_grid(H: int, W: int, dtype, device) -> torch.Tensor:
    """[H*W, 2] pixel center coordinates (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1).reshape(H * W, 2).to(dtype)


def render_sum_dense(xys: torch.Tensor, conics: torch.Tensor,
                     colors: torch.Tensor, opacities: torch.Tensor,
                     H: int, W: int, radii: Optional[torch.Tensor] = None,
                     chunk: int = 1024, q_cut: Optional[float] = None
                     ) -> torch.Tensor:
    """Render [H, W, C] by dense summation over all Gaussians.

    xys [N, 2] pixel coords; conics [N, 3] = (a, b, c); colors [N, C];
    opacities [N, 1] or [N]. ``radii`` cuts contributions outside the radius
    box; ``q_cut`` cuts those with Mahalanobis q > q_cut (the kernels'
    3-sigma gate at q_cut=9); otherwise the full tail is accumulated.
    """
    N = xys.shape[0]
    C = colors.shape[-1]
    dtype = torch.promote_types(xys.dtype, torch.float64)
    dev = xys.device
    pix = _pixel_grid(H, W, dtype, dev)  # [HW, 2]
    out = torch.zeros(H * W, C, dtype=dtype, device=dev)
    opac = opacities.reshape(N).to(dtype)
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        d = pix[:, None, :] - xys[s:e].to(dtype)[None]  # [HW, n, 2]
        dx, dy = d[..., 0], d[..., 1]
        cc = conics[s:e].to(dtype)
        a, b, c = cc[:, 0], cc[:, 1], cc[:, 2]
        # the kernels' q >= 0 clamp (f32 cancellation can go negative for
        # near-degenerate conics)
        q = torch.clamp(a * dx * dx + 2.0 * b * dx * dy + c * dy * dy,
                        min=0.0)
        w = torch.exp(-0.5 * q) * opac[s:e][None]  # [HW, n]
        if q_cut is not None:
            w = torch.where(q <= q_cut, w, torch.zeros_like(w))
        if radii is not None:
            r = radii[s:e].to(dtype)[None]
            w = torch.where((dx.abs() <= r) & (dy.abs() <= r), w,
                            torch.zeros_like(w))
        out += w @ colors[s:e].to(dtype)
    return out.reshape(H, W, C)
