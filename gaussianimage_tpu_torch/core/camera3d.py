"""3D Gaussian projection, EWA splatting (counterpart of gaussianimage_tpu/
core/camera3d.py; reference contract: gsplat's ``project_gaussians``:
means3d, scales, glob_scale, quats, viewmat, projmat, fx, fy, cx, cy, H, W,
tile_bounds -> xys, depths, radii, conics, num_tiles_hit, cov3d).

quaternion -> rotation, Sigma3D = R diag(s)^2 R^T, the camera transform,
the perspective Jacobian J, cov2d = J W Sigma W^T J^T plus the 0.3 px
low-pass on the diagonal, conic = inv(cov2d), radius = 3 sigma_max, and a
cull of the centers at or behind ``clip_near``.

The JAX package pins every contraction to full float32 (Precision.HIGHEST).
Here each 3x3 product is written out elementwise, so no matmul can take
TF32 on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaussianimage_tpu_torch.core.covariance import (conic_from_cov2d,
                                                     radius_from_cov2d)


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """[N, 4] (w, x, y, z) -> [N, 3, 3]; normalizes internally."""
    q = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=1)


def _dot3(u, v):
    """sum_j u[..., j] v[..., j] over a last axis of 3, left to right."""
    return (u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]
            + u[..., 2] * v[..., 2])


def project_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    glob_scale: float,
    quats: torch.Tensor,
    viewmat,
    projmat=None,  # unused (kept for the reference's signature)
    fx: float = 1.0, fy: float = 1.0, cx: float = 0.0, cy: float = 0.0,
    H: int = 0, W: int = 0,
    tile_bounds: Tuple[int, int, int] = (1, 1, 1),
    clip_near: float = 0.01,
    block: Tuple[int, int] = (16, 16),
) -> Tuple[torch.Tensor, ...]:
    """(xys [N,2], depths [N], radii [N], conics [N,3], num_tiles_hit [N],
    cov3d [N,3,3]). ``viewmat`` is a [4, 4] tensor or nested sequence;
    radii and num_tiles_hit are 0 for culled centers."""
    dev = means3d.device
    V = torch.as_tensor(viewmat, dtype=torch.float32, device=dev)
    Rv, tv = V[:3, :3], V[:3, 3]
    R_g = quat_to_rotmat(quats)  # [N, 3, 3]
    S = scales * glob_scale
    # Sigma3D = (R S) (R S)^T
    M = R_g * S[:, None, :]
    cov3d = _dot3(M[:, :, None, :], M[:, None, :, :])  # [N, 3, 3]

    # camera-space positions [N, 3]
    t = _dot3(means3d[:, None, :], Rv[None]) + tv
    tz = torch.maximum(t[:, 2], t.new_full((), clip_near))
    in_front = t[:, 2] > clip_near

    xys = torch.stack([fx * t[:, 0] / tz + cx, fy * t[:, 1] / tz + cy], -1)
    depths = t[:, 2]

    # perspective Jacobian [N, 2, 3]
    zeros = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([fx / tz, zeros, -fx * t[:, 0] / (tz * tz)], -1),
        torch.stack([zeros, fy / tz, -fy * t[:, 1] / (tz * tz)], -1),
    ], dim=1)
    JW = _dot3(J[:, :, None, :], Rv.T[None, None])           # [N, 2, 3]
    A = _dot3(JW[:, :, None, :], cov3d.transpose(1, 2)[:, None])  # J W Sigma
    cov2d_m = _dot3(A[:, :, None, :], JW[:, None, :, :])     # [N, 2, 2]
    cov2d = torch.stack([cov2d_m[:, 0, 0] + 0.3, cov2d_m[:, 0, 1],
                         cov2d_m[:, 1, 1] + 0.3], -1)

    conics = conic_from_cov2d(cov2d)
    radii = torch.where(in_front, radius_from_cov2d(cov2d),
                        torch.zeros_like(tz))

    bh, bw = block
    tx, ty = tile_bounds[0], tile_bounds[1]
    x0 = torch.clamp(torch.floor((xys[:, 0] - radii) / bw), 0, tx)
    x1 = torch.clamp(torch.floor((xys[:, 0] + radii) / bw) + 1, 0, tx)
    y0 = torch.clamp(torch.floor((xys[:, 1] - radii) / bh), 0, ty)
    y1 = torch.clamp(torch.floor((xys[:, 1] + radii) / bh) + 1, 0, ty)
    num_tiles_hit = ((x1 - x0) * (y1 - y0)).int()
    num_tiles_hit = torch.where(in_front, num_tiles_hit,
                                torch.zeros_like(num_tiles_hit))
    return xys, depths, radii, conics, num_tiles_hit, cov3d
