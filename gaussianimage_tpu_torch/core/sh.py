"""Real spherical harmonics to degree 4 (counterpart of gaussianimage_tpu/
core/sh.py; reference contract: gsplat's ``num_sh_bases`` /
``spherical_harmonics``). Elementwise, with the JAX package's constants in
its order of operations, so float32 results agree to the ulp."""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def num_sh_bases(degree: int) -> int:
    if degree > 4:
        raise ValueError("SH degree must be <= 4")
    return (degree + 1) ** 2


def spherical_harmonics(degree: int, viewdirs: torch.Tensor,
                        coeffs: torch.Tensor) -> torch.Tensor:
    """viewdirs [N, 3] (unit), coeffs [N, K, 3] with K = (degree+1)^2.
    Returns rgb [N, 3]."""
    K = num_sh_bases(degree)
    assert coeffs.shape[-2] == K, (coeffs.shape, K)
    x, y, z = viewdirs[:, 0:1], viewdirs[:, 1:2], viewdirs[:, 2:3]

    result = _C0 * coeffs[:, 0]
    if degree >= 1:
        result = (result - _C1 * y * coeffs[:, 1] + _C1 * z * coeffs[:, 2]
                  - _C1 * x * coeffs[:, 3])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (result
                  + _C2[0] * xy * coeffs[:, 4]
                  + _C2[1] * yz * coeffs[:, 5]
                  + _C2[2] * (2.0 * zz - xx - yy) * coeffs[:, 6]
                  + _C2[3] * xz * coeffs[:, 7]
                  + _C2[4] * (xx - yy) * coeffs[:, 8])
    if degree >= 3:
        result = (result
                  + _C3[0] * y * (3 * xx - yy) * coeffs[:, 9]
                  + _C3[1] * xy * z * coeffs[:, 10]
                  + _C3[2] * y * (4 * zz - xx - yy) * coeffs[:, 11]
                  + _C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * coeffs[:, 12]
                  + _C3[4] * x * (4 * zz - xx - yy) * coeffs[:, 13]
                  + _C3[5] * z * (xx - yy) * coeffs[:, 14]
                  + _C3[6] * x * (xx - 3 * yy) * coeffs[:, 15])
    if degree >= 4:
        result = (result
                  + _C4[0] * xy * (xx - yy) * coeffs[:, 16]
                  + _C4[1] * yz * (3 * xx - yy) * coeffs[:, 17]
                  + _C4[2] * xy * (7 * zz - 1) * coeffs[:, 18]
                  + _C4[3] * yz * (7 * zz - 3) * coeffs[:, 19]
                  + _C4[4] * (zz * (35 * zz - 30) + 3) * coeffs[:, 20]
                  + _C4[5] * xz * (7 * zz - 3) * coeffs[:, 21]
                  + _C4[6] * (xx - yy) * (7 * zz - 1) * coeffs[:, 22]
                  + _C4[7] * xz * (xx - 3 * yy) * coeffs[:, 23]
                  + _C4[8] * (xx * (xx - 3 * yy)
                              - yy * (3 * xx - yy)) * coeffs[:, 24])
    return result
