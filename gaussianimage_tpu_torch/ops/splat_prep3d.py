"""Fused 3DGS splat prep (counterpart of
gaussianimage_tpu/ops/splat_prep3d.py): one pass from a 3D Gaussian's raw
parameters to what the blend rasterizer needs, in place of the projection,
SH, activation, packing and binning glue of the generic 3DGS render.

Over rows already in DEPTH order (the caller gathers the [N, k] inputs),
per Gaussian it emits, in the port's prep layout (ops/splat_prep.py):

- ``feat`` [N+1, 16]: the blend's feature row (x, y, conic a b c, rgb from
  SH, sigmoid opacity), row N the zero sentinel;
- ``keys`` [M, N+1] int32: its M packed sort keys ``(tile << id_bits) |
  rank`` slot-major, dead slots at INT32_MAX; the rank is the row's place in
  depth order, so each tile's window comes out depth-sorted;
- ``stats`` [2, N+1] int32: its (trunc, live) counts.

The math is core/camera3d.py's projection, core/sh.py's SH and
models/gs3d.py's activations, in the JAX kernel's term order (the 0.3 px
low-pass, the clip_near cull, SH + 0.5 clamped at 0, sigmoid of the DC row
at degree 0), then the shared tail ``splat_prep.pack_bin`` with the
isotropic 3-sigma bbox, as ``rasterize_gaussians_blend`` bins.

One CUDA kernel, K10 ``blend3d_prep`` (``csrc/splat_prep3d.cu``, sharing
``conic_radius``, the row staging and the staged tail with K4 in
``csrc/splat_prep_common.cuh``), with a plain PyTorch version of the same
math beside it, op for op (``blend3d_prep_plain``). The wrapper takes the
plain version for CPU tensors only; a CUDA tensor launches the kernel or
raises. Forward only: training keeps the autograd projection.

The JAX kernel's [1, blk] lane layout and its 512-row block cap fit the
TPU's vector lanes and VMEM; neither carries over.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from gaussianimage_tpu_torch.core.sh import num_sh_bases, spherical_harmonics
from gaussianimage_tpu_torch.ops import _build
from gaussianimage_tpu_torch.ops import stream_common as sc
from gaussianimage_tpu_torch.ops.splat_prep import (Prep, _check_aligned,
                                                    _check_inputs,
                                                    _check_tile, _finish,
                                                    conic_radius,
                                                    fused_decode_supported,
                                                    pack_bin, prep_geometry)

CLIP_NEAR = 0.01  # camera3d.project_gaussians' near plane

Camera = Tuple[float, ...]


def camera(viewmat, fx: float, fy: float, cx: float, cy: float,
           translation, clip_near: float = CLIP_NEAR) -> Camera:
    """The 20 floats K10 takes, each rounded to float32: the view
    rotation (row major) and translation, fx, fy, cx, cy, the SH origin
    ``translation`` and the near plane. ``viewmat`` [4, 4] and
    ``translation`` [3] are host arrays or sequences."""
    vm = np.asarray(viewmat, np.float32)
    tr = np.asarray(translation, np.float32).reshape(-1)
    vals = (*vm[:3, :3].reshape(-1), *vm[:3, 3], fx, fy, cx, cy, *tr,
            clip_near)
    return tuple(float(np.float32(v)) for v in vals)


# ---------------------------------------------------------------------------
# plain version of K10
# ---------------------------------------------------------------------------


def blend3d_prep_plain(xyz, scaling, quats, opac, coeffs, cam: Sequence[float],
                       sh_degree: int, H: int, W: int, tile_px: int,
                       M: int) -> Prep:
    """Plain PyTorch version of K10: depth-ordered ``xyz`` [N, 3], log
    ``scaling`` [N, 3], ``quats`` [N, 4], opacity logits ``opac`` [N, 1] and
    SH ``coeffs`` [N, 3K] basis-major (the DC colors [N, 3] at degree 0),
    the ``camera`` floats -> (feat [N+1, 16], keys [M, N+1],
    stats [2, N+1]). Each operation is one torch operator, in the kernel's
    order."""
    (w00, w01, w02, w10, w11, w12, w20, w21, w22, tv0, tv1, tv2, fx, fy, cx,
     cy, ox, oy, oz, clip_near) = cam
    N = xyz.shape[0]
    tiles_x, tiles_y, id_bits = prep_geometry(N, H, W, tile_px)
    x3, y3, z3 = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    q = quats
    qn = torch.sqrt(q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]
                    + q[:, 3] * q[:, 3])
    qn = torch.clamp(qn, min=1e-30)
    w, qx, qy, qz = q[:, 0] / qn, q[:, 1] / qn, q[:, 2] / qn, q[:, 3] / qn
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - w * qz)
    r02 = 2 * (qx * qz + w * qy)
    r10 = 2 * (qx * qy + w * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - w * qx)
    r20 = 2 * (qx * qz - w * qy)
    r21 = 2 * (qy * qz + w * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)

    s = torch.exp(scaling)
    s0, s1, s2 = s[:, 0], s[:, 1], s[:, 2]
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    c00 = m00 * m00 + m01 * m01 + m02 * m02
    c01 = m00 * m10 + m01 * m11 + m02 * m12
    c02 = m00 * m20 + m01 * m21 + m02 * m22
    c11 = m10 * m10 + m11 * m11 + m12 * m12
    c12 = m10 * m20 + m11 * m21 + m12 * m22
    c22 = m20 * m20 + m21 * m21 + m22 * m22

    t0 = x3 * w00 + y3 * w01 + z3 * w02 + tv0
    t1 = x3 * w10 + y3 * w11 + z3 * w12 + tv1
    t2 = x3 * w20 + y3 * w21 + z3 * w22 + tv2
    tz = torch.clamp(t2, min=clip_near)
    in_front = t2 > clip_near
    px = fx * t0 / tz + cx
    py = fy * t1 / tz + cy

    # a Python float over a tensor is reciprocal(tensor) * float in torch,
    # rounded twice: divide by a 0-dim tensor instead, as the kernel does
    j00 = tz.new_full((), fx) / tz
    j02 = -fx * t0 / (tz * tz)
    j11 = tz.new_full((), fy) / tz
    j12 = -fy * t1 / (tz * tz)
    jw00 = j00 * w00 + j02 * w20
    jw01 = j00 * w01 + j02 * w21
    jw02 = j00 * w02 + j02 * w22
    jw10 = j11 * w10 + j12 * w20
    jw11 = j11 * w11 + j12 * w21
    jw12 = j11 * w12 + j12 * w22
    u0 = c00 * jw00 + c01 * jw01 + c02 * jw02
    u1 = c01 * jw00 + c11 * jw01 + c12 * jw02
    u2 = c02 * jw00 + c12 * jw01 + c22 * jw02
    v0 = c00 * jw10 + c01 * jw11 + c02 * jw12
    v1 = c01 * jw10 + c11 * jw11 + c12 * jw12
    v2 = c02 * jw10 + c12 * jw11 + c22 * jw12
    s11 = jw00 * u0 + jw01 * u1 + jw02 * u2 + 0.3
    s12 = jw10 * u0 + jw11 * u1 + jw12 * u2
    s22 = jw10 * v0 + jw11 * v1 + jw12 * v2 + 0.3
    ca, cb, cc, radii = conic_radius(s11, s12, s22)
    radii = torch.where(in_front, radii, torch.zeros_like(radii))

    if sh_degree > 0:
        vx, vy, vz = x3 - ox, y3 - oy, z3 - oz
        vn = torch.clamp(torch.sqrt(vx * vx + vy * vy + vz * vz), min=1e-30)
        dirs = torch.stack([vx / vn, vy / vn, vz / vn], dim=1)
        rgb = spherical_harmonics(sh_degree, dirs,
                                  coeffs.reshape(N, -1, 3))
        rgb = torch.clamp(rgb + 0.5, min=0.0)
    else:
        rgb = torch.sigmoid(coeffs)
    return pack_bin(px, py, ca, cb, cc, radii, radii, rgb,
                    torch.sigmoid(opac[:, 0]), tiles_x, tiles_y, tile_px, M,
                    id_bits)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def blend3d_prep(xyz, scaling, quats, opac, coeffs, cam: Sequence[float],
                 sh_degree: int, H: int, W: int, tile_px: int, M: int
                 ) -> Prep:
    """K10 -> (feat [N+1, 16] f32, keys [M, N+1] i32, stats [2, N+1] i32)
    from float32, depth-ordered ``xyz``, ``scaling`` [N, 3], ``quats``
    [N, 4], ``opac`` [N, 1] and ``coeffs`` [N, 3K] (K = (sh_degree + 1)^2:
    the DC colors at degree 0), and the 20 ``camera`` floats.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``blend3d_prep.launches`` counts the kernel's launches. The
    row inputs must start on a 16-byte boundary (``_check_aligned``)."""
    if not 0 <= sh_degree <= 4:
        raise ValueError(f"K10 takes sh_degree 0-4, got {sh_degree}")
    if len(cam) != 20:
        raise ValueError(f"K10 takes 20 camera floats, got {len(cam)}")
    if xyz.device.type == "cpu":
        return blend3d_prep_plain(xyz, scaling, quats, opac, coeffs, cam,
                                  sh_degree, H, W, tile_px, M)
    N = xyz.shape[0]
    _check_inputs("K10", [
        ("xyz", xyz, torch.float32, (N, 3)),
        ("scaling", scaling, torch.float32, (N, 3)),
        ("quats", quats, torch.float32, (N, 4)),
        ("opac", opac, torch.float32, (N, 1)),
        ("coeffs", coeffs, torch.float32, (N, 3 * num_sh_bases(sh_degree)))])
    _check_aligned("K10", [("xyz", xyz), ("scaling", scaling),
                           ("quats", quats), ("opac", opac),
                           ("coeffs", coeffs)])
    _check_tile("K10", tile_px)
    tiles_x, tiles_y, id_bits = prep_geometry(N, H, W, tile_px)
    dev = xyz.device
    feat = torch.empty(N + 1, sc.FW, dtype=torch.float32, device=dev)
    keys = torch.empty(M, N + 1, dtype=torch.int32, device=dev)
    stats = torch.empty(2, N + 1, dtype=torch.int32, device=dev)
    lib = _build.load("splat_prep3d")
    rc = lib.splat_prep_blend3d(
        xyz.data_ptr(), scaling.data_ptr(), quats.data_ptr(),
        opac.data_ptr(), coeffs.data_ptr(), N, H, W, tile_px, tiles_x,
        tiles_y, M, id_bits, sh_degree, *(ctypes.c_float(v) for v in cam),
        feat.data_ptr(), keys.data_ptr(), stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K10 splat_prep_blend3d launch failed: CUDA "
                           f"error {rc}")
    blend3d_prep.launches += 1
    return feat, keys, stats


blend3d_prep.launches = 0


# ---------------------------------------------------------------------------
# the JAX package's entry points
# ---------------------------------------------------------------------------


# The 3DGS fused prep's gate is the Cholesky one's test (the flag, the flat
# stream, the packed-key regime), as in the JAX package; callers take the
# generic render where it is false.
fused_blend_supported = fused_decode_supported


def fused_prep_blend3d(xyz, scaling_raw, quats, opac_raw, coeffs,
                       cam: Sequence[float], sh_degree: int, H: int, W: int,
                       cfg, m_span: int):
    """The 3DGS blend prep front (K10). Every row input must already be in
    depth order; ``coeffs`` [N, 3K] basis-major; ``cam`` from ``camera``.
    Returns (feat [N+1, 16], keys, trunc, n_total)."""
    return _finish(blend3d_prep(
        xyz.float().contiguous(), scaling_raw.float().contiguous(),
        quats.float().contiguous(),
        opac_raw.float().reshape(-1, 1).contiguous(),
        coeffs.float().contiguous(), cam, sh_degree, H, W, cfg.tile_px,
        m_span))
