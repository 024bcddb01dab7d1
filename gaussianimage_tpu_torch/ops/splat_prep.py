"""Fused splat prep (counterpart of gaussianimage_tpu/ops/splat_prep.py): one
pass from a Gaussian's parameters, or from its code arrays, to what the
binning needs, in place of the projection, the packing and the
instance-expansion glue of the generic path.

Per Gaussian it emits:

- ``feat`` [N+1, 16]: the premultiplied feature row ``pack_feat`` builds
  (opacity 1 on the Cholesky and RS models), row N the zero sentinel;
- ``keys`` [M, N+1] int32: its M packed sort keys ``(tile << id_bits) | id``
  in slot-major order, dead slots at INT32_MAX, as ``tiles._sorted_stream``
  packs them, so one sort and the window bounds finish the binning
  (``rasterize_sum.rasterize_from_keys_chw``);
- ``stats`` [2, N+1] int32: its (trunc, live) counts, summed for n_dropped.

Five CUDA kernels in ``csrc/splat_prep.cu`` share one front
(``csrc/splat_prep_common.cuh``: rows staged in shared memory, the head
``project_head``, then the staged tail ``pack_bin_staged`` with opacity 1;
the 3DGS prep K10, ops/splat_prep3d.py, ends with the same tail and a real
opacity). Every kernel loads its row inputs as 16-byte vectors, so the
wrappers refuse rows whose data does not start on 16 bytes
(``_check_aligned``) and the entry points hand them over through
``_aligned``:

- K5 ``raw_prep``: from raw parameters (tanh means, the Cholesky bound),
  the serving render's front (``fused_render_cholesky``, ``render_fast``);
- K4 ``decode_prep``: from the codec's code arrays (f16 means, uniform
  dequantization, the combined residual-VQ codebook), the decode's front
  (``fused_decode_cholesky``);
- K7 ``batch_decode_prep``: K4 over B frames stacked on one tall canvas,
  each row with its frame's scale, beta and codebook, its y shifted into
  its frame and its keys clipped to its frame's tile-row band, the batched
  decode's front (``fused_decode_cholesky_batch``, batched.py);
- K6b ``rs_raw_prep``: the RS model's raw front (scales ``abs(s + bound)``,
  the angle ``sigmoid(r) * 2 pi``, Sigma = R diag(s)^2 R^T), the RS
  serving render's (``fused_render_rs``);
- K6a ``rs_decode_prep``: the RS decode front from code arrays (the
  dequantized scales through ``abs(. + bound)``, the dequantized angle as
  it stands: the codec quantizes the activated rotation), the RS decode's
  (``fused_decode_rs``).

Beside each is a plain PyTorch version of the same math, op for op
(``raw_prep_plain``, ``decode_prep_plain``, ``batch_decode_prep_plain``,
``rs_raw_prep_plain``, ``rs_decode_prep_plain``), over the plain head and
tail (``conic_radius``, ``_project_head``, ``pack_bin``).
A wrapper takes it for CPU tensors only; a CUDA tensor launches the kernel
or raises. The math replicates core/covariance.py,
rasterize_sum._axis_radii and tiles._expand_instances, so the prep's
stream equals the generic path's. Forward only: training keeps the
autograd projection.

The JAX kernel's row blocks (``_BLK_CAP``) and its [1, blk] lane layout fit
the TPU's VMEM and vector lanes; neither carries over, nor does K7's
one-hot selection of the per-frame tables (an exact gather here).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from gaussianimage_tpu_torch.ops import _build
from gaussianimage_tpu_torch.ops import stream_common as sc
from gaussianimage_tpu_torch.ops.rasterize_sum import rasterize_from_keys_chw
from gaussianimage_tpu_torch.ops.tiles import INT32_MAX

CODEBOOK = 8  # residual-VQ codebook size: the combined table has 8 x 8 rows
TWO_PI = 2.0 * math.pi  # the RS angle's range: sigmoid(r) * TWO_PI

Prep = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def prep_geometry(N: int, H: int, W: int, tile_px: int):
    """(tiles_x, tiles_y, id_bits) of a prep; raises outside the packed-key
    regime, where ``(tiles + 1) << id_bits`` no longer fits 31 bits."""
    tiles_x = -(-W // tile_px)
    tiles_y = -(-H // tile_px)
    id_bits = max(int(N - 1).bit_length(), 1)
    if (tiles_x * tiles_y + 1) * (1 << id_bits) >= 2 ** 31:
        raise ValueError("the fused splat prep needs the packed-key regime")
    return tiles_x, tiles_y, id_bits


# ---------------------------------------------------------------------------
# plain versions of K4-K7
# ---------------------------------------------------------------------------


def conic_radius(s11, s12, s22):
    """(ca, cb, cc, radius) of a 2D covariance, op for op as
    splat_prep_common.cuh's conic_radius: the conic with the 1e-6 det
    floor and ceil(3 sqrt(lambda_max))."""
    det = s11 * s22 - s12 * s12
    inv_det = 1.0 / torch.maximum(det, det.new_full((), 1e-6))
    mid = 0.5 * (s11 + s22)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    radii = torch.ceil(3.0 * torch.sqrt(torch.clamp(mid + disc, min=1e-12)))
    return s22 * inv_det, -s12 * inv_det, s11 * inv_det, radii


def _project_head(mx, my, s11, s12, s22, H: int, W: int, q_cut: float):
    """The sum path's head, as project_head: (x, y, ca, cb, cc, rx, ry),
    the pixel center, the conic and the q <= q_cut axis extents capped by
    the radius."""
    x = 0.5 * ((mx + 1.0) * W - 1.0)
    y = 0.5 * ((my + 1.0) * H - 1.0)
    ca, cb, cc, radii = conic_radius(s11, s12, s22)
    cdet = torch.clamp(ca * cc - cb * cb, min=1e-12)
    rx = torch.sqrt(q_cut * torch.clamp(cc, min=0.0) / cdet)
    ry = torch.sqrt(q_cut * torch.clamp(ca, min=0.0) / cdet)
    live = radii > 0
    zero = torch.zeros_like(rx)
    rx = torch.where(live, torch.minimum(rx, radii), zero)
    ry = torch.where(live, torch.minimum(ry, radii), zero)
    return x, y, ca, cb, cc, rx, ry


def pack_bin(x, y, ca, cb, cc, rx, ry, colors, opac, tiles_x: int,
             tiles_y: int, tile_px: int, M: int, id_bits: int, row_lo=None,
             row_hi=None) -> Prep:
    """The tail of every front, as pack_bin: the feature rows (x, y, conic,
    ``colors`` [N, 3], opacity ``opac``: a float or [N]), the keys of the
    bboxes of half-extents (rx, ry) and the counts, plus the sentinel row
    N. ``row_lo`` / ``row_hi`` ([N], K7) clip the tile rows to a band."""
    N = x.shape[0]
    dev = x.device
    if row_lo is None:
        row_lo = torch.zeros_like(y)
        row_hi = torch.full_like(y, tiles_y - 1)
    feat = torch.zeros(N + 1, sc.FW, dtype=torch.float32, device=dev)
    feat[:N, 0] = x
    feat[:N, 1] = y
    feat[:N, 2] = ca
    feat[:N, 3] = cb
    feat[:N, 4] = cc
    feat[:N, 5:8] = colors
    feat[:N, 8] = opac

    x0 = torch.clamp(torch.floor((x - rx) / tile_px), 0, tiles_x - 1)
    x1 = torch.clamp(torch.floor((x + rx) / tile_px), 0, tiles_x - 1)
    y0 = torch.minimum(torch.maximum(torch.floor((y - ry) / tile_px), row_lo),
                       row_hi)
    y1 = torch.minimum(torch.maximum(torch.floor((y + ry) / tile_px), row_lo),
                       row_hi)
    inside = ((rx > 0) & (ry > 0)
              & (x + rx >= 0) & (x - rx < tiles_x * tile_px)
              & (y + ry >= 0) & (y - ry < tiles_y * tile_px))
    span_w = x1 - x0 + 1.0
    area = span_w * (y1 - y0 + 1.0)
    jj = torch.arange(M, dtype=torch.float32, device=dev)[:, None]
    jy = torch.floor(jj / span_w)               # exact for small integers
    jx = jj - jy * span_w
    tile = (y0 + jy) * tiles_x + (x0 + jx)      # [M, N]
    live_j = inside & (jj < torch.clamp(area, max=float(M)))
    row = torch.arange(N, dtype=torch.int32, device=dev)
    keys = torch.full((M, N + 1), INT32_MAX, dtype=torch.int32, device=dev)
    keys[:, :N] = torch.where(live_j, (tile.int() << id_bits) | row,
                              keys[:, :N])
    zero = torch.zeros_like(area)
    stats = torch.zeros(2, N + 1, dtype=torch.int32, device=dev)
    stats[0, :N] = torch.where(inside, torch.clamp(area - M, min=0.0),
                               zero).int()
    stats[1, :N] = torch.where(inside, torch.clamp(area, max=float(M)),
                               zero).int()
    return feat, keys, stats


def _project_pack_bin(mx, my, s11, s12, s22, colors, H: int, W: int,
                      tile_px: int, M: int, q_cut: float,
                      frame=None, B: int = 1) -> Prep:
    """The sum path's front, as project_pack_bin: the head, then the tail
    with opacity 1.

    With ``frame`` ([N] int, K7) the canvas is B frames of height H stacked
    vertically: y is mapped with H and then shifted by frame * H, and the
    tile rows are clipped to the frame's band; the inside test stays
    against the whole canvas."""
    tiles_x, tiles_y, id_bits = prep_geometry(mx.shape[0], H * B, W,
                                              tile_px)
    x, y, ca, cb, cc, rx, ry = _project_head(mx, my, s11, s12, s22, H, W,
                                             q_cut)
    row_lo = row_hi = None
    if frame is not None:
        ff = frame.float()
        y = y + ff * float(H)
        rows = tiles_y // B
        row_lo = ff * float(rows)
        row_hi = row_lo + float(rows - 1)
    return pack_bin(x, y, ca, cb, cc, rx, ry, colors, 1.0, tiles_x, tiles_y,
                    tile_px, M, id_bits, row_lo, row_hi)


def _cov_from_chol(l11, l21, l22):
    return l11 * l11, l11 * l21, l21 * l21 + l22 * l22


def _cov_from_scale_rot(sx, sy, theta):
    """core/covariance.py's cov2d_from_scale_rot on [N] rows."""
    c = torch.cos(theta)
    s = torch.sin(theta)
    sx2 = sx * sx
    sy2 = sy * sy
    return (c * c * sx2 + s * s * sy2, c * s * (sx2 - sy2),
            s * s * sx2 + c * c * sy2)


def raw_prep_plain(xyz, chol, colors, bound, H: int, W: int, tile_px: int,
                   M: int, q_cut: float) -> Prep:
    """Plain PyTorch version of K5: raw ``_xyz`` [N, 2], ``_cholesky``
    [N, 3] and colors [N, 3] -> (feat [N+1, 16], keys [M, N+1],
    stats [2, N+1])."""
    means = torch.tanh(xyz)
    cov = _cov_from_chol(chol[:, 0] + bound[0], chol[:, 1] + bound[1],
                         chol[:, 2] + bound[2])
    return _project_pack_bin(means[:, 0], means[:, 1], *cov, colors, H, W,
                             tile_px, M, q_cut)


def decode_prep_plain(xyz, codes, idx, scale, beta, embed, bound, H: int,
                      W: int, tile_px: int, M: int, q_cut: float) -> Prep:
    """Plain PyTorch version of K4: the f16 means widened to f32 [N, 2],
    Cholesky codes [N, 3] int32, VQ indices [N, 2] int32, the quantizer's
    scale and beta [3] and the combined codebook [64, 3] -> as K5."""
    means = torch.tanh(xyz)
    chol = codes.float() * scale + beta
    cov = _cov_from_chol(chol[:, 0] + bound[0], chol[:, 1] + bound[1],
                         chol[:, 2] + bound[2])
    colors = embed[(idx[:, 0] * CODEBOOK + idx[:, 1]).long()]
    return _project_pack_bin(means[:, 0], means[:, 1], *cov, colors, H, W,
                             tile_px, M, q_cut)


def batch_decode_prep_plain(xyz, codes, idx, scale, beta, embed, bound,
                            B: int, H: int, W: int, tile_px: int, M: int,
                            q_cut: float) -> Prep:
    """Plain PyTorch version of K7: B frames of n = N / B Gaussians as N
    stacked rows (``xyz`` [N, 2], ``codes`` [N, 3], ``idx`` [N, 2]), the
    frames' scale and beta [B, 3] and combined codebooks [B * 64, 3], on a
    canvas of height ``H`` = B x the frame's height -> as K5, row r of frame
    r // n."""
    N = xyz.shape[0]
    frame = torch.arange(N, device=xyz.device) // (N // B)
    means = torch.tanh(xyz)
    chol = codes.float() * scale[frame] + beta[frame]
    cov = _cov_from_chol(chol[:, 0] + bound[0], chol[:, 1] + bound[1],
                         chol[:, 2] + bound[2])
    colors = embed[(frame * CODEBOOK * CODEBOOK + idx[:, 0] * CODEBOOK
                    + idx[:, 1]).long()]
    return _project_pack_bin(means[:, 0], means[:, 1], *cov, colors, H // B,
                             W, tile_px, M, q_cut, frame=frame, B=B)


def rs_raw_prep_plain(xyz, scaling, rotation, colors, bound, H: int, W: int,
                      tile_px: int, M: int, q_cut: float) -> Prep:
    """Plain PyTorch version of K6b: raw ``_xyz`` [N, 2], ``_scaling``
    [N, 2] (before the bound), ``_rotation`` [N, 1] and colors [N, 3] ->
    as K5."""
    means = torch.tanh(xyz)
    theta = torch.sigmoid(rotation[:, 0]) * TWO_PI
    cov = _cov_from_scale_rot(torch.abs(scaling[:, 0] + bound[0]),
                              torch.abs(scaling[:, 1] + bound[1]), theta)
    return _project_pack_bin(means[:, 0], means[:, 1], *cov, colors, H, W,
                             tile_px, M, q_cut)


def rs_decode_prep_plain(xyz, scodes, rcodes, idx, s_scale, s_beta, r_scale,
                         r_beta, embed, bound, H: int, W: int, tile_px: int,
                         M: int, q_cut: float) -> Prep:
    """Plain PyTorch version of K6a: the f16 means widened to f32 [N, 2],
    scaling codes [N, 2] and rotation codes [N, 1] int32, VQ indices
    [N, 2] int32, the quantizers' scale and beta ([2] scaling, [1]
    rotation) and the combined codebook [64, 3] -> as K5. The rotation is
    dequantized to radians and used as it stands."""
    means = torch.tanh(xyz)
    s = scodes.float() * s_scale + s_beta
    theta = rcodes[:, 0].float() * r_scale[0] + r_beta[0]
    cov = _cov_from_scale_rot(torch.abs(s[:, 0] + bound[0]),
                              torch.abs(s[:, 1] + bound[1]), theta)
    colors = embed[(idx[:, 0] * CODEBOOK + idx[:, 1]).long()]
    return _project_pack_bin(means[:, 0], means[:, 1], *cov, colors, H, W,
                             tile_px, M, q_cut)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _check_inputs(kernel: str, named):
    """named: (name, tensor, dtype, shape); raises on anything the kernel
    does not take."""
    dev = named[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got {dev}")
    for name, x, dtype, shape in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, {named[0][0]} on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")


def _check_aligned(kernel: str, named):
    """named: (name, tensor); raises unless each tensor's data starts on a
    16-byte boundary. The fronts (K4-K7 and K10) load their rows as
    16-byte vectors; a view that starts a row into its storage
    (``x[1:]``) is contiguous but need not be aligned."""
    for name, x in named:
        if x.data_ptr() % 16:
            raise ValueError(f"{kernel} loads {name} as 16-byte vectors: its "
                             f"data must start on a 16-byte boundary (a "
                             f"fresh tensor or .clone()), not at "
                             f"{x.data_ptr() % 16} bytes past one")


def _check_tile(kernel: str, tile_px: int):
    """Raises unless ``tile_px`` is a power of two: the kernels bin with
    its reciprocal, exact only there (the rasterizers take 16 or 32)."""
    if tile_px < 1 or tile_px & (tile_px - 1):
        raise ValueError(f"{kernel} bins on tiles of a power-of-two side, "
                         f"got tile_px={tile_px}")


def _aligned(x):
    """``x`` itself when its data starts on a 16-byte boundary, else a
    ``.clone()`` of it (a fresh allocation, which does). A frame of a
    stacked encoding (``enc_b[b]``, the scan decode's) starts b x N rows
    into its storage: the copy is the staged kernel's input there."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(fn_name: str, kernel: str, inputs, bound, H, W, tile_px, M,
            q_cut, frames=None) -> Prep:
    """Launch ``fn_name`` on the N rows of ``inputs[0]`` and a canvas of
    height H. Its C function takes the rows and the height (N, H) (K4-K6),
    or with ``frames`` = B (K7) the rows, the rows of a frame and a
    frame's height (N, N / B, H / B); then the geometry and the floats of
    ``bound`` (three for Cholesky, two for RS)."""
    _check_tile(kernel, tile_px)
    N, dev = inputs[0].shape[0], inputs[0].device
    dims = (N, H) if frames is None else (N, N // frames, H // frames)
    tiles_x, tiles_y, id_bits = prep_geometry(N, H, W, tile_px)
    feat = torch.empty(N + 1, sc.FW, dtype=torch.float32, device=dev)
    keys = torch.empty(M, N + 1, dtype=torch.int32, device=dev)
    stats = torch.empty(2, N + 1, dtype=torch.int32, device=dev)
    lib = _build.load("splat_prep")
    rc = getattr(lib, fn_name)(
        *[x.data_ptr() for x in inputs], *dims, W, tile_px, tiles_x,
        tiles_y, M, id_bits, ctypes.c_float(q_cut),
        *(ctypes.c_float(b) for b in bound),
        feat.data_ptr(), keys.data_ptr(), stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
    return feat, keys, stats


def raw_prep(xyz, chol, colors, bound, H: int, W: int, tile_px: int, M: int,
             q_cut: float) -> Prep:
    """K5 -> (feat [N+1, 16] f32, keys [M, N+1] i32, stats [2, N+1] i32)
    from float32 ``xyz`` [N, 2], ``chol`` [N, 3] (before the bound) and
    ``colors`` [N, 3]; ``bound`` three floats.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``raw_prep.launches`` counts the kernel's launches. The row
    inputs must start on a 16-byte boundary (``_check_aligned``)."""
    if xyz.device.type == "cpu":
        return raw_prep_plain(xyz, chol, colors, bound, H, W, tile_px, M,
                              q_cut)
    N = xyz.shape[0]
    _check_inputs("K5", [("xyz", xyz, torch.float32, (N, 2)),
                         ("chol", chol, torch.float32, (N, 3)),
                         ("colors", colors, torch.float32, (N, 3))])
    _check_aligned("K5", [("xyz", xyz), ("chol", chol), ("colors", colors)])
    out = _launch("splat_prep_raw", "K5 splat_prep_raw", (xyz, chol, colors),
                  bound, H, W, tile_px, M, q_cut)
    raw_prep.launches += 1
    return out


def decode_prep(xyz, codes, idx, scale, beta, embed, bound, H: int, W: int,
                tile_px: int, M: int, q_cut: float) -> Prep:
    """K4 -> as K5, from float32 ``xyz`` [N, 2] (the f16 codes, widened),
    int32 ``codes`` [N, 3] and ``idx`` [N, 2], float32 ``scale`` and
    ``beta`` [3] and the combined codebook ``embed`` [64, 3].

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``decode_prep.launches`` counts the kernel's launches. The
    row inputs must start on a 16-byte boundary (``_check_aligned``)."""
    if xyz.device.type == "cpu":
        return decode_prep_plain(xyz, codes, idx, scale, beta, embed, bound,
                                 H, W, tile_px, M, q_cut)
    N = xyz.shape[0]
    _check_inputs("K4", [("xyz", xyz, torch.float32, (N, 2)),
                         ("codes", codes, torch.int32, (N, 3)),
                         ("idx", idx, torch.int32, (N, 2)),
                         ("scale", scale, torch.float32, (3,)),
                         ("beta", beta, torch.float32, (3,)),
                         ("embed", embed, torch.float32,
                          (CODEBOOK * CODEBOOK, 3))])
    _check_aligned("K4", [("xyz", xyz), ("codes", codes), ("idx", idx)])
    out = _launch("splat_prep_decode", "K4 splat_prep_decode",
                  (xyz, codes, idx, scale, beta, embed), bound, H, W,
                  tile_px, M, q_cut)
    decode_prep.launches += 1
    return out


def batch_decode_prep(xyz, codes, idx, scale, beta, embed, bound, B: int,
                      H: int, W: int, tile_px: int, M: int,
                      q_cut: float) -> Prep:
    """K7 -> as K5, from the N = B * n stacked rows of B frames (float32
    ``xyz`` [N, 2], int32 ``codes`` [N, 3] and ``idx`` [N, 2]), the frames'
    float32 ``scale`` and ``beta`` [B, 3] and combined codebooks ``embed``
    [B * 64, 3], on a canvas of height ``H`` (B frames stacked, H a multiple
    of B * tile_px).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``batch_decode_prep.launches`` counts the kernel's launches.
    The row inputs must start on a 16-byte boundary (``_check_aligned``)."""
    N = xyz.shape[0]
    if B < 1 or N % B or H % (B * tile_px):
        raise ValueError(f"K7 stacks B frames of equal size: B={B}, N={N} "
                         f"rows, canvas height {H}, tile_px {tile_px}")
    if xyz.device.type == "cpu":
        return batch_decode_prep_plain(xyz, codes, idx, scale, beta, embed,
                                       bound, B, H, W, tile_px, M, q_cut)
    _check_inputs("K7", [("xyz", xyz, torch.float32, (N, 2)),
                         ("codes", codes, torch.int32, (N, 3)),
                         ("idx", idx, torch.int32, (N, 2)),
                         ("scale", scale, torch.float32, (B, 3)),
                         ("beta", beta, torch.float32, (B, 3)),
                         ("embed", embed, torch.float32,
                          (B * CODEBOOK * CODEBOOK, 3))])
    _check_aligned("K7", [("xyz", xyz), ("codes", codes), ("idx", idx)])
    out = _launch("splat_prep_decode_batch", "K7 splat_prep_decode_batch",
                  (xyz, codes, idx, scale, beta, embed), bound, H, W,
                  tile_px, M, q_cut, frames=B)
    batch_decode_prep.launches += 1
    return out


def rs_raw_prep(xyz, scaling, rotation, colors, bound, H: int, W: int,
                tile_px: int, M: int, q_cut: float) -> Prep:
    """K6b -> as K5, from float32 ``xyz`` [N, 2], ``scaling`` [N, 2]
    (before the bound), ``rotation`` [N, 1] (before the sigmoid) and
    ``colors`` [N, 3]; ``bound`` two floats.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``rs_raw_prep.launches`` counts the kernel's launches. The
    row inputs must start on a 16-byte boundary (``_check_aligned``)."""
    if xyz.device.type == "cpu":
        return rs_raw_prep_plain(xyz, scaling, rotation, colors, bound, H, W,
                                 tile_px, M, q_cut)
    N = xyz.shape[0]
    _check_inputs("K6b", [("xyz", xyz, torch.float32, (N, 2)),
                          ("scaling", scaling, torch.float32, (N, 2)),
                          ("rotation", rotation, torch.float32, (N, 1)),
                          ("colors", colors, torch.float32, (N, 3))])
    _check_aligned("K6b", [("xyz", xyz), ("scaling", scaling),
                           ("rotation", rotation), ("colors", colors)])
    out = _launch("splat_prep_rs_raw", "K6b splat_prep_rs_raw",
                  (xyz, scaling, rotation, colors), bound, H, W, tile_px, M,
                  q_cut)
    rs_raw_prep.launches += 1
    return out


def rs_decode_prep(xyz, scodes, rcodes, idx, s_scale, s_beta, r_scale,
                   r_beta, embed, bound, H: int, W: int, tile_px: int,
                   M: int, q_cut: float) -> Prep:
    """K6a -> as K5, from float32 ``xyz`` [N, 2] (the f16 codes, widened),
    int32 scaling codes ``scodes`` [N, 2], rotation codes ``rcodes``
    [N, 1] and ``idx`` [N, 2], the float32 quantizer tables ``s_scale``,
    ``s_beta`` [2] and ``r_scale``, ``r_beta`` [1], and the combined
    codebook ``embed`` [64, 3]; ``bound`` two floats.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``rs_decode_prep.launches`` counts the kernel's launches. The
    row inputs must start on a 16-byte boundary (``_check_aligned``)."""
    if xyz.device.type == "cpu":
        return rs_decode_prep_plain(xyz, scodes, rcodes, idx, s_scale,
                                    s_beta, r_scale, r_beta, embed, bound, H,
                                    W, tile_px, M, q_cut)
    N = xyz.shape[0]
    _check_inputs("K6a", [("xyz", xyz, torch.float32, (N, 2)),
                          ("scodes", scodes, torch.int32, (N, 2)),
                          ("rcodes", rcodes, torch.int32, (N, 1)),
                          ("idx", idx, torch.int32, (N, 2)),
                          ("s_scale", s_scale, torch.float32, (2,)),
                          ("s_beta", s_beta, torch.float32, (2,)),
                          ("r_scale", r_scale, torch.float32, (1,)),
                          ("r_beta", r_beta, torch.float32, (1,)),
                          ("embed", embed, torch.float32,
                           (CODEBOOK * CODEBOOK, 3))])
    _check_aligned("K6a", [("xyz", xyz), ("scodes", scodes),
                           ("rcodes", rcodes), ("idx", idx)])
    out = _launch("splat_prep_rs_decode", "K6a splat_prep_rs_decode",
                  (xyz, scodes, rcodes, idx, s_scale, s_beta, r_scale,
                   r_beta, embed), bound, H, W, tile_px, M, q_cut)
    rs_decode_prep.launches += 1
    return out


raw_prep.launches = 0
decode_prep.launches = 0
batch_decode_prep.launches = 0
rs_raw_prep.launches = 0
rs_decode_prep.launches = 0


# ---------------------------------------------------------------------------
# the JAX package's entry points
# ---------------------------------------------------------------------------


def _finish(prep: Prep):
    """(feat, flat keys, trunc, n_total), as the JAX package's _run_prep
    returns them. The keys flatten slot-major; their only reader is a
    sort. The counts are summed as integers, exactly."""
    feat, keys, stats = prep
    tot = stats.sum(dim=1)
    return feat, keys.reshape(-1), tot[0], tot[1]


def fused_raw_prep_cholesky(xyz, chol_raw, colors, bound, H: int, W: int,
                            cfg, m_span: int):
    """Raw-parameter Cholesky front (K5) -> (feat, keys, trunc, n_total)."""
    return _finish(raw_prep(
        _aligned(xyz.float().contiguous()),
        _aligned(chol_raw.float().contiguous()),
        _aligned(colors.float().contiguous()),
        tuple(float(b) for b in bound), H, W, cfg.tile_px, m_span,
        float(cfg.q_cut)))


def fused_prep_cholesky(enc_xyz, chol_codes, quant_scale, quant_beta, bound,
                        vq_idx, embed_combined, H: int, W: int, cfg,
                        m_span: int):
    """Cholesky decode front (K4): code arrays -> (feat, keys, trunc,
    n_total). ``enc_xyz`` [N, 2] holds the float16 codes."""
    return _finish(decode_prep(
        _aligned(enc_xyz.float().contiguous()),
        _aligned(chol_codes.int().contiguous()),
        _aligned(vq_idx.int().contiguous()), quant_scale.float().contiguous(),
        quant_beta.float().contiguous(), embed_combined.float().contiguous(),
        tuple(float(b) for b in bound), H, W, cfg.tile_px, m_span,
        float(cfg.q_cut)))


def fused_prep_cholesky_batch(enc_xyz, chol_codes, quant_scale, quant_beta,
                              bound, vq_idx, embed_combined, B: int,
                              H_total: int, W: int, cfg, m_span: int):
    """Batched Cholesky decode front (K7) over the H_total = B * H stacked
    canvas: the B frames' N = B * n code rows (``enc_xyz`` [N, 2] float16
    codes), scale and beta [B, 3], combined codebooks [B * 64, 3] ->
    (feat, keys, trunc, n_total)."""
    return _finish(batch_decode_prep(
        _aligned(enc_xyz.float().contiguous()),
        _aligned(chol_codes.int().contiguous()),
        _aligned(vq_idx.int().contiguous()),
        quant_scale.reshape(B, 3).float().contiguous(),
        quant_beta.reshape(B, 3).float().contiguous(),
        embed_combined.float().contiguous(), tuple(float(b) for b in bound),
        B, H_total, W, cfg.tile_px, m_span, float(cfg.q_cut)))


def fused_raw_prep_rs(xyz, scaling_raw, rot_raw, colors, bound, H: int,
                      W: int, cfg, m_span: int):
    """Raw-parameter RS front (K6b) -> (feat, keys, trunc, n_total)."""
    return _finish(rs_raw_prep(
        _aligned(xyz.float().contiguous()),
        _aligned(scaling_raw.float().contiguous()),
        _aligned(rot_raw.float().reshape(-1, 1).contiguous()),
        _aligned(colors.float().contiguous()),
        tuple(float(b) for b in bound), H, W,
        cfg.tile_px, m_span, float(cfg.q_cut)))


def fused_prep_rs(enc_xyz, scaling_codes, rot_codes, s_scale, s_beta,
                  r_scale, r_beta, bound, vq_idx, embed_combined, H: int,
                  W: int, cfg, m_span: int):
    """RS decode front (K6a): code arrays -> (feat, keys, trunc, n_total).
    ``enc_xyz`` [N, 2] holds the float16 codes."""
    return _finish(rs_decode_prep(
        _aligned(enc_xyz.float().contiguous()),
        _aligned(scaling_codes.int().contiguous()),
        _aligned(rot_codes.int().reshape(-1, 1).contiguous()),
        _aligned(vq_idx.int().contiguous()),
        s_scale.float().reshape(2).contiguous(),
        s_beta.float().reshape(2).contiguous(),
        r_scale.float().reshape(1).contiguous(),
        r_beta.float().reshape(1).contiguous(),
        embed_combined.float().contiguous(), tuple(float(b) for b in bound),
        H, W, cfg.tile_px, m_span, float(cfg.q_cut)))


def fused_decode_supported(N: int, H: int, W: int, cfg) -> bool:
    """The fused prep's gate: ``cfg.fused_prep``, the flat stream and the
    packed-key regime. Callers take the generic path where it is false, as
    the JAX package's do."""
    if not getattr(cfg, "fused_prep", False):
        return False
    _, _, aligned = sc.stream_caps(N, cfg)
    if aligned:
        return False
    tp = cfg.tile_px
    tiles = (-(-W // tp)) * (-(-H // tp))
    id_bits = max(int(N - 1).bit_length(), 1)
    return (tiles + 1) * (1 << id_bits) < 2 ** 31


def _flat_caps(N: int, cfg):
    I0, m_span, aligned = sc.stream_caps(N, cfg)
    if aligned:
        raise ValueError("the fused splat prep is flat-stream only")
    return I0, m_span


def fused_render_cholesky(xyz, chol_raw, colors, bound, H: int, W: int, cfg):
    """Forward render from raw parameters: K5, one sort, K1. Returns
    (img [3, H, W], alpha [H, W], aux), unclamped."""
    I0, m_span = _flat_caps(xyz.shape[0], cfg)
    feat, keys, trunc, n_total = fused_raw_prep_cholesky(
        xyz, chol_raw, colors, bound, H, W, cfg, m_span)
    return rasterize_from_keys_chw(feat, keys, trunc, n_total, H, W, cfg, I0)


def fused_decode_cholesky(enc_xyz, chol_codes, quant_scale, quant_beta,
                          bound, vq_idx, embed_combined, H: int, W: int, cfg):
    """Decode from code arrays: K4, one sort, K1. Returns (img [3, H, W],
    alpha [H, W], aux), unclamped."""
    I0, m_span = _flat_caps(enc_xyz.shape[0], cfg)
    feat, keys, trunc, n_total = fused_prep_cholesky(
        enc_xyz, chol_codes, quant_scale, quant_beta, bound, vq_idx,
        embed_combined, H, W, cfg, m_span)
    return rasterize_from_keys_chw(feat, keys, trunc, n_total, H, W, cfg, I0)


def fused_decode_cholesky_batch(enc_xyz_b, chol_codes_b, scale_b, beta_b,
                                bound, vq_idx_b, embed_b, H: int, W: int,
                                cfg):
    """Batched decode: K7 over B stacked frames, one sort, K1 on the
    [3, B * H, W] canvas. Inputs carry a leading [B] frame dimension
    (``embed_b`` [B, 64, 3]); ``cfg`` is the batched raster config, with
    the instance budget scaled to B * n. Flat stream only; the key width
    comes from B * n. Returns (img [3, B * H, W], alpha [B * H, W], aux),
    unclamped."""
    B, n = enc_xyz_b.shape[0], enc_xyz_b.shape[1]
    N = B * n
    I0, m_span = _flat_caps(N, cfg)
    feat, keys, trunc, n_total = fused_prep_cholesky_batch(
        enc_xyz_b.reshape(N, 2), chol_codes_b.reshape(N, 3), scale_b,
        beta_b, bound, vq_idx_b.reshape(N, 2), embed_b.reshape(B * 64, 3),
        B, H * B, W, cfg, m_span)
    return rasterize_from_keys_chw(feat, keys, trunc, n_total, H * B, W, cfg,
                                   I0)


def fused_render_rs(xyz, scaling_raw, rot_raw, colors, bound, H: int, W: int,
                    cfg):
    """RS forward render from raw parameters: K6b, one sort, K1. Returns
    (img [3, H, W], alpha [H, W], aux), unclamped."""
    I0, m_span = _flat_caps(xyz.shape[0], cfg)
    feat, keys, trunc, n_total = fused_raw_prep_rs(
        xyz, scaling_raw, rot_raw, colors, bound, H, W, cfg, m_span)
    return rasterize_from_keys_chw(feat, keys, trunc, n_total, H, W, cfg, I0)


def fused_decode_rs(enc_xyz, scaling_codes, rot_codes, s_scale, s_beta,
                    r_scale, r_beta, bound, vq_idx, embed_combined, H: int,
                    W: int, cfg):
    """RS decode from code arrays: K6a, one sort, K1. Returns
    (img [3, H, W], alpha [H, W], aux), unclamped."""
    I0, m_span = _flat_caps(enc_xyz.shape[0], cfg)
    feat, keys, trunc, n_total = fused_prep_rs(
        enc_xyz, scaling_codes, rot_codes, s_scale, s_beta, r_scale, r_beta,
        bound, vq_idx, embed_combined, H, W, cfg, m_span)
    return rasterize_from_keys_chw(feat, keys, trunc, n_total, H, W, cfg, I0)
