"""Accumulated-summation Gaussian rasterizer, forward only (counterpart of
gaussianimage_tpu/ops/rasterize_sum.py; reference contract: gsplat
``rasterize_gaussians_sum``).

Pipeline, as in the JAX package:

- bin each Gaussian into the tiles its exact q <= q_cut bbox overlaps and
  sort the instances by tile (ops/tiles.py via stream_common.prepare_stream);
- pack the per-Gaussian feature rows [N+1, 16] with premultiplied colors
  (stream_common.pack_feat);
- K1 walks each tile's window of the stream and sums
  (o*r, o*g, o*b, o) * exp(-q/2) over it, cut at q > q_cut.

K1 is ``ops/csrc/rasterize_sum_fwd.cu``, launched by ``sum_fwd`` for CUDA
tensors; it gathers the rows itself and writes the [4, H, W] image
directly, so neither the JAX package's stream gather nor its untile runs on
the card. ``sum_fwd_plain`` is the same function in plain PyTorch: the
wrapper takes it for CPU tensors only, and the tests and ``chip_smoke.py``
hold the kernel against it.

Channel 3 of the output is the accumulated alpha. No clamping, no
background compositing (the model clamps). Not differentiable yet: the
backward kernel K2 is not ported, so a call with inputs that require grad
raises rather than return a result without gradients.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from gaussianimage_tpu_torch.ops import _build
from gaussianimage_tpu_torch.ops import stream_common as sc

_C = 4  # output channels: rgb + alpha
_PLAIN_CHUNK = 4096  # stream slots per step of the plain version


class RasterizeConfig(NamedTuple):
    """The JAX package's RasterizeConfig: same fields, same defaults."""
    tile_px: int = 32        # square image tile side (K1 takes 32 only)
    tiles_per_step: int = 8  # tiles per grid step on the TPU; pads T only
    block_inst: int = 64     # instances per chunk (BK); rounds the stream cap
    q_cut: float = 9.0       # Mahalanobis cutoff (3 sigma)
    max_tiles_per_gauss: int = 25  # per-Gaussian binning instance cap
    max_instances: Optional[int] = None  # stream cap (None -> auto from N)
    flat_stream_limit: int = 65536  # above this the aligned layout (K11)
    interpret: Optional[bool] = None  # Pallas interpret mode; unused here
    fused_prep: bool = False  # fused splat prep (K5); not ported yet

    @staticmethod
    def serving(num_points: int, **overrides) -> "RasterizeConfig":
        """Inference config of the JAX package: fused prep, a stream capped
        at 3N and a per-Gaussian span of 9, flat up to 196608 instances."""
        cap = min(-(-3 * num_points // 64) * 64, 196608)
        kw = dict(fused_prep=True, max_instances=cap, max_tiles_per_gauss=9,
                  flat_stream_limit=196608)
        kw.update(overrides)
        return RasterizeConfig(**kw)


# ---------------------------------------------------------------------------
# K1 and its plain version
# ---------------------------------------------------------------------------


def _check_tiles(H: int, W: int, tile_px: int, starts: torch.Tensor):
    tiles_x = -(-W // tile_px)
    tiles_y = -(-H // tile_px)
    if starts.dim() != 1 or starts.shape[0] < tiles_x * tiles_y + 1:
        raise ValueError(
            f"starts must be 1-D with at least {tiles_x * tiles_y + 1} "
            f"window bounds for {H}x{W} at tile_px={tile_px}, got "
            f"{tuple(starts.shape)}")
    return tiles_x, tiles_y


def window_pairs(feat: torch.Tensor, gids: torch.Tensor,
                 starts: torch.Tensor, H: int, W: int, tile_px: int = 32):
    """K1's (instance, pixel) geometry, ``_PLAIN_CHUNK`` stream slots at a
    time: yields (tile [n], rows [n, 16], q [n, P], inside [n, P]).

    ``tile`` is each slot's tile, T for the slots past the last window;
    ``rows`` its gathered feature row; ``q`` the clamped quadratic form on
    the tile's P pixels, op for op as K1 computes it; ``inside`` marks the
    pairs K1 evaluates: a live slot and a pixel within H x W.
    """
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    T = tiles_x * tiles_y
    P = tile_px * tile_px
    dev = feat.device
    rows = sc.gather_stream(gids, feat)
    I = rows.shape[0]
    pidx = torch.arange(P, device=dev)
    X = (pidx % tile_px).float()[None, :]   # [1, P] tile-local pixel x
    Y = (pidx // tile_px).float()[None, :]
    slot = torch.arange(I, device=dev, dtype=torch.int32)
    tile_of = torch.searchsorted(starts[1:T + 1].contiguous(), slot,
                                 right=True)  # [I] in [0, T]; T = dead
    for s in range(0, I, _PLAIN_CHUNK):
        t = tile_of[s:s + _PLAIN_CHUNK]
        g = rows[s:s + _PLAIN_CHUNK]  # [n, 16]
        tx0 = ((t % tiles_x) * tile_px).float()[:, None]
        ty0 = (torch.div(t, tiles_x, rounding_mode="floor")
               * tile_px).float()[:, None]
        gx = g[:, 0:1] - tx0
        gy = g[:, 1:2] - ty0
        a, b, c = g[:, 2:3], g[:, 3:4], g[:, 4:5]
        dx = X - gx  # [n, P]
        dy = Y - gy
        q = torch.clamp(a * dx * dx + 2.0 * b * dx * dy + c * dy * dy,
                        min=0.0)
        inside = (t < T)[:, None] & (X + tx0 < W) & (Y + ty0 < H)
        yield t, g, q, inside


def sum_fwd_plain(feat: torch.Tensor, gids: torch.Tensor,
                  starts: torch.Tensor, H: int, W: int, tile_px: int = 32,
                  q_cut: float = 9.0) -> torch.Tensor:
    """Plain PyTorch version of K1 -> [4, H, W] float32.

    feat [N+1, 16] packed rows, gids [I] int32 stream, starts [>= T+1]
    int32 window bounds. Evaluates every stream slot against its tile's
    pixels (``window_pairs``) and sums the contributions onto the tiles
    with ``index_add_``; slots past the last window land in a discarded row.
    The arithmetic is K1's, op for op.
    """
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    T = tiles_x * tiles_y
    acc = torch.zeros(T + 1, _C, tile_px * tile_px, dtype=torch.float32,
                      device=feat.device)
    for t, g, q, _ in window_pairs(feat, gids, starts, H, W, tile_px):
        w = torch.where(q <= q_cut, torch.exp(-0.5 * q),
                        torch.zeros_like(q))
        acc.index_add_(0, t, g[:, 5:5 + _C, None] * w[:, None, :])
    img = (acc[:T].reshape(tiles_y, tiles_x, _C, tile_px, tile_px)
           .permute(2, 0, 3, 1, 4)
           .reshape(_C, tiles_y * tile_px, tiles_x * tile_px))
    return img[:, :H, :W].contiguous()


def sum_fwd(feat: torch.Tensor, gids: torch.Tensor, starts: torch.Tensor,
            H: int, W: int, tile_px: int = 32, q_cut: float = 9.0
            ) -> torch.Tensor:
    """K1 -> [4, H, W] float32 (rgb premultiplied sums + alpha).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``sum_fwd.launches`` counts the kernel's launches.
    """
    if feat.device.type == "cpu":
        return sum_fwd_plain(feat, gids, starts, H, W, tile_px, q_cut)
    if feat.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, got {feat.device}")
    if tile_px != 32:
        raise NotImplementedError(
            f"K1 is built for 32x32 tiles, got tile_px={tile_px}")
    for name, x, dtype in (("feat", feat, torch.float32),
                           ("gids", gids, torch.int32),
                           ("starts", starts, torch.int32)):
        if x.device != feat.device:
            raise ValueError(f"{name} is on {x.device}, feat on {feat.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if feat.dim() != 2 or feat.shape[1] != sc.FW or feat.shape[0] < 1:
        raise ValueError(f"feat must be [N+1, {sc.FW}], got "
                         f"{tuple(feat.shape)}")
    if gids.dim() != 1:
        raise ValueError(f"gids must be 1-D, got {tuple(gids.shape)}")
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)

    lib = _build.load("rasterize_sum_fwd")
    out = torch.empty(_C, H, W, dtype=torch.float32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = lib.rasterize_sum_fwd(
        feat.data_ptr(), feat.shape[0], gids.data_ptr(), starts.data_ptr(),
        out.data_ptr(), H, W, tiles_x, tiles_y, ctypes.c_float(q_cut),
        stream)
    if rc != 0:
        raise RuntimeError(f"K1 rasterize_sum_fwd launch failed: CUDA error "
                           f"{rc}")
    sum_fwd.launches += 1
    return out


sum_fwd.launches = 0


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _radii_from_conics(conics: torch.Tensor, sigma_mult: float = 3.0
                       ) -> torch.Tensor:
    """radius = ceil(sigma_mult * sqrt(lambda_max(cov))) from the conic."""
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - (a * c - b * b), min=0.0))
    lam_min = torch.clamp(mid - disc, min=1e-12)
    return torch.ceil(sigma_mult / torch.sqrt(lam_min))


def _axis_radii(conics, radii, q_cut):
    """Exact per-axis extents (rx, ry) of the q <= q_cut ellipse for binning:
    extent_x = sqrt(q_cut * cov_xx) = sqrt(q_cut * c / det), capped by the
    projection's 3-sigma ``radii``, and 0 where radii == 0 (culled)."""
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    det = torch.clamp(a * c - b * b, min=1e-12)
    rx = torch.sqrt(q_cut * torch.clamp(c, min=0.0) / det)
    ry = torch.sqrt(q_cut * torch.clamp(a, min=0.0) / det)
    live = radii > 0
    zero = torch.zeros_like(rx)
    return (torch.where(live, torch.minimum(rx, radii), zero),
            torch.where(live, torch.minimum(ry, radii), zero))


def _render_chw(xys, conics, colors, opacities, H, W, radii, cfg, band):
    if cfg.fused_prep:
        raise NotImplementedError(
            "RasterizeConfig.fused_prep needs the fused splat-prep kernel K5 "
            "(ops/splat_prep.py::_raw_kernel), which is not ported yet")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (xys, conics, colors, opacities)):
        raise NotImplementedError(
            "rasterize backward needs kernel K2 (ops/rasterize_sum.py::"
            "_bwd_kernel), which is not ported yet; render under "
            "torch.no_grad()")
    if radii is None:
        radii = _radii_from_conics(conics)
    radii = radii.float()
    rxy = _axis_radii(conics, radii, cfg.q_cut)
    sp = sc.prepare_stream(xys.float(), rxy, H, W, cfg, band=band)
    feat = sc.pack_feat(xys, conics, colors, opacities, premultiply=True)
    full = sum_fwd(feat, sp.gids, sp.starts, H, W, cfg.tile_px,
                   float(cfg.q_cut))
    aux = {"n_dropped": sp.n_dropped, "max_per_tile_used": sp.counts.max()}
    return full, aux


def rasterize_gaussians_sum(
    xys: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    H: int,
    W: int,
    radii: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
    band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Render by accumulated summation (no sorting, no compositing).

    xys [N,2] pixel coords, conics [N,3], colors [N,3], opacities [N,1] or
    [N]. Returns (img [H,W,3], alpha [H,W], aux) with aux["n_dropped"] the
    instance-stream overflow count. ``band`` restricts each Gaussian to an
    inclusive tile-row range.
    """
    full, aux = _render_chw(xys, conics, colors, opacities, H, W, radii,
                            config, band)
    aux["n_dropped_fwd"] = aux["n_dropped_bwd"] = aux["n_dropped"]
    return full[:3].permute(1, 2, 0), full[3], aux


def rasterize_gaussians_sum_chw(
    xys: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    H: int,
    W: int,
    radii: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
    band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Channel-major variant: (img [3, H, W], alpha [H, W], aux)."""
    full, aux = _render_chw(xys, conics, colors, opacities, H, W, radii,
                            config, band)
    return full[:3], full[3], aux
