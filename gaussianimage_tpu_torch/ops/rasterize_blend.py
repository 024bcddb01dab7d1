"""Depth-sorted alpha-blend rasterizer, the 3DGS baseline's (counterpart of
gaussianimage_tpu/ops/rasterize_blend.py; reference contract: gsplat's 3D
``rasterize_gaussians``: front-to-back compositing c += T alpha rgb,
T *= 1 - alpha, the background composited with the final transmittance,
returns (img, alpha)).

Pipeline, as in the JAX package:

- order the Gaussians front to back once (``_depth_order``), bit for bit as
  the JAX package orders them;
- bin the depth-ordered centers and isotropic radii into tiles with
  ``stream_common.prepare_stream`` on detached inputs: the stream's ranks
  index the depth-ordered rows, so each tile's window is in depth order;
- pack the rows [N+1, 16] (xy, conic, raw rgb, opacity) and reorder them
  once; autograd carries the rows' gradient back through the reorder;
- per tile, walk the window in chunks of ``block_inst`` slots and composite
  each pixel front to back with the transmittance carried in log space
  (alpha = min(o exp(-q/2), clip) where it reaches alpha_min, else 0); a
  tile stops after the chunk where every one of its pixels has
  T <= early_stop_T, and records how many chunks it consumed.

Two CUDA kernels (``csrc/rasterize_blend.cu``), each with a plain PyTorch
version of the same function beside it; a wrapper takes the plain version
for CPU tensors only, and a CUDA tensor launches the kernel or raises:

- K8 ``blend_fwd``: rgb, T_fin and log T_fin as [5, H, W], and the chunks
  consumed per tile;
- K9 ``blend_bwd``: per-slot gradient rows from a [4, H, W] cotangent (rgb
  and T_fin), walking back over exactly K8's chunks; the transmittance
  before each slot is exp(log T_fin - the suffix sum of log(1 - alpha)),
  never a division back to front.

The kernels skip the pairs that cannot composite: each staged slot
carries a cull, its q_cut and the tile-local pixel rectangle it can reach,
and a warp walks only the slots whose rectangle meets its pixels.
``blend_cull_plain`` is that cull's plain mirror; the plain versions do not
cull, and the kernels stay equal to them because a culled pair has alpha 0.

The gradient rows go back onto the Gaussians through
``stream_common.scatter_stream_grads``, deterministically. Above
``flat_stream_limit`` instances the stream is aligned: the forward writes
its [NB, 16, 64] blocks once (K11a) and K8 and K9 read them
(``blend_fwd_aligned``, ``blend_bwd_aligned``, which count as K8 and K9
launches too); K9 writes whole gradient blocks, which K11b turns back into
rows for the scatter (``stream_common.scatter_block_grads``). The serving
path from the fused 3DGS prep's keys (K10, ops/splat_prep3d.py) is
``rasterize_blend_from_keys_chw``: one sort, the window bounds, K8. The JAX
package's XLA oracle is not ported.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from gaussianimage_tpu_torch.ops import _build
from gaussianimage_tpu_torch.ops import stream_common as sc
from gaussianimage_tpu_torch.ops.rasterize_sum import (Cull,
                                                       _check_aligned_launch,
                                                       _check_launch,
                                                       _check_tiles,
                                                       _raise_on,
                                                       _stream_ptr,
                                                       _tile_image,
                                                       _untile_image,
                                                       slot_cull_plain,
                                                       stream_from_keys,
                                                       window_counts)

_BK = 64             # the kernels' chunk of stream slots
_TILES = (16, 32)    # the tile sides the kernels are built for
_OUT = 5             # output planes: rgb, T_fin, log T_fin
Q_MARGIN = 0.01      # the cull's q_cut = 2 log(o / alpha_min) + this
#   (kQMargin in csrc/rasterize_blend_common.cuh)
PATCH = (8, 4)       # a warp's pixel patch, columns x rows (kPatchW, kPatchH)


class BlendConfig(NamedTuple):
    """The fields of the JAX package's BlendConfig that the port reads, with
    the same defaults."""
    tile_px: int = 16
    tiles_per_step: int = 8      # tiles per grid step on the TPU; pads T
    block_inst: int = 64         # instances per chunk (BK)
    max_tiles_per_gauss: int = 64
    max_instances: Optional[int] = None  # stream cap (None -> auto from N)
    flat_stream_limit: int = 65536  # above this the aligned layout
    alpha_clip: float = 0.999
    alpha_min: float = 1.0 / 255.0
    early_stop_T: float = 1e-4  # a tile stops after the chunk where every
    #   pixel's transmittance is at or below this; 0 disables
    fused_prep: bool = False  # render_fast through the fused 3DGS prep
    #   (K10, ops/splat_prep3d.py); flat stream, packed keys only


def log_stop(cfg: BlendConfig) -> float:
    """log(early_stop_T), or -inf when early stop is off."""
    return math.log(cfg.early_stop_T) if cfg.early_stop_T > 0 else -math.inf


def _depth_order(depths: torch.Tensor) -> torch.Tensor:
    """Front-to-back order [N] int32, the JAX package's: for N <= 16384 one
    sort of the packed key ``(bits(max(depth, 0)) >> (id_bits + 1)) <<
    id_bits | index`` (depths closer than the dropped mantissa bits keep
    index order), else a stable argsort."""
    n = depths.shape[0]
    id_bits = max(int(n - 1).bit_length(), 1)
    if id_bits > 14:
        return torch.argsort(depths, stable=True).int()
    d = depths.float()
    d = torch.maximum(d, d.new_zeros(()))
    key_f = d.view(torch.int32) >> (id_bits + 1)
    key = (key_f << id_bits) | torch.arange(n, dtype=torch.int32,
                                            device=depths.device)
    skey = torch.sort(key).values  # keys are unique
    return skey & ((1 << id_bits) - 1)


# ---------------------------------------------------------------------------
# plain versions of K8 and K9
# ---------------------------------------------------------------------------


class _Walk(NamedTuple):
    """The tiles' windows and pixel geometry the plain versions walk."""
    tiles_x: int
    tiles_y: int
    starts: torch.Tensor  # [T] window start per tile (int64)
    counts: torch.Tensor  # [T] window length
    tx0: torch.Tensor     # [T] tile origin, pixels
    ty0: torch.Tensor
    X: torch.Tensor       # [1, P] tile-local pixel column
    Y: torch.Tensor       # [1, P] tile-local pixel row


def _walk(starts, counts, H, W, tile_px) -> _Walk:
    """The walk of the windows [starts[t], starts[t] + counts[t])."""
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    T = tiles_x * tiles_y
    dev = starts.device
    t = torch.arange(T, device=dev)
    pidx = torch.arange(tile_px * tile_px, device=dev)
    return _Walk(tiles_x, tiles_y, starts[:T].long(), counts[:T].long(),
                 ((t % tiles_x) * tile_px).float(),
                 (torch.div(t, tiles_x, rounding_mode="floor")
                  * tile_px).float(),
                 (pidx % tile_px).float()[None, :],
                 torch.div(pidx, tile_px, rounding_mode="floor")
                 .float()[None, :])


def _chunk(rows, wk: _Walk, idx, ci: int, bk: int):
    """Chunk ``ci`` of tiles ``idx`` from the stream's rows by slot: rows
    [A, bk, 16] (dead slots read slot 0's and are masked by ``live``),
    live [A, bk], slots [A, bk]."""
    off = ci * bk + torch.arange(bk, device=rows.device)
    live = off[None, :] < wk.counts[idx][:, None]
    slot = torch.where(live, wk.starts[idx][:, None] + off[None, :],
                       torch.zeros_like(live, dtype=torch.long))
    return rows[slot], live, slot


def _alpha_terms(rows, live, tx0, ty0, X, Y, alpha_clip, alpha_min):
    """A chunk's slots against their tiles' P pixels, op for op as the
    kernels (and the JAX kernel's ``_alpha_terms``) compute it: rows
    [A, bk, 16], live [A, bk] -> (alpha, in_range, w, q, dx, dy), each
    [A, bk, P]."""
    gx = (rows[..., 0] - tx0[:, None])[..., None]
    gy = (rows[..., 1] - ty0[:, None])[..., None]
    a, b, c = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5]
    op = rows[..., 8:9]
    dx = X - gx
    dy = Y - gy
    q = torch.clamp(a * dx * dx + 2.0 * b * dx * dy + c * dy * dy, min=0.0)
    w = torch.exp(-0.5 * q)
    raw = op * w
    on = live[..., None] & (raw >= alpha_min)
    alpha = torch.where(on, torch.clamp(raw, max=alpha_clip),
                        torch.zeros_like(raw))
    return alpha, on & (raw <= alpha_clip), w, q, dx, dy


def blend_cull_plain(rows: torch.Tensor, tx0, ty0, alpha_min: float,
                     tile_px: int = 32) -> Cull:
    """The cull K8 and K9 apply to each staged slot, op for op as
    ``blend_cull`` in csrc/rasterize_blend_common.cuh computes it: q_cut =
    2 log(o / alpha_min) + Q_MARGIN and its rectangle
    (``rasterize_sum.slot_cull_plain``). rows [..., 16] feature rows, tx0 /
    ty0 their tiles' origins (broadcastable). Every pair whose alpha
    ``_alpha_terms`` makes nonzero has q <= q_cut and its pixel inside the
    rectangle. The kernels' main path computes this on the card; the plain
    versions do not cull, so nothing but tests and measurements calls it.
    """
    gx = rows[..., 0] - tx0
    gy = rows[..., 1] - ty0
    op = rows[..., 8]
    if alpha_min > 0:
        am = torch.tensor(alpha_min, dtype=torch.float32, device=rows.device)
        qc = 2.0 * torch.log(op / am) + Q_MARGIN
    else:
        qc = torch.full_like(op, math.inf)
    return slot_cull_plain(gx, gy, rows[..., 2], rows[..., 3], rows[..., 4],
                           qc, tile_px)


def _blend_fwd_rows(stream_rows, starts, counts, H, W, tile_px, bk, alpha_clip,
                    alpha_min, log_stop):
    wk = _walk(starts, counts, H, W, tile_px)
    T, P = wk.tiles_x * wk.tiles_y, tile_px * tile_px
    dev = stream_rows.device
    nch_all = torch.div(wk.counts + bk - 1, bk, rounding_mode="floor")
    logT = torch.zeros(T, P, dtype=torch.float32, device=dev)
    acc = torch.zeros(T, 3, P, dtype=torch.float32, device=dev)
    used = torch.zeros(T, dtype=torch.int32, device=dev)
    for ci in range(int(nch_all.max()) if T else 0):
        idx = ((ci < nch_all) & (logT.amax(dim=1) > log_stop)).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        used[idx] += 1
        rows, live, _ = _chunk(stream_rows, wk, idx, ci, bk)
        alpha = _alpha_terms(rows, live, wk.tx0[idx], wk.ty0[idx], wk.X,
                             wk.Y, alpha_clip, alpha_min)[0]
        l1m = torch.log1p(-alpha)
        col = rows[..., 5:8, None]  # [A, bk, 3, 1]
        lT, ac = logT[idx], acc[idx]
        for k in range(bk):
            vis = alpha[:, k] * torch.exp(lT)
            ac = ac + col[:, k] * vis[:, None, :]
            lT = lT + l1m[:, k]
        logT[idx] = lT
        acc[idx] = ac
    tiles = torch.cat([acc, torch.exp(logT)[:, None], logT[:, None]], dim=1)
    return _untile_image(tiles, tile_px, wk.tiles_x, wk.tiles_y, H, W), used


def blend_fwd_plain(feat: torch.Tensor, gids: torch.Tensor,
                    starts: torch.Tensor, H: int, W: int, tile_px: int = 16,
                    block_inst: int = _BK, alpha_clip: float = 0.999,
                    alpha_min: float = 1.0 / 255.0,
                    log_stop: float = math.log(1e-4)
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K8 -> (out [5, H, W] float32: rgb, T_fin,
    log T_fin; nch [T] int32, the chunks each tile consumed).

    feat [N+1, 16] depth-ordered rows, gids [I] int32 stream, starts
    [>= T+1] int32 window bounds. Every tile that is still going walks its
    next chunk: per pixel, slot by slot, acc += rgb * (alpha *
    exp(logT)), then logT += log1p(-alpha); a tile goes on while a chunk is
    left and the max of logT over its pixels (those past H x W included)
    is above ``log_stop``. K8's arithmetic, op for op.
    """
    return _blend_fwd_rows(sc.gather_stream(gids, feat), starts,
                           window_counts(starts), H, W, tile_px, block_inst,
                           alpha_clip, alpha_min, log_stop)


def blend_bwd_plain(feat: torch.Tensor, gids: torch.Tensor,
                    starts: torch.Tensor, logt: torch.Tensor,
                    nch: torch.Tensor, g: torch.Tensor, H: int, W: int,
                    tile_px: int = 16, block_inst: int = _BK,
                    alpha_clip: float = 0.999,
                    alpha_min: float = 1.0 / 255.0) -> torch.Tensor:
    """Plain PyTorch version of K9 -> dgfeat [I, 16] float32.

    logt [H, W] is K8's log T_fin, nch [T] its chunks per tile, g [4, H, W]
    the cotangent of (rgb, T_fin). Walking each tile's consumed chunks
    back to front, slot by slot, per pixel: suf += log1p(-alpha) (the
    suffix sum, this slot included), T_k = exp(logt - suf),
    dalpha = (G.c) T_k - (S + G_T T_fin) / (1 - alpha) where
    alpha_min <= o w <= clip (else 0), then S += (G.c) alpha T_k; chained
    through alpha = o w and w = exp(-q/2) (dq = 0 where q = 0) to row s:
    [dgx, dgy, da, db, dc, dr, dg, db, do, 0 x 7], each a sum over the
    tile's pixels. Rows of slots in no consumed chunk are zero. Pixels
    past H x W take no part (log T_fin = -inf there, so T_k = 0).
    """
    return _blend_bwd_rows(sc.gather_stream(gids, feat), starts,
                           window_counts(starts), logt, nch, g, H, W,
                           tile_px, block_inst, alpha_clip, alpha_min)


def _blend_bwd_rows(stream_rows, starts, counts, logt, nch, g, H, W,
                    tile_px, bk, alpha_clip, alpha_min):
    wk = _walk(starts, counts, H, W, tile_px)
    T, P = wk.tiles_x * wk.tiles_y, tile_px * tile_px
    dev = stream_rows.device
    Gt = _tile_image(g.float(), tile_px, wk.tiles_x, wk.tiles_y)  # [T,4,P]
    inside = _tile_image(torch.ones(1, H, W, device=dev), tile_px,
                         wk.tiles_x, wk.tiles_y)[:, 0] > 0
    lTf_all = torch.where(
        inside, _tile_image(logt[None].float(), tile_px, wk.tiles_x,
                            wk.tiles_y)[:, 0],
        torch.full((), -math.inf, device=dev))
    suf_all = torch.zeros(T, P, dtype=torch.float32, device=dev)
    S_all = torch.zeros(T, P, dtype=torch.float32, device=dev)
    dg = torch.zeros(stream_rows.shape[0], sc.FW, dtype=torch.float32,
                     device=dev)
    nch = nch[:T].long()
    for ci in reversed(range(int(nch.max()) if T else 0)):
        idx = (ci < nch).nonzero()[:, 0]
        rows, live, slot = _chunk(stream_rows, wk, idx, ci, bk)
        alpha, in_range, w, q, dx, dy = _alpha_terms(
            rows, live, wk.tx0[idx], wk.ty0[idx], wk.X, wk.Y, alpha_clip,
            alpha_min)
        G, lTf = Gt[idx][:, None], lTf_all[idx]  # [A, 1, 4, P], [A, P]
        Tf = torch.exp(lTf)
        l1m = torch.log1p(-alpha)
        inv1m = torch.exp(-l1m)
        gdotc = (rows[..., 5:6] * G[:, :, 0] + rows[..., 6:7] * G[:, :, 1]
                 + rows[..., 7:8] * G[:, :, 2])  # [A, bk, P]
        T_k = torch.empty_like(alpha)
        dalpha = torch.empty_like(alpha)
        suf, S = suf_all[idx], S_all[idx]
        for k in reversed(range(bk)):
            suf = suf + l1m[:, k]
            tk = torch.exp(lTf - suf)
            T_k[:, k] = tk
            dalpha[:, k] = (gdotc[:, k] * tk
                            - (S + G[:, 0, 3] * Tf) * inv1m[:, k])
            S = S + gdotc[:, k] * (alpha[:, k] * tk)
        suf_all[idx], S_all[idx] = suf, S
        vis = alpha * T_k
        dalpha = torch.where(in_range, dalpha, torch.zeros_like(dalpha))
        dw = dalpha * rows[..., 8:9]
        dq = torch.where(q > 0.0, -0.5 * w * dw, torch.zeros_like(dw))
        dqdx, dqdy = dq * dx, dq * dy
        sums = torch.stack([
            dqdx.sum(-1), dqdy.sum(-1), (dqdx * dx).sum(-1),
            (dqdx * dy).sum(-1), (dqdy * dy).sum(-1),
            (G[:, :, 0] * vis).sum(-1), (G[:, :, 1] * vis).sum(-1),
            (G[:, :, 2] * vis).sum(-1), (dalpha * w).sum(-1)], dim=-1)
        a, b, c = rows[..., 2], rows[..., 3], rows[..., 4]
        sx, sy = sums[..., 0], sums[..., 1]
        out = torch.zeros(idx.numel(), bk, sc.FW, dtype=torch.float32,
                          device=dev)
        out[..., 0] = -2.0 * a * sx - 2.0 * b * sy
        out[..., 1] = -2.0 * b * sx - 2.0 * c * sy
        out[..., 2] = sums[..., 2]
        out[..., 3] = 2.0 * sums[..., 3]
        out[..., 4] = sums[..., 4]
        out[..., 5:9] = sums[..., 5:9]
        dg[slot[live]] = out[live]
    return dg


def blend_fwd_aligned_plain(blocks: torch.Tensor, starts: torch.Tensor,
                            counts: torch.Tensor, H: int, W: int,
                            tile_px: int = 16, block_inst: int = _BK,
                            alpha_clip: float = 0.999,
                            alpha_min: float = 1.0 / 255.0,
                            log_stop: float = math.log(1e-4)
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the aligned K8: ``blend_fwd_plain`` over
    the aligned stream's feature blocks [NB, 16, 64] and windows
    [starts[t], starts[t] + counts[t])."""
    return _blend_fwd_rows(sc.unblockize_stream_plain(blocks), starts,
                           counts, H, W, tile_px, block_inst, alpha_clip,
                           alpha_min, log_stop)


def blend_bwd_aligned_plain(blocks: torch.Tensor, starts: torch.Tensor,
                            counts: torch.Tensor, logt: torch.Tensor,
                            nch: torch.Tensor, g: torch.Tensor, H: int,
                            W: int, tile_px: int = 16, block_inst: int = _BK,
                            alpha_clip: float = 0.999,
                            alpha_min: float = 1.0 / 255.0) -> torch.Tensor:
    """Plain PyTorch version of the aligned K9 -> gradient blocks
    [NB, 16, 64]: ``blend_bwd_plain``'s rows over the aligned stream, as
    blocks (slots in no consumed chunk zero)."""
    return sc.blocks_of_rows(_blend_bwd_rows(
        sc.unblockize_stream_plain(blocks), starts, counts, logt, nch, g, H,
        W, tile_px, block_inst, alpha_clip, alpha_min))


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def blend_fwd(feat: torch.Tensor, gids: torch.Tensor, starts: torch.Tensor,
              H: int, W: int, tile_px: int = 16, block_inst: int = _BK,
              alpha_clip: float = 0.999, alpha_min: float = 1.0 / 255.0,
              log_stop: float = math.log(1e-4)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 -> (out [5, H, W] float32: rgb, T_fin, log T_fin; nch [T] int32).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``blend_fwd.launches`` counts the kernel's launches.
    """
    if feat.device.type == "cpu":
        return blend_fwd_plain(feat, gids, starts, H, W, tile_px, block_inst,
                               alpha_clip, alpha_min, log_stop)
    _check_launch("K8", feat, gids, starts, tile_px, tiles=_TILES)
    _check_chunk("K8", block_inst)
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    lib = _build.load("rasterize_blend")
    out = torch.empty(_OUT, H, W, dtype=torch.float32, device=feat.device)
    nch = torch.empty(tiles_x * tiles_y, dtype=torch.int32,
                      device=feat.device)
    _raise_on("K8 rasterize_blend_fwd", lib.rasterize_blend_fwd(
        feat.data_ptr(), feat.shape[0], gids.data_ptr(), starts.data_ptr(),
        out.data_ptr(), nch.data_ptr(), H, W, tiles_x, tiles_y, tile_px,
        ctypes.c_float(alpha_clip), ctypes.c_float(alpha_min),
        ctypes.c_float(log_stop), _stream_ptr(feat)))
    blend_fwd.launches += 1
    return out, nch


def blend_bwd(feat: torch.Tensor, gids: torch.Tensor, starts: torch.Tensor,
              logt: torch.Tensor, nch: torch.Tensor, g: torch.Tensor,
              H: int, W: int, tile_px: int = 16, block_inst: int = _BK,
              alpha_clip: float = 0.999, alpha_min: float = 1.0 / 255.0
              ) -> torch.Tensor:
    """K9 -> dgfeat [I, 16] float32 from K8's log T_fin [H, W] and chunk
    counts [T], and the cotangent g [4, H, W] of (rgb, T_fin).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``blend_bwd.launches`` counts the kernel's launches.
    """
    if feat.device.type == "cpu":
        return blend_bwd_plain(feat, gids, starts, logt, nch, g, H, W,
                               tile_px, block_inst, alpha_clip, alpha_min)
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    _check_launch("K9", feat, gids, starts, tile_px, tiles=_TILES, images=[
        ("logt", logt, (H, W)), ("g", g, (4, H, W)),
        ("nch", nch, (tiles_x * tiles_y,), torch.int32)])
    _check_chunk("K9", block_inst)
    lib = _build.load("rasterize_blend")
    dg = torch.zeros(gids.shape[0], sc.FW, dtype=torch.float32,
                     device=feat.device)
    _raise_on("K9 rasterize_blend_bwd", lib.rasterize_blend_bwd(
        feat.data_ptr(), feat.shape[0], gids.data_ptr(), starts.data_ptr(),
        logt.data_ptr(), nch.data_ptr(), g.data_ptr(), dg.data_ptr(), H, W,
        tiles_x, tiles_y, tile_px, ctypes.c_float(alpha_clip),
        ctypes.c_float(alpha_min), _stream_ptr(feat)))
    blend_bwd.launches += 1
    return dg


def blend_fwd_aligned(blocks: torch.Tensor, starts: torch.Tensor,
                      counts: torch.Tensor, H: int, W: int, tile_px: int = 16,
                      block_inst: int = _BK, alpha_clip: float = 0.999,
                      alpha_min: float = 1.0 / 255.0,
                      log_stop: float = math.log(1e-4)
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 on the aligned stream -> (out [5, H, W], nch [T] int32): the
    depth-ordered feature blocks [NB, 16, 64] of K11a, windows
    [starts[t], starts[t] + counts[t]).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. A launch counts in ``blend_fwd.launches`` and
    ``blend_fwd_aligned.launches``.
    """
    if blocks.device.type == "cpu":
        return blend_fwd_aligned_plain(blocks, starts, counts, H, W, tile_px,
                                       block_inst, alpha_clip, alpha_min,
                                       log_stop)
    _check_aligned_launch("K8", blocks, starts, counts, tile_px, H, W,
                          tiles=_TILES)
    _check_chunk("K8", block_inst)
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    lib = _build.load("rasterize_blend")
    out = torch.empty(_OUT, H, W, dtype=torch.float32, device=blocks.device)
    nch = torch.empty(tiles_x * tiles_y, dtype=torch.int32,
                      device=blocks.device)
    _raise_on("K8 rasterize_blend_fwd_aligned",
              lib.rasterize_blend_fwd_aligned(
                  blocks.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                  out.data_ptr(), nch.data_ptr(), H, W, tiles_x, tiles_y,
                  tile_px, ctypes.c_float(alpha_clip),
                  ctypes.c_float(alpha_min), ctypes.c_float(log_stop),
                  _stream_ptr(blocks)))
    blend_fwd.launches += 1
    blend_fwd_aligned.launches += 1
    return out, nch


def blend_bwd_aligned(blocks: torch.Tensor, starts: torch.Tensor,
                      counts: torch.Tensor, logt: torch.Tensor,
                      nch: torch.Tensor, g: torch.Tensor, H: int, W: int,
                      tile_px: int = 16, block_inst: int = _BK,
                      alpha_clip: float = 0.999,
                      alpha_min: float = 1.0 / 255.0) -> torch.Tensor:
    """K9 on the aligned stream -> gradient blocks [NB, 16, 64] (slots in
    no consumed chunk zero) from K8's log T_fin and chunk counts and the
    cotangent g [4, H, W].

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. A launch counts in ``blend_bwd.launches`` and
    ``blend_bwd_aligned.launches``.
    """
    if blocks.device.type == "cpu":
        return blend_bwd_aligned_plain(blocks, starts, counts, logt, nch, g,
                                       H, W, tile_px, block_inst, alpha_clip,
                                       alpha_min)
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    _check_aligned_launch("K9", blocks, starts, counts, tile_px, H, W,
                          tiles=_TILES, images=[
                              ("logt", logt, (H, W)), ("g", g, (4, H, W)),
                              ("nch", nch, (tiles_x * tiles_y,),
                               torch.int32)])
    _check_chunk("K9", block_inst)
    lib = _build.load("rasterize_blend")
    dgb = torch.zeros_like(blocks)
    _raise_on("K9 rasterize_blend_bwd_aligned",
              lib.rasterize_blend_bwd_aligned(
                  blocks.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                  logt.data_ptr(), nch.data_ptr(), g.data_ptr(),
                  dgb.data_ptr(), H, W, tiles_x, tiles_y, tile_px,
                  ctypes.c_float(alpha_clip), ctypes.c_float(alpha_min),
                  _stream_ptr(blocks)))
    blend_bwd.launches += 1
    blend_bwd_aligned.launches += 1
    return dgb


for _fn in (blend_fwd, blend_bwd, blend_fwd_aligned, blend_bwd_aligned):
    _fn.launches = 0


def _check_chunk(kernel: str, block_inst: int) -> None:
    if block_inst != _BK:
        raise NotImplementedError(
            f"{kernel} is built for block_inst={_BK}, got {block_inst}")


# ---------------------------------------------------------------------------
# autograd over the whole blend, and the public entry point
# ---------------------------------------------------------------------------


class _Blend(torch.autograd.Function):
    """feat [N+1, 16] depth-ordered rows -> (rgb [3, H, W], T_fin [H, W])
    of the stream ``sp`` (K8; on the aligned stream K11a first); backward
    K9 on the cotangents, then the scatter onto the rows (K11b first on the
    aligned stream): the JAX package's ``_blend`` custom_vjp."""

    @staticmethod
    def forward(ctx, feat, sp, H, W, cfg):
        args = (H, W, cfg.tile_px, cfg.block_inst, float(cfg.alpha_clip),
                float(cfg.alpha_min))
        if sp.aligned:
            src = sc.blockize_stream(feat, sp.gids)
            out, nch = blend_fwd_aligned(src, sp.starts, sp.counts, *args,
                                         log_stop(cfg))
        else:
            src = feat
            out, nch = blend_fwd(feat, sp.gids, sp.starts, *args,
                                 log_stop(cfg))
        logt = out[4]
        ctx.save_for_backward(src, logt, nch)
        ctx.sp = sp
        ctx.geom = (feat.shape[0], args)
        return out[:3], out[3]

    @staticmethod
    def backward(ctx, d_rgb, d_tfin):
        src, logt, nch = ctx.saved_tensors
        sp = ctx.sp
        n_rows, (H, W, *args) = ctx.geom
        g = torch.cat([d_rgb, d_tfin[None]]).float().contiguous()
        if sp.aligned:
            dgb = blend_bwd_aligned(src, sp.starts, sp.counts, logt, nch, g,
                                    H, W, *args)
            dfeat = sc.scatter_block_grads(dgb, sp.gids, n_rows, sp.m_span)
        else:
            dg = blend_bwd(src, sp.gids, sp.starts, logt, nch, g, H, W,
                           *args)
            dfeat = sc.scatter_stream_grads(dg, sp.gids, n_rows, sp.m_span)
        return dfeat, None, None, None, None


def blend_stream(xys, depths, radii, H: int, W: int, cfg: BlendConfig):
    """(order [N] int32, StreamPrep) of detached inputs: the depth order,
    then the binning of the depth-ordered centers and isotropic radii."""
    with torch.no_grad():
        order = _depth_order(depths.detach())
        ol = order.long()
        sp = sc.prepare_stream(xys.detach().float()[ol],
                               radii.detach().float()[ol], H, W, cfg)
    return order, sp


def blend_feat(xys, conics, colors, opacities, order) -> torch.Tensor:
    """The packed rows [N+1, 16] (raw colors) in depth order; the zero row
    stays last."""
    N = xys.shape[0]
    order_pad = torch.cat([order.long(), torch.full(
        (1,), N, dtype=torch.long, device=order.device)])
    return sc.pack_feat(xys, conics, colors, opacities)[order_pad]


def rasterize_gaussians_blend(
    xys: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    H: int,
    W: int,
    background: Optional[torch.Tensor] = None,
    config: BlendConfig = BlendConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Front-to-back alpha compositing. Returns (img [H, W, 3], alpha
    [H, W], aux) with aux["n_dropped"] the stream overflow and
    aux["max_count"] the longest tile window. Differentiable with respect
    to xys, conics, colors and opacities; ``background`` [3] defaults to
    black."""
    cfg = config
    order, sp = blend_stream(xys, depths, radii, H, W, cfg)
    feat = blend_feat(xys, conics, colors, opacities, order)
    rgb, tfin = _Blend.apply(feat, sp, H, W, cfg)
    if background is None:
        background = torch.zeros(3, dtype=torch.float32, device=xys.device)
    img = rgb + tfin[None] * background[:, None, None]
    T_real = sp.tiles_x * (-(-H // cfg.tile_px))
    aux = {"n_dropped": sp.n_dropped, "max_count": sp.counts[:T_real].max()}
    return img.permute(1, 2, 0), 1.0 - tfin, aux


def rasterize_blend_from_keys_chw(
    feat: torch.Tensor,
    keys: torch.Tensor,
    trunc: torch.Tensor,
    n_total: torch.Tensor,
    H: int,
    W: int,
    background: Optional[torch.Tensor],
    config: BlendConfig,
    max_instances: int,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """The serving blend from pre-packed inputs, the fused 3DGS prep's
    (ops/splat_prep3d.py): ``feat`` [N+1, 16] depth-ordered rows and the
    flat packed keys ``(tile << id_bits) | rank``. One non-stable sort cut
    to I, the dead slots to row N, the window bounds, then K8. Returns
    channel-major (img [3, H, W], alpha [H, W], aux), aux["n_dropped"] =
    trunc + max(n_total - I, 0). Forward only: it raises if autograd would
    need its gradient."""
    if torch.is_grad_enabled() and feat.requires_grad:
        raise RuntimeError("rasterize_blend_from_keys_chw is forward only; "
                           "render() is the differentiable blend")
    cfg = config
    I = max_instances
    gids, starts, counts = stream_from_keys(keys, feat.shape[0] - 1, H, W,
                                            cfg, I)
    out, _ = blend_fwd(feat, gids, starts, H, W, cfg.tile_px, cfg.block_inst,
                       float(cfg.alpha_clip), float(cfg.alpha_min),
                       log_stop(cfg))
    if background is None:
        background = torch.zeros(3, dtype=torch.float32, device=feat.device)
    img = out[:3] + out[3][None] * background[:, None, None]
    T_real = (-(-W // cfg.tile_px)) * (-(-H // cfg.tile_px))
    n_dropped = (trunc + torch.clamp(n_total - I, min=0)).int()
    aux = {"n_dropped": n_dropped, "max_count": counts[:T_real].max()}
    return img, 1.0 - out[3], aux
