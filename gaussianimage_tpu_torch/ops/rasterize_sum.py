"""Accumulated-summation Gaussian rasterizer with its analytic backward
(counterpart of gaussianimage_tpu/ops/rasterize_sum.py; reference contract:
gsplat ``rasterize_gaussians_sum``).

Pipeline, as in the JAX package:

- bin each Gaussian into the tiles its exact q <= q_cut bbox overlaps and
  sort the instances by tile (ops/tiles.py via stream_common.prepare_stream),
  on detached inputs: no graph is built through the binning;
- pack the per-Gaussian feature rows [N+1, 16] with premultiplied colors
  (stream_common.pack_feat); autograd carries the rows' gradient back to
  xys, conics, colors and opacities;
- walk each tile's window of the stream and sum
  (o*r, o*g, o*b, o) * exp(-q/2) over it, cut at q > q_cut.

Three CUDA kernels, each with a plain PyTorch version of the same function
beside it; a wrapper takes the plain version for CPU tensors only, and a
CUDA tensor launches the kernel or raises:

- K1 ``sum_fwd`` (``csrc/rasterize_sum_fwd.cu``): the [4, H, W] render;
- K2 ``sum_bwd`` (``csrc/rasterize_sum_bwd.cu``): per-instance gradient rows
  from a [4, H, W] cotangent, the backward of ``rasterize_gaussians_sum``;
- K3 ``sum_l2`` (same file): render, clip, masked L2 against a target and
  K2's backward in one pass, the training step of
  ``rasterize_gaussians_sum_l2``.

The three share one walk (``csrc/rasterize_sum_common.cuh``), which skips
the pairs that fail the gate: each staged slot carries the tile-local pixel
rectangle it can reach (``sum_cull_plain`` is its plain mirror), and a warp
walks a slot only on its 8 x 4 patches (``PATCH``) that the rectangle
meets. Each pixel still adds its gated pairs in stream order, so K1's
image is bit-equal to ``sum_fwd_plain(..., in_order=True)``.

The kernels gather the rows themselves and read and write [C, H, W]
images directly, so neither the JAX package's stream gather nor its tiling
and untiling of images runs on the card. Per-instance rows go back onto the
Gaussians through ``stream_common.scatter_stream_grads``, deterministically.

Above ``flat_stream_limit`` instances the stream is aligned
(stream_common.prepare_stream): the forward writes its [NB, 16, 64] feature
blocks once (K11a, ``stream_common.blockize_stream``) and K1, K2 and K3
read them (``sum_fwd_aligned``, ``sum_bwd_aligned``, ``sum_l2_aligned``,
which count as K1, K2 and K3 launches too); K2 and K3 then write whole
gradient blocks, which K11b turns back into rows for the scatter
(``stream_common.scatter_block_grads``). On the same instances both
layouts give the same image, loss and gradients bit for bit.

``rasterize_from_keys_chw`` is the forward render from the fused splat
prep's rows and sort keys (ops/splat_prep.py): the serving render and the
codec's fused decode.

Channel 3 of the render is the accumulated alpha. No clamping, no
background compositing (the model clamps).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from gaussianimage_tpu_torch.ops import _build
from gaussianimage_tpu_torch.ops import stream_common as sc
from gaussianimage_tpu_torch.ops.stream_common import _raise_on, _stream_ptr
from gaussianimage_tpu_torch.ops.tiles import INT32_MAX, sorted_window_bounds

_C = 4  # output channels: rgb + alpha
_PLAIN_CHUNK = 4096  # stream slots per step of the plain versions
_TILES = (16, 32)  # the tile sides the CUDA kernels are built for
PATCH = (8, 4)        # K1-K3's patch, columns x rows (kPatchW, kPatchH in
#   csrc/rasterize_sum_common.cuh): a warp skips a slot per patch
WARP_BLOCK = (16, 8)  # K1-K3's warp: a block of 2 x 2 patches, one pixel of
#   each per thread


class RasterizeConfig(NamedTuple):
    """The JAX package's RasterizeConfig: same fields, same defaults."""
    tile_px: int = 32        # square image tile side (K1-K3 take 32 or 16)
    tiles_per_step: int = 8  # tiles per grid step on the TPU; pads T only
    block_inst: int = 64     # instances per chunk (BK); rounds the stream cap
    q_cut: float = 9.0       # Mahalanobis cutoff (3 sigma)
    max_tiles_per_gauss: int = 25  # per-Gaussian binning instance cap
    max_instances: Optional[int] = None  # stream cap (None -> auto from N)
    flat_stream_limit: int = 65536  # above this the aligned layout
    interpret: Optional[bool] = None  # Pallas interpret mode; unused here
    fused_prep: bool = False  # render_fast / decode take the fused prep

    @staticmethod
    def serving(num_points: int, **overrides) -> "RasterizeConfig":
        """Inference config of the JAX package: fused prep, a stream capped
        at 3N and a per-Gaussian span of 9, flat up to 196608 instances."""
        cap = min(-(-3 * num_points // 64) * 64, 196608)
        kw = dict(fused_prep=True, max_instances=cap, max_tiles_per_gauss=9,
                  flat_stream_limit=196608)
        kw.update(overrides)
        return RasterizeConfig(**kw)

    def stacked(self, num_points: int, frames: int) -> "RasterizeConfig":
        """This config for ``frames`` frames of ``num_points`` Gaussians
        stacked on one canvas (batched.py; the JAX package's
        ``_batched_raster_config``): an instance budget of 3 per Gaussian
        (at least 16384), a per-Gaussian span of at most 9 tiles, flat up
        to 196608 instances."""
        return self._replace(
            max_instances=max(3 * frames * num_points, 16384),
            max_tiles_per_gauss=min(self.max_tiles_per_gauss, 9),
            flat_stream_limit=max(self.flat_stream_limit, 196608))


# ---------------------------------------------------------------------------
# geometry shared by the plain versions
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


class Pairs(NamedTuple):
    """One chunk of stream slots against their tiles' pixels."""
    slot: torch.Tensor    # [n] the chunk's stream slots
    tile: torch.Tensor    # [n] each slot's tile
    rows: torch.Tensor    # [n, 16] the slots' feature rows
    dx: torch.Tensor      # [n, P] pixel minus center, tile-local
    dy: torch.Tensor      # [n, P]
    q: torch.Tensor       # [n, P] clamped quadratic form
    inside: torch.Tensor  # [n, P] pixel within H x W


def window_counts(starts: torch.Tensor) -> torch.Tensor:
    """The flat stream's window lengths starts[t+1] - starts[t]."""
    return starts[1:] - starts[:-1]


def window_pairs(rows: torch.Tensor, starts: torch.Tensor,
                 counts: torch.Tensor, H: int, W: int, tile_px: int = 32):
    """The kernels' (instance, pixel) geometry over the slots of the tiles'
    windows [starts[t], starts[t] + counts[t]), ``_PLAIN_CHUNK`` slots at a
    time: yields ``Pairs`` with q computed op for op as the kernels compute
    it (rasterize_sum_common.cuh). ``rows`` [L, 16] are the stream's
    feature rows by slot: feat[gids] on the flat stream (``counts`` =
    ``window_counts(starts)``), the unblockized blocks on the aligned one.
    Reads the windows' total length back to the host."""
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    T = tiles_x * tiles_y
    P = tile_px * tile_px
    dev = rows.device
    cnt = counts[:T].long()
    tile_of = torch.repeat_interleave(torch.arange(T, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    slot_of = (starts[:T].long()[tile_of] - first[tile_of]
               + torch.arange(tile_of.numel(), device=dev))
    pidx = torch.arange(P, device=dev)
    X = (pidx % tile_px).float()[None, :]   # [1, P] tile-local pixel x
    Y = (pidx // tile_px).float()[None, :]
    for s in range(0, tile_of.numel(), _PLAIN_CHUNK):
        t = tile_of[s:s + _PLAIN_CHUNK]
        slot = slot_of[s:s + _PLAIN_CHUNK]
        g = rows[slot]  # [n, 16]
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
        inside = (X + tx0 < W) & (Y + ty0 < H)
        yield Pairs(slot, t, g, dx, dy, q, inside)


class Cull(NamedTuple):
    """Each slot's cull: its gate q_cut and the tile-local pixel rectangle
    [x0, x1] x [y0, y1] it can reach (empty where x0 > x1 or y0 > y1)."""
    q_cut: torch.Tensor  # float32
    x0: torch.Tensor     # int32
    x1: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor


def slot_cull_plain(gx, gy, a, b, c, qc, tile_px: int) -> Cull:
    """The rectangle of the cull that K1-K3 (gate q_cut) and K8 / K9 (gate 2
    log(o / alpha_min) + margin) apply to each staged slot, op for op as
    ``slot_cull`` in csrc/rasterize_sum_common.cuh computes it (whose head
    derives it): gx / gy the tile-local center, a, b, c the conic, qc the
    gate, float32 tensors of one shape. Every pixel of the tile whose
    float32 form (the kernels', rounded op by op) is <= qc lies in it."""
    X, Y, A, B, C, Q = (t.double() for t in (gx, gy, a, b, c, qc))
    empty = (X.isnan() | Y.isnan() | A.isnan() | B.isnan() | C.isnan()
             | ~(Q >= 0.0))
    AC = A * C
    det = AC - B * B
    e = 2e-6 * (AC / det)
    whole = (~empty & (X.isinf() | Y.isinf() | A.isinf() | B.isinf()
                       | C.isinf() | Q.isinf() | ~((det > 0.0) & (A > 0.0))
                       | ~(e < 0.5)))
    Qp = Q / (1.0 - e)
    top = tile_px - 1

    def side(center, extent):
        r = torch.sqrt(Qp * extent / det) * 1.001 + 1.0
        lo, hi = torch.ceil(center - r), torch.floor(center + r)
        lo = torch.where(lo > top, tile_px, torch.where(lo < 0.0, 0.0, lo))
        hi = torch.where(hi < 0.0, -1.0, torch.where(hi > top, top, hi))
        lo = torch.where(empty, tile_px, torch.where(whole, 0.0, lo))
        hi = torch.where(empty, -1.0, torch.where(whole, top, hi))
        return lo.int(), hi.int()

    x0, x1 = side(X, C)
    y0, y1 = side(Y, A)
    return Cull(qc, x0, x1, y0, y1)


def sum_cull_plain(rows: torch.Tensor, tx0, ty0, q_cut: float,
                   tile_px: int = 32) -> Cull:
    """The cull K1-K3 apply to each staged slot (``stage_slots`` in
    csrc/rasterize_sum_common.cuh): the rectangle of ``slot_cull_plain``
    for the gate q <= q_cut on the launch's tiles of ``tile_px`` pixels.
    rows [..., 16] feature rows, tx0 / ty0 their tiles' origins
    (broadcastable). The kernels compute this on the card; the plain
    versions do not cull, so nothing but tests and measurements calls
    it."""
    gx = rows[..., 0] - tx0
    gy = rows[..., 1] - ty0
    return slot_cull_plain(gx, gy, rows[..., 2], rows[..., 3], rows[..., 4],
                           torch.full_like(gx, q_cut), tile_px)


def cull_patches(cull: Cull, tile_px: int, patch) -> torch.Tensor:
    """[S, tile_px^2] bool, pixel p = y * tile_px + x of the tile: the
    pixels whose ``patch`` (columns, rows; the patches tile the tile from
    its origin) meets each slot's rectangle. With a kernel's warp patch:
    the pairs it evaluates (K8 / K9 ``rasterize_blend.PATCH``, K1-K3
    ``PATCH``); with K1-K3's ``WARP_BLOCK``: the pixels of the warps that
    visit the slot."""
    pidx = torch.arange(tile_px * tile_px, device=cull.x0.device)
    pw, ph = patch
    px0 = (pidx % tile_px) // pw * pw
    py0 = torch.div(pidx, tile_px, rounding_mode="floor") // ph * ph
    return ((cull.x0[:, None] <= px0 + pw - 1) & (cull.x1[:, None] >= px0)
            & (cull.y0[:, None] <= py0 + ph - 1) & (cull.y1[:, None] >= py0))


def _tile_image(img: torch.Tensor, tile_px: int, tiles_x: int,
                tiles_y: int) -> torch.Tensor:
    """[C, H, W] -> [T, C, P] tiles, zero-padded past H x W."""
    C, H, W = img.shape
    pad = torch.zeros(C, tiles_y * tile_px, tiles_x * tile_px,
                      dtype=img.dtype, device=img.device)
    pad[:, :H, :W] = img
    return (pad.reshape(C, tiles_y, tile_px, tiles_x, tile_px)
            .permute(1, 3, 0, 2, 4)
            .reshape(tiles_y * tiles_x, C, tile_px * tile_px))


def _untile_image(tiles: torch.Tensor, tile_px: int, tiles_x: int,
                  tiles_y: int, H: int, W: int) -> torch.Tensor:
    """[T, C, P] tiles -> [C, H, W], cropped."""
    C = tiles.shape[1]
    img = (tiles.reshape(tiles_y, tiles_x, C, tile_px, tile_px)
           .permute(2, 0, 3, 1, 4)
           .reshape(C, tiles_y * tile_px, tiles_x * tile_px))
    return img[:, :H, :W].contiguous()


# ---------------------------------------------------------------------------
# plain versions of K1, K2 and K3
# ---------------------------------------------------------------------------


class Gated(NamedTuple):
    """The gated (instance, pixel) pairs of one chunk of stream slots."""
    slot: torch.Tensor  # [n] the chunk's stream slots
    rows: torch.Tensor  # [n, 16] the chunk's feature rows
    k: torch.Tensor     # [m] slot within the chunk
    tile: torch.Tensor  # [m] the slot's tile
    pix: torch.Tensor   # [m] tile-local pixel
    w: torch.Tensor     # [m] exp(-q/2)
    dx: torch.Tensor    # [m] pixel minus center
    dy: torch.Tensor    # [m]


def gated_pairs(rows, starts, counts, H, W, tile_px=32, q_cut=9.0):
    """The pairs that pass the kernels' gate: a slot of a window, a pixel
    within H x W and q <= q_cut, in stream order (slot-major), with their
    weights (``window_pairs``' arguments). The plain versions evaluate only
    these."""
    out = []
    for pr in window_pairs(rows, starts, counts, H, W, tile_px):
        k, p = torch.nonzero(pr.inside & (pr.q <= q_cut), as_tuple=True)
        out.append(Gated(pr.slot, pr.rows, k, pr.tile[k], p,
                         torch.exp(-0.5 * pr.q[k, p]), pr.dx[k, p],
                         pr.dy[k, p]))
    return out


def _accumulate(gated, T: int, P: int, device) -> torch.Tensor:
    """[T, 4, P] per-tile sums of cm * w over the gated pairs (index_add_,
    in stream order where the device adds in order)."""
    acc = torch.zeros(T * P, _C, dtype=torch.float32, device=device)
    for gp in gated:
        acc.index_add_(0, gp.tile * P + gp.pix,
                       gp.rows[gp.k, 5:5 + _C] * gp.w[:, None])
    return acc.reshape(T, P, _C).permute(0, 2, 1)


def _backward_rows(gated, G: torch.Tensor, n_slots: int) -> torch.Tensor:
    """dgfeat [n_slots, 16]: K2's per-slot rows from the tiled cotangent
    G [T, 4, P] over the gated pairs; rows of slots outside every
    window stay zero."""
    dg = torch.zeros(n_slots, sc.FW, dtype=torch.float32, device=G.device)
    for gp in gated:
        cm = gp.rows[gp.k, 5:5 + _C]               # [m, 4]
        Gk = G[gp.tile, :, gp.pix]                 # [m, 4]
        dq = -0.5 * gp.w * (cm * Gk).sum(dim=1)
        dqdx, dqdy = dq * gp.dx, dq * gp.dy
        terms = torch.cat([torch.stack([dqdx, dqdy, dqdx * gp.dx,
                                        dqdx * gp.dy, dqdy * gp.dy], dim=1),
                           gp.w[:, None] * Gk], dim=1)  # [m, 9]
        n = gp.rows.shape[0]
        mom = torch.zeros(n, 9, dtype=torch.float32, device=G.device)
        mom.index_add_(0, gp.k, terms)
        cx, cy = mom[:, 0], mom[:, 1]
        a, b, c = gp.rows[:, 2], gp.rows[:, 3], gp.rows[:, 4]
        out = torch.zeros(n, sc.FW, dtype=torch.float32, device=G.device)
        out[:, 0] = -2.0 * a * cx - 2.0 * b * cy
        out[:, 1] = -2.0 * b * cx - 2.0 * c * cy
        out[:, 2] = mom[:, 2]
        out[:, 3] = 2.0 * mom[:, 3]
        out[:, 4] = mom[:, 4]
        out[:, 5:5 + _C] = mom[:, 5:]
        dg[gp.slot] = out
    return dg


def _accumulate_in_order(rows, starts, counts, H, W, tile_px, q_cut
                         ) -> torch.Tensor:
    """[T, 4, P] per-tile sums of cm * w, each pixel's gated pairs added
    one at a time in stream order, as K1 adds them: a loop over the
    position p within the windows, vectorised over the tiles, with q and w
    op for op as ``window_pairs`` and ``gated_pairs`` compute them. Reads
    the deepest window's length back to the host."""
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    T, P = tiles_x * tiles_y, tile_px * tile_px
    dev = rows.device
    cnt = counts[:T].long()
    first = starts[:T].long()
    t = torch.arange(T, device=dev)
    tx0 = ((t % tiles_x) * tile_px).float()[:, None]
    ty0 = (torch.div(t, tiles_x, rounding_mode="floor")
           * tile_px).float()[:, None]
    pidx = torch.arange(P, device=dev)
    X = (pidx % tile_px).float()[None, :]
    Y = (pidx // tile_px).float()[None, :]
    acc = torch.zeros(T, _C, P, dtype=torch.float32, device=dev)
    for p in range(int(cnt.max()) if T else 0):
        live = cnt > p  # [T] tiles whose window reaches position p
        g = rows[torch.where(live, first + p, 0)]  # [T, 16]
        dx = X - (g[:, 0:1] - tx0)
        dy = Y - (g[:, 1:2] - ty0)
        a, b, c = g[:, 2:3], g[:, 3:4], g[:, 4:5]
        q = torch.clamp(a * dx * dx + 2.0 * b * dx * dy + c * dy * dy,
                        min=0.0)
        on = live[:, None] & (q <= q_cut)  # [T, P]
        w = torch.exp(-0.5 * q)
        acc = torch.where(on[:, None], acc + g[:, 5:5 + _C, None] * w[:, None],
                          acc)
    return acc


def _fwd_rows(rows, starts, counts, H, W, tile_px, q_cut, in_order=False
              ) -> torch.Tensor:
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    if in_order:
        acc = _accumulate_in_order(rows, starts, counts, H, W, tile_px, q_cut)
    else:
        acc = _accumulate(
            gated_pairs(rows, starts, counts, H, W, tile_px, q_cut),
            tiles_x * tiles_y, tile_px * tile_px, rows.device)
    return _untile_image(acc, tile_px, tiles_x, tiles_y, H, W)


def _bwd_rows(rows, starts, counts, g, H, W, tile_px, q_cut) -> torch.Tensor:
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    return _backward_rows(
        gated_pairs(rows, starts, counts, H, W, tile_px, q_cut),
        _tile_image(g.float(), tile_px, tiles_x, tiles_y), rows.shape[0])


def _l2_rows(rows, starts, counts, gt, H, W, tile_px, q_cut, clamp):
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    T, P = tiles_x * tiles_y, tile_px * tile_px
    gated = gated_pairs(rows, starts, counts, H, W, tile_px, q_cut)
    img = _untile_image(_accumulate(gated, T, P, rows.device), tile_px,
                        tiles_x, tiles_y, H, W)[:3]
    diff, G = l2_cotangent(img, gt.float(), H, W, clamp)
    sse = _tile_image(diff * diff, tile_px, tiles_x, tiles_y).sum(dim=(1, 2))
    dg = _backward_rows(gated, _tile_image(G, tile_px, tiles_x, tiles_y),
                        rows.shape[0])
    return sse, dg


def sum_fwd_plain(feat: torch.Tensor, gids: torch.Tensor,
                  starts: torch.Tensor, H: int, W: int, tile_px: int = 32,
                  q_cut: float = 9.0, in_order: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1 -> [4, H, W] float32.

    feat [N+1, 16] packed rows, gids [I] int32 stream, starts [>= T+1]
    int32 window bounds. Sums cm * w over the gated pairs of every window
    (``gated_pairs``) onto the tiles with ``index_add_``, which adds in
    stream order on the CPU and in the atomics' order on the card. The
    arithmetic of each term is K1's, op for op. ``in_order`` adds each
    pixel's pairs one at a time in stream order on any device
    (``_accumulate_in_order``): K1's sum, bit for bit.
    """
    return _fwd_rows(sc.gather_stream(gids, feat), starts,
                     window_counts(starts), H, W, tile_px, q_cut, in_order)


def sum_bwd_plain(feat: torch.Tensor, gids: torch.Tensor,
                  starts: torch.Tensor, g: torch.Tensor, H: int, W: int,
                  tile_px: int = 32, q_cut: float = 9.0) -> torch.Tensor:
    """Plain PyTorch version of K2 -> dgfeat [I, 16] float32.

    g [4, H, W] is the cotangent of the render. Row s is slot s's
    [dgx, dgy, da, db, dc, dcm0..3, 0 x 7]: K2's formulas (the moments of
    dq summed directly over the pixel offsets) over the slot's gated
    pairs; rows of slots outside every window are zero.
    """
    return _bwd_rows(sc.gather_stream(gids, feat), starts,
                     window_counts(starts), g, H, W, tile_px, q_cut)


def sum_l2_plain(feat: torch.Tensor, gids: torch.Tensor,
                 starts: torch.Tensor, gt: torch.Tensor, H: int, W: int,
                 tile_px: int = 32, q_cut: float = 9.0, clamp: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 -> (sse [T] per tile, dgfeat [I, 16]).

    gt [3, H, W]. The plain K1 render, clipped (unless ``clamp`` is False),
    diff = img - gt, the per-tile sums of diff^2 and the L2 cotangent
    G = 2 / (3HW) * diff * [0 < img < 1] (``l2_cotangent``; alpha's is 0),
    then the plain K2 on G, over one evaluation of the gated pairs: K1, the
    loss and K2, as K3 fuses them.
    """
    return _l2_rows(sc.gather_stream(gids, feat), starts,
                    window_counts(starts), gt, H, W, tile_px, q_cut, clamp)


def sum_fwd_aligned_plain(blocks: torch.Tensor, starts: torch.Tensor,
                          counts: torch.Tensor, H: int, W: int,
                          tile_px: int = 32, q_cut: float = 9.0,
                          in_order: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the aligned K1 -> [4, H, W] float32:
    ``sum_fwd_plain`` over the aligned stream, whose feature blocks
    [NB, 16, 64] hold slot s's row down lane s % 64 of block s / 64 and
    whose windows are [starts[t], starts[t] + counts[t]); ``in_order`` as
    there."""
    return _fwd_rows(sc.unblockize_stream_plain(blocks), starts, counts, H,
                     W, tile_px, q_cut, in_order)


def sum_bwd_aligned_plain(blocks: torch.Tensor, starts: torch.Tensor,
                          counts: torch.Tensor, g: torch.Tensor, H: int,
                          W: int, tile_px: int = 32, q_cut: float = 9.0
                          ) -> torch.Tensor:
    """Plain PyTorch version of the aligned K2 -> gradient blocks
    [NB, 16, 64]: ``sum_bwd_plain``'s rows over the aligned stream, as
    blocks (slots outside every window zero)."""
    return sc.blocks_of_rows(_bwd_rows(
        sc.unblockize_stream_plain(blocks), starts, counts, g, H, W, tile_px,
        q_cut))


def sum_l2_aligned_plain(blocks: torch.Tensor, starts: torch.Tensor,
                         counts: torch.Tensor, gt: torch.Tensor, H: int,
                         W: int, tile_px: int = 32, q_cut: float = 9.0,
                         clamp: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the aligned K3 -> (sse [T], gradient blocks
    [NB, 16, 64]): ``sum_l2_plain`` over the aligned stream."""
    sse, dg = _l2_rows(sc.unblockize_stream_plain(blocks), starts, counts,
                       gt, H, W, tile_px, q_cut, clamp)
    return sse, sc.blocks_of_rows(dg)


def l2_cotangent(img: torch.Tensor, gt: torch.Tensor, H: int, W: int,
                 clamp: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(diff [3, H, W], G [4, H, W]): K3's per-pixel loss terms from an
    unclipped render ``img`` [3, H, W], op for op as K3 forms them."""
    if clamp:
        diff = torch.clamp(img, 0.0, 1.0) - gt
        live = (img > 0.0) & (img < 1.0)
        Grgb = 2.0 / (3.0 * H * W) * torch.where(live, diff,
                                                 torch.zeros_like(diff))
    else:
        diff = img - gt
        Grgb = 2.0 / (3.0 * H * W) * diff
    return diff, torch.cat([Grgb, torch.zeros_like(Grgb[:1])])


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _check_tensors(kernel: str, dev, named, images=()) -> None:
    """Device, type and layout checks: ``named`` are (name, tensor, dtype);
    ``images`` (name, tensor, shape) of float32 tensors, or (name, tensor,
    shape, dtype), are also held to their shapes."""
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got {dev}")
    named = list(named) + [(im[0], im[1], im[3] if len(im) > 3
                            else torch.float32) for im in images]
    for name, x, dtype in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the stream on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x, shape, *_ in images:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")


def _check_tile_px(kernel: str, tile_px: int, tiles) -> None:
    if tile_px not in tiles:
        raise NotImplementedError(
            f"{kernel} is built for tile_px in {tiles}, got "
            f"tile_px={tile_px}")


def _check_launch(kernel: str, feat, gids, starts, tile_px, images=(),
                  tiles=_TILES):
    """Checks of a launch on the flat stream; raises on anything the
    kernels do not take. ``images`` as ``_check_tensors``' ; ``tiles`` the
    tile sides the kernel is built for."""
    _check_tensors(kernel, feat.device, [
        ("feat", feat, torch.float32), ("gids", gids, torch.int32),
        ("starts", starts, torch.int32)], images)
    _check_tile_px(kernel, tile_px, tiles)
    if feat.dim() != 2 or feat.shape[1] != sc.FW or feat.shape[0] < 1:
        raise ValueError(f"feat must be [N+1, {sc.FW}], got "
                         f"{tuple(feat.shape)}")
    if gids.dim() != 1:
        raise ValueError(f"gids must be 1-D, got {tuple(gids.shape)}")


def _check_aligned_launch(kernel: str, blocks, starts, counts, tile_px, H,
                          W, images=(), tiles=_TILES):
    """Checks of a launch on the aligned stream: the blocks [NB, 16, 64]
    float32, int32 starts and counts for every tile, every window starting
    on a block and ending inside the stream. Reads one flag back to the
    host."""
    _check_tensors(kernel, blocks.device, [
        ("blocks", blocks, torch.float32), ("starts", starts, torch.int32),
        ("counts", counts, torch.int32)], images)
    _check_tile_px(kernel, tile_px, tiles)
    if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (sc.FW, sc.BK):
        raise ValueError(f"blocks must be [NB, {sc.FW}, {sc.BK}], got "
                         f"{tuple(blocks.shape)}")
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    T = tiles_x * tiles_y
    if counts.dim() != 1 or counts.shape[0] < T:
        raise ValueError(f"counts must be 1-D with at least {T} entries, got "
                         f"{tuple(counts.shape)}")
    st, cnt = starts[:T], counts[:T]
    if bool(((st % sc.BK != 0) | (cnt < 0)
             | (st + cnt > blocks.shape[0] * sc.BK)).any()):
        raise ValueError(f"{kernel}: the aligned windows must start on a "
                         f"multiple of {sc.BK} and end inside the "
                         f"{blocks.shape[0]} blocks")


def sum_fwd(feat: torch.Tensor, gids: torch.Tensor, starts: torch.Tensor,
            H: int, W: int, tile_px: int = 32, q_cut: float = 9.0
            ) -> torch.Tensor:
    """K1 -> [4, H, W] float32 (rgb premultiplied sums + alpha).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``sum_fwd.launches`` counts the kernel's launches.
    """
    if feat.device.type == "cpu":
        return sum_fwd_plain(feat, gids, starts, H, W, tile_px, q_cut)
    _check_launch("K1", feat, gids, starts, tile_px)
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    lib = _build.load("rasterize_sum_fwd")
    out = torch.empty(_C, H, W, dtype=torch.float32, device=feat.device)
    _raise_on("K1 rasterize_sum_fwd", lib.rasterize_sum_fwd(
        feat.data_ptr(), feat.shape[0], gids.data_ptr(), starts.data_ptr(),
        out.data_ptr(), H, W, tiles_x, tiles_y, tile_px, ctypes.c_float(q_cut),
        _stream_ptr(feat)))
    sum_fwd.launches += 1
    return out


def sum_bwd(feat: torch.Tensor, gids: torch.Tensor, starts: torch.Tensor,
            g: torch.Tensor, H: int, W: int, tile_px: int = 32,
            q_cut: float = 9.0) -> torch.Tensor:
    """K2 -> dgfeat [I, 16] float32 from the render's cotangent g [4, H, W].

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``sum_bwd.launches`` counts the kernel's launches.
    """
    if feat.device.type == "cpu":
        return sum_bwd_plain(feat, gids, starts, g, H, W, tile_px, q_cut)
    _check_launch("K2", feat, gids, starts, tile_px,
                  images=[("g", g, (_C, H, W))])
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    lib = _build.load("rasterize_sum_bwd")
    dg = torch.zeros(gids.shape[0], sc.FW, dtype=torch.float32,
                     device=feat.device)
    _raise_on("K2 rasterize_sum_bwd", lib.rasterize_sum_bwd(
        feat.data_ptr(), feat.shape[0], gids.data_ptr(), starts.data_ptr(),
        g.data_ptr(), dg.data_ptr(), H, W, tiles_x, tiles_y, tile_px,
        ctypes.c_float(q_cut), _stream_ptr(feat)))
    sum_bwd.launches += 1
    return dg


def sum_l2(feat: torch.Tensor, gids: torch.Tensor, starts: torch.Tensor,
           gt: torch.Tensor, H: int, W: int, tile_px: int = 32,
           q_cut: float = 9.0, clamp: bool = True
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 -> (sse [T] per-tile sums of squared errors, dgfeat [I, 16]) of
    the clipped render against gt [3, H, W].

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``sum_l2.launches`` counts the kernel's launches.
    """
    if feat.device.type == "cpu":
        return sum_l2_plain(feat, gids, starts, gt, H, W, tile_px, q_cut,
                            clamp)
    _check_launch("K3", feat, gids, starts, tile_px,
                  images=[("gt", gt, (3, H, W))])
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    lib = _build.load("rasterize_sum_bwd")
    sse = torch.empty(tiles_x * tiles_y, dtype=torch.float32,
                      device=feat.device)
    dg = torch.zeros(gids.shape[0], sc.FW, dtype=torch.float32,
                     device=feat.device)
    _raise_on("K3 rasterize_sum_l2", lib.rasterize_sum_l2(
        feat.data_ptr(), feat.shape[0], gids.data_ptr(), starts.data_ptr(),
        gt.data_ptr(), sse.data_ptr(), dg.data_ptr(), H, W, tiles_x, tiles_y,
        tile_px, ctypes.c_float(q_cut), ctypes.c_float(2.0 / (3.0 * H * W)),
        int(bool(clamp)), _stream_ptr(feat)))
    sum_l2.launches += 1
    return sse, dg


def sum_fwd_aligned(blocks: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, H: int, W: int, tile_px: int = 32,
                    q_cut: float = 9.0) -> torch.Tensor:
    """K1 on the aligned stream -> [4, H, W] float32: the feature blocks
    [NB, 16, 64] of K11a, windows [starts[t], starts[t] + counts[t]).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. A launch counts in ``sum_fwd.launches`` and
    ``sum_fwd_aligned.launches``.
    """
    if blocks.device.type == "cpu":
        return sum_fwd_aligned_plain(blocks, starts, counts, H, W, tile_px,
                                     q_cut)
    _check_aligned_launch("K1", blocks, starts, counts, tile_px, H, W)
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    lib = _build.load("rasterize_sum_fwd")
    out = torch.empty(_C, H, W, dtype=torch.float32, device=blocks.device)
    _raise_on("K1 rasterize_sum_fwd_aligned", lib.rasterize_sum_fwd_aligned(
        blocks.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        out.data_ptr(), H, W, tiles_x, tiles_y, tile_px, ctypes.c_float(q_cut),
        _stream_ptr(blocks)))
    sum_fwd.launches += 1
    sum_fwd_aligned.launches += 1
    return out


def sum_bwd_aligned(blocks: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, g: torch.Tensor, H: int, W: int,
                    tile_px: int = 32, q_cut: float = 9.0) -> torch.Tensor:
    """K2 on the aligned stream -> gradient blocks [NB, 16, 64] float32
    from the render's cotangent g [4, H, W]: each slot's row down its lane,
    slots outside every window zero.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. A launch counts in ``sum_bwd.launches`` and
    ``sum_bwd_aligned.launches``.
    """
    if blocks.device.type == "cpu":
        return sum_bwd_aligned_plain(blocks, starts, counts, g, H, W,
                                     tile_px, q_cut)
    _check_aligned_launch("K2", blocks, starts, counts, tile_px, H, W,
                          images=[("g", g, (_C, H, W))])
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    lib = _build.load("rasterize_sum_bwd")
    dgb = torch.zeros_like(blocks)
    _raise_on("K2 rasterize_sum_bwd_aligned", lib.rasterize_sum_bwd_aligned(
        blocks.data_ptr(), starts.data_ptr(), counts.data_ptr(), g.data_ptr(),
        dgb.data_ptr(), H, W, tiles_x, tiles_y, tile_px, ctypes.c_float(q_cut),
        _stream_ptr(blocks)))
    sum_bwd.launches += 1
    sum_bwd_aligned.launches += 1
    return dgb


def sum_l2_aligned(blocks: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, gt: torch.Tensor, H: int, W: int,
                   tile_px: int = 32, q_cut: float = 9.0, clamp: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on the aligned stream -> (sse [T], gradient blocks [NB, 16, 64])
    of the clipped render against gt [3, H, W].

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. A launch counts in ``sum_l2.launches`` and
    ``sum_l2_aligned.launches``.
    """
    if blocks.device.type == "cpu":
        return sum_l2_aligned_plain(blocks, starts, counts, gt, H, W, tile_px,
                                    q_cut, clamp)
    _check_aligned_launch("K3", blocks, starts, counts, tile_px, H, W,
                          images=[("gt", gt, (3, H, W))])
    tiles_x, tiles_y = _check_tiles(H, W, tile_px, starts)
    lib = _build.load("rasterize_sum_bwd")
    sse = torch.empty(tiles_x * tiles_y, dtype=torch.float32,
                      device=blocks.device)
    dgb = torch.zeros_like(blocks)
    _raise_on("K3 rasterize_sum_l2_aligned", lib.rasterize_sum_l2_aligned(
        blocks.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        gt.data_ptr(), sse.data_ptr(), dgb.data_ptr(), H, W, tiles_x,
        tiles_y, tile_px, ctypes.c_float(q_cut),
        ctypes.c_float(2.0 / (3.0 * H * W)), int(bool(clamp)),
        _stream_ptr(blocks)))
    sum_l2.launches += 1
    sum_l2_aligned.launches += 1
    return sse, dgb


for _fn in (sum_fwd, sum_bwd, sum_l2, sum_fwd_aligned, sum_bwd_aligned,
            sum_l2_aligned):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# autograd over the whole rasterize
# ---------------------------------------------------------------------------


class _Raster(torch.autograd.Function):
    """feat [N+1, 16] -> the [4, H, W] render of the stream ``sp`` (K1;
    on the aligned stream K11a first); backward K2 on the cotangent, then
    the scatter onto the rows (K11b first on the aligned stream): the JAX
    package's ``_raster`` custom_vjp."""

    @staticmethod
    def forward(ctx, feat, sp, H, W, tile_px, q_cut):
        if sp.aligned:
            src = sc.blockize_stream(feat, sp.gids)
            out = sum_fwd_aligned(src, sp.starts, sp.counts, H, W, tile_px,
                                  q_cut)
        else:
            src = feat
            out = sum_fwd(feat, sp.gids, sp.starts, H, W, tile_px, q_cut)
        ctx.save_for_backward(src)
        ctx.sp = sp
        ctx.geom = (feat.shape[0], H, W, tile_px, q_cut)
        return out

    @staticmethod
    def backward(ctx, g):
        src, = ctx.saved_tensors
        sp = ctx.sp
        n_rows, H, W, tile_px, q_cut = ctx.geom
        g = g.float().contiguous()
        if sp.aligned:
            dgb = sum_bwd_aligned(src, sp.starts, sp.counts, g, H, W,
                                  tile_px, q_cut)
            dfeat = sc.scatter_block_grads(dgb, sp.gids, n_rows, sp.m_span)
        else:
            dg = sum_bwd(src, sp.gids, sp.starts, g, H, W, tile_px, q_cut)
            dfeat = sc.scatter_stream_grads(dg, sp.gids, n_rows, sp.m_span)
        return dfeat, None, None, None, None, None


class _RasterL2(torch.autograd.Function):
    """feat [N+1, 16] -> mse = sum(sse) / (3HW) of the clipped render
    against gt (K3; on the aligned stream K11a first). The forward also
    scatters K3's gradient rows (K11b first on the aligned stream), so the
    backward is grad_output * dfeat; gt gets no gradient (the JAX package's
    ``_raster_l2`` custom_vjp)."""

    @staticmethod
    def forward(ctx, feat, sp, gt, H, W, tile_px, q_cut, clamp):
        if sp.aligned:
            sse, dgb = sum_l2_aligned(sc.blockize_stream(feat, sp.gids),
                                      sp.starts, sp.counts, gt, H, W, tile_px,
                                      q_cut, clamp)
            dfeat = sc.scatter_block_grads(dgb, sp.gids, feat.shape[0],
                                           sp.m_span)
        else:
            sse, dg = sum_l2(feat, sp.gids, sp.starts, gt, H, W, tile_px,
                             q_cut, clamp)
            dfeat = sc.scatter_stream_grads(dg, sp.gids, feat.shape[0],
                                            sp.m_span)
        ctx.save_for_backward(dfeat)
        return sse.sum() / (3.0 * H * W)

    @staticmethod
    def backward(ctx, gbar):
        dfeat, = ctx.saved_tensors
        return (gbar * dfeat,) + (None,) * 7


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


def _prepare(xys, conics, colors, opacities, H, W, radii, cfg, band=None):
    """The binned stream of detached inputs (the JAX package's
    stop_gradients) and the packed rows, which carry the gradient.
    ``cfg.fused_prep`` is not read here: as in the JAX package, only the
    models' ``render_fast`` and fused decode take the fused prep
    (ops/splat_prep.py), and this generic path bins under the same caps."""
    with torch.no_grad():
        conics_d = conics.detach()
        if radii is None:
            radii = _radii_from_conics(conics_d)
        radii = radii.detach().float()
        rxy = _axis_radii(conics_d, radii, cfg.q_cut)
        sp = sc.prepare_stream(xys.detach().float(), rxy, H, W, cfg,
                               band=band)
    feat = sc.pack_feat(xys, conics, colors, opacities, premultiply=True)
    return sp, feat


def _render_chw(xys, conics, colors, opacities, H, W, radii, cfg, band):
    sp, feat = _prepare(xys, conics, colors, opacities, H, W, radii, cfg,
                        band)
    full = _Raster.apply(feat, sp, H, W, cfg.tile_px, float(cfg.q_cut))
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
    instance-stream overflow count. Differentiable with respect to the four
    inputs (K2). ``band`` restricts each Gaussian to an inclusive tile-row
    range.
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


def stream_from_keys(keys: torch.Tensor, N: int, H: int, W: int,
                     config: RasterizeConfig, max_instances: int):
    """(gids [<= I], starts [T+1], counts [T]) of the tile-sorted stream
    from the flat packed int32 keys ``(tile << id_bits) | gaussian_id``
    (INT32_MAX dead slots) that the fused splat prep emits: one sort, the
    first I keys, dead slots to the sentinel row N, and the window bounds,
    as ``tiles._sorted_stream``'s packed branch finishes it."""
    tp = config.tile_px
    T_real = (-(-W // tp)) * (-(-H // tp))
    T = T_real + ((-T_real) % config.tiles_per_step)
    id_bits = max(int(N - 1).bit_length(), 1)
    if (T_real + 1) * (1 << id_bits) >= 2 ** 31:
        raise ValueError("stream_from_keys needs the packed-key regime")
    # live keys are unique, so a non-stable sort gives one order
    skey = torch.sort(keys, stable=False).values[:max_instances]
    srank = skey & ((1 << id_bits) - 1)
    gids = torch.where(skey == INT32_MAX, torch.full_like(srank, N),
                       srank).int()
    queries = torch.arange(T_real + 1, dtype=torch.int32,
                           device=keys.device) << id_bits
    starts = sorted_window_bounds(skey, queries)  # [T_real + 1], <= I
    if T > T_real:
        starts = torch.cat([starts, starts[-1:].expand(T - T_real)])
    return gids, starts, starts[1:] - starts[:-1]


def rasterize_from_keys_chw(
    feat: torch.Tensor,
    keys: torch.Tensor,
    trunc: torch.Tensor,
    n_total: torch.Tensor,
    H: int,
    W: int,
    config: RasterizeConfig,
    max_instances: int,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Forward-only render from pre-packed inputs: ``feat`` [N+1, 16]
    premultiplied rows and the flat packed sort ``keys`` of the fused
    splat prep (ops/splat_prep.py): ``stream_from_keys``, then K1. Flat
    stream, packed keys only.

    ``trunc`` / ``n_total`` are the prep's summed counts: n_dropped =
    trunc + max(n_total - I, 0), as ``prepare_stream`` counts it. Returns
    (img [3, H, W], alpha [H, W], aux)."""
    I = max_instances
    gids, starts, counts = stream_from_keys(keys, feat.shape[0] - 1, H, W,
                                            config, I)
    full = sum_fwd(feat, gids, starts, H, W, config.tile_px,
                   float(config.q_cut))
    n_dropped = (trunc + torch.clamp(n_total - I, min=0)).int()
    aux = {"n_dropped": n_dropped, "max_per_tile_used": counts.max()}
    return full[:3], full[3], aux


def rasterize_gaussians_sum_l2(
    xys: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    gt_chw: torch.Tensor,
    H: int,
    W: int,
    radii: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
    clamp: bool = True,
) -> Tuple[torch.Tensor, dict]:
    """Fused training objective: mse = mean((clip(render) - gt)^2), with the
    analytic backward computed in the same kernel pass (K3). Equal to
    ``mean((clip(rasterize(...)) - gt)^2)`` up to summation order.

    gt_chw [3, H, W] gets no gradient. Differentiable with respect to the
    four Gaussian inputs. Returns (mse, aux).
    """
    sp, feat = _prepare(xys, conics, colors, opacities, H, W, radii, config)
    mse = _RasterL2.apply(feat, sp, gt_chw.detach().float().contiguous(),
                          H, W, config.tile_px, float(config.q_cut),
                          bool(clamp))
    aux = {"n_dropped": sp.n_dropped, "max_per_tile_used": sp.counts.max()}
    return mse, aux
