"""Per-Gaussian tile binning (counterpart of gaussianimage_tpu/ops/tiles.py):
the sort-based pipeline of the CUDA reference (map_gaussian_to_intersects +
radix sort + tile bin edges) on tensors.

1. per Gaussian: the clipped tile-span rectangle of its bbox, expanded to at
   most M (tile, gaussian) instances (``_expand_instances``);
2. ONE sort groups instances by tile: a packed int32 key
   ``(tile << id_bits) | rank`` with dead slots at INT32_MAX, or, when the
   pair does not fit in 31 bits, the same (tile, rank) order through an
   int64 key (``_sorted_stream``);
3. per-tile window bounds = searchsorted-left of T+1 queries
   (``sorted_window_bounds``);
4. the rasterizers walk the sorted stream directly
   (``bin_gaussian_instances``), or the aligned stream, whose windows are
   padded to whole chunks of BK slots (``bin_instances_aligned``).

Within a tile the stream keeps input order (rank is monotonic in input
position), so gids, window bounds and the overflow count are integer-equal
to the JAX package's on the same inputs. The JAX package's depth ``order``
argument is not ported: its blend rasterizer bins depth-ordered inputs
instead, and so does the port's (ops/rasterize_blend.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

INT32_MAX = 2 ** 31 - 1


class InstanceStream(NamedTuple):
    """Tile-sorted instance stream (rasterizer input).

    gids [I] int32: Gaussian id per sorted instance; N (the zero-feature
    sentinel row) for dead slots, which sort to the tail. starts
    [n_tiles_padded + 1] int32: per-tile window bounds into the stream,
    clipped to I; padded tiles get empty windows.
    """
    gids: torch.Tensor
    starts: torch.Tensor
    n_dropped: torch.Tensor  # [] int32: instances lost to caps


def _split_radii(radii):
    """Isotropic [N] radii or an anisotropic (rx, ry) pair."""
    if isinstance(radii, tuple):
        return radii
    return radii, radii


def _expand_instances(xys, radii, tiles_x: int, tiles_y: int, tile_px: int,
                      M: int,
                      band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(tile [M, N] int32, live [M, N] bool, n_truncated) — bbox tile spans
    capped at M instances per Gaussian, slot-major as in the JAX package.

    ``band``: optional per-Gaussian inclusive tile-ROW bounds (lo[N], hi[N]);
    a Gaussian bins only into tile rows within its band (batched rendering
    stacks frames vertically)."""
    rx, ry = _split_radii(radii)
    x = xys[:, 0]
    y = xys[:, 1]
    rx = rx.float()
    ry = ry.float()
    dev = xys.device

    if band is None:
        row_lo = torch.zeros_like(x)
        row_hi = torch.full_like(x, tiles_y - 1)
    else:
        row_lo, row_hi = band[0].to(x.dtype), band[1].to(x.dtype)

    x0 = torch.clamp(torch.floor((x - rx) / tile_px), 0, tiles_x - 1).int()
    x1 = torch.clamp(torch.floor((x + rx) / tile_px), 0, tiles_x - 1).int()
    y0 = torch.minimum(torch.maximum(torch.floor((y - ry) / tile_px), row_lo),
                       row_hi).int()
    y1 = torch.minimum(torch.maximum(torch.floor((y + ry) / tile_px), row_lo),
                       row_hi).int()
    inside = ((rx > 0) & (ry > 0)
              & (x + rx >= 0) & (x - rx < tiles_x * tile_px)
              & (y + ry >= 0) & (y - ry < tiles_y * tile_px))
    span_w = x1 - x0 + 1
    area = span_w * (y1 - y0 + 1)
    trunc = torch.where(inside, torch.clamp(area - M, min=0),
                        torch.zeros_like(area)).sum()

    jj = torch.arange(M, dtype=torch.int32, device=dev)[:, None]
    jx = jj % span_w[None, :]
    jy = torch.div(jj, span_w[None, :], rounding_mode="floor")
    tile = (y0[None, :] + jy) * tiles_x + (x0[None, :] + jx)  # [M, N]
    live = inside[None, :] & (jj < torch.clamp(area, max=M)[None, :])
    return tile.int(), live, trunc


def _sorted_stream(tile, live, N: int, T: int, force_pair: bool = False):
    """Sort instances by tile. Returns (srank [N*M] input-order ranks, dead
    [N*M] mask, the sorted keys the window bounds search, and the T+1
    queries for those bounds)."""
    dev = tile.device
    rank = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    id_bits = max(int(N - 1).bit_length(), 1)
    if not force_pair and (T + 1) * (1 << id_bits) < 2 ** 31:
        # packed single-int32 key; keys of live instances are unique, so a
        # non-stable sort gives the JAX package's order exactly
        key = torch.where(live, (tile << id_bits) | rank,
                          torch.full_like(tile, INT32_MAX))
        skey = torch.sort(key.reshape(-1), stable=False).values
        srank = skey & ((1 << id_bits) - 1)
        dead = skey == INT32_MAX
        bounds_keys = skey
        queries = torch.arange(T + 1, dtype=torch.int32, device=dev) << id_bits
    else:
        # lexicographic (tile, rank) pair order: one int64 key
        tile_flat = torch.where(live, tile, torch.full_like(tile, T)
                                ).reshape(-1).long()
        rank_flat = rank.expand_as(tile).reshape(-1).long()
        skey = torch.sort(tile_flat * N + rank_flat).values
        stile = torch.div(skey, N, rounding_mode="floor")
        srank = (skey - stile * N).int()
        dead = stile >= T
        bounds_keys = stile.int()
        queries = torch.arange(T + 1, dtype=torch.int32, device=dev)
    return srank, dead, bounds_keys, queries


def sorted_window_bounds(keys: torch.Tensor, queries: torch.Tensor
                         ) -> torch.Tensor:
    """#{keys < q} for each query over SORTED int32 keys — the per-tile
    window bounds (searchsorted 'left')."""
    return torch.searchsorted(keys.contiguous(), queries,
                              right=False).int()


def bin_gaussian_instances(xys, radii, tiles_x: int, tiles_y: int,
                           tile_px: int, max_instances: int,
                           n_tiles_padded: int, max_tiles_per_gauss: int = 36,
                           band=None, force_pair: bool = False
                           ) -> InstanceStream:
    """Tile-sorted instance stream: no per-tile capacity (the rasterizer
    walks each tile's window with a data-dependent trip count); only the
    global ``max_instances`` stream cap applies."""
    T = tiles_x * tiles_y
    N = xys.shape[0]
    I = max_instances

    tile, live, trunc = _expand_instances(
        xys, radii, tiles_x, tiles_y, tile_px, max_tiles_per_gauss,
        band=band)
    srank, dead, bounds_keys, queries = _sorted_stream(tile, live, N, T,
                                                       force_pair=force_pair)
    srank, dead, bounds_keys = srank[:I], dead[:I], bounds_keys[:I]

    gids = torch.where(dead, torch.full_like(srank, N), srank)
    bounds = sorted_window_bounds(bounds_keys, queries)  # [T+1], <= I
    if n_tiles_padded > T:
        bounds = torch.cat([bounds, bounds[-1:].expand(n_tiles_padded - T)])
    n_total = live.sum()
    n_dropped = (trunc + torch.clamp(n_total - I, min=0)).int()
    return InstanceStream(gids.int(), bounds, n_dropped)


class AlignedStream(NamedTuple):
    """Instance stream with every tile window padded to a multiple of the
    chunk size BK; padding slots point at the sentinel row N.

    Each chunk of a window is then one whole block of BK slots, so the
    rasterizers read the stream as [n_blocks, 16, BK] transposed feature
    blocks (stream_common.blockize_stream) and their backward writes whole
    gradient blocks, each owned by one tile.
    """
    gids: torch.Tensor     # [I] int32, N = dead or padding slot
    starts: torch.Tensor   # [n_tiles_padded + 1] int32, multiples of BK
    counts: torch.Tensor   # [n_tiles_padded] int32 real (unpadded) counts
    n_dropped: torch.Tensor  # [] int32


def bin_instances_aligned(xys, radii, tiles_x: int, tiles_y: int,
                          tile_px: int, max_instances_padded: int,
                          n_tiles_padded: int, block: int,
                          max_tiles_per_gauss: int = 25, band=None,
                          force_pair: bool = False) -> AlignedStream:
    """Like ``bin_gaussian_instances``, with BK-aligned tile windows.

    ``max_instances_padded`` is a multiple of ``block`` that includes the
    headroom for the per-tile padding (up to block - 1 slots a tile).
    Windows past the capacity are clipped at it; ``counts`` keeps each
    window's real count, clipped the same way, and n_dropped = trunc +
    max(n_total - kept, 0), as the JAX package counts them."""
    T = tiles_x * tiles_y
    N = xys.shape[0]
    I = max_instances_padded
    dev = xys.device

    tile, live, trunc = _expand_instances(
        xys, radii, tiles_x, tiles_y, tile_px, max_tiles_per_gauss,
        band=band)
    srank, dead, bounds_keys, queries = _sorted_stream(tile, live, N, T,
                                                       force_pair=force_pair)
    gids_sorted = torch.where(dead, torch.full_like(srank, N), srank)

    bounds = sorted_window_bounds(bounds_keys, queries)  # [T+1]
    counts_real = bounds[1:] - bounds[:-1]
    acounts = torch.div(counts_real + block - 1, block,
                        rounding_mode="floor") * block
    astarts = torch.cat([bounds.new_zeros(1),
                         torch.cumsum(acounts, 0).int()])
    astarts = torch.clamp(astarts, max=I)
    counts = torch.minimum(counts_real, astarts[1:] - astarts[:-1])

    # aligned slot m = b*block + r maps back to sorted position
    # bounds[t(b)] + (m - astarts[t(b)]), with t(b) the tile whose window
    # holds block b: the last t with astarts[t] <= b*block
    NB = I // block
    bstart = torch.arange(NB, dtype=torch.int32, device=dev) * block
    t_b = torch.searchsorted(astarts[1:T + 1].contiguous(), bstart,
                             right=True)
    t_b = torch.clamp(t_b, max=T - 1)
    lane = torch.arange(block, dtype=torch.int32, device=dev)[None, :]
    src = (bounds[t_b] + (bstart - astarts[t_b]))[:, None] + lane
    valid = ((src < bounds[t_b + 1][:, None])
             & (bstart[:, None] + lane < astarts[-1]))
    src = torch.clamp(src, 0, gids_sorted.shape[0] - 1).reshape(-1)
    gids = torch.where(valid.reshape(-1), gids_sorted[src.long()],
                       torch.full_like(src, N))

    if n_tiles_padded > T:
        astarts = torch.cat([astarts, astarts[-1:].expand(n_tiles_padded - T)])
        counts = torch.cat([counts, counts.new_zeros(n_tiles_padded - T)])
    n_dropped = (trunc + torch.clamp(live.sum() - counts.sum(), min=0)).int()
    return AlignedStream(gids.int(), astarts.int(), counts.int(), n_dropped)
